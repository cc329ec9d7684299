#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Drives the port (``mss_tf_locoformer_tpu_torch``) at the base config of
``configs/musdb18.yaml``, the xlarge config of ``configs/musdb18_xlarge.yaml``,
the small config of ``configs/musdb18_small.yaml`` and the BS-Locoformer
config of ``configs/musdb18_bslocoformer.yaml`` (all built here in code: the
GPU machine may have no PyYAML), with seeded random weights, through its main
paths: base serving (the separation CLI), xlarge serving (the separation
CLI, through the unfused route's kernels), base training (the training CLI),
training through the unfused route (xlarge and small), BS-Locoformer stereo
serving (the separation CLI) and evaluation (the evaluation CLI, base and
BS-Locoformer).  Phases, each of which raises on failure (exit code != 0, no
result line):

  1. device: require CUDA; print the card's name and power limit;
  2. build: compile the CUDA kernels from ``csrc/`` with nvcc, in parallel;
     gates: the route the step gates give the base config (fused steps)
     and the xlarge config (unfused route), in eval and in training, and
     which flash-attention kernels the unfused route's shapes take (the
     resident forward everywhere; the one-pass resident backward at the
     small config, the streaming one at xlarge), and which FFN-core kernels
     (the Hopper kernels at xlarge's C 256, with #9's row groups, splits
     and scratch; the mma.sync kernels at the small config's C 48);
  3. kernels: each base forward kernel against its plain PyTorch version at
     the shapes the serving path gives it (one engine batch: 2 chunks of
     8 s); the STFT (#1) timed beside ``torch.stft``, in device time and
     with the host's time;
  4. slice parity: the whole model with its kernels against the same model
     with every kernel replaced by its plain version (1 s, batch 1, bf16);
     the check must reject the model with its blocks skipped;
  5. serving: the separation CLI on a 20 s stereo WAV (3 chunks of 8 s in
     2 batches of 2), 4 stereo stems checked, launch counts checked exactly;
  6. timings: each kernel against its plain version, one model forward of
     the engine batch on the kernel path against the plain path (in turns,
     with peak device memory), and the separation's wall time and realtime
     factor; a ``torch.profiler`` trace of one kernel-path forward (device
     time by kernel, the library's matrix products, the device's busy
     share), base and xlarge;
  X. xlarge serving, phases 3-6 again: the flash-attention and FFN-core
     kernels against their plain versions at the engine batch's freq and
     time shapes (flash attention compared on row slices: the plain fp32
     scores of all 690 freq rows would take ~185 GB), with the library
     time of ``scaled_dot_product_attention`` beside flash attention's and
     #8's device time kernel by kernel (``torch.profiler``);
     slice parity at full width and depth; the separation CLI with exact
     launch counts (per forward 24 flash-attention and 48 FFN-core
     launches, no fused step); the forward in turns;
  7. training kernels: forward (with the training stash) and backward of
     the FFN and attention steps at the training path's full rows (micro-
     batch 2 of 3 s: freq [518, 1025, 96], time [2050, 259, 96]) against
     autograd through their plain versions in fp32 on the same inputs at
     dropout 0, and at dropout 0.1 on a 16-row slice; timed;
  8. training: the training CLI on a synthetic MUSDB tree (16 train tracks
     of 4 s, 2 test tracks), base model and training sections (batch 8 as 4
     micro-batches of 2 x 3 s, bf16, dropout 0.1, AdamW, clip 5): one epoch
     of 2 optimizer steps, validation and a checkpoint, then ``--resume``
     for one more epoch; launch counters, gradients and the checkpoint
     (through the separation CLI) checked;
  9. train-step parity: the kernel path against the plain path, same
     weights, batch and dropout seeds (1 x 1 s, dropout 0.1);
 10. train-step timing in turns (plain, kernel, kernel, plain), with peak
     device memory;
 11. unfused training kernels: the flash-attention backward (#7) and the
     FFN-core backward (#9) at the small config's training shapes (batch
     16 x 3 s) and the xlarge config's (micro-batch 1 x 15 s) against
     autograd through their plain versions in fp32 (row slices where the
     plain version's memory forces them; #9 at dropout 0.1 on 16 rows too),
     #7 run twice for the same bits, #9 too at the xlarge freq shape
     (dropout 0.1, 8 row groups), timed beside their bounds (#7 beside
     the autograd backward of ``scaled_dot_product_attention``), each
     kernel of #7 and #9 apart from a ``torch.profiler`` trace; #6 with its
     training stash at the small config's shapes, timed beside SDPA; the
     dropout-mask kernel bit for bit against its plain version;
 12. the xlarge train step at full width and depth (12 layers, remat,
     dropout 0.1, 15 s) at micro-batch 1, and 2 when twice the measured
     peak fits, with exact launch counts (per micro-batch 96 FFN-core
     forwards, 48 backwards, no flash attention); its peak printed beside
     the mma.sync kernels' 40.94 GiB plus #9's scratch cap and partials;
 13. xlarge train-step parity: kernel path against plain path at 1 x 1 s,
     the gradients' relative L2 per parameter group, rejecting the model
     with its blocks skipped;
 14. the training CLI through the unfused route, with exact launch counts:
     the small config's published sections (batch 16 x 3 s, SI-SDR, #6, #7,
     #8, #9) and the xlarge config's training section (augmentation,
     warmup, accumulation 2, gradient checkpointing; cut to 1 layer and
     1 s segments), one epoch of 2 steps each, then ``--resume``;
 15. the iSTFT kernels (#10's frames and the overlap-add; an API of its
     own: no model calls it) against their plain versions at the
     BS-Locoformer and base engine batches' shapes (frames, overlap-add, the
     whole iSTFT and its gradient), timed beside their bounds and
     ``torch.istft``; then #1 at the small training (n_fft 1024) and
     xlarge (4096) sizes, #1 and the iSTFT kernels at the speech configs'
     (128, 256; ragged frame counts), and another n_fft (or a hop too long
     for a block) refused on the card (the STFT and iSTFT kernels take
     microseconds, less than their wrappers' host time, so they, their plain
     versions and ``torch.stft`` are timed twice: in device time, queued
     behind a spin kernel, and with the host's time included;
     ``torch.istft`` synchronises on every call, so it and the whole
     ``istft_fused`` are compared with the host's time included);
 16. BS-Locoformer serving at full width and depth (6 layers, C 128, 4 heads
     of 32, 62 bands, stereo, masking): the FFN and attention steps against
     their plain versions at its engine batch's shapes (freq [1380, 62, 128],
     time [124, 690, 128]); slice parity with exact launch counts per
     forward (12 FFN steps, 12 attention steps); the separation CLI on the
     20 s stereo WAV (4 true-stereo stems); the forward in turns and its
     profile;
 17. evaluation: the evaluation CLI on a synthetic MUSDB test subset (2
     tracks of 10 s, 2 overlap-added chunks each) for the base config
     (mono) and BS-Locoformer (stereo): the kernel route timed with exact
     launch counts, the plain route with ``--bss_eval``, ``results.json``
     checked; each kernel-route stem held against the plain route's stem
     (SI-SDR from slice parity's bound) and its score against the plain
     route's score.

``python3 chip_smoke.py --profile-xlarge-train`` instead prints the device-
time breakdown of one xlarge micro-batch train step (minutes of trace
reading, so it is not a phase of the smoke test).

It imports nothing of JAX.  The line before the last is a JSON object with
one entry per kernel; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 0
SR = 44100


def base_model_config():
    """The model section of ``configs/musdb18.yaml``."""
    from mss_tf_locoformer_tpu_torch.core.config import ModelConfig
    return ModelConfig(
        n_fft=2048, hop_length=512, n_sources=4, n_layers=4, emb_dim=96,
        norm_type="rmsgroupnorm", num_groups=4, tf_order="ft", n_heads=4,
        flash_attention=True, fused_ffn=True, fused_stft=True,
        attention_dim=96, pos_enc="rope",
        ffn_type=("swiglu_conv1d", "swiglu_conv1d"), ffn_hidden_dim=(384, 384),
        conv1d_kernel=4, conv1d_shift=1, dropout=0.1, eps=1.0e-5)


def xlarge_model_config():
    """The model section of ``configs/musdb18_xlarge.yaml``: C 256 and 16 heads
    of 16, which the fused steps' gates refuse, so every step takes the
    unfused route through the flash-attention and FFN-core kernels."""
    from mss_tf_locoformer_tpu_torch.core.config import ModelConfig
    return ModelConfig(
        n_fft=4096, hop_length=1024, n_sources=4, n_layers=12, emb_dim=256,
        norm_type="rmsgroupnorm", num_groups=8, tf_order="ft", n_heads=16,
        flash_attention=True, fused_ffn=True, fused_stft=True,
        attention_dim=256, pos_enc="rope",
        ffn_type=("swiglu_conv1d", "swiglu_conv1d"), ffn_hidden_dim=(1024, 1024),
        conv1d_kernel=4, conv1d_shift=1, dropout=0.1, eps=1.0e-5)


def bs_model_config():
    """The model section of ``configs/musdb18_bslocoformer.yaml``: C 128, 4
    heads of 32, one FFN of 384 per path, 62 bands at n_fft 2048, stereo,
    masking; the fused steps' gates admit every step."""
    from mss_tf_locoformer_tpu_torch.core.config import BSModelConfig
    return BSModelConfig(
        name="bslocoformer", n_fft=2048, hop_length=512, stft_size=2048,
        sample_rate=44100, masking=True, stereo=True, n_sources=4, n_layers=6,
        emb_dim=128, norm_type="rmsgroupnorm", num_groups=4, tf_order="ft",
        n_heads=4, flash_attention=True, fused_ffn=True, attention_dim=128,
        pos_enc="rope", ffn_type="swiglu_conv1d", ffn_hidden_dim=384,
        conv1d_kernel=4, conv1d_shift=1, dropout=0.1, eps=1.0e-5)


def _plain_config(cfg):
    import dataclasses
    return dataclasses.replace(cfg, fused_stft=False, fused_ffn=False,
                               flash_attention=False)


def _time_ms(fn, iters: int = 10) -> float:
    """Mean milliseconds per call on the current stream (CUDA events)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


SPIN_CYCLES = 50_000_000   # ~25 ms of the card's clock


def _device_ms(fn, iters: int = 20) -> float:
    """Mean device milliseconds per call, for calls shorter than their host
    side (wrapper, ctypes, the library's own dispatch): the calls queue
    behind a spin kernel while the host enqueues them, so the events time
    the device's work alone, back to back.  Raises when the spin ended
    before the host had queued every call: a call that waits on the device
    (``torch.istft`` checks its window envelope with ``.item()``) drains
    the queue, and its host time would be counted."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    if start.query():
        raise RuntimeError("_device_ms: the spin ended before the calls were queued "
                           "(a call synchronises, or the host took longer than the spin)")
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_and_host_ms(**fns) -> dict:
    """For each ``name_ms=fn``: ``name_ms``, the device time per call
    (:func:`_device_ms`), and ``name_host_ms``, the time per call with the
    host's included (:func:`_time_ms`, CUDA events around 20 calls), the
    yardstick of every other kernel's times."""
    out = {}
    for name, fn in fns.items():
        out[name] = _device_ms(fn)
        out[name[:-2] + "host_ms"] = _time_ms(fn, iters=20)
    return out


def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: chip_smoke.py needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    print(f"[device] {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi)
    return name, smi


def phase_build():
    from mss_tf_locoformer_tpu_torch.ops import cuda as kernels
    seconds = kernels.build_all()
    print(f"[build] {len(kernels.SOURCES)} kernel libraries in {seconds:.2f} s")
    for name, log in kernels.BUILD_LOG.items():
        for line in log.splitlines():
            if "Used" in line and "registers" in line:
                print(f"[build] {name}: {line.split(':', 1)[1].strip()}")


def phase_gates():
    """The route the step gates give the base, xlarge and BS-Locoformer
    configs (shapes only, the same answer on the CPU): the fused steps for
    base and BS-Locoformer, the unfused route for xlarge, in eval and in
    training."""
    from mss_tf_locoformer_tpu_torch.ops.cuda import SMEM_OPTIN
    from mss_tf_locoformer_tpu_torch.ops.cuda import attention_block as AB
    from mss_tf_locoformer_tpu_torch.ops.cuda import swiglu_block as FB
    for name, cfg, fused in (("base", base_model_config(), True),
                             ("xlarge", xlarge_model_config(), False),
                             ("bs", bs_model_config(), True)):
        c, a, h, k = cfg.emb_dim, cfg.attention_dim, cfg.n_heads, cfg.conv1d_kernel
        for training in (False, True):
            routes = ([FB.supports_step(c, i, k, training) for i in _inner_dims(cfg)]
                      + [AB.supports_block(c, a, h, training)])
            print(f"[gates] {name} (C {c}, H {h}), {'training' if training else 'eval'}: "
                  f"FFN step {FB.step_bytes(c, k, training)} B, attention step "
                  f"{max(AB.launch_bytes(c, a, h, training).values())} B of {SMEM_OPTIN}: "
                  f"fused steps {routes}")
            if routes != [fused] * len(routes):
                raise AssertionError(f"gates: {name} should take the "
                                     f"{'fused' if fused else 'unfused'} route")
    # the unfused route's attention: which flash kernels each path's shape
    # takes (resident K/V forward; one-pass resident backward)
    from mss_tf_locoformer_tpu_torch.ops.cuda import flash_attention as FA
    want = {("xlarge", "freq"): (True, False), ("xlarge", "time"): (True, False),
            ("small", "freq"): (True, True), ("small", "time"): (True, True)}
    for name, path, _, _, seq, d, _, _ in _unfused_train_shapes():
        got = (FA.forward_resident(seq, d), FA.backward_resident(seq, d))
        print(f"[gates] flash attention {name} {path} (L {seq}, D {d}): forward "
              f"{'resident' if got[0] else 'streaming'} "
              f"({FA.forward_resident_bytes(seq, d)} B), backward "
              f"{'resident' if got[1] else 'streaming'} "
              f"({FA.backward_resident_bytes(seq, d)} B) of {SMEM_OPTIN}")
        if (name, path) in want and got != want[name, path]:
            raise AssertionError(f"gates: flash attention {name} {path} should be "
                                 f"{want[name, path]}")
    for seq in (2049, 345):   # xlarge serving
        if not FA.forward_resident(seq, 16):
            raise AssertionError(f"gates: the xlarge serving forward at L {seq} should be "
                                 f"resident")
    # the unfused route's FFN cores: the Hopper kernels (wgmma) at C 128 and
    # 256, the mma.sync kernels at the other widths; #9's row groups
    from mss_tf_locoformer_tpu_torch.ops.cuda import swiglu_ffn as SF
    for name, path, rows, _, seq, _, c, inner in _unfused_train_shapes():
        k = 4
        lin = seq + 2 * (k - 1)
        if SF.hopper_route(c):
            plan = SF.wg_backward_plan(rows, lin, c, inner, k)
            what = (f"Hopper kernels: forward ffn_core_wg_kernel ({SF.core_bytes(c)} B), "
                    f"backward ffn_bwd_dx_wg_kernel + ffn_wgrad_gemm_kernel "
                    f"({SF.backward_bytes(c, k)}), {plan['groups']} row groups of "
                    f"{plan['rows']}, {plan['splits']} splits, scratch "
                    f"{plan['scratch_bytes'] / 2**20:.1f} MiB of "
                    f"{SF.SCRATCH_CAP / 2**20:.0f}, partials "
                    f"{plan['partial_bytes'] / 2**20:.1f} MiB")
        else:
            what = (f"mma.sync kernels: forward ffn_core_kernel ({SF.core_bytes(c)} B), "
                    f"backward ffn_core_bwd_dx_kernel + ffn_core_bwd_w_kernel "
                    f"({SF.backward_bytes(c, k)})")
        print(f"[gates] FFN core {name} {path} [{rows}, {lin}, {c}], I {inner}: {what}")
        if SF.hopper_route(c) != (name == "xlarge"):
            raise AssertionError(f"gates: the FFN core of {name} should take the "
                                 f"{'Hopper' if name == 'xlarge' else 'mma.sync'} kernels")


def _rand(gen, shape, scale=1.0):
    import torch
    return torch.randn(*shape, generator=gen) * scale


def _uniform(gen, shape, bound):
    import torch
    return (torch.rand(*shape, generator=gen) * 2 - 1) * bound


def _compare(name, got, ref, tol_rel, null=None):
    """max |got - ref| against ``tol_rel * max|ref|``.  ``null`` is an output
    the check must reject (the residual input alone), so that a kernel that
    skipped its work cannot pass."""
    import torch
    got, ref = got.to(torch.complex64 if got.is_complex() else torch.float32), \
        ref.to(torch.complex64 if ref.is_complex() else torch.float32)
    if got.shape != ref.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(ref.shape)}")
    if not torch.isfinite(torch.view_as_real(got) if got.is_complex() else got).all():
        raise AssertionError(f"{name}: non-finite output")
    scale = ref.abs().max().item()
    err = (got - ref).abs().max().item()
    tol = tol_rel * scale
    line = (f"[kernels] {name}: max_abs_err {err:.3e} rel {err / scale:.3e} "
            f"(tol {tol:.3e} = {tol_rel:g} x max|ref| {scale:.3f})")
    if null is not None:
        null_err = (null.to(torch.float32) - ref).abs().max().item()
        line += f"; residual alone is off by {null_err:.3e}"
        if null_err <= 2 * tol:
            raise AssertionError(f"{name}: check cannot tell the kernel from "
                                 f"the residual alone")
    print(line)
    if not err <= tol:
        raise AssertionError(f"{name}: error {err:.3e} above tolerance {tol:.3e}")
    return err


# Tolerances, relative to max|plain output|:
#  * STFT: both sides fp32 FFTs, by different butterflies; measured ~3e-7
#    relative, so 1e-4 leaves room and still catches any wrong bin or frame
#    (those are O(1) relative).
#  * FFN and attention steps: bf16 rows; the kernel and the plain version
#    round at different places (the kernel keeps the conv output, the
#    softmax and the residual sum in fp32 and rounds once; the plain version
#    rounds each torch op's bf16 result), so they differ by about one bf16
#    step of the output (2^-8 relative, 0.4%); 2e-2 is five such steps.
STFT_TOL, STEP_TOL = 1e-4, 2e-2
BATCH = 2          # chunks per engine batch (the CLI's --batch_size default)
CHUNK = 8 * SR     # samples per chunk (--chunk_seconds 8)


def _main_path_steps(cfg):
    """(path, rows, sequence) of the FFN and attention steps in one engine
    batch: the freq path attends over bins on rows B*T, the time path over
    frames on rows B*F."""
    n_frames = 1 + CHUNK // cfg.hop_length
    return (("freq", BATCH * n_frames, cfg.n_freqs),
            ("time", BATCH * cfg.n_freqs, n_frames))


def _step_inputs(gen, rows, seq, device, c=96):
    import torch
    inner, k = 384, 4
    x = _rand(gen, (rows, seq, c), 0.5).to(device, torch.bfloat16)
    gamma = (1.0 + _rand(gen, (c,), 0.1)).to(device)
    ffn = (_uniform(gen, (2 * inner, c, k), (c * k) ** -0.5),
           _uniform(gen, (2 * inner,), (c * k) ** -0.5),
           _uniform(gen, (inner, c, k), (c * k) ** -0.5),
           _uniform(gen, (c,), (c * k) ** -0.5))
    # QKV weights at twice torch's init scale: a peaked softmax and an
    # attention output larger than the residual, so a wrong softmax shows
    attn = (_uniform(gen, (3 * c, c), 2 * c ** -0.5),
            _uniform(gen, (c, c), c ** -0.5))
    return x, gamma, [w.to(device) for w in ffn], [w.to(device) for w in attn]


def phase_kernels(results):
    import torch
    from mss_tf_locoformer_tpu_torch.ops.cuda import attention_block as AB
    from mss_tf_locoformer_tpu_torch.ops.cuda import swiglu_block as FB
    cfg = base_model_config()
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(SEED)

    _stft_case(results, "base", _rand(gen, (BATCH, CHUNK), 0.1).to(dev), cfg.n_fft,
               cfg.hop_length)

    for path, rows, seq in _main_path_steps(cfg):
        x, gamma, ffn, attn = _step_inputs(gen, rows, seq, dev)
        args = (cfg.conv1d_kernel, cfg.num_groups, cfg.eps)
        got = FB.fused_norm_ffn_residual(x, gamma, *ffn, *args)
        torch.cuda.synchronize()
        ref = FB.reference_norm_ffn_residual(x, gamma, *ffn, *args)
        err = _compare(f"ffn_step {path} [{rows}, {seq}, 96]", got, ref, STEP_TOL, null=x)
        r = results.setdefault("ffn_step", dict(err=0.0))
        r["err"] = max(r["err"], err)
        r[path] = (rows, _time_ms(lambda: FB.fused_norm_ffn_residual(x, gamma, *ffn, *args)),
                   _time_ms(lambda: FB.reference_norm_ffn_residual(x, gamma, *ffn, *args)))

        aargs = (cfg.n_heads, cfg.num_groups, cfg.eps)
        got = AB.fused_attention_block(x, gamma, *attn, *aargs)
        torch.cuda.synchronize()
        del ref
        ref = AB.reference_attention_block(x, gamma, *attn, *aargs)
        err = _compare(f"attention_step {path} [{rows}, {seq}, 96]", got, ref,
                       STEP_TOL, null=x)
        r = results.setdefault("attention_step", dict(err=0.0))
        r["err"] = max(r["err"], err)
        r[path] = (rows, _time_ms(lambda: AB.fused_attention_block(x, gamma, *attn, *aargs)),
                   _time_ms(lambda: AB.reference_attention_block(x, gamma, *attn, *aargs),
                            iters=3))
        del x, ffn, attn, got, ref
        torch.cuda.empty_cache()


# Slice parity bound: per-stem relative L2 error between the kernel path and
# the plain path through the whole bf16 model (bf16 rounding taken at
# different places in every block).  Measured ~1e-2 at the base config's 4
# layers; the xlarge config's 12 layers may add up to ~3x that, so one bound
# of 5e-2 serves both.  The model with its blocks skipped must miss it.
SLICE_REL_L2 = 5e-2


def _mix_shape(cfg, batch, samples):
    """A mixture batch's shape: ``[B, 2, T]`` for a stereo model, else ``[B, T]``."""
    return (batch, 2, samples) if getattr(cfg, "stereo", False) else (batch, samples)


def _model_pair(cfg=None):
    """The bf16 model (the base config by default) on the card twice, on the
    same seeded weights: with its kernels, and with every kernel replaced by
    its plain version."""
    import torch
    from mss_tf_locoformer_tpu_torch.core.precision import BF16
    from mss_tf_locoformer_tpu_torch.models import build_model
    cfg = cfg or base_model_config()
    dev = torch.device("cuda", 0)
    fused = build_model(cfg, BF16, torch.Generator().manual_seed(SEED)).to(dev).eval()
    plain = build_model(_plain_config(cfg), BF16).to(dev).eval()
    plain.load_state_dict(fused.state_dict(), strict=True)
    return fused, plain


def phase_slice_parity(cfg=None, need=None):
    """Kernel path against plain path on 1 s of audio (batch 1), per stem;
    the plain model with its blocks skipped must miss the bound.  With
    ``need``, the kernel path's launches in that one forward must be exactly
    ``need`` (counters not named: 0)."""
    import torch
    fused, plain = _model_pair(cfg)
    cfg = fused.config
    gen = torch.Generator().manual_seed(SEED + 1)
    shape = _mix_shape(cfg, 1, SR)
    mix = _rand(gen, shape, 0.1).to("cuda")
    counters = _counters()
    with torch.inference_mode():
        for fn in counters.values():
            fn.launches = 0
        a = fused(mix)
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in counters.items()}
        b = plain(mix)
        blocks, plain.blocks = plain.blocks, torch.nn.ModuleList()
        skipped = plain(mix)
        plain.blocks = blocks
    if need is not None:
        _check_launches(f"parity {cfg.name}", launches, need)
    worst, least_skip = 0.0, float("inf")
    for name in a:
        if a[name].shape != shape or not torch.isfinite(a[name]).all():
            raise AssertionError(f"slice parity: stem {name} is not finite {list(shape)}")
        rel = ((a[name] - b[name]).norm() / b[name].norm()).item()
        skip = ((skipped[name] - b[name]).norm() / b[name].norm()).item()
        worst, least_skip = max(worst, rel), min(least_skip, skip)
        print(f"[parity] {cfg.name} {name}: relative L2 {rel:.3e} (bound {SLICE_REL_L2:g}); "
              f"blocks skipped {skip:.3e}")
    if not worst <= SLICE_REL_L2:
        raise AssertionError(f"slice parity: relative L2 {worst:.3e} above {SLICE_REL_L2:g}")
    if not least_skip > SLICE_REL_L2:
        raise AssertionError("slice parity: the check cannot tell the model from the "
                             "model with its blocks skipped")
    del fused, plain
    torch.cuda.empty_cache()
    return worst, least_skip


def phase_slice(workdir, cfg=None):
    """The separation CLI on a 20 s stereo WAV with a seeded random-init
    checkpoint of ``cfg`` (the base config by default): the launch counts of
    the first run, then the wall time of a second.  A stereo model's stems
    must be true stereo (channels not equal)."""
    import dataclasses

    import numpy as np
    import torch
    from mss_tf_locoformer_tpu_torch.cli import separate as cli
    from mss_tf_locoformer_tpu_torch.models import build_model
    from mss_tf_locoformer_tpu_torch.utils.audio import load_audio, save_audio
    cfg = cfg or base_model_config()
    model = build_model(cfg, generator=torch.Generator().manual_seed(SEED))
    ckpt = os.path.join(workdir, "model_random.pth")
    torch.save(model.state_dict(), ckpt)
    del model
    cfg_path = os.path.join(workdir, "model.json")
    with open(cfg_path, "w") as f:
        json.dump({"model": dataclasses.asdict(cfg)}, f)
    seconds = 20
    rng = np.random.default_rng(SEED)
    t = np.arange(seconds * SR) / SR
    left = 0.3 * np.sin(2 * np.pi * 220 * t) + 0.05 * rng.standard_normal(t.size)
    right = 0.3 * np.sin(2 * np.pi * 330 * t) + 0.05 * rng.standard_normal(t.size)
    wav = os.path.join(workdir, "mix.wav")
    save_audio(wav, np.stack([left, right]).astype(np.float32), SR, normalize=True)
    out_dir = os.path.join(workdir, "stems")
    argv = ["--input", wav, "--output_dir", out_dir, "--checkpoint", ckpt,
            "--config", cfg_path, "--device", "cuda", "--batch_size", str(BATCH)]

    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    cli.main(argv)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    for stem in ("vocals", "drums", "bass", "other"):
        path = os.path.join(out_dir, f"mix_{stem}.wav")
        audio, sr = load_audio(path)
        if audio.shape != (2, seconds * SR) or sr != SR or not np.isfinite(audio).all():
            raise AssertionError(f"{path}: got {audio.shape} at {sr} Hz")
        stereo = not np.array_equal(audio[0], audio[1])
        if stereo != getattr(cfg, "stereo", False):
            raise AssertionError(f"{path}: stereo stem {stereo}, stereo model "
                                 f"{getattr(cfg, 'stereo', False)}")
        print(f"[slice] {path}: {audio.shape[0]} x {audio.shape[1]} at {sr} Hz, "
              f"peak {np.abs(audio).max():.3f}, {'stereo' if stereo else 'mono duplicated'}")

    t0 = time.perf_counter()
    cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return launches, wall, seconds


def _check_launches(tag, launches, need):
    """Launch counts of a run against the exact counts ``need`` (every
    counter not named must be 0)."""
    for name, got in launches.items():
        want = need.get(name, 0)
        print(f"[{tag}] {name}: {got} launches (need {want})")
        if got != want:
            raise AssertionError(f"{tag}: {name} launched {got} times, not {want}")


def phase_forward(cfg=None, reps: int = 3):
    """One model forward of an engine batch, kernel path against plain path
    on the same weights: a warm-up forward of each (its peak device memory
    kept), then ``reps`` forwards per turn in the order plain, kernel,
    kernel, plain, host clock around synchronised forwards.  Returns
    ``{path: (mean ms per forward, peak bytes)}``."""
    import torch
    models = dict(zip(("kernel", "plain"), _model_pair(cfg)))
    mix = _rand(torch.Generator().manual_seed(SEED + 2),
                _mix_shape(models["kernel"].config, BATCH, CHUNK), 0.1).to("cuda")
    peak, times = {}, {"kernel": [], "plain": []}
    with torch.inference_mode():
        for path, model in models.items():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            model(mix)
            torch.cuda.synchronize()
            peak[path] = torch.cuda.max_memory_allocated()
        for path in ("plain", "kernel", "kernel", "plain"):
            t0 = time.perf_counter()
            for _ in range(reps):
                models[path](mix)
            torch.cuda.synchronize()
            times[path].append((time.perf_counter() - t0) / reps)
    del models, mix
    torch.cuda.empty_cache()
    return {path: (1e3 * sum(t) / len(t), peak[path]) for path, t in times.items()}


def phase_profile(cfg=None, top: int = 8):
    """Where one engine-batch forward of the kernel path spends the device's
    time: ``torch.profiler`` over one forward after a warm-up, the self
    device time of each kernel (and copy) by name, and their sum over the
    forward's wall time (the device's busy share).  Returns ``(busy share,
    [(name, ms, share of device time), ...])``, or None when the profiler
    saw no device activity.  The last row sums the library's matrix
    products (cuBLAS/cuDNN, by kernel name): on the xlarge path the QKV and
    out-projection products run there, around #6."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from mss_tf_locoformer_tpu_torch.core.precision import BF16
    from mss_tf_locoformer_tpu_torch.models import build_model
    cfg = cfg or base_model_config()
    model = build_model(cfg, BF16, torch.Generator().manual_seed(SEED)).to("cuda").eval()
    mix = _rand(torch.Generator().manual_seed(SEED + 2), _mix_shape(cfg, BATCH, CHUNK),
                0.1).to("cuda")
    with torch.inference_mode():
        model(mix)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model(mix)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    del model, mix
    torch.cuda.empty_cache()

    def gemm(_, device):
        return "all library matrix products (cuBLAS/cuDNN)", sum(
            ms for name, ms in device
            if any(tag in name.lower() for tag in ("gemm", "nvjet", "xmma", "cutlass")))

    return _profile_summary(prof, wall, top, gemm)


# names whose device-side entries are profiler ranges (spans), not kernels
_RANGES = ("plain_attention",)


def _profile_summary(prof, wall, top, last_row):
    """``(busy share, [(name, ms, share of device time), ...])`` of a
    ``torch.profiler`` run over ``wall`` seconds: the ``top`` kernels by self
    device time, then ``last_row(prof, [(kernel, ms), ...])``'s ``(label,
    ms)``; None when the profiler saw no device activity."""
    from torch.autograd import DeviceType
    device = [(e.key, e.self_device_time_total / 1e3) for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
              and e.key not in _RANGES]
    total = sum(ms for _, ms in device)
    if not total:
        print("[profile] the profiler saw no device activity")
        return None
    device.sort(key=lambda kv: -kv[1])
    short = lambda name: name.replace("void ", "").replace("(anonymous namespace)::", "")[:60]
    rows = [(short(name), ms, ms / total) for name, ms in device[:top]]
    label, ms = last_row(prof, device)
    rows.append((label, ms, ms / total))
    return total / (1e3 * wall), rows


# ------------------------------------------------------------ xlarge


def flash_work(r, h, l, d):
    """(FLOP, bytes, exponentials) of one flash-attention call: QK^T and PV
    at the true head_dim; q, k and v read and o written once, bf16; one
    exponential per score."""
    return 4.0 * r * h * l * l * d, 4 * r * h * l * d * 2.0, float(r * h * l * l)


def ffn_core_work(r, l, c, inner, k):
    """(FLOP, bytes) of one FFN-core call on rows padded to L + 2(k-1): both
    products over the L + k - 1 conv positions; x read and the output
    written once (bf16), the bf16 weight panels and fp32 biases once."""
    lin, l1 = l + 2 * (k - 1), l + k - 1
    return (6.0 * r * l1 * k * c * inner,
            2 * r * lin * c * 2.0 + 3 * inner * c * k * 2.0 + (2 * inner + c) * 4.0)


def phase_xlarge_kernels(results):
    """The flash-attention (#6) and FFN-core (#8) kernels against their plain
    versions at the xlarge engine batch's freq and time shapes, and timed
    beside their bounds (and, for #6, ``scaled_dot_product_attention`` on the
    pre-rotated q and k)."""
    import torch
    import torch.nn.functional as F
    from mss_tf_locoformer_tpu_torch.ops.cuda import flash_attention as FA
    from mss_tf_locoformer_tpu_torch.ops.cuda import swiglu_ffn as SF
    from mss_tf_locoformer_tpu_torch.ops.rope import apply_rope
    cfg = xlarge_model_config()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    c, h, k = cfg.emb_dim, cfg.n_heads, cfg.conv1d_kernel
    d, inner = cfg.attention_dim // h, cfg.ffn_hidden_dim[0]
    for path, rows, seq in _main_path_steps(cfg):
        # #6 on the views of a QKV product [R, L, 3, H, D], as the MHSA hands
        # them over; q and k at 1.5x unit scale give a peaked softmax, so the
        # uniform-attention output (the null) is far from the right one
        qkv = (1.5 * torch.randn(rows, seq, 3, h, d, generator=gen, device=dev)).to(
            torch.bfloat16)
        q, kk, v = qkv.permute(2, 0, 3, 1, 4)
        got = FA.flash_attention(q, kk, v, True)
        torch.cuda.synchronize()
        n, err = (8 if path == "freq" else 64), 0.0
        for r0 in (0, rows - n):
            sl = slice(r0, r0 + n)
            ref = FA.reference_flash_attention(q[sl], kk[sl], v[sl], True)
            null = v[sl].float().mean(-2, keepdim=True).expand(ref.shape)
            err = max(err, _compare(
                f"flash_attention {path} rows {r0}..{r0 + n} of [{rows}, {h}, {seq}, {d}]",
                got[sl], ref, STEP_TOL, null=null))
        del got, ref, null
        ms = _time_ms(lambda: FA.flash_attention(q, kk, v, True), iters=3)
        plain_ms = _time_ms(lambda: FA.reference_flash_attention(q, kk, v, True), iters=1)
        qr, kr = apply_rope(q), apply_rope(kk)
        library_ms = _time_ms(lambda: F.scaled_dot_product_attention(qr, kr, v), iters=3)
        r = results.setdefault("flash_attention", dict(err=0.0))
        r["err"] = max(r["err"], err)
        r[path] = dict(shape=(rows, h, seq, d), ms=ms, plain_ms=plain_ms,
                       library_ms=library_ms, bound=_bound(*flash_work(rows, h, seq, d)))
        del qkv, q, kk, v, qr, kr
        torch.cuda.empty_cache()

        # #8 on rows pre-padded by k-1 zeros each side
        lin = seq + 2 * (k - 1)
        x = torch.zeros(rows, lin, c, dtype=torch.bfloat16, device=dev)
        x[:, k - 1:k - 1 + seq] = torch.randn(rows, seq, c, generator=gen, device=dev)
        b = (c * k) ** -0.5
        w = [(torch.rand(*s, generator=gen, device=dev) * 2 - 1) * b
             for s in ((2 * inner, c, k), (2 * inner,), (inner, c, k), (c,))]
        got = SF.swiglu_conv_deconv(x, *w, k)
        torch.cuda.synchronize()
        ref = SF.reference_swiglu_conv_deconv(x, *w, k)
        err = _compare(f"swiglu_ffn {path} [{rows}, {lin}, {c}], I {inner}", got, ref,
                       STEP_TOL, null=torch.zeros_like(ref) + w[3])
        del got, ref
        r0 = rows // 2
        xs = x[r0:r0 + 16].contiguous()
        got = SF.swiglu_conv_deconv(xs, *w, k, 0.1, 777, r0)
        ref = SF.reference_swiglu_conv_deconv(xs, *w, k, 0.1, 777, r0)
        _compare(f"swiglu_ffn {path} rows {r0}..{r0 + 16}, dropout 0.1", got, ref, STEP_TOL,
                 null=SF.reference_swiglu_conv_deconv(xs, *w, k))
        del got, ref
        torch.cuda.empty_cache()
        ms = _time_ms(lambda: SF.swiglu_conv_deconv(x, *w, k), iters=3)
        per_kernel = _kernel_device_ms(lambda: SF.swiglu_conv_deconv(x, *w, k), "ffn_")
        plain_ms = _time_ms(lambda: SF.reference_swiglu_conv_deconv(x, *w, k), iters=2)
        r = results.setdefault("swiglu_ffn", dict(err=0.0))
        r["err"] = max(r["err"], err)
        r[path] = dict(shape=(rows, lin, c), ms=ms, plain_ms=plain_ms, library_ms=None,
                       bound=_bound(*ffn_core_work(rows, seq, c, inner, k)),
                       kernels=per_kernel)
        del x, w
        torch.cuda.empty_cache()


# ------------------------------------------------------------ training

# H100 SXM peaks (NVIDIA's data sheet, dense), for the bounds of the
# kernels: bf16 tensor cores, fp32 outside them, device memory.
PEAK_BF16, PEAK_FP32, HBM_RATE = 989e12, 67e12, 3.35e12
# Exponentials on the special-function units: 16 per SM per clock x 132 SMs
# x 1.83 GHz, "989 TFLOPS of FP16 matmul but only 3.9 TFLOPS of special
# functions" (FlashAttention-3, Shah et al. 2024, section 1).  A softmax
# needs one per score, so at small head_dim they, not the products, bound it.
SFU_RATE = 3.9e12
SEGMENT = 132300     # 3 s training segments (configs/musdb18.yaml)
TRAIN_MB = 2         # micro-batch of the base config (batch 8 = 4 x 2)
# Gradient bounds.  Weight and gamma gradients are sums over ~5e5
# positions whose summands the kernels take from bf16-rounded operands (xn,
# the SwiGLU output, dy, P, dS, as the TPU kernels do); the rounding errors
# are independent, so the sums' relative L2 error stays near the bf16 step
# (2^-9) and 2e-2 leaves a factor of ~10.  The train step's gradients
# (kernel path against plain path, both bf16, rounding at different places
# through 4 blocks forward and back) get 1e-1, the loss 2e-2.
GRAD_REL_L2, STEP_GRAD_REL_L2, STEP_LOSS_REL = 2e-2, 1e-1, 2e-2


def _bound(flop: float, nbytes: float, exps: float = 0.0, peak: float = PEAK_BF16):
    """(least ms, what bounds it) for ``flop`` at ``peak``, ``nbytes`` moved
    once at the device memory rate and ``exps`` exponentials at the
    special-function rate: "operations", "bytes" or "exponentials"."""
    terms = {"operations": flop / peak, "bytes": nbytes / HBM_RATE,
             "exponentials": exps / SFU_RATE}
    by = max(terms, key=terms.get)
    return 1e3 * terms[by], by


def ffn_work(r, l, c=96, inner=384, k=4):
    """(forward FLOP, forward bytes, backward FLOP, backward bytes) of one
    FFN step: the conv has L+k-1 outputs, the cropped deconv L; the
    backward recomputes the conv and takes both products' two adjoints."""
    conv = 2.0 * r * (l + k - 1) * k * c * 2 * inner
    deconv = 2.0 * r * l * k * inner * c
    w = (3 * inner * c * k + 2 * inner + c) * 4.0
    rows = r * l * c * 2.0
    return conv + deconv, 2 * rows + w, 3 * conv + 2 * deconv, 3 * rows + 2 * w


def attn_work(r, l, c=96, a=96, h=4):
    """(forward FLOP, forward bytes, backward FLOP, backward bytes,
    exponentials) of one attention step at the true head_dim: QK^T and PV
    forward; dP, dS K, dS^T Q and P^T dO backward; the projections'
    products; the backward reads the stashed q, k, v, o and log-sum-exp;
    one exponential per score each way (the backward recomputes P)."""
    d = a // h
    core = 2.0 * 2 * r * h * l * l * d
    proj = 2.0 * r * l * c * 3 * a + 2.0 * r * l * a * c
    w = 4.0 * a * c * 4
    rows = r * l * c * 2.0
    stash = r * l * (4 * a * 2.0 + 4 * h)
    return (core + proj, 2 * rows + w, 2 * core + 2 * proj, 3 * rows + stash + 2 * w,
            float(r * h * l * l))


def _train_steps(cfg):
    """(path, rows, sequence) of the steps in one training micro-batch."""
    n_frames = 1 + SEGMENT // cfg.hop_length
    return (("freq", TRAIN_MB * n_frames, cfg.n_freqs),
            ("time", TRAIN_MB * cfg.n_freqs, n_frames))


def _rel_l2(got, ref) -> float:
    ref = ref.float()
    return ((got.float() - ref).norm() / ref.norm()).item()


def _check_grads(name, got, ref, g):
    """dx against ``STEP_TOL x max|ref|`` (the cotangent alone, what a
    kernel that only passed the residual through would give, must fail);
    the other gradients by relative L2 (an all-zero gradient gives 1.0)."""
    dx_err = _compare(f"{name} dx", got[0], ref[0], STEP_TOL, null=g)
    worst = 0.0
    for i, (a, b) in enumerate(zip(got[1:], ref[1:]), 1):
        if not torch_isfinite(a):
            raise AssertionError(f"{name}: gradient {i} is not finite")
        rel = _rel_l2(a, b)
        worst = max(worst, rel)
        if not rel <= GRAD_REL_L2:
            raise AssertionError(f"{name}: gradient {i} relative L2 {rel:.3e} "
                                 f"above {GRAD_REL_L2:g}")
    print(f"[train-kernels] {name}: weight/gamma gradients relative L2 <= "
          f"{worst:.3e} (bound {GRAD_REL_L2:g})")
    return dx_err, worst


def torch_isfinite(t) -> bool:
    import torch
    return bool(torch.isfinite(t).all())


def _autograd(fn, x, params, g):
    """``(out, grads)`` of ``fn(x, *params)`` for the cotangent ``g``."""
    import torch
    x = x.detach().requires_grad_(True)
    ps = [p.detach().requires_grad_(True) for p in params]
    out = fn(x, *ps)
    return out, torch.autograd.grad(out, [x, *ps], g)


def _timed_grad(fn, x, params, g, iters=5):
    """(forward ms, backward ms) of ``fn`` with autograd."""
    import torch
    x = x.detach().requires_grad_(True)
    ps = [p.detach().requires_grad_(True) for p in params]
    fwd = _time_ms(lambda: fn(x, *ps), iters)
    out = fn(x, *ps)
    bwd = _time_ms(lambda: torch.autograd.grad(out, [x, *ps], g, retain_graph=True), iters)
    return fwd, bwd


def phase_train_kernels(results):
    """Forward (training stash) and backward of both steps at the training
    path's full rows against their plain versions (fp32 autograd on the
    same bf16 inputs) at dropout 0, and at dropout 0.1 on a 16-row slice
    (row offset passed, so the masks are those rows' masks of a full call)."""
    import torch
    from mss_tf_locoformer_tpu_torch.ops.cuda import attention_block as AB
    from mss_tf_locoformer_tpu_torch.ops.cuda import swiglu_block as FB
    cfg = base_model_config()
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(SEED + 3)
    fargs = (cfg.conv1d_kernel, cfg.num_groups, cfg.eps)
    aargs = (cfg.n_heads, cfg.num_groups, cfg.eps, True, 10000.0)
    for path, rows, seq in _train_steps(cfg):
        x, gamma, ffn, attn = _step_inputs(gen, rows, seq, dev)
        g = _rand(gen, (rows, seq, 96)).to(dev, torch.bfloat16)
        for name, kfn, pfn, params, work in (
                ("ffn_step", FB.fused_norm_ffn_residual, FB.reference_norm_ffn_residual,
                 [gamma, *ffn], lambda: ffn_work(rows, seq)),
                ("attention_step", AB.fused_attention_block, AB.reference_attention_block,
                 [gamma, *attn], lambda: attn_work(rows, seq))):
            args = fargs if name == "ffn_step" else aargs
            out, got = _autograd(lambda *a: kfn(*a, *args), x, params, g)
            torch.cuda.synchronize()
            ref_out, ref = _autograd(lambda *a: pfn(*a, *args), x.float(), params, g.float())
            label = f"{name} {path} [{rows}, {seq}, 96]"
            _compare(f"{label} forward (training)", out, ref_out, STEP_TOL, null=x)
            gerr, grel = _check_grads(f"{label} backward", got, ref, g)
            del out, got, ref_out, ref
            torch.cuda.empty_cache()

            r0 = rows // 2
            xs, gs = x[r0:r0 + 16].contiguous(), g[r0:r0 + 16].contiguous()
            dargs = args + (0.1, 777, r0)
            out, got = _autograd(lambda *a: kfn(*a, *dargs), xs, params, gs)
            torch.cuda.synchronize()
            ref_out, ref = _autograd(lambda *a: pfn(*a, *dargs), xs.float(), params, gs.float())
            _compare(f"{name} {path} rows {r0}..{r0 + 16}, dropout 0.1 forward", out, ref_out,
                     STEP_TOL, null=xs)
            _check_grads(f"{name} {path} rows {r0}..{r0 + 16}, dropout 0.1", got, ref, gs)
            del out, got, ref_out, ref

            kf, kb = _timed_grad(lambda *a: kfn(*a, *args, 0.1, 777), x, params, g)
            pf, pb = _timed_grad(lambda *a: pfn(*a, *args, 0.1, 777), x, params, g, iters=1)
            fflop, fbytes, bflop, bbytes, exps = (*work(), 0.0)[:5]   # FFN: no exps
            r = results.setdefault(name + "_backward", dict(err=0.0, rel_l2=0.0))
            r["err"] = max(r["err"], gerr)
            r["rel_l2"] = max(r["rel_l2"], grel)
            r[path] = dict(rows=rows, seq=seq, fwd_ms=kf, ms=kb, plain_fwd_ms=pf, plain_ms=pb,
                           bound=_bound(bflop, bbytes, exps),
                           fwd_bound=_bound(fflop, fbytes, exps))
            torch.cuda.empty_cache()
        del x, g, ffn, attn
        torch.cuda.empty_cache()


def _write_musdb(root, n_train=16, n_test=2, seconds=4.0, seed=SEED):
    """A synthetic MUSDB18-HQ tree: stereo 44.1 kHz 16-bit WAV, 4 stems of
    tones and noise plus their mixture per track."""
    import numpy as np
    from mss_tf_locoformer_tpu_torch.data.audio_io import write
    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    t = np.arange(n) / SR
    for subset, count in (("train", n_train), ("test", n_test)):
        for i in range(count):
            d = os.path.join(root, subset, f"track{i:02d}")
            os.makedirs(d)
            stems = {}
            for j, stem in enumerate(("vocals", "drums", "bass", "other")):
                f = 110.0 * (j + 1) * (1 + 0.1 * rng.random())
                tone = 0.1 * np.sin(2 * np.pi * f * t)[:, None]
                stems[stem] = (tone + 0.02 * rng.standard_normal((n, 2))).astype(np.float32)
                write(os.path.join(d, f"{stem}.wav"), stems[stem], SR)
            write(os.path.join(d, "mixture.wav"), sum(stems.values()), SR)


def _train_config(root, epochs):
    """configs/musdb18.yaml's dataset, model, loss and training sections
    (one epoch = 2 optimizer steps on 16 tracks), as JSON-ready dicts."""
    import dataclasses
    return {"dataset": {"root_dir": root, "sample_rate": SR, "segment_length": SEGMENT,
                        "sources": ["vocals", "drums", "bass", "other"]},
            "model": dataclasses.asdict(base_model_config()),
            "loss": {"loss_type": "combined", "si_sdr_weight": 1.0, "l1_weight": 0.1,
                     "spectral_weight": 0.1, "eps": 1.0e-8},
            "training": {"batch_size": 8, "num_epochs": epochs, "gradient_clip": 5.0,
                         "num_workers": 4,
                         "optimizer": {"type": "adamw", "lr": 5e-4, "weight_decay": 0.01,
                                       "eps": 1e-8, "betas": [0.9, 0.999]},
                         "scheduler": {"type": "reducelronplateau", "mode": "min",
                                       "factor": 0.5, "patience": 8, "min_lr": 1e-7,
                                       "cooldown": 5},
                         "use_amp": True, "amp_dtype": "bfloat16",
                         "gradient_accumulation_steps": 4, "save_interval": 1,
                         "keep_last": 10, "save_best": True, "val_interval": 1,
                         "log_interval": 1},
            "mesh": {"dp": -1, "mp": 1}, "seed": 42}


def phase_train(workdir):
    """The training CLI on the card: one epoch, then ``--resume`` for one
    more; returns the training path's launch counts and step times."""
    import numpy as np
    import torch
    from mss_tf_locoformer_tpu_torch.cli import separate as sep_cli
    from mss_tf_locoformer_tpu_torch.cli import train as train_cli
    from mss_tf_locoformer_tpu_torch.core.precision import BF16
    from mss_tf_locoformer_tpu_torch.models import build_model
    from mss_tf_locoformer_tpu_torch.utils.audio import load_audio
    root = os.path.join(workdir, "musdb")
    _write_musdb(root)
    cfg_path = os.path.join(workdir, "train.json")
    out_dir = os.path.join(workdir, "exp")
    argv = ["--config", cfg_path, "--device", "cuda", "--output_dir", out_dir]
    counters = _counters()
    launches, wall = {}, {}
    for epochs, extra in ((1, []), (2, ["--resume", "latest"])):
        with open(cfg_path, "w") as f:
            json.dump(_train_config(root, epochs), f)
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        trainer = train_cli.main(argv + extra)
        torch.cuda.synchronize()
        wall[epochs] = time.perf_counter() - t0
        launches[epochs] = {k: fn.launches for k, fn in counters.items()}
        micro = 2 * 4   # one epoch: 2 optimizer steps of 4 micro-batches
        need = {"ffn_step": 16 * micro, "attention_step": 8 * micro,
                "ffn_step_backward": 16 * micro, "attention_step_backward": 8 * micro,
                "stft": micro}
        print(f"[train] epoch {epochs - 1}: {trainer.step} optimizer steps so far, "
              f"{micro} micro-batches this run, {wall[epochs]:.1f} s wall (build, "
              f"data, validation and checkpoint included)")
        for k, n in need.items():
            got = launches[epochs][k]
            print(f"[train] {k}: {got} launches (need >= {n})")
            if got < n:
                raise AssertionError(f"training launched {k} {got} times, fewer than {n}")
        if launches[epochs]["flash_attention"] or launches[epochs]["swiglu_ffn"]:
            raise AssertionError(f"base training left the fused steps: {launches[epochs]}")
    if trainer.step != 4 or trainer.start_epoch != 1:
        raise AssertionError(f"resume: step {trainer.step}, start epoch {trainer.start_epoch}")
    blob = torch.load(trainer.ckpt.path(1), map_location="cpu", weights_only=True)
    meta = blob["metadata"]
    for key in ("train_loss", "val_loss"):
        if not np.isfinite(meta[key]):
            raise AssertionError(f"checkpoint {key} {meta[key]} is not finite")
    init = build_model(base_model_config(), BF16, torch.Generator().manual_seed(42)).state_dict()
    for name, p in trainer.model.named_parameters():
        if p.grad is None or not torch.isfinite(p.grad).all():
            raise AssertionError(f"parameter {name}: gradient missing or not finite")
        if torch.equal(p.detach().cpu(), init[name]):
            raise AssertionError(f"parameter {name} did not change in training")
    n_params = sum(1 for _ in trainer.model.parameters())
    print(f"[train] losses: train {meta['train_loss']:.4f}, val {meta['val_loss']:.4f}; "
          f"all {n_params} parameters have finite gradients and changed")
    wav = os.path.join(workdir, "train_check.wav")
    from mss_tf_locoformer_tpu_torch.utils.audio import save_audio
    save_audio(wav, np.random.default_rng(SEED).standard_normal((2, 3 * SR)).astype(
        np.float32) * 0.1, SR)
    model_cfg = os.path.join(workdir, "model.json")
    with open(model_cfg, "w") as f:
        json.dump({"model": _train_config(root, 1)["model"]}, f)
    stems_dir = os.path.join(workdir, "train_stems")
    sep_cli.main(["--input", wav, "--output_dir", stems_dir, "--checkpoint",
                  trainer.ckpt.path(1), "--config", model_cfg, "--device", "cuda"])
    for stem in ("vocals", "drums", "bass", "other"):
        audio, _ = load_audio(os.path.join(stems_dir, f"train_check_{stem}.wav"))
        if audio.shape != (2, 3 * SR) or not np.isfinite(audio).all():
            raise AssertionError(f"trained checkpoint separated {stem} as {audio.shape}")
    print("[train] the trained checkpoint separates a WAV through the separation CLI")
    del trainer
    torch.cuda.empty_cache()
    return launches[1], wall


def _counters():
    from mss_tf_locoformer_tpu_torch.ops import dropout as D
    from mss_tf_locoformer_tpu_torch.ops.cuda import attention_block as AB
    from mss_tf_locoformer_tpu_torch.ops.cuda import flash_attention as FA
    from mss_tf_locoformer_tpu_torch.ops.cuda import stft_kernel as SK
    from mss_tf_locoformer_tpu_torch.ops.cuda import swiglu_block as FB
    from mss_tf_locoformer_tpu_torch.ops.cuda import swiglu_ffn as SF
    return {"stft": SK.stft_fused, "ffn_step": FB.fused_norm_ffn_residual,
            "attention_step": AB.fused_attention_block,
            "ffn_step_backward": FB.ffn_step_backward,
            "attention_step_backward": AB.attention_step_backward,
            "flash_attention": FA.flash_attention, "swiglu_ffn": SF.swiglu_conv_deconv,
            "flash_attention_backward": FA.flash_attention_backward,
            "swiglu_ffn_backward": SF.swiglu_ffn_backward, "dropout_mask": D.keep_mask,
            "istft": SK.istft_fused, "istft_overlap_add": SK.frames_to_audio}


def _train_models():
    """The bf16 base model twice on the same weights, kernel and plain, in
    training mode."""
    fused, plain = _model_pair()
    return fused.train(), plain.train()


def _batch(gen, b, n, dev):
    import torch
    stems = {s: _rand(gen, (b, n), 0.1).to(dev) for s in ("vocals", "drums", "bass", "other")}
    return sum(stems.values()), stems


def phase_train_parity():
    """One micro-batch (1 x 1 s, dropout 0.1) through the kernel path and the
    plain path with the same seeds: loss and every parameter's gradient."""
    import torch
    from mss_tf_locoformer_tpu_torch.core.config import LossConfig
    from mss_tf_locoformer_tpu_torch.losses.mss_loss import mss_loss
    fused, plain = _train_models()
    mix, tg = _batch(torch.Generator().manual_seed(SEED + 4), 1, SR, fused.deconv.weight.device)
    losses, grads = [], []
    for model in (fused, plain):
        model.zero_grad(set_to_none=True)
        loss = mss_loss(model(mix, generator=torch.Generator().manual_seed(9)), tg,
                        LossConfig())["total_loss"]
        loss.backward()
        losses.append(loss.item())
        grads.append({n: p.grad for n, p in model.named_parameters()})
    rel_loss = abs(losses[0] - losses[1]) / abs(losses[1])
    worst, worst_name = 0.0, ""
    for name, ref in grads[1].items():
        got = grads[0][name]
        if got is None or ref is None or not torch.isfinite(got).all():
            raise AssertionError(f"train-step parity: gradient of {name} missing or not finite")
        rel = _rel_l2(got, ref)
        if rel > worst:
            worst, worst_name = rel, name
    print(f"[train-parity] loss kernel {losses[0]:.5f} plain {losses[1]:.5f} (relative "
          f"{rel_loss:.2e}, bound {STEP_LOSS_REL:g}); worst gradient relative L2 "
          f"{worst:.3e} at {worst_name} (bound {STEP_GRAD_REL_L2:g})")
    if not (rel_loss <= STEP_LOSS_REL and worst <= STEP_GRAD_REL_L2):
        raise AssertionError("train-step parity outside its bounds")
    del fused, plain, grads
    torch.cuda.empty_cache()
    return rel_loss, worst


def phase_train_timing(reps: int = 1):
    """One optimizer step (AdamW, clip 5, dropout 0.1) on one micro-batch of
    2 x 3 s, kernel path against plain path, in turns (plain, kernel,
    kernel, plain), after a warm-up step of each (its peak device memory
    kept).  The plain attention keeps no scores for the backward (its 1 GiB
    groups are recomputed), so both paths fit at the same micro-batch."""
    import torch
    from mss_tf_locoformer_tpu_torch.core.config import LossConfig, TrainingConfig
    from mss_tf_locoformer_tpu_torch.train.state import make_optimizer
    from mss_tf_locoformer_tpu_torch.train.step import train_step
    models = dict(zip(("kernel", "plain"), _train_models()))
    dev = models["kernel"].deconv.weight.device
    batch = _batch(torch.Generator().manual_seed(SEED + 5), TRAIN_MB, SEGMENT, dev)
    opts = {p: make_optimizer(m.parameters(), TrainingConfig()) for p, m in models.items()}
    gens = {p: torch.Generator().manual_seed(11) for p in models}

    def step(path):
        mix, tg = batch
        train_step(models[path], opts[path], mix, tg, 5e-4, gens[path], LossConfig(),
                   accum=1, gradient_clip=5.0)

    peak, times = {}, {"kernel": [], "plain": []}
    for path in models:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step(path)
        torch.cuda.synchronize()
        peak[path] = torch.cuda.max_memory_allocated()
    for path in ("plain", "kernel", "kernel", "plain"):
        t0 = time.perf_counter()
        for _ in range(reps):
            step(path)
        torch.cuda.synchronize()
        times[path].append((time.perf_counter() - t0) / reps)
    out = {p: (sum(t) / len(t), peak[p], TRAIN_MB) for p, t in times.items()}
    del models, opts, batch
    torch.cuda.empty_cache()
    return out


# ------------------------------------------- training through the unfused route

SMALL_SEGMENT = 132300   # 3 s (configs/musdb18_small.yaml)
SMALL_BATCH = 16
XL_SEGMENT = 661500      # 15 s (configs/musdb18_xlarge.yaml)
# The xlarge train step's peak with #9 on the mma.sync kernels, which
# keep no scratch (NVIDIA H100 80GB HBM3, 700 W): the step fails if the
# Hopper kernels' scratch and partials raise it by more than their cap
XL_PEAK_GIB = 40.94


def small_model_config():
    """The model section of ``configs/musdb18_small.yaml``: C 48 (no fused-
    step width) and 4 heads of 12, so every step takes the unfused route;
    dropout 0, so attention runs through flash attention (#6, #7) in
    training too."""
    from mss_tf_locoformer_tpu_torch.core.config import ModelConfig
    return ModelConfig(
        n_fft=1024, hop_length=256, n_sources=4, n_layers=3, emb_dim=48,
        norm_type="rmsgroupnorm", num_groups=4, tf_order="ft", n_heads=4,
        flash_attention=True, fused_ffn=True, fused_stft=True, attention_dim=48,
        pos_enc="rope", ffn_type="swiglu_conv1d", ffn_hidden_dim=192,
        conv1d_kernel=4, conv1d_shift=1, dropout=0.0, eps=1.0e-5)


def flash_bwd_work(r, h, l, d):
    """(FLOP, bytes, exponentials) of one flash-attention backward: S
    recomputed, dP, dV, dQ and dK, 10 L^2 D per (row, head) at the true
    head_dim; q, k, v, o, dO read and dq, dk, dv written once (bf16), the
    log-sum-exp read (fp32); P recomputed once, one exponential per score."""
    return (10.0 * r * h * l * l * d, 8 * r * h * l * d * 2.0 + 4.0 * r * h * l,
            float(r * h * l * l))


def ffn_core_bwd_work(r, l, c, inner, k):
    """(FLOP, bytes) of one FFN-core backward on rows padded to L + 2(k-1):
    the conv recomputed, dh, dx and both weight products, 16 k C I per conv
    position; x and the cotangent read and dx written once (bf16), the
    weights read (bf16) and their gradients written (fp32)."""
    lin, l1 = l + 2 * (k - 1), l + k - 1
    w = 3 * inner * c * k
    return 16.0 * r * l1 * k * c * inner, 3 * r * lin * c * 2.0 + w * 2.0 + w * 4.0


def _inner_dims(cfg):
    dims = cfg.ffn_hidden_dim
    return tuple(dims) if isinstance(dims, (tuple, list)) else (dims,)


def _unfused_train_shapes():
    """(config name, path, rows, heads, sequence, head_dim, C, inner) of the
    attention cores and FFN cores of one training micro-batch: small at its
    published batch 16 x 3 s, xlarge at micro-batch 1 x 15 s."""
    out = []
    for name, cfg, mb, seg in (("small", small_model_config(), SMALL_BATCH, SMALL_SEGMENT),
                               ("xlarge", xlarge_model_config(), 1, XL_SEGMENT)):
        n_frames = 1 + seg // cfg.hop_length
        inner = _inner_dims(cfg)[0]
        d = cfg.attention_dim // cfg.n_heads
        for path, rows, seq in (("freq", mb * n_frames, cfg.n_freqs),
                                ("time", mb * cfg.n_freqs, n_frames)):
            out.append((name, path, rows, cfg.n_heads, seq, d, cfg.emb_dim, inner))
    return out


def _kernel_device_ms(fn, prefix: str, per_call=None, reps: int = 3) -> dict:
    """Device ms per call of each kernel named ``prefix...`` (a regular
    expression) that ``fn`` launches, from a ``torch.profiler`` trace of
    ``reps`` calls (so a call of several launches is timed kernel by
    kernel): each kernel's mean over the launches the trace holds (late in
    a process it loses some) times its launches a call, ``per_call[name]``
    (1 where not named); keyed ``name xn`` when n > 1.  Raises when the
    trace holds more launches than ``reps`` calls make; empty when it holds
    none."""
    import re
    import torch
    per_call = per_call or {}
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
        m = re.search(rf"({prefix}\w+)", e.key)
        if t and m and e.count:
            name = m.group(1)
            n = per_call.get(name, 1)
            if e.count > reps * n:
                raise AssertionError(f"{name}: {e.count} launches in the trace of {reps} "
                                     f"calls, expected {n} a call")
            out[name + (f" x{n}" if n > 1 else "")] = t / 1e3 / e.count * n
    return out


def ffn_bwd_launches(sf, rows, lin, c, inner, k) -> dict:
    """Launches one #9 call of the wrapper module ``sf`` makes of each of its
    kernels (1 where not named): per row group the Hopper dx kernel and
    weight-gradient GEMM, then two reductions; or the mma.sync dx and weight
    kernels once each, then three reductions."""
    if getattr(sf, "hopper_route", lambda _: False)(c):
        n = sf.wg_backward_plan(rows, lin, c, inner, k)["groups"]
        return {"ffn_bwd_dx_wg_kernel": n, "ffn_wgrad_gemm_kernel": n, "wg::reduce_kernel": 2}
    return {"wg::reduce_kernel": 3}


def phase_unfused_train_kernels(results):
    """The flash-attention backward (#7) and the FFN-core backward (#9)
    through their autograd Functions against autograd through their plain
    versions in fp32 on the same bf16 inputs: #7 on row slices (the rows are
    independent; the plain fp32 scores of all rows would not fit), #9 on
    full rows at the small config and a 64-row slice at xlarge (the plain
    fp32 conv intermediates of 647 rows take ~40 GB), and at dropout 0.1 on
    a 16-row slice; then timed beside their bounds (and, for #7, the
    autograd backward of ``scaled_dot_product_attention``).  The mask
    kernel against its plain version, bit for bit."""
    import torch
    import torch.nn.functional as F
    from mss_tf_locoformer_tpu_torch.ops import dropout as D
    from mss_tf_locoformer_tpu_torch.ops.cuda import flash_attention as FA
    from mss_tf_locoformer_tpu_torch.ops.cuda import swiglu_ffn as SF
    from mss_tf_locoformer_tpu_torch.ops.rope import apply_rope
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    k = 4
    for name, path, rows, h, seq, d, c, inner in _unfused_train_shapes():
        tag = f"{name} {path}"
        # #7 on the views of a QKV product [R, L, 3, H, D]
        qkv = (1.5 * torch.randn(rows, seq, 3, h, d, generator=gen, device=dev)).to(
            torch.bfloat16).requires_grad_(True)
        go = torch.randn(rows, h, seq, d, generator=gen, device=dev).to(torch.bfloat16)
        q, kk, v = qkv.permute(2, 0, 3, 1, 4)
        out = FA.flash_attention(q, kk, v, True)
        (got,) = torch.autograd.grad(out, qkv, go)
        # no atomics: a second run gives the same bits
        (again,) = torch.autograd.grad(FA.flash_attention(q, kk, v, True), qkv, go)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"flash_attention_backward {tag}: two runs differ")
        print(f"[train-kernels] flash_attention_backward {tag}: two runs bit-equal "
              f"({'resident' if FA.backward_resident(seq, d) else 'streaming'} kernels)")
        del again
        n, err, fwd_err = (8 if seq > 1000 or rows > 4000 else 64), 0.0, 0.0
        for r0 in (0, rows - n):
            ref_leaf = qkv.detach()[r0:r0 + n].float().requires_grad_(True)
            rq, rk, rv = ref_leaf.permute(2, 0, 3, 1, 4)
            ref_out = FA.reference_flash_attention(rq, rk, rv, True)
            (ref,) = torch.autograd.grad(ref_out, ref_leaf, go[r0:r0 + n].float())
            fwd_err = max(fwd_err, _compare(
                f"flash_attention {tag} (training) rows {r0}..{r0 + n} of "
                f"[{rows}, {h}, {seq}, {d}]", out[r0:r0 + n], ref_out.detach(), STEP_TOL,
                null=rv.detach().mean(-2, keepdim=True).expand(ref_out.shape)))
            for i, g_name in enumerate(("dq", "dk", "dv")):
                err = max(err, _compare(
                    f"flash_attention_backward {tag} {g_name} rows {r0}..{r0 + n} of "
                    f"[{rows}, {h}, {seq}, {d}]", got[r0:r0 + n, :, i], ref[:, :, i], STEP_TOL,
                    null=torch.zeros_like(ref[:, :, i])))
        del got, ref, ref_leaf, ref_out
        saved = (qkv.detach().permute(2, 0, 3, 1, 4))
        q4, k4, v4 = saved
        o, lse = FA._forward(q4, k4, v4, True, 10000.0, True)
        bwd = lambda: FA.flash_attention_backward(go.permute(0, 2, 1, 3), q4, k4, v4, o, lse,
                                                  True, 10000.0)
        ms = _time_ms(bwd, iters=3)
        per_kernel = _kernel_device_ms(bwd, "flash_")
        # the plain version recomputes its score groups in the backward
        # (checkpoint): its backward is forward + backward less a forward
        both = _time_ms(lambda: torch.autograd.grad(
            FA.reference_flash_attention(q, kk, v, True), qkv, go), iters=1)
        with torch.no_grad():
            fwd = _time_ms(lambda: FA.reference_flash_attention(q, kk, v, True), iters=1)
        plain_ms = both - fwd
        qr, kr = (apply_rope(t.detach()).requires_grad_(True) for t in (q, kk))
        vr = v.detach().requires_grad_(True)
        lib_out = F.scaled_dot_product_attention(qr, kr, vr)
        library_ms = _time_ms(lambda: torch.autograd.grad(lib_out, (qr, kr, vr), go,
                                                          retain_graph=True), iters=3)
        r = results.setdefault("flash_attention_backward", dict(err=0.0))
        r["err"] = max(r["err"], err)
        r[tag] = dict(shape=(rows, h, seq, d), ms=ms, plain_ms=plain_ms,
                      library_ms=library_ms, bound=_bound(*flash_bwd_work(rows, h, seq, d)),
                      kernels=per_kernel)
        if name == "small":
            # #6 at the small training shapes, as training runs it (stash)
            fr = results.setdefault("flash_attention", dict(err=0.0))
            fr["err"] = max(fr["err"], fwd_err)
            with torch.no_grad():
                fr[tag] = dict(
                    shape=(rows, h, seq, d),
                    ms=_time_ms(lambda: FA._forward(q4, k4, v4, True, 10000.0, True), iters=3),
                    plain_ms=fwd,
                    library_ms=_time_ms(lambda: F.scaled_dot_product_attention(
                        qr.detach(), kr.detach(), v.detach()), iters=3),
                    bound=_bound(*flash_work(rows, h, seq, d)))
        del qkv, go, q, kk, v, out, o, lse, q4, k4, v4, saved, qr, kr, vr, lib_out
        torch.cuda.empty_cache()

        # #9 on rows pre-padded by k-1 zeros each side
        lin = seq + 2 * (k - 1)
        x = torch.zeros(rows, lin, c, dtype=torch.bfloat16, device=dev)
        x[:, k - 1:k - 1 + seq] = torch.randn(rows, seq, c, generator=gen, device=dev)
        b = (c * k) ** -0.5
        w = [(torch.rand(*s, generator=gen, device=dev) * 2 - 1) * b
             for s in ((2 * inner, c, k), (2 * inner,), (inner, c, k), (c,))]
        g = torch.randn(rows, lin, c, generator=gen, device=dev).to(torch.bfloat16)
        fn = lambda *a, p=0.0, r0=0: SF.swiglu_conv_deconv(*a, k, p, 777, r0)
        pfn = lambda *a, p=0.0, r0=0: SF.reference_swiglu_conv_deconv(*a, k, p, 777, r0)
        n = rows if name == "small" else 64
        xs, gs = x[:n].contiguous(), g[:n].contiguous()
        _, got = _autograd(fn, xs, w, gs)
        torch.cuda.synchronize()
        _, ref = _autograd(pfn, xs.float(), w, gs.float())
        gerr, grel = _check_grads(f"swiglu_ffn_backward {tag} [{n} of {rows}, {lin}, {c}], "
                                  f"I {inner}", got, ref, gs)
        # on the Hopper route the slices again in as many row groups as the
        # full shape runs (a scratch cap of that many rows' dyvg and h), so
        # the partials' accumulation across groups, each group's row offset
        # and its dropout rows are held too; the dropout slice's groups of 5
        # start off the full shape's group boundaries and end ragged
        if SF.hopper_route(c):
            per_row = SF.wg_backward_plan(1, lin, c, inner, k)["scratch_bytes"]
            groups = SF.wg_backward_plan(rows, lin, c, inner, k)["groups"]
            cap = per_row * -(-n // groups)
            grouped = SF.swiglu_ffn_backward(gs, xs, *w[:3], k, scratch_cap=cap)
            _check_grads(f"swiglu_ffn_backward {tag} [{n} of {rows}, {lin}, {c}] in "
                         f"{-(-n // (cap // per_row))} row groups", grouped, ref, gs)
            del grouped
        del got, ref
        r0 = rows // 2
        xs, gs = x[r0:r0 + 16].contiguous(), g[r0:r0 + 16].contiguous()
        _, got = _autograd(lambda *a: fn(*a, p=0.1, r0=r0), xs, w, gs)
        _, ref = _autograd(lambda *a: pfn(*a, p=0.1, r0=r0), xs.float(), w, gs.float())
        _check_grads(f"swiglu_ffn_backward {tag} rows {r0}..{r0 + 16}, dropout 0.1", got, ref, gs)
        if SF.hopper_route(c):
            grouped = SF.swiglu_ffn_backward(gs, xs, *w[:3], k, 0.1, 777, r0,
                                             scratch_cap=5 * per_row)
            _check_grads(f"swiglu_ffn_backward {tag} rows {r0}..{r0 + 16}, dropout 0.1, in "
                         f"row groups of 5", grouped, ref, gs)
            del grouped
        del got, ref, xs, gs
        torch.cuda.empty_cache()
        if tag == "xlarge freq":
            # no atomics: a second run gives the same bits (split partials
            # summed in a fixed order, across 8 row groups)
            first = SF.swiglu_ffn_backward(g, x, *w[:3], k, 0.1, 777, 0)
            again = SF.swiglu_ffn_backward(g, x, *w[:3], k, 0.1, 777, 0)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(first, again)):
                raise AssertionError(f"swiglu_ffn_backward {tag}: two runs differ")
            print(f"[train-kernels] swiglu_ffn_backward {tag}: two runs bit-equal "
                  f"(dropout 0.1)")
            del first, again
        bwd = lambda: SF.swiglu_ffn_backward(g, x, *w[:3], k)
        ms = _time_ms(bwd, iters=3)
        per_kernel = _kernel_device_ms(bwd, "(?:ffn_|wg::reduce_)",
                                       ffn_bwd_launches(SF, rows, lin, c, inner, k))
        xp = x.detach().requires_grad_(True)
        wp = [t.detach().requires_grad_(True) for t in w]
        pout = pfn(xp, *wp)
        plain_ms = _time_ms(lambda: torch.autograd.grad(pout, [xp, *wp], g, retain_graph=True),
                            iters=1)
        r = results.setdefault("swiglu_ffn_backward", dict(err=0.0, rel_l2=0.0))
        r["err"] = max(r["err"], gerr)
        r["rel_l2"] = max(r["rel_l2"], grel)
        r[tag] = dict(shape=(rows, lin, c), ms=ms, plain_ms=plain_ms, library_ms=None,
                      bound=_bound(*ffn_core_bwd_work(rows, seq, c, inner, k)),
                      kernels=per_kernel)
        del x, w, g, xp, wp, pout
        torch.cuda.empty_cache()

    # the mask kernel: the xlarge freq path's probability mask of one 1 GiB
    # group of (row, head) pairs, bit for bit against the plain version
    from mss_tf_locoformer_tpu_torch.ops.attention import group_keep_mask
    seq, heads = 2049, 16
    rows_ids = torch.arange(647, device=dev)
    group = (1 << 30) // (4 * seq * seq)
    got = group_keep_mask(12345, rows_ids, heads, seq, 3000, 3000 + group, 0.1)
    f = torch.arange(3000, 3000 + group, device=dev)
    ar = torch.arange(seq, device=dev)
    args = (12345, D.SITE_ATTN_PROB, rows_ids[f // heads][:, None, None],
            (f % heads)[:, None, None], ar[None, None, :], ar[None, :, None])
    ref = D.reference_keep_mask(*args, p=0.1)
    if not torch.equal(got, ref):
        raise AssertionError("dropout mask kernel: bits differ from the plain version")
    rate = got.float().mean().item()
    print(f"[train-kernels] dropout_mask [{group}, {seq}, {seq}]: equal to the plain version, "
          f"keep rate {rate:.5f} (p 0.1)")
    if abs(rate - 0.9) > 1e-3:
        raise AssertionError(f"dropout mask keep rate {rate}")
    ms = _time_ms(lambda: D.keep_mask(*args, p=0.1), iters=5)
    plain_ms = _time_ms(lambda: D.reference_keep_mask(*args, p=0.1), iters=1)
    n = got.numel()
    # bound: one byte written per element, or 10 Philox rounds (~10 integer
    # operations each) per 4 elements at the fp32 non-tensor rate
    results["dropout_mask"] = dict(err=0.0, ms=ms, plain_ms=plain_ms, library_ms=None,
                                   bound=_bound(25.0 * n, float(n), peak=PEAK_FP32),
                                   shape=tuple(got.shape))
    del got, ref, f, ar, args
    torch.cuda.empty_cache()


def _xl_train_model(plain=False):
    """The bf16 xlarge model with per-block remat, in training mode; with
    ``plain``, every kernel replaced by its plain version."""
    import dataclasses

    import torch
    from mss_tf_locoformer_tpu_torch.core.precision import BF16
    from mss_tf_locoformer_tpu_torch.models import build_model
    cfg = dataclasses.replace(xlarge_model_config(), remat_blocks=True)
    if plain:
        cfg = _plain_config(cfg)
    return build_model(cfg, BF16, torch.Generator().manual_seed(SEED)).to("cuda").train()


def _xl_step(model, opt, mb, gen_seed=11):
    import torch
    from mss_tf_locoformer_tpu_torch.core.config import LossConfig
    from mss_tf_locoformer_tpu_torch.train.step import train_step
    mix, tg = _batch(torch.Generator().manual_seed(SEED + 8), mb, XL_SEGMENT, "cuda")
    return train_step(model, opt, mix, tg, 3e-4, torch.Generator().manual_seed(gen_seed),
                      LossConfig(), accum=1, gradient_clip=5.0)


def _plain_attention_ms(prof, _):
    """The plain attention's device time in a training step's trace: each
    kernel launched under a ``plain_attention`` range (its score groups'
    forwards and recomputes: products, softmax, masks) or by the autograd
    nodes only it creates (``SoftmaxBackward0``, ``BmmBackward0``), counted
    once; its other backward nodes (the mask's ``where``, the casts) are
    not, so it is a lower bound."""
    owners = set(_RANGES) | {"SoftmaxBackward0", "BmmBackward0"}
    ms = 0.0
    for e in prof.events():
        if not e.kernels:
            continue
        p = e
        while p is not None and p.name not in owners:
            p = p.cpu_parent
        if p is not None:
            ms += sum(k.duration for k in e.kernels) / 1e3
    return "plain attention (all its kernels)", ms


def phase_xlarge_train_step():
    """The xlarge config's train step at full width and depth (12 layers,
    C 256, remat on, dropout 0.1, 15 s segments), kernel path, at micro-batch
    1 (the first step, so it includes the libraries' warm-up), with exact
    launch counts (#8 forward twice per FFN under remat, #9 once, no flash
    attention: dropout routes attention to the plain path); micro-batch 2
    too when twice the measured peak leaves room on the card.  Returns
    ``({micro-batch: (s/step, peak bytes)}, launches, predicted peak of the
    next micro-batch)``."""
    import torch
    from mss_tf_locoformer_tpu_torch.core.config import TrainingConfig
    from mss_tf_locoformer_tpu_torch.ops.cuda import swiglu_ffn as SF
    from mss_tf_locoformer_tpu_torch.train.state import make_optimizer
    cfg = xlarge_model_config()
    model = _xl_train_model()
    opt = make_optimizer(model.parameters(), TrainingConfig())
    counters = _counters()
    total = torch.cuda.get_device_properties(0).total_memory
    out, launches, want = {}, None, 0.0
    for mb in (1, 2):
        if mb > 1:   # activations scale with the micro-batch; the weights do not
            want = 2.0 * out[1][1]
            if want > 0.85 * total:
                print(f"[xl-train] micro-batch 2: predicted peak {want / 2**30:.1f} GiB of "
                      f"{total / 2**30:.1f} GiB: not run")
                break
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        ld = _xl_step(model, opt, mb)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        if launches is None:
            launches = {k: fn.launches for k, fn in counters.items()}
        peak = torch.cuda.max_memory_allocated()
        if not torch.isfinite(ld["total_loss"]):
            raise AssertionError(f"xlarge train step: loss {ld['total_loss']}")
        out[mb] = (sec, peak)
        print(f"[xl-train] micro-batch {mb} x 15 s: {sec:.2f} s, peak {peak / 2**30:.2f} GiB, "
              f"loss {float(ld['total_loss']):.4f}")
        if mb == 1:   # #9's scratch and partials (the freq path's, the larger)
            k = cfg.conv1d_kernel
            plan = SF.wg_backward_plan(1 + XL_SEGMENT // cfg.hop_length,
                                       cfg.n_freqs + 2 * (k - 1), cfg.emb_dim,
                                       _inner_dims(cfg)[0], k)
            limit = XL_PEAK_GIB + (SF.SCRATCH_CAP + plan["partial_bytes"]) / 2**30
            print(f"[xl-train] peak {peak / 2**30:.2f} GiB against {XL_PEAK_GIB:.2f} GiB "
                  f"before #9's scratch (the mma.sync kernels') + its cap "
                  f"{SF.SCRATCH_CAP / 2**30:.2f} GiB + partials "
                  f"{plan['partial_bytes'] / 2**30:.3f} GiB = {limit:.2f} GiB")
            if peak > limit * 2**30:
                raise AssertionError(f"xlarge train step: peak {peak / 2**30:.2f} GiB above "
                                     f"{limit:.2f} GiB")
    ffns = cfg.n_layers * 2 * len(_inner_dims(cfg))
    if launches["dropout_mask"] <= 0:
        raise AssertionError("xlarge train step drew no dropout mask on the card")
    _check_launches("xl-train", launches, {"stft": 1, "swiglu_ffn": 2 * ffns,
                                           "swiglu_ffn_backward": ffns,
                                           "dropout_mask": launches["dropout_mask"]})
    del model, opt
    torch.cuda.empty_cache()
    return out, launches, want


def phase_xlarge_train_profile():
    """Where one xlarge micro-batch step (1 x 15 s, remat, dropout 0.1)
    spends the device's time: ``torch.profiler`` over a step after a warm-
    up step.  Reading the trace takes minutes (~10^6 events), so this runs
    only with ``--profile-xlarge-train``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from mss_tf_locoformer_tpu_torch.core.config import TrainingConfig
    from mss_tf_locoformer_tpu_torch.train.state import make_optimizer
    model = _xl_train_model()
    opt = make_optimizer(model.parameters(), TrainingConfig())
    _xl_step(model, opt, 1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _xl_step(model, opt, 1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = _profile_summary(prof, wall, 8, _plain_attention_ms)
    del model, opt, prof
    torch.cuda.empty_cache()
    return wall, rows


def phase_xlarge_train_parity():
    """One xlarge micro-batch (1 x 1 s, remat on, dropout 0.1) through the
    kernel path and the plain path with the same weights, batch and seeds:
    the relative L2 of the gradients per parameter group (encoder, each
    block, decoder) within ``STEP_GRAD_REL_L2``; the gradients of the plain
    model with its blocks skipped must miss the bound."""
    import torch
    from mss_tf_locoformer_tpu_torch.core.config import LossConfig
    from mss_tf_locoformer_tpu_torch.losses.mss_loss import mss_loss
    fused = _xl_train_model()
    plain = _xl_train_model(plain=True)
    plain.load_state_dict(fused.state_dict(), strict=True)
    mix, tg = _batch(torch.Generator().manual_seed(SEED + 4), 1, SR, "cuda")

    def grads(model):
        model.zero_grad(set_to_none=True)
        loss = mss_loss(model(mix, generator=torch.Generator().manual_seed(9)), tg,
                        LossConfig())["total_loss"]
        loss.backward()
        return loss.item(), {n: p.grad.detach().clone() for n, p in model.named_parameters()
                             if p.grad is not None}

    def group(name):
        return ".".join(name.split(".")[:2]) if name.startswith("blocks.") else name.split(".")[0]

    def by_group(ga, gb):
        out = {}
        for name, a in ga.items():
            ref = gb[name]
            if not torch.isfinite(a).all():
                raise AssertionError(f"xlarge parity: gradient of {name} is not finite")
            num, den = out.get(group(name), (0.0, 0.0))
            out[group(name)] = (num + (a.float() - ref.float()).pow(2).sum().item(),
                                den + ref.float().pow(2).sum().item())
        return {k: (n / d) ** 0.5 for k, (n, d) in out.items()}

    lk, gk = grads(fused)
    lp, gp = grads(plain)
    if set(gk) != set(gp):
        raise AssertionError("xlarge parity: the two paths' gradients cover other parameters")
    rel = by_group(gk, gp)
    blocks, plain.blocks = plain.blocks, torch.nn.ModuleList()
    _, gs = grads(plain)
    plain.blocks = blocks
    skip = by_group(gs, gp)     # the encoder and the decoder: no blocks to differentiate
    worst = max(rel.values())
    print(f"[xl-parity] loss kernel {lk:.5f} plain {lp:.5f}; gradient relative L2 by group: "
          + ", ".join(f"{k} {v:.2e}" for k, v in rel.items())
          + f" (bound {STEP_GRAD_REL_L2:g}); blocks skipped: "
          + ", ".join(f"{k} {v:.2e}" for k, v in skip.items()))
    if not worst <= STEP_GRAD_REL_L2:
        raise AssertionError(f"xlarge train parity: relative L2 {worst:.3e} above bound")
    if not min(skip.values()) > STEP_GRAD_REL_L2:
        raise AssertionError("xlarge train parity: cannot tell the model from the model "
                             "with its blocks skipped")
    del fused, plain, gk, gp, gs
    torch.cuda.empty_cache()
    return worst, min(skip.values())


def _unfused_train_config(root, name, epochs):
    """The training CLI's config: the small config's published sections
    (batch 16 x 3 s, SI-SDR loss, dropout 0), or the xlarge config's training
    section (augmentation, warmup, batch 8 as 2 x 4, gradient checkpointing,
    combined loss, dropout 0.1) at full width, cut to 1 layer and 1 s
    segments (the plain attention over 2049 bins dominates its time)."""
    import dataclasses
    if name == "small":
        model, seg = dataclasses.asdict(small_model_config()), SMALL_SEGMENT
        loss = {"loss_type": "si_sdr", "si_sdr_weight": 1.0}
        training = {"batch_size": SMALL_BATCH, "optimizer": {"type": "adamw", "lr": 5e-4,
                                                            "weight_decay": 0.01},
                    "scheduler": {"type": "reducelronplateau", "factor": 0.5, "patience": 5,
                                  "min_lr": 1e-7}}
        aug = False
    else:
        model = dataclasses.asdict(dataclasses.replace(xlarge_model_config(), n_layers=1))
        seg, aug = SR, True
        loss = {"loss_type": "combined", "si_sdr_weight": 1.0, "l1_weight": 0.1,
                "spectral_weight": 0.1}
        training = {"batch_size": 8, "gradient_clip": 5.0, "gradient_checkpointing": True,
                    "gradient_accumulation_steps": 2,
                    "optimizer": {"type": "adamw", "lr": 3e-4, "weight_decay": 0.01,
                                  "betas": [0.9, 0.999]},
                    "scheduler": {"type": "reducelronplateau", "factor": 0.5, "patience": 10,
                                  "min_lr": 1e-7, "warmup_steps": 4000}}
    training.update({"num_epochs": epochs, "num_workers": 4, "use_amp": True,
                     "amp_dtype": "bfloat16", "save_interval": 1, "val_interval": 1,
                     "log_interval": 1})
    return {"dataset": {"root_dir": root, "sample_rate": SR, "segment_length": seg,
                        "sources": ["vocals", "drums", "bass", "other"],
                        "augmentation": aug},
            "model": model, "loss": loss, "training": training, "seed": 42}


def _val_forwards(raw, n_test, seconds):
    """Model forwards of one validation: the test tracks cut into segments,
    scored in groups of ``val_batch_size`` (4 by default)."""
    seg = raw["dataset"]["segment_length"]
    chunks = n_test * -(-int(seconds * SR) // seg)
    return -(-chunks // raw["training"].get("val_batch_size", 4))


def phase_unfused_train_cli(workdir, name):
    """The training CLI through the unfused route: one epoch of 2 optimizer
    steps with validation and a checkpoint, then ``--resume`` for one more
    epoch; exact launch counts of the first run (training and validation
    forwards)."""
    import torch
    from mss_tf_locoformer_tpu_torch.cli import train as train_cli
    n_train = 32 if name == "small" else 16
    root = os.path.join(workdir, "musdb")
    _write_musdb(root, n_train=n_train, n_test=2, seconds=4.0)
    cfg_path = os.path.join(workdir, "train.json")
    argv = ["--config", cfg_path, "--output_dir", os.path.join(workdir, "exp")]
    counters = _counters()
    launches, wall = {}, {}
    for epochs, extra in ((1, []), (2, ["--resume", "latest"])):
        raw = _unfused_train_config(root, name, epochs)
        with open(cfg_path, "w") as f:
            json.dump(raw, f)
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        trainer = train_cli.main(argv + extra)     # --device defaults to cuda
        torch.cuda.synchronize()
        wall[epochs] = time.perf_counter() - t0
        launches[epochs] = {k: fn.launches for k, fn in counters.items()}
    cfg = trainer.model.config
    tcfg = raw["training"]
    micro = (n_train // tcfg["batch_size"]) * tcfg.get("gradient_accumulation_steps", 1)
    val = _val_forwards(raw, 2, 4.0)
    paths = cfg.n_layers * 2
    ffns = paths * len(_inner_dims(cfg))
    remat = 2 if cfg.remat_blocks else 1
    if name == "small":   # dropout 0: flash attention in training too
        need = {"flash_attention": paths * (micro + val), "flash_attention_backward":
                paths * micro, "swiglu_ffn": ffns * (micro + val),
                "swiglu_ffn_backward": ffns * micro, "stft": micro + val}
    else:                 # dropout 0.1: attention on the plain path in training
        need = {"flash_attention": paths * val, "swiglu_ffn": ffns * (remat * micro + val),
                "swiglu_ffn_backward": ffns * micro, "stft": micro + val,
                "dropout_mask": launches[1]["dropout_mask"]}
        if not (cfg.remat_blocks and launches[1]["dropout_mask"] > 0):
            raise AssertionError(f"xlarge CLI: remat {cfg.remat_blocks}, masks "
                                 f"{launches[1]['dropout_mask']}")
    _check_launches(f"train-cli {name}", launches[1], need)
    if trainer.step != 4 or trainer.start_epoch != 1:
        raise AssertionError(f"resume: step {trainer.step}, start epoch {trainer.start_epoch}")
    blob = torch.load(trainer.ckpt.path(1), map_location="cpu", weights_only=True)
    for key in ("train_loss", "val_loss"):
        if not blob["metadata"][key] == blob["metadata"][key]:
            raise AssertionError(f"{name} checkpoint {key} is not finite")
    for pname, p in trainer.model.named_parameters():
        if p.grad is None or not torch.isfinite(p.grad).all():
            raise AssertionError(f"{name}: gradient of {pname} missing or not finite")
    print(f"[train-cli] {name}: {micro} micro-batches + {val} validation forwards per epoch; "
          f"first run {wall[1]:.1f} s, resumed run {wall[2]:.1f} s; losses train "
          f"{blob['metadata']['train_loss']:.4f} val {blob['metadata']['val_loss']:.4f}")
    del trainer
    torch.cuda.empty_cache()
    return launches[1], wall


# ------------------------------------------------ iSTFT, BS-Locoformer, evaluation

# The iSTFT (#10) and its overlap-add: both sides fp32 (FFTs by different
# butterflies; the plain fold sums in another order); expected ~1e-6 of
# max|ref|, so the STFT's 1e-4 leaves room and still catches any wrong bin,
# frame or window sample (those are O(1) relative).
ISTFT_TOL = 1e-4


def stft_work(b, t, n_frames, n_bins, n_fft):
    """(FLOP, bytes) of the STFT of ``b`` signals of ``t`` samples: an FFT's
    5 n_fft log2 n_fft per frame; the audio read once, the complex spectrum
    written once."""
    return (5.0 * b * n_frames * n_fft * math.log2(n_fft),
            b * t * 4.0 + b * n_bins * n_frames * 8.0)


def istft_work(r, n, n_bins, n_fft):
    """(FLOP, bytes) of the windowed frames of ``r`` spectra of ``n`` frames:
    the function's own work, an FFT's per frame (5 n_fft log2 n_fft, as #1's
    bound counts it); the complex spectrum read once, the fp32 frames
    written once."""
    return (5.0 * r * n * n_fft * math.log2(n_fft),
            r * n_bins * n * 8.0 + r * n * n_fft * 4.0)


def ola_work(r, n, n_fft, length):
    """(FLOP, bytes) of the overlap-add of ``r`` x ``n`` windowed frames into
    ``length`` samples each: a sum, a square and an envelope sum per frame
    sample; the frames read once, the audio written once."""
    return 3.0 * r * n * n_fft, r * n * n_fft * 4.0 + r * length * 4.0


def _stft_case(results, tag, audio, n_fft, hop):
    """#1 against its plain version on ``audio [B, T]``, timed (device and
    host-inclusive time) beside the plain version, ``torch.stft`` and its
    bound."""
    import torch
    from mss_tf_locoformer_tpu_torch.ops.cuda import stft_kernel as SK
    got = SK.stft_fused(audio, n_fft, hop)
    torch.cuda.synchronize()
    ref = SK.reference_stft(audio, n_fft, hop)
    err = _compare(f"stft {tag} {list(audio.shape)}, n_fft {n_fft}, hop {hop} -> "
                   f"{list(ref.shape)}", got, ref, STFT_TOL)
    del got
    window = torch.hann_window(n_fft, device=audio.device)
    (b, t), (n_bins, n_frames) = audio.shape, ref.shape[-2:]
    r = results.setdefault("stft", dict(err=0.0, shapes={}))
    r["err"] = max(r["err"], err)
    r["shapes"][tag] = dict(
        shape=tuple(audio.shape), n_fft=n_fft, hop=hop,
        bound=_bound(*stft_work(b, t, n_frames, n_bins, n_fft), peak=PEAK_FP32),
        **_device_and_host_ms(
            ms=lambda: SK.stft_fused(audio, n_fft, hop),
            plain_ms=lambda: SK.reference_stft(audio, n_fft, hop),
            library_ms=lambda: torch.stft(audio, n_fft, hop, window=window,
                                          return_complex=True)))


def _istft_case(results, tag, spec, n_fft, hop, length, gen):
    """#10 and the overlap-add kernel against their plain versions on
    complex ``spec [R, F, N]``: the frames, the overlap-add of the plain
    frames, the whole iSTFT and its gradient; timed (device and host-
    inclusive time) beside the plain versions, ``torch.istft`` and their
    bounds."""
    import torch
    from mss_tf_locoformer_tpu_torch.ops.cuda import stft_kernel as SK
    r, n_bins, n_frames = spec.shape
    shape = f"[{r}, {n_bins}, {n_frames}]"
    got = SK.windowed_frames(spec, n_fft)
    torch.cuda.synchronize()
    frames = SK.reference_windowed_frames(spec, n_fft)
    err = _compare(f"istft frames {tag} {shape} -> {list(got.shape)}", got, frames,
                   ISTFT_TOL)
    del got
    audio = SK.reference_frames_to_audio(frames, n_fft, hop, length)
    ola_err = _compare(f"istft overlap-add {tag} {list(frames.shape)} -> "
                       f"{list(audio.shape)}", SK.frames_to_audio(frames, n_fft, hop, length),
                       audio, ISTFT_TOL)
    s = spec.detach().requires_grad_(True)
    out = SK.istft_fused(s, n_fft, hop, length)
    g = _rand(gen, tuple(out.shape), 1.0).to(spec.device)
    (dgot,) = torch.autograd.grad(out, s, g)
    torch.cuda.synchronize()
    ref = SK.reference_istft(s, n_fft, hop, length)
    (dref,) = torch.autograd.grad(ref, s, g)
    err = max(err, _compare(f"istft {tag} {shape} -> {list(out.shape)}", out, ref,
                            ISTFT_TOL, null=torch.zeros_like(ref)))
    _compare(f"istft gradient {tag} {shape}", dgot, dref, ISTFT_TOL)
    del s, out, g, dgot, ref, dref
    window = torch.hann_window(n_fft, device=spec.device)
    res = results.setdefault("istft", dict(err=0.0))
    res["err"] = max(res["err"], err)
    res[tag] = dict(
        shape=tuple(spec.shape),
        bound=_bound(*istft_work(r, n_frames, n_bins, n_fft), peak=PEAK_FP32),
        # torch.istft synchronises on every call: its time includes the
        # host's, and the whole istft_fused is held against it on that
        # yardstick (istft_host_ms)
        library_host_ms=_time_ms(lambda: torch.istft(spec, n_fft, hop, window=window,
                                                     length=length), iters=20),
        **_device_and_host_ms(
            ms=lambda: SK.windowed_frames(spec, n_fft),
            plain_ms=lambda: SK.reference_windowed_frames(spec, n_fft),
            istft_ms=lambda: SK.istft_fused(spec, n_fft, hop, length)))
    ola = results.setdefault("istft_overlap_add", dict(err=0.0))
    ola["err"] = max(ola["err"], ola_err)
    ola[tag] = dict(
        shape=tuple(frames.shape),
        bound=_bound(*ola_work(r, n_frames, n_fft, audio.shape[-1]), peak=PEAK_FP32),
        **_device_and_host_ms(
            ms=lambda: SK.frames_to_audio(frames, n_fft, hop, length),
            plain_ms=lambda: SK.reference_frames_to_audio(frames, n_fft, hop, length)))
    del frames, audio


def phase_istft_kernel(results):
    """#10 and the overlap-add kernel against their plain versions at the
    BS-Locoformer engine batch (16 spectra: 2 chunks x 4 stems x 2 channels)
    and the base engine batch (8), n_fft 2048; then the launches of one call
    at each shape with the counters at 0 (no model calls them)."""
    import torch
    from mss_tf_locoformer_tpu_torch.ops.cuda import stft_kernel as SK
    cfg = base_model_config()
    n_fft, hop = cfg.n_fft, cfg.hop_length
    gen = torch.Generator().manual_seed(SEED + 9)
    specs = {}
    for tag, r in (("bs", BATCH * 4 * 2), ("base", BATCH * 4)):
        specs[tag] = SK.reference_stft(_rand(gen, (r, CHUNK), 0.1).to("cuda"), n_fft, hop)
        _istft_case(results, tag, specs[tag], n_fft, hop, CHUNK, gen)
        torch.cuda.empty_cache()
    SK.istft_fused.launches = SK.frames_to_audio.launches = 0
    with torch.inference_mode():
        for spec in specs.values():
            SK.istft_fused(spec, n_fft, hop, CHUNK)
    torch.cuda.synchronize()
    launches = {"istft": SK.istft_fused.launches,
                "istft_overlap_add": SK.frames_to_audio.launches}
    for k, n in launches.items():
        results[k]["launches"] = n
    _check_launches("istft", launches, {"istft": len(specs), "istft_overlap_add": len(specs)})
    del specs
    torch.cuda.empty_cache()


def phase_stft_shapes(results):
    """#1 at the other sizes the paths launch it at, on the engine batch
    ``[2, 352800]``: small training (n_fft 1024, hop 256) and xlarge (4096,
    1024); #1, #10 and the overlap-add at the speech configs' sizes (128/64,
    256/128), the kernels' smallest, on one 4 s signal at 16 kHz (1001 and
    501 frames: not a multiple of the kernels' 8 frames a block); another
    n_fft, or a hop whose block exceeds the shared memory, raises on the
    card."""
    import torch
    from mss_tf_locoformer_tpu_torch.ops.cuda import stft_kernel as SK
    gen = torch.Generator().manual_seed(SEED + 11)
    for tag, n_fft, hop in (("small", 1024, 256), ("xlarge", 4096, 1024)):
        _stft_case(results, tag, _rand(gen, (BATCH, CHUNK), 0.1).to("cuda"), n_fft, hop)
    samples = 4 * 16000 + 37
    for n_fft, hop in ((128, 64), (256, 128)):
        audio = _rand(gen, (1, samples), 0.1).to("cuda")
        tag = f"speech {n_fft}"
        _stft_case(results, tag, audio, n_fft, hop)
        _istft_case(results, tag, SK.reference_stft(audio, n_fft, hop), n_fft, hop, samples,
                    gen)
    audio = _rand(gen, (1, samples), 0.1).to("cuda")
    for n_fft in (1000, 8192):
        spec = torch.zeros(1, n_fft // 2 + 1, 8, dtype=torch.complex64, device="cuda")
        for name, call in (("stft_fused", lambda: SK.stft_fused(audio, n_fft, n_fft // 4)),
                           ("istft_fused", lambda: SK.istft_fused(spec, n_fft, n_fft // 4))):
            try:
                call()
            except ValueError as e:
                print(f"[kernels] {name} refuses n_fft {n_fft} on the card: {e}")
            else:
                raise AssertionError(f"{name} took n_fft {n_fft} on the card")
    try:
        SK.stft_fused(audio, 4096, 8192)
    except RuntimeError as e:
        if "n_fft 4096, hop 8192" not in str(e):
            raise
        print(f"[kernels] stft_fused refuses hop 8192 at n_fft 4096 on the card: {e}")
    else:
        raise AssertionError("stft_fused took hop 8192 at n_fft 4096 on the card")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def _bs_main_path_steps(cfg):
    """(path, rows, sequence) of the steps in one BS-Locoformer engine batch:
    the freq path attends over 62 bands on rows B*T, the time path over
    frames on rows B*bands."""
    from mss_tf_locoformer_tpu_torch.models.bslocoformer import compute_bands
    n_frames = 1 + CHUNK // cfg.hop_length
    bands = len(compute_bands(cfg.stft_size, cfg.sample_rate))
    return (("freq", BATCH * n_frames, bands), ("time", BATCH * bands, n_frames))


def phase_bs_kernels(results):
    """The FFN step (#2) and the attention step (#3) against their plain
    versions at the BS-Locoformer engine batch's shapes (C 128, I 384, 4
    heads of 32: no head padding), bf16, timed."""
    import torch
    from mss_tf_locoformer_tpu_torch.ops.cuda import attention_block as AB
    from mss_tf_locoformer_tpu_torch.ops.cuda import swiglu_block as FB
    cfg = bs_model_config()
    c, dev = cfg.emb_dim, torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(SEED + 10)
    fargs = (cfg.conv1d_kernel, cfg.num_groups, cfg.eps)
    aargs = (cfg.n_heads, cfg.num_groups, cfg.eps)
    for path, rows, seq in _bs_main_path_steps(cfg):
        x, gamma, ffn, attn = _step_inputs(gen, rows, seq, dev, c)
        for name, kfn, pfn, w, args, work in (
                ("ffn_step", FB.fused_norm_ffn_residual, FB.reference_norm_ffn_residual,
                 ffn, fargs, ffn_work(rows, seq, c)),
                ("attention_step", AB.fused_attention_block, AB.reference_attention_block,
                 attn, aargs, attn_work(rows, seq, c, cfg.attention_dim, cfg.n_heads))):
            got = kfn(x, gamma, *w, *args)
            torch.cuda.synchronize()
            err = _compare(f"{name} bs {path} [{rows}, {seq}, {c}]", got,
                           pfn(x, gamma, *w, *args), STEP_TOL, null=x)
            del got
            r = results.setdefault(name, dict(err=0.0))
            r["err"] = max(r["err"], err)
            r["bs " + path] = dict(
                shape=(rows, seq, c), ms=_time_ms(lambda: kfn(x, gamma, *w, *args)),
                plain_ms=_time_ms(lambda: pfn(x, gamma, *w, *args), iters=3),
                bound=_bound(*work[:2], *work[4:]))
            torch.cuda.empty_cache()
        del x, gamma, ffn, attn
        torch.cuda.empty_cache()


# Evaluation: the routes' stems against each other, and their scores.  A stem
# within relative L2 eps of the plain route's (slice parity's bound) has an
# SI-SDR against it of at least 20 log10((1 - eps) / eps), 25.6 dB at 5e-2
# (~38 dB at the ~1e-2 measured).  Against the targets, with random weights
# an estimate's projection is small (SI-SDR -10 to -35 dB), and there a
# difference of that size can move the log ratio by tenths of a dB; 1 dB
# bounds the routes' scores on every stem of every track.
EVAL_STEM_SI_SDR_DB = 20 * math.log10((1 - SLICE_REL_L2) / SLICE_REL_L2)
EVAL_SI_SDR_DB = 1.0
EVAL_TRACK_S = 10.0    # 2 chunks of 8 s with 1 s of overlap: one engine batch


def _eval_config(root, cfg):
    import dataclasses
    return {"dataset": {"root_dir": root, "sample_rate": SR,
                        "sources": ["vocals", "drums", "bass", "other"]},
            "model": dataclasses.asdict(cfg),
            "evaluation": {"metrics": ["si_sdr", "sdr", "sar", "sir"]}}


def _check_results(tag, results, tracks, bss):
    """Every track, stem, ``average`` and ``summary`` entry present and finite."""
    import math
    stems = ("vocals", "drums", "bass", "other", "average")
    metrics = {"si_sdr", "sdr", "sar", "sir"} | (
        {"bss_sdr", "bss_sir", "bss_sar"} if bss else set())
    if sorted(results["per_track"]) != tracks:
        raise AssertionError(f"evaluate {tag}: tracks {sorted(results['per_track'])}")
    for where, table in list(results["per_track"].items()) + [("summary", results["summary"])]:
        for stem in stems:
            vals = table.get(stem, {})
            if set(vals) != metrics or not all(math.isfinite(v) for v in vals.values()):
                raise AssertionError(f"evaluate {tag}: {where} {stem}: {vals}")


def phase_evaluate(workdir):
    """The evaluation CLI on a synthetic MUSDB test subset (2 tracks of
    ``EVAL_TRACK_S``: 2 chunks each, overlap-added) with a seeded random
    checkpoint: the base config (mono stems) and BS-Locoformer (stereo
    stems).  The kernel route is timed (exact launch counts, ``results.json``
    complete and finite); the plain route on the same checkpoint adds
    ``--bss_eval``.  Both save their stems: each kernel-route stem's SI-SDR
    against the plain route's at least ``EVAL_STEM_SI_SDR_DB``, and each
    per-stem SI-SDR against the targets within ``EVAL_SI_SDR_DB`` across
    the routes.  Returns ``{tag: (kernel-route wall s, launches)}``."""
    import torch
    from mss_tf_locoformer_tpu_torch.cli import evaluate as cli
    from mss_tf_locoformer_tpu_torch.eval.metrics import compute_si_sdr
    from mss_tf_locoformer_tpu_torch.models import build_model
    from mss_tf_locoformer_tpu_torch.utils.audio import load_audio
    stems = ("vocals", "drums", "bass", "other")
    root = os.path.join(workdir, "musdb")
    _write_musdb(root, n_train=0, n_test=2, seconds=EVAL_TRACK_S)
    tracks = ["track00", "track01"]
    counters = _counters()
    out = {}
    # one forward per track (its 2 chunks are one engine batch)
    for tag, cfg, need in (("base", base_model_config(),
                            {"stft": 2, "ffn_step": 32, "attention_step": 16}),
                           ("bs", bs_model_config(), {"ffn_step": 24, "attention_step": 24})):
        ckpt = os.path.join(workdir, f"{tag}.pth")
        torch.save(build_model(cfg, generator=torch.Generator().manual_seed(SEED)).state_dict(),
                   ckpt)
        scores, dirs = {}, {}
        for route, model_cfg in (("kernel", cfg), ("plain", _plain_config(cfg))):
            cfg_path = os.path.join(workdir, f"{tag}_{route}.json")
            with open(cfg_path, "w") as f:
                json.dump(_eval_config(root, model_cfg), f)
            dirs[route] = os.path.join(workdir, f"eval_{tag}_{route}")
            argv = ["--config", cfg_path, "--checkpoint", ckpt, "--output_dir", dirs[route],
                    "--device", "cuda", "--save_audio"] + (
                        ["--bss_eval"] if route == "plain" else [])
            for fn in counters.values():
                fn.launches = 0
            t0 = time.perf_counter()
            cli.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {k: fn.launches for k, fn in counters.items()}
            with open(os.path.join(dirs[route], "results.json")) as f:
                results = json.load(f)
            _check_results(f"{tag} {route}", results, tracks, route == "plain")
            scores[route] = results["per_track"]
            avg = results["summary"]["average"]
            if route == "kernel":
                _check_launches(f"evaluate {tag}", launches, need)
                out[tag] = (wall, launches)
                print(f"[evaluate] {tag}: {len(tracks)} tracks of {EVAL_TRACK_S:g} s in "
                      f"{wall:.1f} s (model load, separation, metrics, stems written); "
                      f"mean SI-SDR {avg['si_sdr']:.2f} dB")
            else:
                print(f"[evaluate] {tag} plain route: {wall:.1f} s with BSS Eval; mean BSS "
                      f"SDR {avg['bss_sdr']:.2f} dB")
        worst_score, least_stem = 0.0, math.inf
        for track in tracks:
            for stem in stems:
                k, p = (scores[r][track][stem]["si_sdr"] for r in ("kernel", "plain"))
                worst_score = max(worst_score, abs(k - p))
                est, ref = (load_audio(os.path.join(dirs[r], track, f"{stem}.wav"))[0]
                            for r in ("kernel", "plain"))
                agree = compute_si_sdr(est, ref)
                least_stem = min(least_stem, agree)
                print(f"[evaluate] {tag} {track} {stem}: SI-SDR against the target: kernel "
                      f"{k:.3f} dB, plain {p:.3f} dB; kernel stem against the plain stem "
                      f"{agree:.2f} dB")
        if not least_stem >= EVAL_STEM_SI_SDR_DB:
            raise AssertionError(f"evaluate {tag}: a kernel-route stem at {least_stem:.2f} dB "
                                 f"SI-SDR against the plain route's (bound "
                                 f"{EVAL_STEM_SI_SDR_DB:.2f} dB)")
        if not worst_score <= EVAL_SI_SDR_DB:
            raise AssertionError(f"evaluate {tag}: SI-SDR of the routes {worst_score:.3f} dB "
                                 f"apart")
    return out


def profile_main():
    """``python3 chip_smoke.py --profile-xlarge-train``: the device-time
    breakdown of one xlarge micro-batch train step, on its own."""
    sys.path.insert(0, HERE)
    import torch
    _, smi = phase_device()
    phase_build()
    wall, prof = phase_xlarge_train_profile()
    if prof is None:
        raise SystemExit("the profiler saw no device activity")
    busy, rows = prof
    print(f"[profile] xlarge train step, micro-batch 1 x 15 s, remat, dropout 0.1: "
          f"{wall:.2f} s under the profiler, device busy {100 * busy:.1f}% of it; by self "
          f"device time: " + "; ".join(f"{name} {ms:.1f} ms ({100 * share:.1f}%)"
                                      for name, ms, share in rows) + f" ({smi})")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                      "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))


def main():
    if not os.path.isdir(os.path.join(HERE, "mss_tf_locoformer_tpu_torch")):
        raise SystemExit("chip_smoke.py: run it from a checkout of the repository "
                         "(mss_tf_locoformer_tpu_torch/ not found beside it)")
    sys.path.insert(0, HERE)
    import torch

    t_start = time.perf_counter()
    name, smi = phase_device()
    phase_build()
    # the plain versions are the oracle: full fp32 in their matmuls and
    # convolutions (importing the port's core.precision turns TF32 off too)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_gates()
    results = {}
    phase_kernels(results)
    phase_slice_parity(need={"stft": 1, "ffn_step": 16, "attention_step": 8})
    with tempfile.TemporaryDirectory() as workdir:
        launches, wall, seconds = phase_slice(workdir)
    # the fused steps and nothing else: 2 forwards (3 chunks in batches of 2)
    _check_launches("slice", launches, {"stft": 2, "ffn_step": 32, "attention_step": 16})
    forward = phase_forward()

    xl = xlarge_model_config()
    phase_xlarge_kernels(results)
    phase_slice_parity(xl, {"stft": 1, "flash_attention": 24, "swiglu_ffn": 48})
    with tempfile.TemporaryDirectory() as workdir:
        xl_launches, xl_wall, _ = phase_slice(workdir, xl)
    # per forward 2 paths x 12 layers: 1 flash attention and 2 FFN cores each
    _check_launches("xlarge slice", xl_launches,
                    {"stft": 2, "flash_attention": 48, "swiglu_ffn": 96})
    xl_forward = phase_forward(xl, reps=1)
    profiles = {"base": phase_profile(), "xlarge": phase_profile(xl)}

    phase_train_kernels(results)
    with tempfile.TemporaryDirectory() as workdir:
        train_launches, train_wall = phase_train(workdir)
    phase_train_parity()
    train_time = phase_train_timing()

    phase_unfused_train_kernels(results)
    xl_train, xl_train_launches, xl_next_peak = phase_xlarge_train_step()
    phase_xlarge_train_parity()
    unfused_cli = {}
    for tag in ("small", "xlarge"):
        with tempfile.TemporaryDirectory() as workdir:
            unfused_cli[tag] = phase_unfused_train_cli(workdir, tag)

    phase_istft_kernel(results)
    phase_stft_shapes(results)
    bs = bs_model_config()
    phase_bs_kernels(results)
    # per forward 2 paths x 6 layers: one FFN step and one attention step each
    phase_slice_parity(bs, {"ffn_step": 12, "attention_step": 12})
    with tempfile.TemporaryDirectory() as workdir:
        bs_launches, bs_wall, _ = phase_slice(workdir, bs)
    _check_launches("bs slice", bs_launches, {"ffn_step": 24, "attention_step": 24})
    bs_forward = phase_forward(bs)
    profiles["bs"] = phase_profile(bs)
    with tempfile.TemporaryDirectory() as workdir:
        evaluation = phase_evaluate(workdir)

    card = f"({smi})"
    # device time (queued behind a spin) / with the host's time (CUDA events)
    both = lambda r, k: f"{r[k + 'ms']:.4f} / {r[k + 'host_ms']:.4f} ms"
    for tag, r in results["stft"]["shapes"].items():
        print(f"[timing] stft {tag} {list(r['shape'])}, n_fft {r['n_fft']}/{r['hop']}, "
              f"device / host-inclusive time: kernel {both(r, '')}, plain "
              f"{both(r, 'plain_')}, torch.stft {both(r, 'library_')}; bound "
              f"{r['bound'][0]:.4f} ms ({r['bound'][1]}) {card}")
    for k in ("ffn_step", "attention_step"):
        for path in ("freq", "time"):
            rows, ms, plain_ms = results[k][path]
            print(f"[timing] {k} {path} ({rows} rows): kernel {ms:.3f} ms, "
                  f"plain {plain_ms:.3f} ms {card}")
    for k in ("ffn_step_backward", "attention_step_backward"):
        for path in ("freq", "time"):
            r = results[k][path]
            print(f"[timing] training {k[:-9]} {path} [{r['rows']}, {r['seq']}, 96], dropout "
                  f"0.1: forward (stash) {r['fwd_ms']:.3f} ms (plain {r['plain_fwd_ms']:.3f}, "
                  f"bound {r['fwd_bound'][0]:.3f} ms); backward {r['ms']:.3f} ms (plain "
                  f"{r['plain_ms']:.3f}, bound {r['bound'][0]:.3f} ms, {r['bound'][1]}) {card}")
    for k in ("flash_attention", "swiglu_ffn"):
        for path in [t for t, r in results[k].items() if isinstance(r, dict)]:
            r = results[k][path]
            lib = "" if r["library_ms"] is None else f", library {r['library_ms']:.3f} ms"
            where = path if path.startswith("small") else "xlarge " + path
            split = "".join(f"; {n} {t:.3f} ms" for n, t in r.get("kernels", {}).items())
            print(f"[timing] {k} {where} {list(r['shape'])}: kernel {r['ms']:.3f} ms{split}, "
                  f"plain {r['plain_ms']:.3f} ms{lib}, bound {r['bound'][0]:.3f} ms "
                  f"({r['bound'][1]}) {card}")
    for tag in ("bs", "base", "speech 128", "speech 256"):
        r, o = results["istft"][tag], results["istft_overlap_add"][tag]
        print(f"[timing] istft {tag} {list(r['shape'])}, device / host-inclusive time: "
              f"frames kernel {both(r, '')} (plain irfft x window {both(r, 'plain_')}, "
              f"bound {r['bound'][0]:.4f} ms, {r['bound'][1]}); overlap-add kernel "
              f"{both(o, '')} (plain {both(o, 'plain_')}, bound {o['bound'][0]:.4f} ms, "
              f"{o['bound'][1]}); whole iSTFT {both(r, 'istft_')}, torch.istft (it "
              f"synchronises: host-inclusive only) {r['library_host_ms']:.4f} ms {card}")
    for k in ("ffn_step", "attention_step"):
        for path in ("freq", "time"):
            r = results[k]["bs " + path]
            print(f"[timing] bs {k} {path} {list(r['shape'])}: kernel {r['ms']:.3f} ms, plain "
                  f"{r['plain_ms']:.3f} ms, bound {r['bound'][0]:.3f} ms ({r['bound'][1]}) "
                  f"{card}")
    audio_s = BATCH * CHUNK / SR
    for tag, fwd in (("base", forward), ("xlarge", xl_forward), ("bs", bs_forward)):
        for path, (ms, peak) in fwd.items():
            print(f"[timing] {tag} forward [{BATCH}, {CHUNK}], {path} path: {ms:.1f} ms, "
                  f"{1e3 * audio_s / ms:.2f}x realtime, peak {peak / 2**30:.2f} GiB {card}")
    for tag, prof in profiles.items():
        if prof is not None:
            busy, rows = prof
            print(f"[profile] {tag} forward [{BATCH}, {CHUNK}], kernel path: device busy "
                  f"{100 * busy:.1f}% of the wall time; by self device time: " + "; ".join(
                      f"{name} {ms:.1f} ms ({100 * share:.1f}%)" for name, ms, share in rows)
                  + f" {card}")
    for tag, w in (("base", wall), ("xlarge", xl_wall), ("bs", bs_wall)):
        print(f"[timing] {tag} separation of {seconds} s: {w:.3f} s wall, "
              f"{seconds / w:.2f}x realtime {card}")
    for path, (sec, peak, mb) in train_time.items():
        print(f"[timing] train step, {path} path, micro-batch {mb} x 3 s, dropout 0.1: "
              f"{sec:.3f} s/step, {mb * SEGMENT / SR / sec:.2f} s of audio per s, peak "
              f"{peak / 2**30:.2f} GiB {card}")
    for k, main_shape in (("flash_attention_backward", "small freq"),
                          ("swiglu_ffn_backward", "xlarge freq")):
        for tag, r in results[k].items():
            if not isinstance(r, dict):
                continue
            lib = "" if r["library_ms"] is None else f", library {r['library_ms']:.3f} ms"
            split = "".join(f"; {n} {t:.3f} ms" for n, t in r.get("kernels", {}).items())
            print(f"[timing] {k} {tag} {list(r['shape'])}: kernel {r['ms']:.3f} ms{split}, "
                  f"plain {r['plain_ms']:.3f} ms{lib}, bound {r['bound'][0]:.3f} ms "
                  f"({r['bound'][1]}) {card}")
    r = results["dropout_mask"]
    print(f"[timing] dropout_mask {list(r['shape'])}: kernel {r['ms']:.3f} ms, plain "
          f"{r['plain_ms']:.3f} ms, bound {r['bound'][0]:.3f} ms ({r['bound'][1]}) {card}")
    for mb, (sec, peak) in sorted(xl_train.items()):
        print(f"[timing] xlarge train step, kernel path, micro-batch {mb} x 15 s, remat, "
              f"dropout 0.1: {sec:.2f} s/step (first step), {mb * XL_SEGMENT / SR / sec:.3f} s "
              f"of audio per s, peak {peak / 2**30:.2f} GiB {card}")
    if xl_next_peak:
        print(f"[timing] xlarge train step, micro-batch {max(xl_train) + 1}: predicted peak "
              f"{xl_next_peak / 2**30:.1f} GiB (twice the measured one), not run {card}")
    for tag, (_, w) in unfused_cli.items():
        print(f"[timing] training CLI, {tag} config: first run {w[1]:.1f} s for 2 steps, "
              f"resumed run {w[2]:.1f} s for 2 steps (data, validation, checkpoint included) "
              f"{card}")
    print(f"[timing] training CLI, base config (batch 8 = 4 x 2 x 3 s): first run "
          f"{train_wall[1]:.1f} s for 2 steps, resumed run {train_wall[2]:.1f} s for 2 "
          f"steps (data, validation, checkpoint included) {card}")
    for tag, (w, _) in evaluation.items():
        print(f"[timing] evaluation CLI, {tag} config: 2 tracks of {EVAL_TRACK_S:g} s in "
              f"{w:.1f} s, {2 * EVAL_TRACK_S / w:.2f}x realtime (model load, stems written "
              f"and results.json included; no BSS Eval) {card}")

    # per kernel: the shape its ms, plain_ms and bound_ms are taken at
    fflop, fbytes, _, _ = ffn_work(BATCH * (1 + CHUNK // 512), 1025)
    aflop, abytes, _, _, aexps = attn_work(BATCH * (1 + CHUNK // 512), 1025)
    sources = {
        "stft": ("csrc/stft.cu", "ops/pallas/stft_kernel.py:150", None, None),
        "ffn_step": ("csrc/swiglu_block.cu", "ops/pallas/swiglu_block.py:279",
                     _bound(fflop, fbytes), None),
        "ffn_step_backward": ("csrc/swiglu_block.cu", "ops/pallas/swiglu_block.py:456",
                              None, None),
        "attention_step": ("csrc/attention_block.cu", "ops/pallas/attention_block.py:393",
                           _bound(aflop, abytes, aexps), None),
        "attention_step_backward": ("csrc/attention_block.cu",
                                    "ops/pallas/attention_block.py:626", None, None),
        "flash_attention": ("csrc/flash_attention.cu", "ops/pallas/flash_attention.py:207",
                            None, None),
        "swiglu_ffn": ("csrc/swiglu_ffn.cu", "ops/pallas/swiglu_ffn.py:221", None, None),
        "flash_attention_backward": ("csrc/flash_attention.cu",
                                     "ops/pallas/flash_attention.py:315", None, None),
        "swiglu_ffn_backward": ("csrc/swiglu_ffn.cu", "ops/pallas/swiglu_ffn.py:363",
                                None, None),
        # no Pallas kernel: the JAX package draws these masks in XLA
        "dropout_mask": ("csrc/dropout.cu", "ops/attention.py:52", None, None),
        "istft": ("csrc/stft.cu", "ops/pallas/stft_kernel.py:230", None, None),
        # no Pallas kernel: istft_pallas leaves the overlap-add to XLA
        "istft_overlap_add": ("csrc/stft.cu", "ops/pallas/stft_kernel.py:279", None, None)}
    kernels = []
    for k, (src, tpu, bound, library_ms) in sources.items():
        r = results[k]
        main_path = launches
        if k == "stft":
            b = r["shapes"]["base"]
            ms, plain_ms, bound, library_ms = b["ms"], b["plain_ms"], b["bound"], b["library_ms"]
        elif k in ("ffn_step_backward", "attention_step_backward"):
            ms, plain_ms, bound = r["freq"]["ms"], r["freq"]["plain_ms"], r["freq"]["bound"]
            main_path = train_launches
        elif k in ("flash_attention", "swiglu_ffn"):
            f = r["freq"]
            ms, plain_ms, bound, library_ms = f["ms"], f["plain_ms"], f["bound"], f["library_ms"]
            main_path = xl_launches
        elif k in ("flash_attention_backward", "swiglu_ffn_backward"):
            # #7's main path is small training (dropout 0), #9's xlarge training
            f = r["small freq" if k == "flash_attention_backward" else "xlarge freq"]
            ms, plain_ms, bound, library_ms = f["ms"], f["plain_ms"], f["bound"], f["library_ms"]
            main_path = (unfused_cli["small"][0] if k == "flash_attention_backward"
                         else xl_train_launches)
        elif k == "dropout_mask":
            ms, plain_ms, bound = r["ms"], r["plain_ms"], r["bound"]
            main_path = xl_train_launches
        elif k == "istft":
            # an API of its own: the launches of its phase's calls
            b = r["bs"]
            # torch.istft synchronises: its time is host-inclusive only
            ms, plain_ms, bound = b["ms"], b["plain_ms"], b["bound"]
            library_ms = b["library_host_ms"]
            main_path = {"istft": r["launches"]}
        elif k == "istft_overlap_add":
            b = r["bs"]
            ms, plain_ms, bound = b["ms"], b["plain_ms"], b["bound"]
            main_path = {k: r["launches"]}
        else:
            ms, plain_ms = r["freq"][1:]
        entry = {"name": k, "route": "cuda",
                 "source": f"mss_tf_locoformer_tpu_torch/{src}",
                 "replaces": f"mss_tf_locoformer_tpu/{tpu}",
                 "launches": main_path[k],
                 "max_abs_err": r["err"], "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": bound[0], "library_ms": library_ms,
                 # exponentials are operations, at the special-function rate
                 "bound_by": "bytes" if bound[1] == "bytes" else "operations",
                 "bound_term": bound[1]}
        if k in ("stft", "istft", "istft_overlap_add"):
            # these take microseconds: ms and plain_ms above (and torch.stft's
            # library_ms) are device time, queued behind a spin; the host-
            # inclusive times (CUDA events, the other entries' yardstick)
            # stand beside them, and the whole istft_fused's beside torch.istft
            at = r["shapes"]["base"] if k == "stft" else r["bs"]
            entry.update({f"{p}host_ms": at[f"{p}host_ms"]
                          for p in ("", "plain_", "library_", "istft_") if f"{p}host_ms" in at})
        if k in ("swiglu_ffn", "swiglu_ffn_backward"):
            entry["kernels"] = f["kernels"]   # device ms per call, kernel by kernel
        if main_path is launches:
            entry["launches_training"] = train_launches[k]
            entry["launches_bs"] = bs_launches[k]
        kernels.append(entry)
    print(f"[done] chip_smoke.py took {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:] == ["--profile-xlarge-train"]:
        profile_main()
    else:
        main()
