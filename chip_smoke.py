#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Drives the port (``mss_tf_locoformer_tpu_torch``) at the base config of
``configs/musdb18.yaml`` and the xlarge config of
``configs/musdb18_xlarge.yaml`` (both built here in code: the GPU machine may
have no PyYAML), with seeded random weights, through its main paths: base
serving (the separation CLI), xlarge serving (the separation CLI, through
the unfused route's kernels) and base training (the training CLI).  Phases,
each of which raises on failure (exit code != 0, no result line):

  1. device: require CUDA; print the card's name and power limit;
  2. build: compile the CUDA kernels from ``csrc/`` with nvcc, in parallel;
     gates: the route the step gates give the base config (fused steps)
     and the xlarge config (unfused route), in eval and in training;
  3. kernels: each base forward kernel against its plain PyTorch version at
     the shapes the serving path gives it (one engine batch: 2 chunks of
     8 s);
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
     time of ``scaled_dot_product_attention`` beside flash attention's;
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
     device memory.

It imports nothing of JAX.  The line before the last is a JSON object with
one entry per kernel; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import json
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
    """The route the step gates give the base and xlarge configs (shapes
    only, the same answer on the CPU): the fused steps for base, the unfused
    route for xlarge, in eval and in training."""
    from mss_tf_locoformer_tpu_torch.ops.cuda import SMEM_OPTIN
    from mss_tf_locoformer_tpu_torch.ops.cuda import attention_block as AB
    from mss_tf_locoformer_tpu_torch.ops.cuda import swiglu_block as FB
    for name, cfg, fused in (("base", base_model_config(), True),
                             ("xlarge", xlarge_model_config(), False)):
        c, a, h, k = cfg.emb_dim, cfg.attention_dim, cfg.n_heads, cfg.conv1d_kernel
        for training in (False, True):
            routes = ([FB.supports_step(c, i, k, training) for i in cfg.ffn_hidden_dim]
                      + [AB.supports_block(c, a, h, training)])
            print(f"[gates] {name} (C {c}, H {h}), {'training' if training else 'eval'}: "
                  f"FFN step {FB.step_bytes(c, k, training)} B, attention step "
                  f"{max(AB.launch_bytes(c, a, h, training).values())} B of {SMEM_OPTIN}: "
                  f"fused steps {routes}")
            if routes != [fused] * len(routes):
                raise AssertionError(f"gates: {name} should take the "
                                     f"{'fused' if fused else 'unfused'} route")


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
#  * STFT: both sides fp32; the kernel sums 2048 products in order, cuFFT by
#    butterflies; measured ~2e-6 relative, so 1e-4 leaves room and still
#    catches any wrong bin or frame (those are O(1) relative).
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


def _step_inputs(gen, rows, seq, device):
    import torch
    c, inner, k = 96, 384, 4
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
    from mss_tf_locoformer_tpu_torch.ops.cuda import stft_kernel as SK
    from mss_tf_locoformer_tpu_torch.ops.cuda import swiglu_block as FB
    cfg = base_model_config()
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(SEED)

    audio = _rand(gen, (BATCH, CHUNK), 0.1).to(dev)
    got = SK.stft_fused(audio, cfg.n_fft, cfg.hop_length)
    torch.cuda.synchronize()
    ref = SK.reference_stft(audio, cfg.n_fft, cfg.hop_length)
    err = _compare(f"stft [{BATCH}, {CHUNK}] -> {tuple(ref.shape)}", got, ref, STFT_TOL)
    results["stft"] = dict(err=err, ms=_time_ms(
        lambda: SK.stft_fused(audio, cfg.n_fft, cfg.hop_length)),
        plain_ms=_time_ms(lambda: SK.reference_stft(audio, cfg.n_fft, cfg.hop_length)))

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


def phase_slice_parity(cfg=None):
    import torch
    fused, plain = _model_pair(cfg)
    gen = torch.Generator().manual_seed(SEED + 1)
    mix = _rand(gen, (1, SR), 0.1).to(fused.deconv.weight.device)
    with torch.inference_mode():
        a = fused(mix)
        torch.cuda.synchronize()
        b = plain(mix)
        blocks, plain.blocks = plain.blocks, torch.nn.ModuleList()
        skipped = plain(mix)
        plain.blocks = blocks
    worst, least_skip = 0.0, float("inf")
    for name in a:
        if a[name].shape != (1, SR) or not torch.isfinite(a[name]).all():
            raise AssertionError(f"slice parity: stem {name} is not finite [1, {SR}]")
        rel = ((a[name] - b[name]).norm() / b[name].norm()).item()
        skip = ((skipped[name] - b[name]).norm() / b[name].norm()).item()
        worst, least_skip = max(worst, rel), min(least_skip, skip)
        print(f"[parity] {name}: relative L2 {rel:.3e} (bound {SLICE_REL_L2:g}); "
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
    the first run, then the wall time of a second."""
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
        print(f"[slice] {path}: {audio.shape[0]} x {audio.shape[1]} at {sr} Hz, "
              f"peak {np.abs(audio).max():.3f}")

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
    mix = _rand(torch.Generator().manual_seed(SEED + 2), (BATCH, CHUNK), 0.1).to(
        models["kernel"].deconv.weight.device)
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
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from mss_tf_locoformer_tpu_torch.core.precision import BF16
    from mss_tf_locoformer_tpu_torch.models import build_model
    model = build_model(cfg or base_model_config(), BF16,
                        torch.Generator().manual_seed(SEED)).to("cuda").eval()
    mix = _rand(torch.Generator().manual_seed(SEED + 2), (BATCH, CHUNK), 0.1).to("cuda")
    with torch.inference_mode():
        model(mix)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model(mix)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    device = [(e.key, e.self_device_time_total / 1e3) for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    del model, mix
    torch.cuda.empty_cache()
    total = sum(ms for _, ms in device)
    if not total:
        print("[profile] the profiler saw no device activity")
        return None
    device.sort(key=lambda kv: -kv[1])
    short = lambda name: name.replace("void ", "").replace("(anonymous namespace)::", "")[:60]
    rows = [(short(name), ms, ms / total) for name, ms in device[:top]]
    gemm = sum(ms for name, ms in device
               if any(tag in name.lower() for tag in ("gemm", "nvjet", "xmma", "cutlass")))
    rows.append(("all library matrix products (cuBLAS/cuDNN)", gemm, gemm / total))
    return total / (1e3 * wall), rows


# ------------------------------------------------------------ xlarge


def flash_work(r, h, l, d):
    """(FLOP, bytes) of one flash-attention call: QK^T and PV at the true
    head_dim; q, k and v read and o written once, bf16."""
    return 4.0 * r * h * l * l * d, 4 * r * h * l * d * 2.0


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
        plain_ms = _time_ms(lambda: SF.reference_swiglu_conv_deconv(x, *w, k), iters=2)
        r = results.setdefault("swiglu_ffn", dict(err=0.0))
        r["err"] = max(r["err"], err)
        r[path] = dict(shape=(rows, lin, c), ms=ms, plain_ms=plain_ms, library_ms=None,
                       bound=_bound(*ffn_core_work(rows, seq, c, inner, k)))
        del x, w
        torch.cuda.empty_cache()


# ------------------------------------------------------------ training

# H100 SXM peaks (NVIDIA's data sheet, dense), for the bounds of the
# kernels: bf16 tensor cores, fp32 outside them, device memory.
PEAK_BF16, PEAK_FP32, HBM_RATE = 989e12, 67e12, 3.35e12
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


def _bound(flop: float, nbytes: float, peak: float = PEAK_BF16):
    """(least ms, what bounds it) for ``flop`` at ``peak`` and ``nbytes``
    moved once at the device memory rate."""
    t_op, t_b = flop / peak, nbytes / HBM_RATE
    return 1e3 * max(t_op, t_b), ("operations" if t_op >= t_b else "bytes")


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
    """(forward FLOP, forward bytes, backward FLOP, backward bytes) of one
    attention step at the true head_dim: QK^T and PV forward; dP, dS K,
    dS^T Q and P^T dO backward; the projections' products; the backward
    reads the stashed q, k, v, o and log-sum-exp."""
    d = a // h
    core = 2.0 * 2 * r * h * l * l * d
    proj = 2.0 * r * l * c * 3 * a + 2.0 * r * l * a * c
    w = 4.0 * a * c * 4
    rows = r * l * c * 2.0
    stash = r * l * (4 * a * 2.0 + 4 * h)
    return core + proj, 2 * rows + w, 2 * core + 2 * proj, 3 * rows + stash + 2 * w


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
            fflop, fbytes, bflop, bbytes = work()
            r = results.setdefault(name + "_backward", dict(err=0.0, rel_l2=0.0))
            r["err"] = max(r["err"], gerr)
            r["rel_l2"] = max(r["rel_l2"], grel)
            r[path] = dict(rows=rows, seq=seq, fwd_ms=kf, ms=kb, plain_fwd_ms=pf, plain_ms=pb,
                           bound=_bound(bflop, bbytes), fwd_bound=_bound(fflop, fbytes))
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
    from mss_tf_locoformer_tpu_torch.ops.cuda import attention_block as AB
    from mss_tf_locoformer_tpu_torch.ops.cuda import flash_attention as FA
    from mss_tf_locoformer_tpu_torch.ops.cuda import stft_kernel as SK
    from mss_tf_locoformer_tpu_torch.ops.cuda import swiglu_block as FB
    from mss_tf_locoformer_tpu_torch.ops.cuda import swiglu_ffn as SF
    return {"stft": SK.stft_fused, "ffn_step": FB.fused_norm_ffn_residual,
            "attention_step": AB.fused_attention_block,
            "ffn_step_backward": FB.ffn_step_backward,
            "attention_step_backward": AB.attention_step_backward,
            "flash_attention": FA.flash_attention, "swiglu_ffn": SF.swiglu_conv_deconv}


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


def _plain_micro_batch(cfg) -> tuple:
    """Micro-batch of the plain path's timed step: 2 if the tensors its
    attention keeps for the backward (fp32 and bf16 probabilities and the
    boolean mask, 7 bytes per score, every layer) leave room in 80 GB, else 1."""
    est = {}
    for m in (2, 1):
        n_frames = 1 + SEGMENT // cfg.hop_length
        per = (m * n_frames * cfg.n_freqs ** 2 + m * cfg.n_freqs * n_frames ** 2)
        est[m] = 7.0 * cfg.n_heads * cfg.n_layers * per
    return (2 if est[2] < 60e9 else 1), est


def phase_train_timing(reps: int = 1):
    """One optimizer step (AdamW, clip 5, dropout 0.1) on one micro-batch of
    3 s segments, kernel path at micro-batch 2 against plain path, in turns
    (plain, kernel, kernel, plain), after a warm-up step of each (its peak
    device memory kept)."""
    import torch
    from mss_tf_locoformer_tpu_torch.core.config import LossConfig, TrainingConfig
    from mss_tf_locoformer_tpu_torch.train.state import make_optimizer
    from mss_tf_locoformer_tpu_torch.train.step import train_step
    cfg = base_model_config()
    models = dict(zip(("kernel", "plain"), _train_models()))
    mb_plain, est = _plain_micro_batch(cfg)
    print(f"[train-timing] plain path at micro-batch {mb_plain} (its attention keeps "
          f"~{est[2] / 1e9:.0f} GB for the backward at micro-batch 2, "
          f"~{est[1] / 1e9:.0f} GB at 1)")
    mbs = {"kernel": TRAIN_MB, "plain": mb_plain}
    dev = models["kernel"].deconv.weight.device
    gen = torch.Generator().manual_seed(SEED + 5)
    batches = {p: _batch(gen, mbs[p], SEGMENT, dev) for p in models}
    opts = {p: make_optimizer(m.parameters(), TrainingConfig()) for p, m in models.items()}
    gens = {p: torch.Generator().manual_seed(11) for p in models}

    def step(path):
        mix, tg = batches[path]
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
    out = {p: (sum(t) / len(t), peak[p], mbs[p]) for p, t in times.items()}
    del models, opts, batches
    torch.cuda.empty_cache()
    return out


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
    phase_slice_parity()
    with tempfile.TemporaryDirectory() as workdir:
        launches, wall, seconds = phase_slice(workdir)
    # the fused steps and nothing else: 2 forwards (3 chunks in batches of 2)
    _check_launches("slice", launches, {"stft": 2, "ffn_step": 32, "attention_step": 16})
    forward = phase_forward()

    xl = xlarge_model_config()
    phase_xlarge_kernels(results)
    phase_slice_parity(xl)
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

    card = f"({smi})"
    print(f"[timing] stft [{BATCH}, {CHUNK}]: kernel {results['stft']['ms']:.3f} ms, "
          f"plain {results['stft']['plain_ms']:.3f} ms {card}")
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
        for path in ("freq", "time"):
            r = results[k][path]
            lib = "" if r["library_ms"] is None else f", library {r['library_ms']:.3f} ms"
            print(f"[timing] xlarge {k} {path} {list(r['shape'])}: kernel {r['ms']:.3f} ms, "
                  f"plain {r['plain_ms']:.3f} ms{lib}, bound {r['bound'][0]:.3f} ms "
                  f"({r['bound'][1]}) {card}")
    audio_s = BATCH * CHUNK / SR
    for tag, fwd in (("base", forward), ("xlarge", xl_forward)):
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
    for tag, w in (("base", wall), ("xlarge", xl_wall)):
        print(f"[timing] {tag} separation of {seconds} s: {w:.3f} s wall, "
              f"{seconds / w:.2f}x realtime {card}")
    for path, (sec, peak, mb) in train_time.items():
        print(f"[timing] train step, {path} path, micro-batch {mb} x 3 s, dropout 0.1: "
              f"{sec:.3f} s/step, {mb * SEGMENT / SR / sec:.2f} s of audio per s, peak "
              f"{peak / 2**30:.2f} GiB {card}")
    print(f"[timing] training CLI, base config (batch 8 = 4 x 2 x 3 s): first run "
          f"{train_wall[1]:.1f} s for 2 steps, resumed run {train_wall[2]:.1f} s for 2 "
          f"steps (data, validation, checkpoint included) {card}")

    # per kernel: the shape its ms, plain_ms and bound_ms are taken at
    fflop, fbytes, _, _ = ffn_work(BATCH * (1 + CHUNK // 512), 1025)
    aflop, abytes, _, _ = attn_work(BATCH * (1 + CHUNK // 512), 1025)
    n_bins, n_frames = 1025, 1 + CHUNK // 512
    sbytes = BATCH * CHUNK * 4 + BATCH * n_bins * n_frames * 8
    sflop = BATCH * n_frames * 5 * 2048 * 11   # an FFT's work per frame
    stft_bound = _bound(sflop, sbytes, PEAK_FP32)
    sources = {
        "stft": ("csrc/stft.cu", "ops/pallas/stft_kernel.py:150", stft_bound,
                 results["stft"]["plain_ms"]),
        "ffn_step": ("csrc/swiglu_block.cu", "ops/pallas/swiglu_block.py:279",
                     _bound(fflop, fbytes), None),
        "ffn_step_backward": ("csrc/swiglu_block.cu", "ops/pallas/swiglu_block.py:456",
                              None, None),
        "attention_step": ("csrc/attention_block.cu", "ops/pallas/attention_block.py:393",
                           _bound(aflop, abytes), None),
        "attention_step_backward": ("csrc/attention_block.cu",
                                    "ops/pallas/attention_block.py:626", None, None),
        "flash_attention": ("csrc/flash_attention.cu", "ops/pallas/flash_attention.py:207",
                            None, None),
        "swiglu_ffn": ("csrc/swiglu_ffn.cu", "ops/pallas/swiglu_ffn.py:221", None, None)}
    kernels = []
    for k, (src, tpu, bound, library_ms) in sources.items():
        r = results[k]
        main_path = launches
        if k == "stft":
            ms, plain_ms = r["ms"], r["plain_ms"]
        elif k.endswith("_backward"):
            ms, plain_ms, bound = r["freq"]["ms"], r["freq"]["plain_ms"], r["freq"]["bound"]
            main_path = train_launches
        elif k in ("flash_attention", "swiglu_ffn"):
            f = r["freq"]
            ms, plain_ms, bound, library_ms = f["ms"], f["plain_ms"], f["bound"], f["library_ms"]
            main_path = xl_launches
        else:
            ms, plain_ms = r["freq"][1:]
        entry = {"name": k, "route": "cuda",
                 "source": f"mss_tf_locoformer_tpu_torch/{src}",
                 "replaces": f"mss_tf_locoformer_tpu/{tpu}",
                 "launches": main_path[k],
                 "max_abs_err": r["err"], "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": bound[0], "bound_by": bound[1], "library_ms": library_ms}
        if main_path is launches:
            entry["launches_training"] = train_launches[k]
        kernels.append(entry)
    print(f"[done] chip_smoke.py took {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
