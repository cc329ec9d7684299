#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Drives the port (``mss_tf_locoformer_tpu_torch``) at the base config of
``configs/musdb18.yaml``, the xlarge config of ``configs/musdb18_xlarge.yaml``,
the small config of ``configs/musdb18_small.yaml`` and the BS-Locoformer
config of ``configs/musdb18_bslocoformer.yaml`` and the speech configs of
``configs/speech_*.yaml`` (all built here in code: the GPU machine may have
no PyYAML), with seeded random weights, through its main paths: base
serving (the separation CLI), xlarge serving (the separation CLI, through
the unfused route's kernels), base training (the training CLI), training
through the unfused route (xlarge and small), BS-Locoformer stereo serving
(the separation CLI), evaluation (the evaluation CLI, base and
BS-Locoformer), speech serving, training and evaluation (the speech CLIs)
and BS-Locoformer training (the training CLI); at fp32, xlarge serving
and small training through the unfused route's fp32 kernels.  Phases,
each of which raises on failure (exit code != 0, no result line):

  1. device: require CUDA; print the card's name and power limit;
  2. build: compile the CUDA kernels from ``csrc/`` with nvcc, in parallel;
     gates: the route the step gates give the base config (fused steps)
     and the xlarge config (unfused route), in eval and in training, and
     which flash-attention kernels the unfused route's shapes take (the
     resident forward everywhere; the one-pass resident backward at the
     small config, the streaming one at xlarge), the FFN step's Hopper
     kernels at the base and BS-Locoformer widths (C 96, 128) with #5's
     row groups at the base training shapes, which FFN-core kernels (the
     Hopper kernels at xlarge's C 256, with #9's row groups, splits and
     scratch; the mma.sync kernels at the small config's C 48), and which
     attention-step core each fused shape takes (resident k and v at every
     shipped shape, streaming beyond L 1808);
  3. kernels: each base forward kernel against its plain PyTorch version at
     the shapes the serving path gives it (one engine batch: 2 chunks of
     8 s); the STFT (#1) timed beside ``torch.stft``, in device time and
     with the host's time; #3 kernel by kernel (``torch.profiler``) and
     beside ``scaled_dot_product_attention`` on q, k, v of its shape (the
     core alone: no one PyTorch call computes the whole step);
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
     dropout 0, and at dropout 0.1 on a 16-row slice (#5's slice again in
     as many row groups as the full shape runs); timed, #3, #4 and #5
     kernel by kernel (``torch.profiler``), #4 and #5 run twice at dropout
     0.1 for the same bits, #4 beside SDPA's autograd backward; #3 and #4
     at ``[16, 1900, 96]``, beyond the resident core, at dropout 0 and 0.1;
  8. training: the training CLI on a synthetic MUSDB tree (16 train tracks
     of 4 s, 2 test tracks), base model and training sections (batch 8 as 4
     micro-batches of 2 x 3 s, bf16, dropout 0.1, AdamW, clip 5): one epoch
     of 2 optimizer steps, validation and a checkpoint, then ``--resume``
     for one more epoch; launch counters, gradients and the checkpoint
     (through the separation CLI) checked; the first run's
     ``profile_steps: 1`` must leave a ``torch.profiler`` trace with device
     kernels; then the MFU of the base forward and train step at the
     H100's dense bf16 peak (``utils/flops.py::device_peak_flops``);
  9. train-step parity: the kernel path against the plain path, same
     weights, batch and dropout seeds (1 x 1 s, dropout 0.1);
 10. train-step timing in turns (plain, kernel, kernel, plain), with peak
     device memory (the kernel path's no higher than BASE_TRAIN_PEAK_GIB);
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
     route's score;
 18. speech gates: the speech configs (wsj0-2mix, WHAMR, DNS) take the fused
     steps in eval and in training, the Hopper FFN-step kernels and the
     resident attention core at every speech shape;
 19. speech kernels: #2 and #3 against their plain versions at speech
     serving shapes (8 s at 8 kHz, n_fft 128: [1001, 65, 128] / [65, 1001,
     128]; 8 s of DNS at 16 kHz, n_fft 256: [1001, 129, 128] / [129, 1001,
     128]), #3 with its stash, #4 and #5 against autograd through the plain
     versions in fp32 at the wsj0-2mix and WHAMR (I 192, k 8) training
     shapes (batch 4 x 4 s: [2004, 65, 128] / [260, 501, 128]), dropout 0
     as the speech configs; timed beside the plain versions and the bounds;
 20. speech slice parity: the wsj0-2mix separator (6 layers) through STFT
     and iSTFT on 4 s, kernel path against plain path per speaker,
     rejecting the blocks-skipped model, 24 FFN and 12 attention steps per
     forward exactly;
 21. speech serving: the speech separation CLI (fp32 blocks, its default)
     on three 8 kHz WAVs (3.3, 5 and 9.7 s) and a FLAC written by
     ``tests/flac_writer.py`` (read back exactly through the port's native
     decoder), 2 WAVs of the input's length each, exact launches of the
     fp32 step kernels, every stem against the plain route's CLI run; the
     realtime factor of a second run of the WAVs;
 22. speech training: the speech training CLI with the wsj0-2mix sections
     (batch 4 x 4 s, bf16, PIT SI-SNR; 2 steps, validation, checkpoint,
     then ``--resume``) and with the DNS sections (one source, 16 kHz,
     n_fft 256, fixed-order ``mr_l1_tfd``), exact forward and backward
     launches, finite gradients, the first run's ``profile_steps: 2``
     trace; a train step of each timed in turns with the plain path, with
     its peak device memory;
 23. speech evaluation: the speech evaluation CLI (fp32) on 2 utterances,
     kernel route against plain route (estimates within 1e-4 of the peak
     and by SI-SNR, scores within 1 dB), ``results.json`` checked, exact
     launches;
 24. BS-Locoformer training: train-step parity (1 x 1 s stereo, dropout
     0.1, the kernel path against the plain path in fp32, per parameter
     group, rejecting the blocks-skipped model); the training CLI on the
     synthetic MUSDB tree (stereo, 4 micro-batches of 2 x 3 s a step, 2
     steps, validation, then ``--resume``) with exact launches; a micro-
     batch step timed in turns with the plain path, with its peak;
 25. the partial-sum mode (``residual=False``) of #2-#5, the tensor-parallel
     steps': each shard of the base config's steps at mp 2 and 4 at the base
     training shapes, summed with the bias and the residual outside, against
     the whole kernel and the plain version; one shard at dropout 0.1
     against its plain version (mask replay, keep rates); shards timed
     beside the whole step;
 26. parallel runs, two ranks sharing cuda:0 over gloo (each rank a
     ``chip_smoke.py --rank`` process under a timeout): base training at
     mesh dp 2 and mp 2 against one process (losses, grad_norm, exact
     launches per rank, step time), the 2-rank evaluation CLI's
     ``results.json`` against one rank's, and the training CLI under a
     world-1 NCCL process group;
 27. fp32 rows of #2-#5 (``csrc/step_fp32.cu``; #2/#5's GEMMs on the
     3xTF32 kernels of ``csrc/ffn_core_fp32.cu``, #3/#4's attention core
     on those of ``csrc/attn_fp32.cu``; run with the speech phases): the
     fp32 gates at the base, BS and speech widths (the layouts' bytes
     against the compiled kernels' count; no FFMA attention kernel left in
     ``step_fp32.cu``'s library); #2 and #3 against their fp32 plain
     versions (#2/#5 within 1e-5) at the speech serving shapes (wsj0-2mix
     and DNS), with the stash and #5 and #4 at the wsj0-2mix training
     shapes (dropout 0), the base training shapes (dropout 0.1, keep rates
     printed) and shard 0 of mp 2 in the partial-sum mode; exact fp32
     launches, two backward runs bit-equal, each call's launches by CUDA
     events (#2/#5: 3xTF32 GEMMs, no FFMA GEMM; #3/#4: the 3xTF32 core
     among them), timed beside the bf16 kernels and the bounds (3xTF32,
     FFMA beside); the wsj0-2mix separator at fp32 against its plain path
     (1e-4); a ``use_amp: false`` step of the base and the wsj0-2mix
     configs, kernel path against plain path (loss and grad_norm within
     1e-4), and timed at the full batch;
 28. fp32 rows of #6-#9 (``ops/cuda/unfused_fp32.py``: flash attention on
     ``csrc/step_fp32.cu``'s RoPE split and the 3xTF32 core of
     ``csrc/attn_fp32.cu``, the FFN core's products on the 3xTF32 GEMMs of
     ``csrc/ffn_core_fp32.cu``): the fp32 gates (the flash and FFN-core
     launches' bytes against the compiled kernels' count; the xlarge and
     small configs' fp32 blocks on the unfused route's kernels); #6 and #8
     against their fp32 plain versions at the xlarge engine batch's shapes,
     #6 with its stash, #7, #8 and #9 at the small training shapes, #9 at
     the xlarge training shapes (a 64-row slice, also in row groups; the
     whole shape twice for the same bits), exact fp32 launches, each
     call's kernels by CUDA events (#6/#7: the RoPE split and the 3xTF32
     core; #8/#9: 3xTF32 GEMMs, no FFMA GEMM), timed beside the plain
     versions, the bf16 kernels, the bounds (3xTF32, fp32 FFMA beside) and
     SDPA on fp32 q, k, v;
     the xlarge separation CLI at ``--precision fp32`` on one engine batch
     (15 s) at full depth (launches, realtime factor, peak memory), and at
     2 layers on the kernel and the plain route (stems within 1e-4 of the
     peak); ``use_amp: false`` steps of the small config (#6-#9) and of an
     xlarge micro-batch (1 x 3 s, 2 layers, remat, dropout 0.1: #8, #9)
     against the plain path (loss and grad_norm within 1e-4), with their
     peak memory; the small config's training CLI at ``use_amp: false``.

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
# The device of the model pairs and of the speech and BS-training phases; a
# CPU rehearsal of them at a tiny size sets "cpu"
DEV = "cuda"


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
    # the fused FFN step's kernels: the Hopper ones (wgmma) at C 96 and 128,
    # with #5's row groups at the base training shapes
    for name, c in (("base", 96), ("bs", 128)):
        if not FB.hopper_route(c):
            raise AssertionError(f"gates: the FFN step of {name} should take the Hopper kernels")
        print(f"[gates] FFN step {name} (C {c}): Hopper kernels ffn_step_wg_kernel / "
              f"ffn_step_dx_wg_kernel + ffn_wgrad_gemm_kernel, {FB.wg_step_bytes(c)} B")
    for path, rows, seq in _train_steps(base_model_config()):
        plan = FB.wg_step_plan(rows, seq, 96, 384, 4)
        print(f"[gates] FFN step backward, base training {path} [{rows}, {seq}, 96]: "
              f"{plan['groups']} row groups of {plan['rows']}, {plan['splits']} splits, scratch "
              f"{plan['scratch_bytes'] / 2**20:.1f} MiB of {FB.SCRATCH_CAP / 2**20:.0f}, "
              f"partials {plan['partial_bytes'] / 2**20:.1f} MiB")
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
    # the fused attention step's core: k and v resident at every shipped
    # shape; the streaming core beyond L 1808
    base, bs = base_model_config(), bs_model_config()
    for name, shapes in (("base serving", _main_path_steps(base)),
                         ("base training", _train_steps(base)),
                         ("bs serving", _bs_main_path_steps(bs)),
                         ("beyond the resident gate", [("stream", *ATTN_STREAM_SHAPE[:2])])):
        for path, rows, seq in shapes:
            res = AB.core_resident(seq)
            print(f"[gates] attention step {name} {path} [{rows}, {seq}]: "
                  f"{'resident' if res else 'streaming'} core "
                  f"({AB.core_resident_bytes(seq) or AB.launch_bytes(96, 96, 4)['core']} B)")
            if res != (path != "stream"):
                raise AssertionError(f"gates: attention step {name} {path} should take the "
                                     f"{'resident' if path != 'stream' else 'streaming'} core")
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


def _step_inputs(gen, rows, seq, device, c=96, inner=384, k=4):
    import torch
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
        r = results.setdefault("attention_step", dict(err=0.0, kernels={}, core_library_ms={}))
        r["err"] = max(r["err"], err)
        call = lambda: AB.fused_attention_block(x, gamma, *attn, *aargs)
        r[path] = (rows, _time_ms(call),
                   _time_ms(lambda: AB.reference_attention_block(x, gamma, *attn, *aargs),
                            iters=3))
        r["kernels"][path] = _kernel_device_ms(call, "attn_")
        del x, ffn, attn, got, ref
        torch.cuda.empty_cache()
        r["core_library_ms"][path] = _sdpa_core_ms(rows, seq, cfg.n_heads, 96 // cfg.n_heads)
        print(f"[kernels] attention_step {path}: kernels {r['kernels'][path]}; SDPA on the "
              f"core alone {r['core_library_ms'][path]:.3f} ms")
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


def _model_pair(cfg=None, precision=None):
    """The model (the base config by default; bf16 blocks unless
    ``precision`` says otherwise) on the card twice, on the same seeded
    weights: with its kernels, and with every kernel replaced by its plain
    version."""
    import torch
    from mss_tf_locoformer_tpu_torch.core.precision import BF16
    from mss_tf_locoformer_tpu_torch.models import build_model
    cfg = cfg or base_model_config()
    precision = precision or BF16
    fused = build_model(cfg, precision, torch.Generator().manual_seed(SEED)).to(DEV).eval()
    plain = build_model(_plain_config(cfg), precision).to(DEV).eval()
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


_T0 = time.perf_counter()


def _mark(tag):
    """How far into the run a phase ended (the smoke test is meant to end
    well within 1200 s)."""
    print(f"[progress] {tag} done at {time.perf_counter() - _T0:.1f} s", flush=True)


def _check_launches(tag, launches, need, quiet=False):
    """Launch counts of a run against the exact counts ``need`` (every
    counter not named must be 0); ``quiet`` prints the counters that should
    or did launch only."""
    for name, got in launches.items():
        want = need.get(name, 0)
        if not quiet or got or want:
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


def flash_work(r, h, l, d, row_bytes=2):
    """(FLOP, bytes, exponentials) of one flash-attention call: QK^T and PV
    at the true head_dim; q, k and v read and o written once, ``row_bytes``
    an element (bf16 by default); one exponential per score."""
    return 4.0 * r * h * l * l * d, 4 * r * h * l * d * float(row_bytes), float(r * h * l * l)


def ffn_core_work(r, l, c, inner, k, row_bytes=2):
    """(FLOP, bytes) of one FFN-core call on rows padded to L + 2(k-1): both
    products over the L + k - 1 conv positions; x read and the output
    written once and the weight panels read once, ``row_bytes`` an element
    (bf16 by default), the fp32 biases once."""
    lin, l1 = l + 2 * (k - 1), l + k - 1
    return (6.0 * r * l1 * k * c * inner,
            2 * r * lin * c * float(row_bytes) + 3 * inner * c * k * float(row_bytes)
            + (2 * inner + c) * 4.0)


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
# TF32 tensor cores (dense): the fp32 rows of #2/#5 and #8/#9 and of the
# attention core (#6/#7, and #3/#4 whose projections stay FFMA) run their
# products there in three passes (3xTF32), so their bound is 3 x FLOP at
# this rate (0.41x the FFMA bound at PEAK_FP32, printed beside it)
PEAK_TF32 = 494.7e12
TF32_PASSES = 3
# Exponentials on the special-function units: 16 per SM per clock x 132 SMs
# x 1.83 GHz, "989 TFLOPS of FP16 matmul but only 3.9 TFLOPS of special
# functions" (FlashAttention-3, Shah et al. 2024, section 1).  A softmax
# needs one per score, so at small head_dim they, not the products, bound it.
SFU_RATE = 3.9e12
SEGMENT = 132300     # 3 s training segments (configs/musdb18.yaml)
TRAIN_MB = 2         # micro-batch of the base config (batch 8 = 4 x 2)
# An attention step beyond the resident core's gate (L > 1808): a time path
# with a longer --chunk_seconds gets there; the streaming core takes it
ATTN_STREAM_SHAPE = (16, 1900, 96)
# Gradient bounds.  Weight and gamma gradients are sums over ~5e5
# positions whose summands the kernels take from bf16-rounded operands (xn,
# the SwiGLU output, dy, P, dS, as the TPU kernels do); the rounding errors
# are independent, so the sums' relative L2 error stays near the bf16 step
# (2^-9) and 2e-2 leaves a factor of ~10.  The train step's gradients
# (kernel path against plain path, both bf16, rounding at different places
# through 4 blocks forward and back) get 1e-1, the loss 2e-2.
GRAD_REL_L2, STEP_GRAD_REL_L2, STEP_LOSS_REL = 2e-2, 1e-1, 2e-2


def _bound(flop: float, nbytes: float, exps: float = 0.0, peak: float = PEAK_BF16,
           passes: int = 1):
    """(least ms, what bounds it) for ``flop`` at ``peak`` (``passes`` times
    over: 3xTF32 runs each product three times), ``nbytes`` moved once at
    the device memory rate and ``exps`` exponentials at the special-function
    rate: "operations", "bytes" or "exponentials"."""
    terms = {"operations": passes * flop / peak, "bytes": nbytes / HBM_RATE,
             "exponentials": exps / SFU_RATE}
    by = max(terms, key=terms.get)
    return 1e3 * terms[by], by


def ffn_work(r, l, c=96, inner=384, k=4, row_bytes=2):
    """(forward FLOP, forward bytes, backward FLOP, backward bytes) of one
    FFN step on rows of ``row_bytes`` an element: the conv has L+k-1
    outputs, the cropped deconv L; the backward recomputes the conv and
    takes both products' two adjoints."""
    conv = 2.0 * r * (l + k - 1) * k * c * 2 * inner
    deconv = 2.0 * r * l * k * inner * c
    w = (3 * inner * c * k + 2 * inner + c) * 4.0
    rows = r * l * c * float(row_bytes)
    return conv + deconv, 2 * rows + w, 3 * conv + 2 * deconv, 3 * rows + 2 * w


def attn_work(r, l, c=96, a=96, h=4, row_bytes=2):
    """(forward FLOP, forward bytes, backward FLOP, backward bytes,
    exponentials) of one attention step at the true head_dim on rows of
    ``row_bytes`` an element: QK^T and PV forward; dP, dS K, dS^T Q and P^T
    dO backward; the projections' products; the backward reads the stashed
    q, k, v, o (rows' width) and log-sum-exp; one exponential per score each
    way (the backward recomputes P)."""
    d = a // h
    core = 2.0 * 2 * r * h * l * l * d
    proj = 2.0 * r * l * c * 3 * a + 2.0 * r * l * a * c
    w = 4.0 * a * c * 4
    rows = r * l * c * float(row_bytes)
    stash = r * l * (4 * a * float(row_bytes) + 4 * h)
    return (core + proj, 2 * rows + w, 2 * core + 2 * proj, 3 * rows + stash + 2 * w,
            float(r * h * l * l))


def _train_steps(cfg):
    """(path, rows, sequence) of the steps in one training micro-batch."""
    n_frames = 1 + SEGMENT // cfg.hop_length
    return (("freq", TRAIN_MB * n_frames, cfg.n_freqs),
            ("time", TRAIN_MB * cfg.n_freqs, n_frames))


def _sdpa_core_ms(rows, seq, h, d, backward=False, iters=5) -> float:
    """``scaled_dot_product_attention`` on random bf16 q, k, v ``[rows, h,
    seq, d]`` at dropout 0 (or, with ``backward``, its autograd backward):
    the attention core alone, the nearest one PyTorch call comes to an
    attention step (none computes the norm, projections and residual)."""
    import torch
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    q, k, v = (torch.randn(rows, h, seq, d, generator=gen, device="cuda",
                           dtype=torch.bfloat16).requires_grad_(backward) for _ in range(3))
    if not backward:
        return _time_ms(lambda: F.scaled_dot_product_attention(q, k, v), iters)
    o = F.scaled_dot_product_attention(q, k, v)
    go = torch.randn_like(o)
    return _time_ms(lambda: torch.autograd.grad(o, [q, k, v], go, retain_graph=True), iters)


def _rel_l2(got, ref) -> float:
    ref = ref.float()
    return ((got.float() - ref).norm() / ref.norm()).item()


def _check_grads(name, got, ref, g, tol=STEP_TOL, rel_bound=GRAD_REL_L2):
    """dx against ``tol x max|ref|`` (the cotangent alone, what a kernel
    that only passed the residual through would give, must fail; ``g`` None
    in the partial-sum mode, which has no residual); the other gradients by
    relative L2 within ``rel_bound`` (an all-zero gradient gives 1.0)."""
    dx_err = _compare(f"{name} dx", got[0], ref[0], tol, null=g)
    worst = 0.0
    for i, (a, b) in enumerate(zip(got[1:], ref[1:]), 1):
        if not torch_isfinite(a):
            raise AssertionError(f"{name}: gradient {i} is not finite")
        rel = _rel_l2(a, b)
        worst = max(worst, rel)
        if not rel <= rel_bound:
            raise AssertionError(f"{name}: gradient {i} relative L2 {rel:.3e} "
                                 f"above {rel_bound:g}")
    print(f"[train-kernels] {name}: weight/gamma gradients relative L2 <= "
          f"{worst:.3e} (bound {rel_bound:g})")
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
            if name == "ffn_step" and FB.hopper_route(96):
                # the slice again in as many row groups as the full shape runs
                # (a scratch cap of that many rows), so that the partials'
                # accumulation across groups, each group's row offset and
                # its dropout rows are held too
                groups = FB.wg_step_plan(rows, seq, 96, 384, cfg.conv1d_kernel)["groups"]
                per_row = FB.wg_step_plan(1, seq, 96, 384, cfg.conv1d_kernel)["scratch_bytes"]
                cap = per_row * -(-16 // groups)
                grouped = FB.ffn_step_backward(gs, xs, *params[:4], *dargs, scratch_cap=cap)
                _check_grads(f"{name} {path} rows {r0}..{r0 + 16}, dropout 0.1, in "
                             f"{FB.wg_step_plan(16, seq, 96, 384, 4, cap)['groups']} row groups",
                             grouped, ref, gs)
                del grouped
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
            if name == "ffn_step":
                # #5 kernel by kernel (device time, torch.profiler), and no
                # atomics: a second run gives the same bits
                call = lambda: FB.ffn_step_backward(g, x, *params[:4], *args, 0.1, 777)
                r[path]["kernels"] = _kernel_device_ms(
                    call, "(?:ffn_|wgrad_|reduce_)",
                    ffn_step_bwd_launches(FB, rows, seq, 96, 384, cfg.conv1d_kernel))
                first, again = call(), call()
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(first, again)):
                    raise AssertionError(f"ffn_step_backward {path}: two runs differ")
                print(f"[train-kernels] ffn_step_backward {path}: two runs bit-equal "
                      f"(dropout 0.1); kernels {r[path]['kernels']}")
                del first, again
            else:
                # #3 (with the stash) and #4 kernel by kernel (device time,
                # torch.profiler), #4 beside SDPA's backward on the core
                # alone, and no atomics: a second run gives the same bits
                dargs = args + (0.1, 777, 0)
                fwd = lambda: AB.attention_step_forward(x, *params, *dargs, stash=True)
                r[path]["fwd_kernels"] = _kernel_device_ms(fwd, "attn_")
                _, stash = fwd()
                call = lambda: AB.attention_step_backward(g, x, *params, stash, *dargs)
                r[path]["kernels"] = _kernel_device_ms(call, "(?:attn_|wgrad_|reduce_)",
                                                       attn_bwd_launches(AB))
                first, again = call(), call()
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(first, again)):
                    raise AssertionError(f"attention_step_backward {path}: two runs differ")
                del first, again, stash
                torch.cuda.empty_cache()
                r[path]["core_library_ms"] = _sdpa_core_ms(rows, seq, cfg.n_heads,
                                                           96 // cfg.n_heads, backward=True)
                print(f"[train-kernels] attention_step_backward {path}: two runs bit-equal "
                      f"(dropout 0.1); forward kernels {r[path]['fwd_kernels']}; backward "
                      f"kernels {r[path]['kernels']}; SDPA's backward on the core alone "
                      f"{r[path]['core_library_ms']:.3f} ms")
            torch.cuda.empty_cache()
        del x, g, ffn, attn
        torch.cuda.empty_cache()


def phase_attention_stream(results):
    """#3 and #4 at ``ATTN_STREAM_SHAPE``, beyond the resident core's gate
    (the streaming core), forward and backward against autograd through
    the plain version in fp32 on the same bf16 inputs, at dropout 0 and
    0.1 (rows offset by 5); timed at 0.1."""
    import torch
    from mss_tf_locoformer_tpu_torch.ops.cuda import attention_block as AB
    cfg = base_model_config()
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(SEED + 4)
    rows, seq, c = ATTN_STREAM_SHAPE
    if AB.core_resident(seq):
        raise AssertionError(f"attention step at L {seq} should take the streaming core")
    x, gamma, _, attn = _step_inputs(gen, rows, seq, dev)
    g = _rand(gen, (rows, seq, c)).to(dev, torch.bfloat16)
    params = [gamma, *attn]
    for p in (0.0, 0.1):
        args = (cfg.n_heads, cfg.num_groups, cfg.eps, True, 10000.0, p, 777, 5)
        fn = lambda *a: AB.fused_attention_block(*a, *args)
        out, got = _autograd(fn, x, params, g)
        torch.cuda.synchronize()
        ref_out, ref = _autograd(lambda *a: AB.reference_attention_block(*a, *args),
                                 x.float(), params, g.float())
        label = f"attention_step streaming core [{rows}, {seq}, {c}], dropout {p:g}"
        err = _compare(f"{label} forward", out, ref_out, STEP_TOL, null=x)
        gerr, grel = _check_grads(f"{label} backward", got, ref, g)
        results["attention_step"]["err"] = max(results["attention_step"]["err"], err)
        rb = results["attention_step_backward"]
        rb["err"], rb["rel_l2"] = max(rb["err"], gerr), max(rb["rel_l2"], grel)
        del out, got, ref_out, ref
        torch.cuda.empty_cache()
    fwd, bwd = _timed_grad(fn, x, params, g)
    _, _, _, _, exps = attn_work(rows, seq)
    flop, nbytes, bflop, bbytes, _ = attn_work(rows, seq)
    results["attention_step"]["stream"] = dict(
        shape=ATTN_STREAM_SHAPE, fwd_ms=fwd, ms=bwd, fwd_bound=_bound(flop, nbytes, exps),
        bound=_bound(bflop, bbytes, exps))


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
        raw = _train_config(root, epochs)
        if epochs == 1:   # a torch.profiler trace of the second optimizer step
            raw["training"].update(profile_steps=1, profile_start_step=1)
        with open(cfg_path, "w") as f:
            json.dump(raw, f)
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
        if epochs == 1:
            _trace_file(os.path.join(out_dir, "logs"), "base training CLI, profile_steps 1")
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
    from mss_tf_locoformer_tpu_torch.ops.cuda import step_fp32 as S32
    from mss_tf_locoformer_tpu_torch.ops.cuda import stft_kernel as SK
    from mss_tf_locoformer_tpu_torch.ops.cuda import swiglu_block as FB
    from mss_tf_locoformer_tpu_torch.ops.cuda import swiglu_ffn as SF
    from mss_tf_locoformer_tpu_torch.ops.cuda import unfused_fp32 as U32
    return {"stft": SK.stft_fused, "ffn_step": FB.fused_norm_ffn_residual,
            "attention_step": AB.fused_attention_block,
            "ffn_step_backward": FB.ffn_step_backward,
            "attention_step_backward": AB.attention_step_backward,
            "flash_attention": FA.flash_attention, "swiglu_ffn": SF.swiglu_conv_deconv,
            "flash_attention_backward": FA.flash_attention_backward,
            "swiglu_ffn_backward": SF.swiglu_ffn_backward, "dropout_mask": D.keep_mask,
            "istft": SK.istft_fused, "istft_overlap_add": SK.frames_to_audio,
            # fp32 rows of #2-#5 (csrc/step_fp32.cu), counted apart
            "ffn_step_fp32": S32.ffn_forward, "ffn_step_fp32_backward": S32.ffn_backward,
            "attention_step_fp32": S32.attention_forward,
            "attention_step_fp32_backward": S32.attention_backward,
            # fp32 rows of #6-#9 (csrc/step_fp32.cu), counted apart
            "flash_attention_fp32": U32.flash_forward_fp32,
            "flash_attention_fp32_backward": U32.flash_backward_fp32,
            "swiglu_ffn_fp32": U32.ffn_core_fp32,
            "swiglu_ffn_fp32_backward": U32.ffn_core_fp32_backward}


def _train_models(cfg=None, precision=None):
    """The model (the base config by default, bf16 by default) twice on the
    same weights, kernel and plain, in training mode."""
    fused, plain = _model_pair(cfg, precision)
    return fused.train(), plain.train()


def _batch(gen, b, n, dev, cfg=None):
    """A mixture and its 4 stems, ``[b, n]`` (``[b, 2, n]`` for a stereo ``cfg``)."""
    stems = {s: _rand(gen, _mix_shape(cfg, b, n), 0.1).to(dev)
             for s in ("vocals", "drums", "bass", "other")}
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


# The base train step's peak with the FFN step's wmma backward, which
# allocated its whole scratch at once (NVIDIA H100 80GB HBM3, 700 W, printed
# as 8.92 GiB): the step fails if the Hopper backward's scratch raises it
BASE_TRAIN_PEAK_GIB = 8.925


def phase_train_timing(reps: int = 1, cfg=None):
    """One optimizer step (AdamW, clip 5, dropout 0.1) on one micro-batch of
    2 x 3 s of ``cfg`` (the base config by default), kernel path against
    plain path, in turns (plain, kernel, kernel, plain), after a warm-up
    step of each (its peak device memory kept).  The plain attention keeps
    no scores for the backward (its 1 GiB groups are recomputed), so both
    paths fit at the same micro-batch."""
    import torch
    from mss_tf_locoformer_tpu_torch.core.config import LossConfig, TrainingConfig
    from mss_tf_locoformer_tpu_torch.train.state import make_optimizer
    from mss_tf_locoformer_tpu_torch.train.step import train_step
    models = dict(zip(("kernel", "plain"), _train_models(cfg)))
    dev = next(models["kernel"].parameters()).device
    batch = _batch(torch.Generator().manual_seed(SEED + 5), TRAIN_MB, SEGMENT, dev, cfg)
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


def flash_bwd_work(r, h, l, d, row_bytes=2):
    """(FLOP, bytes, exponentials) of one flash-attention backward: S
    recomputed, dP, dV, dQ and dK, 10 L^2 D per (row, head) at the true
    head_dim; q, k, v, o, dO read and dq, dk, dv written once (``row_bytes``
    an element, bf16 by default), the log-sum-exp read (fp32); P recomputed
    once, one exponential per score."""
    return (10.0 * r * h * l * l * d, 8 * r * h * l * d * float(row_bytes) + 4.0 * r * h * l,
            float(r * h * l * l))


def ffn_core_bwd_work(r, l, c, inner, k, row_bytes=2):
    """(FLOP, bytes) of one FFN-core backward on rows padded to L + 2(k-1):
    the conv recomputed, dh, dx and both weight products, 16 k C I per conv
    position; x and the cotangent read and dx written once and the weights
    read (``row_bytes`` an element, bf16 by default), their gradients
    written (fp32)."""
    lin, l1 = l + 2 * (k - 1), l + k - 1
    w = 3 * inner * c * k
    return (16.0 * r * l1 * k * c * inner,
            3 * r * lin * c * float(row_bytes) + w * float(row_bytes) + w * 4.0)


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


def ffn_step_bwd_launches(fb, rows, seq, c, inner, k) -> dict:
    """Launches one #5 call of the wrapper module ``fb`` makes of each of its
    kernels (1 where not named): on the Hopper route per row group the dx
    kernel and the weight-gradient GEMM, then four reductions; else the dx
    kernel, two split-K weight kernels and four reductions."""
    if getattr(fb, "hopper_route", lambda _: False)(c):
        n = fb.wg_step_plan(rows, seq, c, inner, k)["groups"]
        return {"ffn_step_dx_wg_kernel": n, "ffn_wgrad_gemm_kernel": n, "reduce_kernel": 4}
    return {"wgrad_kernel": 2, "reduce_kernel": 4}


def attn_bwd_launches(ab) -> dict:
    """Launches one #4 call of the wrapper module ``ab`` makes of the kernels
    it runs more than once (the others once); a wrapper without
    ``BACKWARD_LAUNCHES`` (the first design) made two weight products and
    three reductions."""
    return getattr(ab, "BACKWARD_LAUNCHES", {"wgrad_kernel": 2, "reduce_kernel": 3})


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


def _grad_parity(tag, fused, plain, mix, tg, group, others=None):
    """One micro-batch through the kernel path and the plain path with the
    same weights, batch and dropout seeds: the relative L2 of the gradients
    per parameter group (``group(name)``) within ``STEP_GRAD_REL_L2``; the
    gradients of the plain model with its blocks skipped must miss the
    bound.  ``others`` (``{label: model}``): models whose gradients' distance
    from the plain path's is printed beside, unchecked.  Returns ``(worst,
    least of the blocks-skipped model)``."""
    import torch
    from mss_tf_locoformer_tpu_torch.core.config import LossConfig
    from mss_tf_locoformer_tpu_torch.losses.mss_loss import mss_loss

    def grads(model):
        model.zero_grad(set_to_none=True)
        loss = mss_loss(model(mix, generator=torch.Generator().manual_seed(9)), tg,
                        LossConfig())["total_loss"]
        loss.backward()
        return loss.item(), {n: p.grad.detach().clone() for n, p in model.named_parameters()
                             if p.grad is not None}

    def by_group(ga, gb):
        out = {}
        for name, a in ga.items():
            ref = gb[name]
            if not torch.isfinite(a).all():
                raise AssertionError(f"{tag}: gradient of {name} is not finite")
            num, den = out.get(group(name), (0.0, 0.0))
            out[group(name)] = (num + (a.float() - ref.float()).pow(2).sum().item(),
                                den + ref.float().pow(2).sum().item())
        return {k: (n / d) ** 0.5 for k, (n, d) in out.items()}

    lk, gk = grads(fused)
    lp, gp = grads(plain)
    if set(gk) != set(gp):
        raise AssertionError(f"{tag}: the two paths' gradients cover other parameters")
    rel = by_group(gk, gp)
    blocks, plain.blocks = plain.blocks, torch.nn.ModuleList()
    _, gs = grads(plain)
    plain.blocks = blocks
    skip = by_group(gs, gp)     # the encoder and the decoder: no blocks to differentiate
    worst = max(rel.values())
    print(f"[{tag}] loss kernel {lk:.5f} plain {lp:.5f}; gradient relative L2 by group: "
          + ", ".join(f"{k} {v:.2e}" for k, v in rel.items())
          + f" (bound {STEP_GRAD_REL_L2:g}); blocks skipped: "
          + ", ".join(f"{k} {v:.2e}" for k, v in skip.items()))
    for label, model in (others or {}).items():
        lo, go = grads(model)
        print(f"[{tag}] {label}: loss {lo:.5f}; gradient relative L2 by group against the "
              f"plain path: " + ", ".join(f"{k} {v:.2e}" for k, v in by_group(go, gp).items()))
    if not worst <= STEP_GRAD_REL_L2:
        raise AssertionError(f"{tag}: relative L2 {worst:.3e} above bound")
    if not min(skip.values()) > STEP_GRAD_REL_L2:
        raise AssertionError(f"{tag}: cannot tell the model from the model with its "
                             f"blocks skipped")
    del gk, gp, gs
    return worst, min(skip.values())


def phase_xlarge_train_parity():
    """One xlarge micro-batch (1 x 1 s, remat on, dropout 0.1), kernel path
    against plain path (``_grad_parity``; groups: encoder, each block,
    decoder)."""
    import torch
    fused = _xl_train_model()
    plain = _xl_train_model(plain=True)
    plain.load_state_dict(fused.state_dict(), strict=True)
    mix, tg = _batch(torch.Generator().manual_seed(SEED + 4), 1, SR, "cuda")

    def group(name):
        return ".".join(name.split(".")[:2]) if name.startswith("blocks.") else name.split(".")[0]

    out = _grad_parity("xl-parity", fused, plain, mix, tg, group)
    del fused, plain
    torch.cuda.empty_cache()
    return out


def _unfused_train_config(root, name, epochs, amp=True):
    """The training CLI's config: the small config's published sections
    (batch 16 x 3 s, SI-SDR loss, dropout 0), or the xlarge config's training
    section (augmentation, warmup, batch 8 as 2 x 4, gradient checkpointing,
    combined loss, dropout 0.1) at full width, cut to 1 layer and 1 s
    segments (the plain attention over 2049 bins dominates its time); bf16
    blocks, or fp32 with ``amp`` False (``use_amp: false``)."""
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
    training.update({"num_epochs": epochs, "num_workers": 4, "use_amp": amp,
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


def phase_unfused_train_cli(workdir, name, amp=True):
    """The training CLI through the unfused route: one epoch of 2 optimizer
    steps with validation and a checkpoint, then ``--resume`` for one more
    epoch; exact launch counts of the first run (training and validation
    forwards), on the bf16 kernels or, with ``amp`` False (``use_amp:
    false``), on the fp32 ones."""
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
        raw = _unfused_train_config(root, name, epochs, amp)
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
    fa, sf = ("flash_attention", "swiglu_ffn") if amp else ("flash_attention_fp32",
                                                          "swiglu_ffn_fp32")
    if name == "small":   # dropout 0: flash attention in training too
        need = {fa: paths * (micro + val), f"{fa}_backward": paths * micro,
                sf: ffns * (micro + val), f"{sf}_backward": ffns * micro, "stft": micro + val}
    else:                 # dropout 0.1: attention on the plain path in training
        need = {fa: paths * val, sf: ffns * (remat * micro + val),
                f"{sf}_backward": ffns * micro, "stft": micro + val,
                "dropout_mask": launches[1]["dropout_mask"]}
        if not (cfg.remat_blocks and launches[1]["dropout_mask"] > 0):
            raise AssertionError(f"xlarge CLI: remat {cfg.remat_blocks}, masks "
                                 f"{launches[1]['dropout_mask']}")
    tag = name if amp else f"{name}, use_amp false"
    _check_launches(f"train-cli {tag}", launches[1], need)
    if trainer.step != 4 or trainer.start_epoch != 1:
        raise AssertionError(f"resume: step {trainer.step}, start epoch {trainer.start_epoch}")
    blob = torch.load(trainer.ckpt.path(1), map_location="cpu", weights_only=True)
    for key in ("train_loss", "val_loss"):
        if not blob["metadata"][key] == blob["metadata"][key]:
            raise AssertionError(f"{name} checkpoint {key} is not finite")
    for pname, p in trainer.model.named_parameters():
        if p.grad is None or not torch.isfinite(p.grad).all():
            raise AssertionError(f"{name}: gradient of {pname} missing or not finite")
    print(f"[train-cli] {tag}: {micro} micro-batches + {val} validation forwards per epoch; "
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


def _bs_train_steps(cfg):
    """(path, rows, sequence) of the steps of one BS-Locoformer training
    micro-batch (``TRAIN_MB`` x ``SEGMENT``)."""
    from mss_tf_locoformer_tpu_torch.models.bslocoformer import compute_bands
    n_frames = 1 + SEGMENT // cfg.hop_length
    bands = len(compute_bands(cfg.stft_size, cfg.sample_rate))
    return (("freq", TRAIN_MB * n_frames, bands), ("time", TRAIN_MB * bands, n_frames))


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


# ------------------------------------------- the speech family and BS training

SPEECH_TRAINING = {"batch_size": 4, "num_epochs": 150, "gradient_clip": 5.0, "num_workers": 4,
                   "optimizer": {"type": "adamw", "lr": 0.001, "weight_decay": 0.01},
                   "scheduler": {"type": "reducelronplateau", "factor": 0.5, "patience": 3,
                                 "warmup_steps": 4000},
                   "use_amp": True, "amp_dtype": "bfloat16", "save_interval": 1,
                   "val_interval": 1, "early_stopping": {"enabled": True, "patience": 10}}
SPEECH_SEGMENT_S = 4.0     # the configs' segment_length: 4 s
SPEECH_BATCH = 4           # and their batch_size


def speech_raw(name):
    """``configs/speech_{name}.yaml`` (wsj0_2mix, whamr, whamr_nope, dns) as
    the mapping its YAML holds, built in code."""
    whamr = name.startswith("whamr")
    dns = name == "dns"
    root = {"wsj0_2mix": "/data/wsj0_2mix", "dns": "/data/dns_ins20"}.get(name, "/data/whamr")
    dataset = {"root_dir": f"{root}/tr", "valid_dir": f"{root}/cv", "num_spk": 1 if dns else 2,
               "mix_dir": "noisy" if dns else "mix_both_reverb" if whamr else "mix",
               "sample_rate": 16000 if dns else 8000,
               "segment_length": 64000 if dns else 32000}
    if dns or whamr:
        dataset["spk_dirs"] = ["clean"] if dns else ["s1_anechoic", "s2_anechoic"]
    inner = 192 if whamr else 384
    separator = {"num_spk": 1 if dns else 2, "n_layers": 6, "emb_dim": 128,
                 "norm_type": "rmsgroupnorm", "num_groups": 4, "tf_order": "ft", "n_heads": 4,
                 "flash_attention": True, "fused_ffn": True, "attention_dim": 128,
                 "pos_enc": "nope" if name == "whamr_nope" else "rope",
                 "ffn_type": ["swiglu_conv1d", "swiglu_conv1d"], "ffn_hidden_dim": [inner, inner],
                 "conv1d_kernel": 8 if whamr else 4, "conv1d_shift": 1, "dropout": 0.0}
    return {"task": "speech_separation", "dataset": dataset,
            "stft": {"n_fft": 256, "hop_length": 128} if dns else {"n_fft": 128, "hop_length": 64},
            "separator": separator,
            "loss": ({"criterion": "mr_l1_tfd", "wrapper": "fixed_order"} if dns
                     else {"criterion": "si_snr", "wrapper": "pit"}),
            "training": json.loads(json.dumps(SPEECH_TRAINING)),
            "paths": {"output_dir": f"./experiments/{'dns_ins20' if dns else name}"},
            "mesh": {"dp": -1, "mp": 1}, "seed": 42}


def speech_config(name):
    from mss_tf_locoformer_tpu_torch.core.config import speech_config_from_dict
    return speech_config_from_dict(speech_raw(name))


def _speech_steps(cfg, batch, seconds):
    """(path, rows, sequence) of the steps of a speech batch: the freq path
    attends over F = n_fft/2 + 1 bins on rows B*N, the time path over N =
    T/hop + 1 frames on rows B*F."""
    n_frames = 1 + int(seconds * cfg.dataset.sample_rate) // cfg.stft.hop_length
    n_bins = cfg.stft.n_fft // 2 + 1
    return (("freq", batch * n_frames, n_bins), ("time", batch * n_bins, n_frames))


def phase_speech_gates():
    """The route the step gates give the speech configs (wsj0-2mix, WHAMR,
    DNS), in eval and in training: the fused steps; and which attention-step
    core their shapes take (resident)."""
    from mss_tf_locoformer_tpu_torch.ops.cuda import attention_block as AB
    from mss_tf_locoformer_tpu_torch.ops.cuda import swiglu_block as FB
    for name in ("wsj0_2mix", "whamr", "dns"):
        cfg = speech_config(name)
        sep = cfg.separator
        c, a, h, k = sep.emb_dim, sep.attention_dim, sep.n_heads, sep.conv1d_kernel
        for training in (False, True):
            routes = ([FB.supports_step(c, i, k, training, sep.num_groups)
                       for i in sep.ffn_hidden_dim] + [AB.supports_block(c, a, h, training)])
            print(f"[gates] speech {name} (C {c}, I {sep.ffn_hidden_dim[0]}, k {k}), "
                  f"{'training' if training else 'eval'}: FFN step "
                  f"{FB.step_bytes(c, k, training)} B, attention step "
                  f"{max(AB.launch_bytes(c, a, h, training).values())} B: fused steps {routes}")
            if not all(routes):
                raise AssertionError(f"gates: speech {name} should take the fused steps")
        for path, rows, seq in (_speech_steps(cfg, SPEECH_BATCH, SPEECH_SEGMENT_S)
                                + _speech_steps(cfg, 1, 8.0)):
            if not (AB.core_resident(seq) and FB.hopper_route(c)):
                raise AssertionError(f"gates: speech {name} {path} L {seq} should take the "
                                     f"resident attention core and the Hopper FFN step")
        print(f"[gates] speech {name}: Hopper FFN-step kernels, resident attention core at "
              f"every shape (L <= {max(s for *_, s in _speech_steps(cfg, 1, 8.0))})")


def _step_case(results, tag, path, rows, seq, cfg, gen, training, drop=0.0):
    """#2 and #3 (``training``: forward with the stash, and #4 and #5 against
    autograd through the plain versions in fp32 at dropout ``drop``) at one
    shape of the blocks of ``cfg`` (a speech ``SeparatorConfig`` or a
    ``ModelConfig``), timed beside the plain versions and the bounds."""
    import torch
    from mss_tf_locoformer_tpu_torch.ops.cuda import attention_block as AB
    from mss_tf_locoformer_tpu_torch.ops.cuda import swiglu_block as FB
    inner = _inner_dims(cfg)[0]
    c, k = cfg.emb_dim, cfg.conv1d_kernel
    x, gamma, ffn, attn = _step_inputs(gen, rows, seq, DEV, c, inner, k)
    drops = (drop, 777, 0) if training else ()
    fargs = (k, cfg.num_groups, cfg.eps) + drops
    aargs = (cfg.n_heads, cfg.num_groups, cfg.eps, cfg.pos_enc == "rope", 10000.0) + drops
    g = _rand(gen, (rows, seq, c)).to(DEV, torch.bfloat16) if training else None
    for name, kfn, pfn, w, args, work in (
            ("ffn_step", FB.fused_norm_ffn_residual, FB.reference_norm_ffn_residual, ffn,
             fargs, ffn_work(rows, seq, c, inner, k)),
            ("attention_step", AB.fused_attention_block, AB.reference_attention_block, attn,
             aargs, attn_work(rows, seq, c, cfg.attention_dim, cfg.n_heads))):
        label = f"{name} {tag} {path} [{rows}, {seq}, {c}]"
        fflop, fbytes, bflop, bbytes, exps = (*work, 0.0)[:5]   # FFN: no exps
        if not training:
            got = kfn(x, gamma, *w, *args)
            torch.cuda.synchronize()
            err = _compare(label, got, pfn(x, gamma, *w, *args), STEP_TOL, null=x)
            del got
            r = results.setdefault(name, dict(err=0.0))
            r["err"] = max(r["err"], err)
            r[f"{tag} {path}"] = dict(
                shape=(rows, seq, c), ms=_time_ms(lambda: kfn(x, gamma, *w, *args)),
                plain_ms=_time_ms(lambda: pfn(x, gamma, *w, *args), iters=3),
                bound=_bound(fflop, fbytes, exps))
            continue
        params = [gamma, *w]
        out, got = _autograd(lambda *a: kfn(*a, *args), x, params, g)
        torch.cuda.synchronize()
        ref_out, ref = _autograd(lambda *a: pfn(*a, *args), x.float(), params, g.float())
        ferr = _compare(f"{label} forward (training)", out, ref_out, STEP_TOL, null=x)
        gerr, grel = _check_grads(f"{label} backward", got, ref, g)
        del out, got, ref_out, ref
        kf, kb = _timed_grad(lambda *a: kfn(*a, *args), x, params, g)
        pf, pb = _timed_grad(lambda *a: pfn(*a, *args), x, params, g, iters=1)
        r = results.setdefault(name, dict(err=0.0))
        r["err"] = max(r["err"], ferr)
        rb = results.setdefault(name + "_backward", dict(err=0.0, rel_l2=0.0))
        rb["err"], rb["rel_l2"] = max(rb["err"], gerr), max(rb["rel_l2"], grel)
        rb[f"{tag} {path}"] = dict(
            rows=rows, seq=seq, c=c, drop=drop, fwd_ms=kf, ms=kb, plain_fwd_ms=pf,
            plain_ms=pb, bound=_bound(bflop, bbytes, exps),
            fwd_bound=_bound(fflop, fbytes, exps))
        torch.cuda.empty_cache()
    del x, g, ffn, attn
    torch.cuda.empty_cache()


def phase_speech_kernels(results):
    """#2 and #3 against their plain versions at speech serving shapes (one
    8 kHz utterance of 8 s at n_fft 128: freq [1001, 65, 128], time [65,
    1001, 128]; one 16 kHz DNS utterance of 8 s at n_fft 256: [1001, 129,
    128] / [129, 1001, 128]); #3 with its stash, #4 and #5 against autograd
    through the plain versions at the wsj0-2mix training shapes (batch 4 x
    4 s: [2004, 65, 128] / [260, 501, 128]) and at WHAMR's (I 192, k 8), at
    dropout 0 as the speech configs; and at BS-Locoformer's training shapes
    (micro-batch 2 x 3 s: [518, 62, 128] / [124, 259, 128]) at its dropout
    0.1."""
    import torch
    gen = torch.Generator().manual_seed(SEED + 20)
    for tag, name in (("speech wsj0-2mix serving", "wsj0_2mix"), ("speech dns serving", "dns")):
        cfg = speech_config(name)
        for path, rows, seq in _speech_steps(cfg, 1, 8.0):
            _step_case(results, tag, path, rows, seq, cfg.separator, gen, False)
    for tag, name in (("speech wsj0-2mix training", "wsj0_2mix"),
                      ("speech whamr training", "whamr")):
        cfg = speech_config(name)
        for path, rows, seq in _speech_steps(cfg, SPEECH_BATCH, SPEECH_SEGMENT_S):
            _step_case(results, tag, path, rows, seq, cfg.separator, gen, True)
    bs = bs_model_config()
    for path, rows, seq in _bs_train_steps(bs):
        _step_case(results, "bs training", path, rows, seq, bs, gen, True, bs.dropout)


def _speech_pair(cfg, precision=None):
    """The separator of ``cfg`` (bf16 blocks unless ``precision`` says
    otherwise) on the device twice, on the same seeded weights: with its
    kernels, and with every kernel replaced by its plain version."""
    import dataclasses
    import torch
    from mss_tf_locoformer_tpu_torch.core.precision import BF16
    from mss_tf_locoformer_tpu_torch.models import TFLocoformerSeparator
    precision = precision or BF16
    fused = TFLocoformerSeparator(cfg.separator, precision, torch.Generator().manual_seed(SEED))
    plain = TFLocoformerSeparator(dataclasses.replace(cfg.separator, fused_ffn=False,
                                                      flash_attention=False), precision)
    plain.load_state_dict(fused.state_dict(), strict=True)
    return fused.to(DEV).eval(), plain.to(DEV).eval()


# launches of one separator forward at the speech configs' 6 layers: 2
# paths x (2 FFN steps + 1 attention step) a layer
SPEECH_FORWARD = {"ffn_step": 24, "attention_step": 12}


def _times(need, n):
    return {k: v * n for k, v in need.items()}


def phase_speech_parity():
    """The wsj0-2mix separator at full width and depth on 4 s (batch 1)
    through STFT, separator and iSTFT: kernel path against plain path per
    speaker (relative L2 within ``SLICE_REL_L2``), exact launches per
    forward, and the plain model with its blocks skipped must miss."""
    import torch
    from mss_tf_locoformer_tpu_torch.models.espnet_compat import separate_waveforms
    cfg = speech_config("wsj0_2mix")
    fused, plain = _speech_pair(cfg)
    mix = _rand(torch.Generator().manual_seed(SEED + 21), (1, 4 * 8000), 0.1).to(DEV)
    sep = lambda m: separate_waveforms(m, mix, cfg.stft.n_fft, cfg.stft.hop_length)
    counters = _counters()
    with torch.no_grad():
        for fn in counters.values():
            fn.launches = 0
        a = sep(fused)
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in counters.items()}
        b = sep(plain)
        blocks, plain.blocks = plain.blocks, torch.nn.ModuleList()
        skipped = sep(plain)
        plain.blocks = blocks
    _check_launches("speech parity", launches, SPEECH_FORWARD)
    if a.shape != (1, 2, 4 * 8000) or not torch.isfinite(a).all():
        raise AssertionError(f"speech parity: estimates {tuple(a.shape)} not finite")
    rel = [_rel_l2(a[:, s], b[:, s]) for s in range(2)]
    skip = [_rel_l2(skipped[:, s], b[:, s]) for s in range(2)]
    print(f"[speech-parity] wsj0-2mix, 6 layers, 4 s: relative L2 per speaker "
          f"{', '.join(f'{v:.3e}' for v in rel)} (bound {SLICE_REL_L2:g}); blocks skipped "
          f"{', '.join(f'{v:.3e}' for v in skip)}")
    if not max(rel) <= SLICE_REL_L2:
        raise AssertionError(f"speech parity: relative L2 {max(rel):.3e} above {SLICE_REL_L2:g}")
    if not min(skip) > SLICE_REL_L2:
        raise AssertionError("speech parity: the check cannot tell the model from the model "
                             "with its blocks skipped")
    del fused, plain
    torch.cuda.empty_cache()
    return max(rel), min(skip)


def _speech_wave(rng, n, sr):
    """Two voices of tones under noise, a speech-like mixture for the CLIs."""
    import numpy as np
    t = np.arange(n) / sr
    f0 = 100 + 200 * rng.random(2)
    voices = [0.2 * np.sin(2 * np.pi * f * t * (1 + 0.05 * np.sin(2 * np.pi * 3 * t)))
              for f in f0]
    return voices, sum(voices) + 0.01 * rng.standard_normal(n)


def _write_json(path, raw):
    with open(path, "w") as f:
        json.dump(raw, f)
    return path


def _speech_checkpoint(workdir, name, seed=SEED):
    """A seeded random separator of ``speech_config(name)`` saved as a
    ``.pth``, and a JSON config of it."""
    import torch
    from mss_tf_locoformer_tpu_torch.models import TFLocoformerSeparator
    cfg = speech_config(name)
    ckpt = os.path.join(workdir, f"speech_{name}.pth")
    torch.save(TFLocoformerSeparator(cfg.separator, generator=torch.Generator().manual_seed(
        seed)).state_dict(), ckpt)
    return ckpt, _write_json(os.path.join(workdir, f"speech_{name}.json"), speech_raw(name))


SPEECH_SERVE_S = (3.3, 5.0, 9.7)   # the serving phase's utterances


SPEECH_FLAC_S = 2.5   # a FLAC utterance beside the WAVs (tests/flac_writer.py)


def phase_speech_serving(workdir):
    """The speech separation CLI on three 8 kHz WAVs of ``SPEECH_SERVE_S``
    and a 16-bit FLAC of ``SPEECH_FLAC_S`` (written by the repository's
    ``tests/flac_writer.py``, read through the port's native decoder against
    its samples) with a seeded random wsj0-2mix checkpoint, fp32 blocks (the
    CLI's default, as the JAX CLI's): 2 WAVs per file, each of the input's
    length; exact launches of the fp32 step kernels (one separator forward
    per file) and none of the bf16 ones; every stem against the plain
    route's (the CLI on the same checkpoint with the kernels' flags off)
    within ``FP32_TOL`` of its peak and one 16-bit step; then the wall time
    of a second run of the WAVs.  Returns ``(launches, wall s, audio s)``."""
    import numpy as np
    import torch
    from mss_tf_locoformer_tpu_torch.cli import separate_speech as cli
    from mss_tf_locoformer_tpu_torch.data import audio_io
    from mss_tf_locoformer_tpu_torch.utils.audio import load_audio, save_audio
    sys.path.insert(0, os.path.join(HERE, "tests"))
    from flac_writer import write_flac
    sr = 8000
    ckpt, cfg_path = _speech_checkpoint(workdir, "wsj0_2mix")
    in_dir, out_dir = os.path.join(workdir, "speech_in"), os.path.join(workdir, "speech_out")
    os.makedirs(in_dir)
    rng = np.random.default_rng(SEED)
    lengths = {}
    for i, seconds in enumerate(SPEECH_SERVE_S):
        n = int(seconds * sr)
        save_audio(os.path.join(in_dir, f"utt{i}.wav"),
                   _speech_wave(rng, n, sr)[1].astype(np.float32), sr, normalize=False)
        lengths[f"utt{i}"] = n
    n = int(SPEECH_FLAC_S * sr)
    pcm = np.round(np.clip(_speech_wave(rng, n, sr)[1], -1, 1) * 32767).astype(np.int64)
    flac = os.path.join(in_dir, "utt_flac.flac")
    t0 = time.perf_counter()
    write_flac(flac, pcm, sr, bits=16, block_size=4096, modes="fixed2")
    read, rate = audio_io.read(flac)
    if rate != sr or not np.array_equal(read[:, 0], (pcm / 32768.0).astype(np.float32)):
        raise AssertionError(f"{flac}: the native decoder's samples differ from the file's")
    print(f"[speech-serving] {flac}: {n} samples at {rate} Hz written and read back exactly "
          f"through the port's FLAC decoder ({time.perf_counter() - t0:.1f} s)")
    lengths["utt_flac"] = n
    argv = ["--config", cfg_path, "--checkpoint", ckpt, "--input", in_dir, "--output_dir",
            out_dir, "--device", DEV]
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    cli.main(argv)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    _check_launches("speech serving", launches, _times(SPEECH_FORWARD_FP32, len(lengths)))
    raw = speech_raw("wsj0_2mix")
    raw["separator"].update(fused_ffn=False, flash_attention=False)
    plain_dir = os.path.join(workdir, "speech_out_plain")
    cli.main(["--config", _write_json(os.path.join(workdir, "speech_plain.json"), raw),
              "--checkpoint", ckpt, "--input", in_dir, "--output_dir", plain_dir,
              "--device", DEV])
    worst = 0.0
    for base, n in lengths.items():
        for s in (1, 2):
            path = os.path.join(out_dir, f"{base}_spk{s}.wav")
            audio, rate = load_audio(path)
            if audio.shape != (1, n) or rate != sr or not np.isfinite(audio).all():
                raise AssertionError(f"{path}: {audio.shape} at {rate} Hz, want (1, {n})")
            ref, _ = load_audio(os.path.join(plain_dir, f"{base}_spk{s}.wav"))
            err = float(np.abs(audio - ref).max())
            worst = max(worst, err / float(np.abs(ref).max()))
            if not err <= FP32_TOL * float(np.abs(ref).max()) + 1.0 / 32768:
                raise AssertionError(f"{path}: {err:.3e} from the plain route's stem")
        print(f"[speech-serving] {base}: {n / sr:g} s -> 2 speakers of {n} samples")
    print(f"[speech-serving] fp32 stems against the plain route's: max error {worst:.3e} of "
          f"the peak (bound {FP32_TOL:g} and one 16-bit step)")
    os.remove(flac)
    t0 = time.perf_counter()
    cli.main(argv)
    torch.cuda.synchronize()
    return launches, time.perf_counter() - t0, sum(SPEECH_SERVE_S)


def _write_speech_corpus(root, cfg, n_train=8, n_val=2, seconds=SPEECH_SEGMENT_S, seed=SEED):
    """A synthetic corpus in the layout of ``cfg.dataset`` (``mix/ s1/ s2/``
    or ``noisy/ clean/``) under ``root/tr`` and ``root/cv``: mono 16-bit
    WAVs at its rate; training utterances of ``seconds``, validation ones of
    ``seconds`` + 1, + 2, ... (each a shape of its own)."""
    import numpy as np
    from mss_tf_locoformer_tpu_torch.data.audio_io import write
    d = cfg.dataset
    spk_dirs = d.spk_dirs or [f"s{i + 1}" for i in range(d.num_spk)]
    rng = np.random.default_rng(seed)
    for sub, count in (("tr", n_train), ("cv", n_val)):
        for dd in (d.mix_dir, *spk_dirs):
            os.makedirs(os.path.join(root, sub, dd))
        for u in range(count):
            n = int((seconds if sub == "tr" else seconds + 1 + u) * d.sample_rate)
            voices, mix = _speech_wave(rng, n, d.sample_rate)
            if d.num_spk == 1:   # enhancement: the clean voice under the other as noise
                voices = voices[:1]
            for dd, x in zip((d.mix_dir, *spk_dirs), (mix, *voices)):
                write(os.path.join(root, sub, dd, f"u{u:02d}.wav"),
                      x.astype(np.float32)[:, None], d.sample_rate)


def _speech_train_raw(name, root, epochs):
    raw = speech_raw(name)
    raw["dataset"].update(root_dir=os.path.join(root, "tr"), valid_dir=os.path.join(root, "cv"))
    raw["training"].update(num_epochs=epochs, log_interval=1)
    return raw


def phase_speech_train(workdir):
    """The speech training CLI: the wsj0-2mix sections (batch 4 x 4 s, bf16,
    PIT SI-SNR) on 8 training and 2 validation utterances, one epoch of 2
    steps with validation and a checkpoint, then ``--resume`` for one more;
    then one epoch of the DNS sections (one source, 16 kHz, n_fft 256,
    fixed-order ``mr_l1_tfd``).  Exact launches each run (forward and
    backward per step, a forward per validation utterance), finite
    gradients.  Returns ``{run: (launches, wall s)}``."""
    import numpy as np
    import torch
    from mss_tf_locoformer_tpu_torch.cli import train_speech as cli
    out = {}
    steps, n_val = 2, 2
    need = {**_times(SPEECH_FORWARD, steps + n_val),
            "ffn_step_backward": SPEECH_FORWARD["ffn_step"] * steps,
            "attention_step_backward": SPEECH_FORWARD["attention_step"] * steps}
    counters = _counters()
    for name, runs in (("wsj0_2mix", ((1, []), (2, ["--resume", "latest"]))),
                       ("dns", ((1, []),))):
        cfg = speech_config(name)
        root = os.path.join(workdir, f"corpus_{name}")
        _write_speech_corpus(root, cfg)
        cfg_path = os.path.join(workdir, f"train_{name}.json")
        exp = os.path.join(workdir, f"exp_{name}")
        for epochs, extra in runs:
            raw = _speech_train_raw(name, root, epochs)
            profile = name == "wsj0_2mix" and epochs == 1
            if profile:   # a torch.profiler trace of both steps
                raw["training"].update(profile_steps=2, profile_start_step=0)
            _write_json(cfg_path, raw)
            for fn in counters.values():
                fn.launches = 0
            t0 = time.perf_counter()
            trainer = cli.main(["--config", cfg_path, "--device", DEV, "--output_dir", exp]
                               + extra)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {k: fn.launches for k, fn in counters.items()}
            tag = f"speech training {name} epoch {epochs - 1}"
            _check_launches(tag, launches, need)
            if trainer.step != steps * epochs or trainer.start_epoch != epochs - 1:
                raise AssertionError(f"{tag}: step {trainer.step}, start epoch "
                                     f"{trainer.start_epoch}")
            meta = torch.load(trainer.ckpt.path(epochs - 1), map_location="cpu",
                              weights_only=True)["metadata"]
            for p_name, p in trainer.model.named_parameters():
                if p.grad is None or not torch.isfinite(p.grad).all():
                    raise AssertionError(f"{tag}: gradient of {p_name} missing or not finite")
            if not (np.isfinite(meta["train_loss"]) and np.isfinite(meta["val_loss"])):
                raise AssertionError(f"{tag}: losses {meta}")
            print(f"[speech-train] {tag}: {steps} steps and {n_val} validation utterances in "
                  f"{wall:.1f} s (build, data, checkpoint included); train "
                  f"{meta['train_loss']:.4f}, val {meta['val_loss']:.4f}; gradients finite")
            if profile:
                _trace_file(os.path.join(exp, "logs"), f"{tag}, profile_steps 2")
            out[f"{name} {epochs - 1}"] = (launches, wall)
            del trainer
            torch.cuda.empty_cache()
    return out


def phase_speech_train_timing(reps: int = 2):
    """One optimizer step of the wsj0-2mix and DNS configs at their batch (4
    x 4 s, bf16, AdamW, clip 5), kernel path against plain path, in turns
    (plain, kernel, kernel, plain) after a warm-up step of each (its peak
    device memory kept).  Returns ``{name: {path: (s/step, peak bytes)}}``."""
    import torch
    from mss_tf_locoformer_tpu_torch.train.speech import speech_train_step
    from mss_tf_locoformer_tpu_torch.train.state import make_optimizer
    out = {}
    for name in ("wsj0_2mix", "dns"):
        cfg = speech_config(name)
        models = dict(zip(("kernel", "plain"), _speech_pair(cfg)))
        opts = {p: make_optimizer(m.parameters(), cfg.training) for p, m in models.items()}
        gen = torch.Generator().manual_seed(SEED + 22)
        n = int(SPEECH_SEGMENT_S * cfg.dataset.sample_rate)
        src = _rand(gen, (SPEECH_BATCH, cfg.separator.num_spk, n), 0.1).to(DEV)
        mix = src.sum(1)

        def step(path):
            speech_train_step(models[path], opts[path], mix, src, 1e-4,
                              torch.Generator().manual_seed(1), cfg)

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
        out[name] = {p: (sum(t) / len(t), peak[p]) for p, t in times.items()}
        del models, opts
        torch.cuda.empty_cache()
    return out


def phase_speech_evaluate(workdir):
    """The speech evaluation CLI on 2 wsj0-2mix utterances (5 and 6 s, the
    validation set of ``_write_speech_corpus``), kernel route against plain
    route on one seeded random checkpoint: ``results.json`` complete and
    finite, exact launches on the kernel route (a forward per utterance);
    each kernel-route estimate held against the plain route's (SI-SNR at
    least ``EVAL_STEM_SI_SDR_DB``, slice parity's bound) and each score
    within ``EVAL_SI_SDR_DB``.  Returns ``(kernel-route wall s,
    launches)``."""
    import torch
    from mss_tf_locoformer_tpu_torch.cli import evaluate_speech as cli
    from mss_tf_locoformer_tpu_torch.eval.metrics import compute_si_sdr
    from mss_tf_locoformer_tpu_torch.models import espnet_compat as EC
    cfg = speech_config("wsj0_2mix")
    root = os.path.join(workdir, "corpus_eval")
    _write_speech_corpus(root, cfg, n_train=0, n_val=2)
    ckpt, _ = _speech_checkpoint(workdir, "wsj0_2mix")
    counters = _counters()
    estimates, results, out = {}, {}, None
    real = EC.SpeechSeparator.__call__
    for route in ("kernel", "plain"):
        raw = speech_raw("wsj0_2mix")
        raw["dataset"]["valid_dir"] = os.path.join(root, "cv")
        if route == "plain":
            raw["separator"].update(fused_ffn=False, flash_attention=False)
        cfg_path = _write_json(os.path.join(workdir, f"eval_{route}.json"), raw)
        estimates[route] = []
        EC.SpeechSeparator.__call__ = (
            lambda self, audio, _r=route: estimates[_r].append(real(self, audio))
            or estimates[_r][-1])
        for fn in counters.values():
            fn.launches = 0
        try:
            t0 = time.perf_counter()
            results[route] = cli.main(["--config", cfg_path, "--checkpoint", ckpt,
                                       "--output_dir", os.path.join(workdir, f"eval_{route}"),
                                       "--device", DEV])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            EC.SpeechSeparator.__call__ = real
        launches = {k: fn.launches for k, fn in counters.items()}
        with open(os.path.join(workdir, f"eval_{route}", "results.json")) as f:
            written = json.load(f)
        utts = sorted(written["per_utterance"])
        if utts != ["u00.wav", "u01.wav"] or not all(
                set(v) == {"si_snr", "sdr", "stoi"} and all(map(math.isfinite, v.values()))
                for v in [written["mean"], *written["per_utterance"].values()]):
            raise AssertionError(f"evaluate speech {route}: results.json {written}")
        if route == "kernel":
            _check_launches("evaluate speech", launches, _times(SPEECH_FORWARD_FP32, 2))
            out = (wall, launches)
        print(f"[speech-evaluate] {route} route: 2 utterances in {wall:.1f} s; mean SI-SNR "
              f"{written['mean']['si_snr']:.2f} dB, SDR {written['mean']['sdr']:.2f} dB, "
              f"STOI {written['mean']['stoi']:.3f}")
    least, worst, est_err = math.inf, 0.0, 0.0
    for u, (k, p) in enumerate(zip(estimates["kernel"], estimates["plain"])):
        for s in range(k.shape[1]):
            least = min(least, compute_si_sdr(k[0, s], p[0, s]))
            est_err = max(est_err, float(abs(k[0, s] - p[0, s]).max() / abs(p[0, s]).max()))
        name = f"u{u:02d}.wav"
        for m in ("si_snr", "sdr"):
            worst = max(worst, abs(results["kernel"]["per_utterance"][name][m]
                                   - results["plain"]["per_utterance"][name][m]))
    print(f"[speech-evaluate] kernel-route estimates (fp32, the CLI's default) against the "
          f"plain route's: max error {est_err:.3e} of the peak (bound {FP32_TOL:g}), SI-SNR >= "
          f"{least:.2f} dB (bound {EVAL_STEM_SI_SDR_DB:.2f}); scores within {worst:.3f} dB "
          f"(bound {EVAL_SI_SDR_DB:g})")
    if not est_err <= FP32_TOL:
        raise AssertionError(f"evaluate speech: estimates {est_err:.3e} from the plain route's")
    if not least >= EVAL_STEM_SI_SDR_DB:
        raise AssertionError(f"evaluate speech: an estimate at {least:.2f} dB against the "
                             f"plain route's")
    if not worst <= EVAL_SI_SDR_DB:
        raise AssertionError(f"evaluate speech: scores {worst:.3f} dB apart")
    return out


def phase_bs_train_parity():
    """One BS-Locoformer micro-batch (1 x 1 s stereo, dropout 0.1), the
    kernel path (bf16) against the plain path in fp32 (``_grad_parity``;
    groups: the band encoders, each block, the band decoders).  The plain
    path in bf16 is printed beside and is no reference here: with random
    weights and masking the combined loss's SI-SDR sits near -46 dB, where
    the loss's gradient amplifies rounding, and the bf16 plain path's
    gradients land several times farther from fp32's than the kernel
    path's (its rounding falls at other places)."""
    import torch
    from mss_tf_locoformer_tpu_torch.core.precision import FP32
    from mss_tf_locoformer_tpu_torch.models import build_model
    cfg = bs_model_config()
    fused, plain16 = _train_models(cfg)
    plain = build_model(_plain_config(cfg), FP32).to(DEV).train()
    plain.load_state_dict(fused.state_dict(), strict=True)
    mix, tg = _batch(torch.Generator().manual_seed(SEED + 23), 1, SR, DEV, cfg)

    def group(name):
        return ".".join(name.split(".")[:2])

    out = _grad_parity("bs-parity", fused, plain, mix, tg, group,
                       {"plain path in bf16": plain16})
    del fused, plain, plain16
    torch.cuda.empty_cache()
    return out


def _bs_train_config(root, epochs):
    """configs/musdb18_bslocoformer.yaml's dataset, model, loss and training
    sections (batch 8 = 4 micro-batches of 2 x 3 s; one epoch = 2 steps on
    16 tracks), as JSON-ready dicts."""
    import dataclasses
    raw = _train_config(root, epochs)
    raw["model"] = dataclasses.asdict(bs_model_config())
    raw["training"].update(num_workers=8, save_interval=5)
    return raw


def phase_bs_train(workdir):
    """The training CLI with the BS-Locoformer sections on the synthetic
    MUSDB tree (stereo): one epoch of 2 steps (8 micro-batches), validation
    (4 chunks of 3 s in one group) and a checkpoint, then ``--resume`` for
    one more epoch; exact launches each run.  Returns ``{epoch: (launches,
    wall s)}``."""
    import torch
    from mss_tf_locoformer_tpu_torch.cli import train as cli
    from mss_tf_locoformer_tpu_torch.models.bslocoformer_mss import BSLocoformerMSS
    root = os.path.join(workdir, "musdb")
    _write_musdb(root)
    cfg_path = os.path.join(workdir, "bs_train.json")
    exp = os.path.join(workdir, "exp_bs")
    micro, val_forwards = 2 * 4, 1
    # 6 layers x 2 paths: one FFN step and one attention step each
    need = {"ffn_step": 12 * (micro + val_forwards), "attention_step": 12 * (micro + val_forwards),
            "ffn_step_backward": 12 * micro, "attention_step_backward": 12 * micro}
    counters = _counters()
    out = {}
    for epochs, extra in ((1, []), (2, ["--resume", "latest"])):
        _write_json(cfg_path, _bs_train_config(root, epochs))
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        trainer = cli.main(["--config", cfg_path, "--device", DEV, "--output_dir", exp] + extra)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
        tag = f"bs training epoch {epochs - 1}"
        _check_launches(tag, launches, need)
        if not isinstance(trainer.model, BSLocoformerMSS) or trainer.step != 2 * epochs:
            raise AssertionError(f"{tag}: {type(trainer.model).__name__}, step {trainer.step}")
        for p_name, p in trainer.model.named_parameters():
            if p.grad is None or not torch.isfinite(p.grad).all():
                raise AssertionError(f"{tag}: gradient of {p_name} missing or not finite")
        print(f"[bs-train] {tag}: 2 steps of 4 x 2 x 3 s stereo and validation in {wall:.1f} s "
              f"(build, data, checkpoint included); gradients finite")
        out[epochs - 1] = (launches, wall)
        del trainer
        torch.cuda.empty_cache()
    return out


# ------------------------------------- fp32 rows of the fused steps (#2-#5)

# fp32 kernels (csrc/step_fp32.cu) against the fp32 plain versions: both
# sides sum fp32 products in fp32, in other orders (~1e-6 relative), so
# outputs within FP32_TOL of max|ref|, gradients within FP32_GRAD_REL_L2
# (relative L2), the train step's loss within FP32_LOSS_REL and the speech
# stems within FP32_TOL of max|ref| -- against the 1.1-1.2e-2 the bf16
# blocks give (PERF.md section 6)
FP32_TOL, FP32_GRAD_REL_L2, FP32_LOSS_REL = 1e-4, 1e-4, 1e-4
# #2/#5 at fp32 (3xTF32 GEMMs, FFMA norms) against the plain version run in
# float64: outputs and dx within 1e-5 of max|ref|, the other gradients
# within 1e-5 relative L2.  The fp32 plain version is no oracle at this
# bound: its conv weight gradient (cuDNN's fp32 sums over 532k positions)
# is 1.24e-5 (relative L2) off the float64 one at base training, the
# kernels' 5.1e-7 (tools/ffn_step_errors.py on an H100)
FP32_STEP_TOL = 1e-5
SPEECH_FORWARD_FP32 = {"ffn_step_fp32": 24, "attention_step_fp32": 12}


def phase_fp32_gates():
    """The fp32 gates (``step_fp32.supports_ffn`` / ``supports_attention``)
    at the base, BS-Locoformer and speech configs' widths, in eval and in
    training, from the layouts' bytes (the FFN step's: ``core_nn`` at each
    GEMM's tile, ``core_tn``, the norm backward), which the compiled kernels
    count the same."""
    from mss_tf_locoformer_tpu_torch.ops.cuda import load
    from mss_tf_locoformer_tpu_torch.ops.cuda import step_fp32 as S32
    cfgs = [("base", base_model_config()), ("bs", bs_model_config())] + [
        (f"speech {n}", speech_config(n).separator) for n in ("wsj0_2mix", "whamr", "dns")]
    # the attention core is csrc/attn_fp32.cu's alone: no FFMA attention
    # kernel is left in step_fp32.cu's library
    left = [n for n in ("f32_attn_fwd", "f32_attn_bwd", "f32_attn_smem_bytes")
            if hasattr(load("step_fp32"), n)]
    if left or not all(hasattr(load("attn_fp32"), n) for n in ("f32_attn_fwd", "f32_attn_bwd")):
        raise AssertionError(f"fp32 gates: step_fp32.cu still exports {left}")
    print("[fp32-gates] the attention core: csrc/attn_fp32.cu (3xTF32); step_fp32.cu exports "
          "no attention kernel")
    for training in (False, True):
        for c in (96, 128):
            want, got = S32.launch_bytes(c, training), S32.compiled_launch_bytes(c, training)
            if want != got:
                raise AssertionError(f"fp32 gates: layouts {want} != compiled {got}")
    for tag, cfg in cfgs:
        c, k = cfg.emb_dim, cfg.conv1d_kernel
        for training in (False, True):
            for i in _inner_dims(cfg):
                want = S32.ffn_launch_bytes(c, i, training)
                got = S32.compiled_ffn_launch_bytes(c, i, training)
                if want != got:
                    raise AssertionError(f"fp32 FFN gate: layouts {want} != compiled {got}")
            routes = ([S32.supports_ffn(c, i, k, training, cfg.num_groups)
                       for i in _inner_dims(cfg)]
                      + [S32.supports_attention(c, cfg.attention_dim, cfg.n_heads, training)])
            print(f"[fp32-gates] {tag} (C {c}, I {_inner_dims(cfg)[0]}, k {k}), "
                  f"{'training' if training else 'eval'}: FFN step (3xTF32) launches "
                  f"{S32.ffn_launch_bytes(c, _inner_dims(cfg)[0], training)} B, attention "
                  f"step {S32.launch_bytes(c, training)} B: fused steps {routes}")
            if not all(routes):
                raise AssertionError(f"fp32 gates: {tag} should take the fused steps")


def _fp32_case(results, tag, path, rows, seq, cfg, gen, training, drop=0.0, mp=1):
    """#2 and #3 on fp32 rows at one shape of ``cfg``'s blocks (with
    ``training``: their stash, and #5 and #4, against autograd through the
    plain versions in fp32 at dropout ``drop``; with ``mp`` > 1, shard 0 in
    the partial-sum mode) against the plain versions (#2/#5 in float64
    within ``FP32_STEP_TOL``, #3/#4 in fp32 within ``FP32_TOL``): one
    counted fp32 launch
    each way and none of the bf16 kernels; two backward runs bit-equal; the
    kernels timed beside the plain versions, the bf16 kernels on the same
    values, the 3xTF32 bound (the FFN GEMMs and the attention core run
    3xTF32) with the FFMA bound beside it, and each launch of the chain by
    CUDA events (an FFN step raises if an FFMA GEMM runs in it)."""
    import torch
    from mss_tf_locoformer_tpu_torch.ops.cuda import attention_block as AB
    from mss_tf_locoformer_tpu_torch.ops.cuda import step_fp32 as S32
    from mss_tf_locoformer_tpu_torch.ops.cuda import swiglu_block as FB
    inner = _inner_dims(cfg)[0]
    c, k, h, a = cfg.emb_dim, cfg.conv1d_kernel, cfg.n_heads, cfg.attention_dim
    x16, gamma, ffn, attn = _step_inputs(gen, rows, seq, DEV, c, inner, k)
    if mp > 1:   # shard 0 by the TP rules (parallel/sharding.py); no deconv bias
        from mss_tf_locoformer_tpu_torch.parallel.sharding import shard_tensor
        ffn = [shard_tensor(kk, w, 0, mp) for kk, w in zip(TP_FFN_KEYS, ffn)] + [None]
        attn = [shard_tensor(kk, w, 0, mp) for kk, w in zip(TP_ATTN_KEYS, attn)]
        inner, h, a = inner // mp, h // mp, a // mp
    x = x16.float()
    residual = mp == 1
    drops = (drop, 777, 0, residual)
    fargs = (k, cfg.num_groups, cfg.eps) + drops
    aargs = (h, cfg.num_groups, cfg.eps, cfg.pos_enc == "rope", 10000.0) + drops
    g = _rand(gen, (rows, seq, c)).to(DEV) if training else None
    counters = _counters()
    for name, kfn, pfn, w, args, work in (
            ("ffn_step", FB.fused_norm_ffn_residual, FB.reference_norm_ffn_residual, ffn,
             fargs, ffn_work(rows, seq, c, inner, k, row_bytes=4)),
            ("attention_step", AB.fused_attention_block, AB.reference_attention_block, attn,
             aargs, attn_work(rows, seq, c, a, h, row_bytes=4))):
        label = f"{name} fp32 {tag} {path} [{rows}, {seq}, {c}]"
        key = f"{name}_fp32"
        fflop, fbytes, bflop, bbytes, exps = (*work, 0.0)[:5]   # FFN: no exps
        wk = [t for t in w if t is not None]
        pad = [None] * (len(w) - len(wk))   # the partial-sum FFN's absent bias
        attn = name == "attention_step"
        tol, rel_bound = (FP32_TOL, FP32_GRAD_REL_L2) if attn else (FP32_STEP_TOL,
                                                                     FP32_STEP_TOL)
        ref_dt = torch.float32 if attn else torch.float64   # the oracle's dtype

        def bounds(flop, nbytes, _exps=exps):
            """{3xTF32 bound, the FFMA bound}"""
            return {"bound": _bound(flop, nbytes, _exps, PEAK_TF32, TF32_PASSES),
                    "ffma_bound": _bound(flop, nbytes, _exps, PEAK_FP32)}

        def launches(fn, backward, _attn=attn, _label=label):
            """each launch of the chain ``fn`` runs, by CUDA events"""
            if _attn:
                return _fp32_attn_launches(_label, fn, backward)
            return _fp32_core_kernels(_label, fn, backward, tag="fp32-kernels")

        def call(fn, _pad=pad, _args=args):
            return lambda x_, g_, *p: fn(x_, g_, *p, *_pad, *_args)
        for fn in counters.values():
            fn.launches = 0
        if not training:
            with torch.no_grad():
                got = call(kfn)(x, gamma, *wk)
                torch.cuda.synchronize()
                _check_launches(f"{label} launches", {n: fn.launches for n, fn in
                                                      counters.items()}, {key: 1}, quiet=True)
                err = _compare(label, got, call(pfn)(x.to(ref_dt), gamma.to(ref_dt),
                                                     *[t.to(ref_dt) for t in wk]), tol,
                               null=x if residual else None)
            del got
            r = results.setdefault(key, dict(err=0.0))
            r["err"] = max(r["err"], err)
            r[f"{tag} {path}"] = dict(
                shape=(rows, seq, c), ms=_time_ms(lambda: call(kfn)(x, gamma, *wk)),
                plain_ms=_time_ms(lambda: call(pfn)(x, gamma, *wk), iters=3),
                bf16_ms=_time_ms(lambda: call(kfn)(x16, gamma, *wk)),
                **bounds(fflop, fbytes))
            r[f"{tag} {path}"]["kernels"] = launches(lambda: call(kfn)(x, gamma, *wk), False)
            continue
        params = [gamma, *wk]
        out, got = _autograd(call(kfn), x, params, g)
        torch.cuda.synchronize()
        _check_launches(f"{label} launches", {n: fn.launches for n, fn in counters.items()},
                        {key: 1, f"{key}_backward": 1}, quiet=True)
        again = _autograd(call(kfn), x, params, g)[1]
        torch.cuda.synchronize()
        same = all(torch.equal(u, v) for u, v in zip(got, again))
        print(f"[fp32-kernels] {label}: two backward runs bit-equal: {same}")
        if not same:
            raise AssertionError(f"{label}: two backward runs differ")
        del again
        ref_out, ref = _autograd(call(pfn), x.to(ref_dt), [t.to(ref_dt) for t in params],
                                 g.to(ref_dt))
        ferr = _compare(f"{label} forward (training)", out, ref_out, tol,
                        null=x if residual else None)
        gerr, grel = _check_grads(f"{label} backward", got, ref, g if residual else None,
                                  tol, rel_bound)
        del out, got, ref_out, ref
        kf, kb = _timed_grad(call(kfn), x, params, g)
        pf, pb = _timed_grad(call(pfn), x, params, g, iters=1)
        bf, bb = _timed_grad(call(kfn), x16, params, g.to(torch.bfloat16))
        r = results.setdefault(key, dict(err=0.0))
        r["err"] = max(r["err"], ferr)
        rb = results.setdefault(f"{key}_backward", dict(err=0.0, rel_l2=0.0))
        rb["err"], rb["rel_l2"] = max(rb["err"], gerr), max(rb["rel_l2"], grel)
        fb_ = bounds(fflop, fbytes)
        rb[f"{tag} {path}"] = dict(
            rows=rows, seq=seq, c=c, drop=drop, mp=mp, fwd_ms=kf, ms=kb, plain_fwd_ms=pf,
            plain_ms=pb, bf16_fwd_ms=bf, bf16_ms=bb, **bounds(bflop, bbytes),
            **{f"fwd_{k}": v for k, v in fb_.items()})
        # each launch of the chain, forward (with its stash) and backward
        if attn:
            _, stash = S32.attention_forward(x, gamma, *wk, *args, stash=True)
            fwd = lambda: S32.attention_forward(x, gamma, *wk, *args, stash=True)
            bwd = lambda: S32.attention_backward(g, x, gamma, *wk, stash, *args)
        else:
            fwd = lambda: S32.ffn_forward(x, gamma, *wk, *pad, *args)
            bwd = lambda: S32.ffn_backward(g, x, gamma, *w[:3], *args)
        rb[f"{tag} {path}"]["fwd_kernels"] = launches(fwd, False)
        rb[f"{tag} {path}"]["kernels"] = launches(bwd, True)
        if attn:
            del stash
        torch.cuda.empty_cache()
    del x, x16, g, ffn, attn
    torch.cuda.empty_cache()


def _keep_rates(rows, seq, cfg, seed=777, p=0.1):
    """The keep rates of the four dropout sites at a step's shape (16 rows),
    from the mask kernel at the coordinates the step kernels draw at."""
    import torch
    from mss_tf_locoformer_tpu_torch.ops import dropout as D
    from mss_tf_locoformer_tpu_torch.ops.cuda import attention_block as AB
    n = min(rows, 16)
    ar = lambda m: torch.arange(m, device=DEV)
    lc = seq + cfg.conv1d_kernel - 1
    inner = _inner_dims(cfg)[0]
    rates = {
        "ffn inner": D.keep_mask(seed, D.SITE_FFN_INNER, ar(n)[:, None, None],
                                 ar(lc)[None, None], ar(inner)[None, :, None], p=p),
        "ffn outer": D.keep_mask(seed, D.SITE_FFN_OUTER, ar(n)[:, None, None],
                                 ar(seq)[None, :, None], ar(cfg.emb_dim)[None, None], p=p),
        "attention probabilities": AB.probability_mask(seed, ar(n), cfg.n_heads, seq, p, DEV),
        "attention projection": D.keep_mask(seed, D.SITE_ATTN_PROJ, ar(n)[:, None, None],
                                            ar(seq)[None, :, None],
                                            ar(cfg.emb_dim)[None, None], p=p)}
    return {k: v.float().mean().item() for k, v in rates.items()}


def phase_fp32_kernels(results):
    """#2-#5 on fp32 rows against their fp32 plain versions: #2 and #3 at the
    speech serving shapes (8 s of wsj0-2mix and of DNS); with the stash, #5
    and #4 at the wsj0-2mix training shapes (batch 4 x 4 s) at dropout 0, at
    the base training shapes (micro-batch 2 x 3 s) at dropout 0.1 (the keep
    rates printed), and shard 0 of mp 2 in the partial-sum mode at the base
    training shapes at dropout 0.1."""
    import torch
    gen = torch.Generator().manual_seed(SEED + 30)
    for tag, name in (("speech wsj0-2mix serving", "wsj0_2mix"), ("speech dns serving", "dns")):
        cfg = speech_config(name)
        for path, rows, seq in _speech_steps(cfg, 1, 8.0):
            _fp32_case(results, tag, path, rows, seq, cfg.separator, gen, False)
    cfg = speech_config("wsj0_2mix")
    for path, rows, seq in _speech_steps(cfg, SPEECH_BATCH, SPEECH_SEGMENT_S):
        _fp32_case(results, "speech wsj0-2mix training", path, rows, seq, cfg.separator, gen,
                   True)
    base = base_model_config()
    for path, rows, seq in _train_steps(base):
        rates = _keep_rates(rows, seq, base)
        print(f"[fp32-kernels] base training {path}: keep rates at dropout 0.1 "
              + ", ".join(f"{k} {v:.4f}" for k, v in rates.items()))
        if not all(abs(v - 0.9) < 0.01 for v in rates.values()):
            raise AssertionError(f"keep rates {rates}")
        _fp32_case(results, "base training", path, rows, seq, base, gen, True, 0.1)
    for path, rows, seq in _train_steps(base)[:1]:
        _fp32_case(results, "base training shard", path + " mp2", rows, seq, base, gen, True,
                   0.1, mp=2)


def phase_fp32_speech_parity():
    """The wsj0-2mix separator at fp32, the speech CLIs' default: kernel path
    (the fp32 step kernels) against plain path on 4 s, per speaker within
    ``FP32_TOL`` of max|ref| (the bf16 path's figure beside it), exact fp32
    launches and none of the bf16 kernels."""
    import torch
    from mss_tf_locoformer_tpu_torch.core.precision import FP32
    from mss_tf_locoformer_tpu_torch.models.espnet_compat import separate_waveforms
    cfg = speech_config("wsj0_2mix")
    fused, plain = _speech_pair(cfg, FP32)
    mix = _rand(torch.Generator().manual_seed(SEED + 21), (1, 4 * 8000), 0.1).to(DEV)
    sep = lambda m: separate_waveforms(m, mix, cfg.stft.n_fft, cfg.stft.hop_length)
    counters = _counters()
    with torch.no_grad():
        for fn in counters.values():
            fn.launches = 0
        a = sep(fused)
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in counters.items()}
        b = sep(plain)
    _check_launches("fp32 speech parity", launches, SPEECH_FORWARD_FP32)
    errs = [(a[:, s] - b[:, s]).abs().max().item() / b[:, s].abs().max().item()
            for s in range(2)]
    rel = [_rel_l2(a[:, s], b[:, s]) for s in range(2)]
    print(f"[fp32-speech-parity] wsj0-2mix, 6 layers, 4 s, fp32: max error per speaker "
          f"{', '.join(f'{v:.3e}' for v in errs)} of max|ref| (bound {FP32_TOL:g}), "
          f"relative L2 {', '.join(f'{v:.3e}' for v in rel)}")
    if not max(errs) <= FP32_TOL:
        raise AssertionError(f"fp32 speech parity: {max(errs):.3e} above {FP32_TOL:g}")
    del fused, plain
    torch.cuda.empty_cache()
    return max(errs), max(rel)


def phase_fp32_train_steps(reps: int = 2):
    """``use_amp: false`` (``precision_from_amp``): one optimizer step of the
    base config (1 x 1 s, dropout 0.1) and of the wsj0-2mix config (batch 2
    x 4 s, PIT SI-SNR) on the kernel path (the fp32 step kernels forward and
    backward, exact launches, no bf16 kernel) against the plain path with
    the same seeds: loss and grad_norm within ``FP32_LOSS_REL``; then the
    kernel path's step at the full batch (base micro-batch 2 x 3 s, speech 4
    x 4 s) timed with its peak device memory.  Returns ``{tag: {...}}``."""
    import torch
    from mss_tf_locoformer_tpu_torch.core.config import LossConfig, TrainingConfig
    from mss_tf_locoformer_tpu_torch.core.precision import FP32, precision_from_amp
    from mss_tf_locoformer_tpu_torch.train.speech import speech_train_step
    from mss_tf_locoformer_tpu_torch.train.state import make_optimizer
    from mss_tf_locoformer_tpu_torch.train.step import train_step
    if precision_from_amp(False) != FP32:
        raise AssertionError("use_amp false is not fp32")
    counters = _counters()
    out = {}
    base, speech = base_model_config(), speech_config("wsj0_2mix")
    for tag in ("base", "speech wsj0-2mix"):
        if tag == "base":
            models = dict(zip(("kernel", "plain"), _train_models(base, FP32)))
            opts = {p: make_optimizer(m.parameters(), TrainingConfig()) for p, m in
                    models.items()}
            per = {"ffn_step_fp32": 16, "attention_step_fp32": 8}
            stft = {"stft": 1}   # the model's STFT kernel (fused_stft)

            def step(path, batch):
                return train_step(models[path], opts[path], *batch, 5e-4,
                                  torch.Generator().manual_seed(11), LossConfig(), accum=1,
                                  gradient_clip=5.0)
            small = _batch(torch.Generator().manual_seed(SEED + 4), 1, SR, DEV)
            full = _batch(torch.Generator().manual_seed(SEED + 5), TRAIN_MB, SEGMENT, DEV)
        else:
            models = dict(zip(("kernel", "plain"), [m.train() for m in
                                                    _speech_pair(speech, FP32)]))
            opts = {p: make_optimizer(m.parameters(), speech.training) for p, m in
                    models.items()}
            per = SPEECH_FORWARD_FP32
            stft = {}   # the speech lane's transforms are plain
            gen = torch.Generator().manual_seed(SEED + 22)
            n = int(SPEECH_SEGMENT_S * speech.dataset.sample_rate)

            def batch_of(b):
                src = _rand(gen, (b, 2, n), 0.1).to(DEV)
                return src.sum(1), src

            def step(path, batch):
                return speech_train_step(models[path], opts[path], *batch, 1e-4,
                                         torch.Generator().manual_seed(1), speech)
            small, full = batch_of(2), batch_of(SPEECH_BATCH)
        need = {**per, **{f"{k}_backward": v for k, v in per.items()}, **stft}
        for fn in counters.values():
            fn.launches = 0
        got = step("kernel", small)
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in counters.items()}
        _check_launches(f"fp32 train step {tag}", launches, need)
        ref = step("plain", small)
        rel = {k: abs(float(got[k]) - float(ref[k])) / abs(float(ref[k]))
               for k in ("total_loss", "grad_norm")}
        print(f"[fp32-train] {tag}, use_amp false: loss kernel {float(got['total_loss']):.6f} "
              f"plain {float(ref['total_loss']):.6f}; relative differences "
              + ", ".join(f"{k} {v:.2e}" for k, v in rel.items())
              + f" (bound {FP32_LOSS_REL:g})")
        if not max(rel.values()) <= FP32_LOSS_REL:
            raise AssertionError(f"fp32 train step {tag}: {rel}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step("kernel", full)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        t0 = time.perf_counter()
        for _ in range(reps):
            step("kernel", full)
        torch.cuda.synchronize()
        sec = (time.perf_counter() - t0) / reps
        print(f"[fp32-train] {tag}, use_amp false, kernel path at the full batch: {sec:.4f} "
              f"s/step, peak {peak / 2**30:.2f} GiB")
        out[tag] = dict(launches=launches, rel=rel, sec=sec, peak=peak)
        del models, opts, small, full
        torch.cuda.empty_cache()
    return out


# ------------------------------------ fp32 rows of the unfused route (#6-#9)

# The xlarge serving CLI's input at fp32: one engine batch (2 chunks of 8 s
# with 1 s of overlap), the shapes #6 and #8 are timed at
XL_FP32_SERVE_S = 15.0
XL_FP32_LAYERS = 2   # the depth at which the stems are held to the plain route
XL_FP32_SEGMENT = 3 * SR   # the xlarge use_amp false micro-batch's segments


def phase_unfused_fp32_gates():
    """The fp32 gates of #6-#9 (``unfused_fp32.supports_flash`` /
    ``supports_core``; the flash launches' bytes against the compiled
    kernels' count) and the routes of the xlarge and small configs' fp32
    blocks: no fused step, attention on the flash kernels and every FFN on
    the FFN-core kernels, in eval and in training (dropout aside)."""
    import dataclasses

    from mss_tf_locoformer_tpu_torch.core.precision import FP32
    from mss_tf_locoformer_tpu_torch.models import build_model
    from mss_tf_locoformer_tpu_torch.ops.cuda import unfused_fp32 as U32
    for d in (12, 16, 24, 32, 64):
        want, got = U32.flash_launch_bytes(d), U32.compiled_flash_launch_bytes(d)
        if want != got:
            raise AssertionError(f"fp32 flash gate at D {d}: layouts {want} != compiled {got}")
    want, got = U32.core_launch_bytes(), U32.compiled_core_launch_bytes()
    if want != got:
        raise AssertionError(f"fp32 FFN-core gate: layouts {want} != compiled {got}")
    for tag, cfg in (("xlarge", xlarge_model_config()), ("small", small_model_config())):
        block = build_model(dataclasses.replace(cfg, n_layers=1), FP32).blocks[0].freq_path
        d = cfg.attention_dim // cfg.n_heads
        for training in (False, True):
            block.train(training)
            routes = (block.fused_steps(fp32=True), block.attn._flash[True],
                      [f._fused[training, True] for f in block.ffn])
            print(f"[fp32-gates] {tag} (C {cfg.emb_dim}, D {d} padded to {U32.head_pad(d)}, "
                  f"I {_inner_dims(cfg)[0]}), {'training' if training else 'eval'}: fused "
                  f"steps {routes[0]}, flash {routes[1]}, FFN cores {routes[2]}; launches "
                  f"{U32.flash_launch_bytes(d)} / {U32.core_launch_bytes()} B")
            nf = len(block.ffn)
            if routes != (([False] * nf, False), True, [True] * nf):
                raise AssertionError(f"fp32 gates: {tag} should take the unfused route's "
                                     f"fp32 kernels")


def _qkv_fp32(gen, rows, seq, h, d):
    """fp32 q, k, v as the MHSA hands them over: ``[B, H, L, D]`` views of a
    QKV product ``[B, L, 3, H, D]`` at 1.5x unit scale (a peaked softmax, so
    the uniform-attention output is far from the right one)."""
    import torch
    return 1.5 * torch.randn(rows, seq, 3, h, d, generator=gen, device=DEV)


def _sdpa_fp32(q, k, v):
    """``scaled_dot_product_attention`` on fp32 q, k, v through its memory-
    efficient backend, the one that takes fp32 (its math backend would hold
    every score); the yardstick of #6 and #7 at fp32."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        return F.scaled_dot_product_attention(q, k, v)


def _fp32_attn_bounds(work) -> dict:
    """The bounds of an fp32 attention call of ``work`` (FLOP, bytes,
    exponentials): ``bound`` at 3 x FLOP on the TF32 tensor cores (the 3xTF32
    core's), ``ffma_bound`` at the fp32 FFMA rate beside it."""
    return {"bound": _bound(*work, peak=PEAK_TF32, passes=TF32_PASSES),
            "ffma_bound": _bound(*work, peak=PEAK_FP32)}


def _fp32_flash_case(results, tag, rows, h, seq, d, gen, training):
    """#6 (and with ``training`` its stash and #7) on fp32 rows against the
    fp32 plain version on row slices (the plain fp32 scores of all rows
    would not fit); exact launches; #7 twice for the same bits; each call's
    launches by CUDA events (the RoPE split and the 3xTF32 core); timed
    beside the plain version, the bf16 kernels on the same values, SDPA on
    fp32 q, k, v (RoPE applied first; its autograd backward for #7) and the
    bounds (3xTF32, FFMA beside)."""
    import torch
    from mss_tf_locoformer_tpu_torch.ops.cuda import flash_attention as FA
    from mss_tf_locoformer_tpu_torch.ops.rope import apply_rope
    qkv = _qkv_fp32(gen, rows, seq, h, d).requires_grad_(training)
    q, kk, v = qkv.permute(2, 0, 3, 1, 4)
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    label = f"flash_attention fp32 {tag} [{rows}, {h}, {seq}, {d}]"
    n = 8 if seq > 1000 or rows > 4000 else 64
    slices = [slice(r0, r0 + n) for r0 in (0, rows - n)]
    if not training:
        with torch.no_grad():
            out = FA.flash_attention(q, kk, v, True)
            torch.cuda.synchronize()
            _check_launches(label, {k: f.launches for k, f in counters.items()},
                            {"flash_attention_fp32": 1}, quiet=True)
            err = 0.0
            for sl in slices:
                ref = FA.reference_flash_attention(q[sl], kk[sl], v[sl], True)
                err = max(err, _compare(f"{label} rows {sl.start}..{sl.stop}", out[sl], ref,
                                        FP32_TOL, null=v[sl].mean(-2, keepdim=True).expand(
                                            ref.shape)))
            del out, ref
            r = results.setdefault("flash_attention_fp32", dict(err=0.0))
            r["err"] = max(r["err"], err)
            qr, kr = apply_rope(q), apply_rope(kk)
            q16, k16, v16 = (t.to(torch.bfloat16) for t in (q, kk, v))
            r[tag] = dict(
                shape=(rows, h, seq, d),
                ms=_time_ms(lambda: FA.flash_attention(q, kk, v, True), iters=3),
                plain_ms=_time_ms(lambda: FA.reference_flash_attention(q, kk, v, True), iters=1),
                bf16_ms=_time_ms(lambda: FA.flash_attention(q16, k16, v16, True), iters=3),
                library_ms=_time_ms(lambda: _sdpa_fp32(qr, kr, v), iters=3),
                **_fp32_attn_bounds(flash_work(rows, h, seq, d, row_bytes=4)),
                kernels=_fp32_attn_launches(label, lambda: FA.flash_attention(q, kk, v, True),
                                            False))
        del qkv, q, kk, v, qr, kr, q16, k16, v16
        torch.cuda.empty_cache()
        return
    go = torch.randn(rows, h, seq, d, generator=gen, device=DEV)
    out = FA.flash_attention(q, kk, v, True)
    (got,) = torch.autograd.grad(out, qkv, go)
    torch.cuda.synchronize()
    _check_launches(label, {k: f.launches for k, f in counters.items()},
                    {"flash_attention_fp32": 1, "flash_attention_fp32_backward": 1}, quiet=True)
    (again,) = torch.autograd.grad(FA.flash_attention(q, kk, v, True), qkv, go)
    torch.cuda.synchronize()
    same = torch.equal(got, again)
    print(f"[fp32-unfused] {label}: two backward runs bit-equal: {same}")
    if not same:
        raise AssertionError(f"{label}: two backward runs differ")
    del again
    ferr, gerr, grel = 0.0, 0.0, 0.0
    for sl in slices:
        leaf = qkv.detach()[sl].requires_grad_(True)
        rq, rk, rv = leaf.permute(2, 0, 3, 1, 4)
        ref_out = FA.reference_flash_attention(rq, rk, rv, True)
        (ref,) = torch.autograd.grad(ref_out, leaf, go[sl])
        ferr = max(ferr, _compare(f"{label} (training) rows {sl.start}..{sl.stop}", out[sl],
                                  ref_out.detach(), FP32_TOL,
                                  null=rv.detach().mean(-2, keepdim=True).expand(ref_out.shape)))
        for i, name in enumerate(("dq", "dk", "dv")):
            gerr = max(gerr, _compare(f"{label} backward {name} rows {sl.start}..{sl.stop}",
                                      got[sl, :, i], ref[:, :, i], FP32_TOL,
                                      null=torch.zeros_like(ref[:, :, i])))
            rel = _rel_l2(got[sl, :, i], ref[:, :, i])
            grel = max(grel, rel)
            if not rel <= FP32_GRAD_REL_L2:
                raise AssertionError(f"{label} backward {name}: relative L2 {rel:.3e}")
        del leaf, ref_out, ref
    print(f"[fp32-unfused] {label} backward: relative L2 <= {grel:.3e} (bound "
          f"{FP32_GRAD_REL_L2:g})")
    del got, out
    q4, k4, v4 = qkv.detach().permute(2, 0, 3, 1, 4)
    g4 = go.permute(0, 2, 1, 3).contiguous()
    o, lse = FA._forward(q4, k4, v4, True, 10000.0, True)
    q16, k16, v16 = (t.to(torch.bfloat16) for t in (q4, k4, v4))
    o16, lse16 = FA._forward(q16, k16, v16, True, 10000.0, True)
    g16 = g4.to(torch.bfloat16)
    times = dict(
        fwd_ms=_time_ms(lambda: FA._forward(q4, k4, v4, True, 10000.0, True), iters=3),
        ms=_time_ms(lambda: FA.flash_attention_backward(g4, q4, k4, v4, o, lse, True, 10000.0),
                    iters=3),
        bf16_fwd_ms=_time_ms(lambda: FA._forward(q16, k16, v16, True, 10000.0, True), iters=3),
        bf16_ms=_time_ms(lambda: FA.flash_attention_backward(g16, q16, k16, v16, o16, lse16,
                                                             True, 10000.0), iters=3))
    kern = (_fp32_attn_launches(label, lambda: FA._forward(q4, k4, v4, True, 10000.0, True),
                                False),
            _fp32_attn_launches(label, lambda: FA.flash_attention_backward(
                g4, q4, k4, v4, o, lse, True, 10000.0), True))
    del o, lse, o16, lse16, q16, k16, v16, g16
    # the plain version recomputes its score groups in the backward
    # (checkpoint): its backward is forward + backward less a forward
    both = _time_ms(lambda: torch.autograd.grad(
        FA.reference_flash_attention(q, kk, v, True), qkv, go), iters=1)
    with torch.no_grad():
        plain_fwd = _time_ms(lambda: FA.reference_flash_attention(q, kk, v, True), iters=1)
    qr, kr = (apply_rope(t.detach()).requires_grad_(True) for t in (q, kk))
    vr = v.detach().requires_grad_(True)
    with torch.no_grad():
        lib_fwd = _time_ms(lambda: _sdpa_fp32(qr, kr, vr), iters=3)
    lib_out = _sdpa_fp32(qr, kr, vr)
    lib_bwd = _time_ms(lambda: torch.autograd.grad(lib_out, (qr, kr, vr), go, retain_graph=True),
                       iters=3)
    r = results.setdefault("flash_attention_fp32", dict(err=0.0))
    r["err"] = max(r["err"], ferr)
    r[tag] = dict(shape=(rows, h, seq, d), ms=times["fwd_ms"], plain_ms=plain_fwd,
                  bf16_ms=times["bf16_fwd_ms"], library_ms=lib_fwd,
                  **_fp32_attn_bounds(flash_work(rows, h, seq, d, row_bytes=4)), kernels=kern[0])
    rb = results.setdefault("flash_attention_fp32_backward", dict(err=0.0, rel_l2=0.0))
    rb["err"], rb["rel_l2"] = max(rb["err"], gerr), max(rb["rel_l2"], grel)
    rb[tag] = dict(shape=(rows, h, seq, d), ms=times["ms"], plain_ms=both - plain_fwd,
                   bf16_ms=times["bf16_ms"], library_ms=lib_bwd,
                   **_fp32_attn_bounds(flash_bwd_work(rows, h, seq, d, row_bytes=4)),
                   kernels=kern[1])
    del qkv, go, q, kk, v, q4, k4, v4, g4, qr, kr, vr, lib_out
    torch.cuda.empty_cache()


def _fp32_attn_launches(label, fn, backward, reps=2, prims=None) -> dict:
    """The launches of one fp32 attention call ``fn`` (#3 or #6, or with
    ``backward`` #4 or #7), caught on ``prims`` (``step_fp32.CudaPrims`` by
    default; a benchmark passes another checkout's): per launch
    ``[launches, device ms]`` a call from CUDA events around each (mean of
    ``reps`` calls; ``attn_bwd`` is the core's dq and dk/dv kernels in one
    call).  Raises when the attention core (``attn_fwd`` / ``attn_bwd``)
    did not run once a call."""
    import torch
    if prims is None:
        from mss_tf_locoformer_tpu_torch.ops.cuda.step_fp32 import CudaPrims as prims
    events, saved = [], []
    for name in ("gemm_nn", "gemm_tn", "reduce", "norm_fwd", "norm_bwd", "mask_rows",
                 "qkv_split", "attn_fwd", "attn_bwd"):
        real = getattr(prims, name)

        def timed(self, *a, _real=real, _name=name, **kw):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = _real(self, *a, **kw)
            ev[1].record()
            events.append((_name, ev))
            return out
        saved.append((name, real))
        setattr(prims, name, timed)
    try:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    finally:
        for name, real in saved:
            setattr(prims, name, real)
    out = {}
    for key, (start, end) in events:
        n, ms = out.get(key, (0, 0.0))
        out[key] = (n + 1, ms + start.elapsed_time(end))
    out = {k: [n / reps, ms / reps] for k, (n, ms) in out.items()}
    core = "attn_bwd" if backward else "attn_fwd"
    print(f"[fp32-kernels] {label} {'backward' if backward else 'forward'}: per launch "
          f"[launches, device ms] a call: " + ", ".join(f"{k} [{n:g}, {ms:.3f}]"
                                                        for k, (n, ms) in out.items()))
    if out.get(core, [0])[0] != 1:
        raise AssertionError(f"{label}: the 3xTF32 core {core} ran {out.get(core, [0])[0]} "
                             f"times a call, not once")
    return out


def _fp32_core_kernels(label, fn, backward, reps=2, S=None, U=None, check=True,
                       tag="fp32-unfused") -> dict:
    """The launches of one fp32 FFN call ``fn`` (#8 or #2, or with
    ``backward`` #9 or #5), caught on the prims: the 3xTF32 kernels of
    ``csrc/ffn_core_fp32.cu`` (``core_nn`` by epilogue, ``core_tn``,
    ``core_colsum``) and those of ``csrc/step_fp32.cu`` (the norms, the
    outer mask, the reductions, and the FFMA GEMMs); per kernel
    ``[launches, device ms]`` a call, the device time from CUDA events
    around each launch (mean of ``reps`` calls; a ``torch.profiler`` trace
    loses its kernels late in this process).  ``S`` / ``U`` are the
    ``step_fp32`` / ``unfused_fp32`` modules whose prims are caught (this
    tree's by default; a benchmark passes another checkout's, with ``U``
    None where it has no ``CorePrims``).  With ``check``, raises when an
    FFMA GEMM (``gemm_nn``, ``gemm_tn``) ran or a 3xTF32 GEMM did not."""
    import torch
    if S is None:
        from mss_tf_locoformer_tpu_torch.ops.cuda import step_fp32 as S
        from mss_tf_locoformer_tpu_torch.ops.cuda import unfused_fp32 as U
    epi = {S.EPI_STORE: "store", S.EPI_SWIGLU: "swiglu", S.EPI_SWIGLU_BWD: "swiglu_bwd",
           S.EPI_OUT: "out"}
    core = {"gemm_nn": "core_nn", "gemm_tn": "core_tn", "colsum": "core_colsum"}
    events = []
    saved = []
    for cls, names, lib in ((S.CudaPrims, ("gemm_nn", "gemm_tn", "colsum", "reduce", "norm_fwd",
                                           "norm_bwd", "mask_rows"), "step_fp32"),
                            (getattr(U, "CorePrims", None), tuple(core), "ffn_core_fp32")):
        for name in names:
            real = getattr(cls, name, None)
            if real is None:
                continue
            kernel = core[name] if lib == "ffn_core_fp32" else name

            def timed(self, *a, _real=real, _key=f"{lib} {kernel}", **kw):
                key = _key + (f" {epi[a[0]]}" if _key.endswith(("core_nn", "gemm_nn")) else "")
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                out = _real(self, *a, **kw)
                ev[1].record()
                events.append((key, ev))
                return out
            saved.append((cls, name, real))
            setattr(cls, name, timed)
    try:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    finally:
        for cls, name, real in saved:
            setattr(cls, name, real)
    out = {}
    for key, (start, end) in events:
        n, ms = out.get(key, (0, 0.0))
        out[key] = (n + 1, ms + start.elapsed_time(end))
    out = {k: [n / reps, ms / reps] for k, (n, ms) in out.items()}
    print(f"[{tag}] {label} {'backward' if backward else 'forward'}: per kernel "
          f"[launches, device ms] a call: " + ", ".join(f"{k} [{n:g}, {ms:.3f}]"
                                                        for k, (n, ms) in out.items()))
    ffma = [k for k in out if k.startswith(("step_fp32 gemm_nn", "step_fp32 gemm_tn"))]
    need = ("core_nn", "core_tn") if backward else ("core_nn",)
    missing = [n for n in need if not any(k.startswith(f"ffn_core_fp32 {n}") for k in out)]
    if check and (ffma or missing):
        raise AssertionError(f"{label}: FFMA GEMMs {ffma} ran, 3xTF32 GEMMs {missing} did not")
    return out


def _fp32_core_case(results, tag, rows, seq, c, inner, k, gen, training, slice_rows=None):
    """#8 (and with ``training`` #9) on fp32 pre-padded rows against the fp32
    plain version (cuDNN without TF32): the whole shape, or with
    ``slice_rows`` a slice of that many rows, run again in as many row
    groups as the whole shape runs (the plain fp32 intermediates of all the
    rows would not fit); the inner mask on a 16-row slice at its row offset;
    exact launches; #9 twice for the same bits; timed at the whole shape
    beside the plain version, the bf16 kernels on the same values and both
    bounds (3xTF32, which the design is held to, and fp32 FFMA); each
    kernel's launches and device ms a call (CUDA events around each launch:
    3xTF32 GEMMs, no FFMA GEMM)."""
    import torch
    from mss_tf_locoformer_tpu_torch.ops.cuda import swiglu_ffn as SF
    from mss_tf_locoformer_tpu_torch.ops.cuda import unfused_fp32 as U32
    lin = seq + 2 * (k - 1)
    x = torch.zeros(rows, lin, c, device=DEV)
    x[:, k - 1:k - 1 + seq] = torch.randn(rows, seq, c, generator=gen, device=DEV)
    b = (c * k) ** -0.5
    w = [(torch.rand(*s, generator=gen, device=DEV) * 2 - 1) * b
         for s in ((2 * inner, c, k), (2 * inner,), (inner, c, k), (c,))]
    fn = lambda *a, p=0.0, r0=0: SF.swiglu_conv_deconv(*a, k, p, 777, r0)
    pfn = lambda *a, p=0.0, r0=0: SF.reference_swiglu_conv_deconv(*a, k, p, 777, r0)
    label = f"swiglu_ffn fp32 {tag} [{rows}, {lin}, {c}], I {inner}"
    counters = _counters()
    for f in counters.values():
        f.launches = 0
    r = results.setdefault("swiglu_ffn_fp32", dict(err=0.0))
    if not training:
        with torch.no_grad():
            got = fn(x, *w)
            torch.cuda.synchronize()
            _check_launches(label, {n: f.launches for n, f in counters.items()},
                            {"swiglu_ffn_fp32": 1}, quiet=True)
            err = _compare(label, got, pfn(x, *w), FP32_TOL, null=torch.zeros_like(got) + w[3])
            del got
            r0 = rows // 2
            xs = x[r0:r0 + 16].contiguous()
            _compare(f"{label} rows {r0}..{r0 + 16}, dropout 0.1", fn(xs, *w, p=0.1, r0=r0),
                     pfn(xs, *w, p=0.1, r0=r0), FP32_TOL, null=pfn(xs, *w))
            torch.cuda.empty_cache()
            x16 = x.to(torch.bfloat16)
            r["err"] = max(r["err"], err)
            work = ffn_core_work(rows, seq, c, inner, k, row_bytes=4)
            r[tag] = dict(shape=(rows, lin, c), ms=_time_ms(lambda: fn(x, *w), iters=3),
                          plain_ms=_time_ms(lambda: pfn(x, *w), iters=1),
                          bf16_ms=_time_ms(lambda: fn(x16, *w), iters=3), library_ms=None,
                          bound=_bound(*work, peak=PEAK_TF32, passes=TF32_PASSES),
                          ffma_bound=_bound(*work, peak=PEAK_FP32),
                          kernels=_fp32_core_kernels(label, lambda: fn(x, *w), False))
        del x, x16, xs, w
        torch.cuda.empty_cache()
        return
    g = torch.randn(rows, lin, c, generator=gen, device=DEV)
    n = slice_rows or rows
    xs, gs = x[:n].contiguous(), g[:n].contiguous()
    out, got = _autograd(fn, xs, w, gs)
    torch.cuda.synchronize()
    _check_launches(label, {nm: f.launches for nm, f in counters.items()},
                    {"swiglu_ffn_fp32": 1, "swiglu_ffn_fp32_backward": 1}, quiet=True)
    ref_out, ref = _autograd(pfn, xs, w, gs)
    ferr = _compare(f"{label} rows 0..{n} (training)", out, ref_out, FP32_TOL,
                    null=torch.zeros_like(out) + w[3])
    gerr, grel = _check_grads(f"{label} backward rows 0..{n}", got, ref, gs, FP32_TOL,
                              FP32_GRAD_REL_L2)
    del out, ref_out
    if slice_rows:   # the slice in as many row groups as the whole shape runs
        groups = -(-rows // U32.core_rows(rows, lin, c, inner, k, True))
        per_row = 4 * 5 * (lin - k + 1) * (-(-inner // 4) * 4)
        cap = per_row * -(-n // groups)
        grouped = SF.swiglu_ffn_backward(gs, xs, *w[:3], k, scratch_cap=cap)
        _check_grads(f"{label} backward rows 0..{n} in {-(-n // (cap // per_row))} row groups",
                     grouped, ref, gs, FP32_TOL, FP32_GRAD_REL_L2)
        del grouped
    del got, ref
    r0 = rows // 2
    xs, gs = x[r0:r0 + 16].contiguous(), g[r0:r0 + 16].contiguous()
    _, got = _autograd(lambda *a: fn(*a, p=0.1, r0=r0), xs, w, gs)
    _, ref = _autograd(lambda *a: pfn(*a, p=0.1, r0=r0), xs, w, gs)
    _check_grads(f"{label} backward rows {r0}..{r0 + 16}, dropout 0.1", got, ref, gs, FP32_TOL,
                 FP32_GRAD_REL_L2)
    del got, ref, xs, gs
    torch.cuda.empty_cache()
    # no atomics: a second run gives the same bits (split partials summed in
    # a fixed order, across the row groups)
    first = SF.swiglu_ffn_backward(g, x, *w[:3], k, 0.1, 777, 0)
    again = SF.swiglu_ffn_backward(g, x, *w[:3], k, 0.1, 777, 0)
    torch.cuda.synchronize()
    same = all(torch.equal(a_, b_) for a_, b_ in zip(first, again))
    print(f"[fp32-unfused] {label} backward (dropout 0.1, "
          f"{-(-rows // U32.core_rows(rows, lin, c, inner, k, True))} row groups): two runs "
          f"bit-equal: {same}")
    if not same:
        raise AssertionError(f"{label}: two backward runs differ")
    del first, again
    torch.cuda.empty_cache()
    x16, g16 = x.to(torch.bfloat16), g.to(torch.bfloat16)
    times = dict(
        fwd_ms=_time_ms(lambda: fn(x, *w), iters=3),
        ms=_time_ms(lambda: SF.swiglu_ffn_backward(g, x, *w[:3], k), iters=2),
        bf16_fwd_ms=_time_ms(lambda: fn(x16, *w), iters=3),
        bf16_ms=_time_ms(lambda: SF.swiglu_ffn_backward(g16, x16, *w[:3], k), iters=2))
    del x16, g16
    torch.cuda.empty_cache()
    with torch.no_grad():
        plain_fwd = _time_ms(lambda: pfn(x, *w), iters=1)
    xp = x.detach().requires_grad_(True)
    wp = [t.detach().requires_grad_(True) for t in w]
    pout = pfn(xp, *wp)
    plain_bwd = _time_ms(lambda: torch.autograd.grad(pout, [xp, *wp], g, retain_graph=True),
                         iters=1)
    del pout, xp, wp
    r["err"] = max(r["err"], ferr)
    work = ffn_core_work(rows, seq, c, inner, k, row_bytes=4)
    r[tag] = dict(shape=(rows, lin, c), ms=times["fwd_ms"], plain_ms=plain_fwd,
                  bf16_ms=times["bf16_fwd_ms"], library_ms=None,
                  bound=_bound(*work, peak=PEAK_TF32, passes=TF32_PASSES),
                  ffma_bound=_bound(*work, peak=PEAK_FP32),
                  kernels=_fp32_core_kernels(label, lambda: fn(x, *w), False))
    rb = results.setdefault("swiglu_ffn_fp32_backward", dict(err=0.0, rel_l2=0.0))
    rb["err"], rb["rel_l2"] = max(rb["err"], gerr), max(rb["rel_l2"], grel)
    work = ffn_core_bwd_work(rows, seq, c, inner, k, row_bytes=4)
    rb[tag] = dict(shape=(rows, lin, c), ms=times["ms"], plain_ms=plain_bwd,
                   bf16_ms=times["bf16_ms"], library_ms=None,
                   bound=_bound(*work, peak=PEAK_TF32, passes=TF32_PASSES),
                   ffma_bound=_bound(*work, peak=PEAK_FP32),
                   kernels=_fp32_core_kernels(
                       label, lambda: SF.swiglu_ffn_backward(g, x, *w[:3], k), True))
    del x, g, w
    torch.cuda.empty_cache()


def phase_unfused_fp32_kernels(results):
    """#6-#9 on fp32 rows against their fp32 plain versions: #6 and #8 at the
    xlarge engine batch's serving shapes, #6 with its stash and #7, #8 and #9
    at the small config's training shapes (batch 16 x 3 s), #9 at the xlarge
    training shapes (micro-batch 1 x 15 s: a 64-row slice, also in as many
    row groups as the whole shape runs; the whole shape twice for the same
    bits); one fp32 launch a call and none of the bf16 kernels; timed beside
    the plain versions, the bf16 kernels on the same values, the fp32 bound
    and, for #6 and #7, SDPA on fp32 q, k, v."""
    import torch
    gen = torch.Generator(device=DEV).manual_seed(SEED + 40)
    xl = xlarge_model_config()
    h, d = xl.n_heads, xl.attention_dim // xl.n_heads
    for path, rows, seq in _main_path_steps(xl):
        _fp32_flash_case(results, f"xlarge {path}", rows, h, seq, d, gen, False)
        _fp32_core_case(results, f"xlarge {path}", rows, seq, xl.emb_dim, _inner_dims(xl)[0],
                        xl.conv1d_kernel, gen, False)
    for name, path, rows, h, seq, d, c, inner in _unfused_train_shapes():
        tag = f"{name} training {path}"
        if name == "small":
            _fp32_flash_case(results, tag, rows, h, seq, d, gen, True)
            _fp32_core_case(results, tag, rows, seq, c, inner, 4, gen, True)
        else:
            _fp32_core_case(results, tag, rows, seq, c, inner, 4, gen, True, slice_rows=64)


def _stems_of(out_dir, name):
    from mss_tf_locoformer_tpu_torch.utils.audio import load_audio
    return {s: load_audio(os.path.join(out_dir, f"{name}_{s}.wav"))[0]
            for s in ("vocals", "drums", "bass", "other")}


def phase_xlarge_fp32_serving(workdir):
    """The separation CLI at ``--precision fp32`` on a 15 s stereo WAV (one
    engine batch of 2 chunks of 8 s): at full depth with the xlarge config
    (12 layers, exact fp32 launches: per forward 24 of #6 and 48 of #8, no
    bf16 kernel), its wall time, realtime factor and peak device memory; at
    2 layers (full width) on the kernel route and on the plain route, every
    stem within ``FP32_TOL`` of its peak and one 16-bit step of the plain
    route's.  Returns ``(launches, wall, peak bytes, worst stem error)``."""
    import dataclasses

    import numpy as np
    import torch
    from mss_tf_locoformer_tpu_torch.cli import separate as cli
    from mss_tf_locoformer_tpu_torch.models import build_model
    from mss_tf_locoformer_tpu_torch.utils.audio import save_audio
    rng = np.random.default_rng(SEED + 3)
    t = np.arange(int(XL_FP32_SERVE_S * SR)) / SR
    mix = np.stack([0.3 * np.sin(2 * np.pi * f * t) + 0.05 * rng.standard_normal(t.size)
                    for f in (220, 330)]).astype(np.float32)
    wav = os.path.join(workdir, "mix.wav")
    save_audio(wav, mix, SR, normalize=True)
    counters = _counters()

    def run(cfg, tag):
        model = build_model(cfg, generator=torch.Generator().manual_seed(SEED))
        ckpt, cfg_path = (os.path.join(workdir, f"{tag}.{ext}") for ext in ("pth", "json"))
        torch.save(model.state_dict(), ckpt)
        del model
        with open(cfg_path, "w") as f:
            json.dump({"model": dataclasses.asdict(cfg)}, f)
        out_dir = os.path.join(workdir, tag)
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        cli.main(["--input", wav, "--output_dir", out_dir, "--checkpoint", ckpt, "--config",
                  cfg_path, "--batch_size", str(BATCH), "--precision", "fp32"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
        stems = _stems_of(out_dir, "mix")
        for s, a in stems.items():
            if a.shape != mix.shape or not np.isfinite(a).all():
                raise AssertionError(f"xlarge fp32 {tag} stem {s}: {a.shape}")
        return launches, wall, torch.cuda.max_memory_allocated(), stems

    xl = xlarge_model_config()
    paths = 2 * xl.n_layers
    launches, wall, peak, _ = run(xl, "xlarge")
    _check_launches("xlarge fp32 serving", launches, {
        "stft": 1, "flash_attention_fp32": paths, "swiglu_ffn_fp32": 2 * paths})
    print(f"[xl-fp32-serving] separation CLI, --precision fp32, {xl.n_layers} layers, "
          f"{XL_FP32_SERVE_S:g} s stereo (one engine batch): {wall:.2f} s wall, "
          f"{XL_FP32_SERVE_S / wall:.3f}x realtime, peak {peak / 2**30:.2f} GiB")
    cut = dataclasses.replace(xl, n_layers=XL_FP32_LAYERS)
    got = run(cut, "kernel")
    _check_launches("xlarge fp32 serving, 2 layers", got[0], {
        "stft": 1, "flash_attention_fp32": 2 * XL_FP32_LAYERS,
        "swiglu_ffn_fp32": 4 * XL_FP32_LAYERS})
    ref = run(_plain_config(cut), "plain")
    if any(ref[0].values()):
        raise AssertionError(f"the plain route launched kernels: {ref[0]}")
    worst = 0.0
    for s, a in got[3].items():
        b = ref[3][s]
        err = float(np.abs(a - b).max())
        bound = FP32_TOL * float(np.abs(b).max()) + 1.0 / 32768
        worst = max(worst, err / float(np.abs(b).max()))
        print(f"[xl-fp32-serving] 2 layers, stem {s}: max error {err:.3e} against the plain "
              f"route's (bound {bound:.3e}: {FP32_TOL:g} of the peak and one 16-bit step)")
        if not err <= bound:
            raise AssertionError(f"xlarge fp32 stems: {s} off by {err:.3e}")
    torch.cuda.empty_cache()
    return launches, wall, peak, worst


def phase_fp32_unfused_steps(reps: int = 1):
    """``use_amp: false`` steps through the unfused route's fp32 kernels,
    kernel path against the plain path with the same weights, batch and
    seeds (loss and grad_norm within ``FP32_LOSS_REL``), exact launches and
    the peak device memory: the small config (dropout 0, #6-#9; parity at 2
    x 3 s, then the published batch 16 x 3 s timed) and one xlarge micro-
    batch (1 x 3 s, 2 layers at full width, remat, dropout 0.1: #8 twice
    and #9 once per FFN, attention on the plain path with the mask kernel).
    Returns ``{tag: {...}}``."""
    import dataclasses

    import torch
    from mss_tf_locoformer_tpu_torch.core.config import LossConfig, TrainingConfig
    from mss_tf_locoformer_tpu_torch.core.precision import FP32
    from mss_tf_locoformer_tpu_torch.train.state import make_optimizer
    from mss_tf_locoformer_tpu_torch.train.step import train_step
    counters = _counters()
    out = {}
    small = small_model_config()
    xl = dataclasses.replace(xlarge_model_config(), n_layers=XL_FP32_LAYERS, remat_blocks=True)
    for tag, cfg, loss, parity_mb, full_mb, seg in (
            ("small", small, LossConfig(loss_type="si_sdr", si_sdr_weight=1.0), 2, SMALL_BATCH,
             SMALL_SEGMENT),
            ("xlarge micro-batch", xl, LossConfig(), 1, None, XL_FP32_SEGMENT)):
        models = dict(zip(("kernel", "plain"), _train_models(cfg, FP32)))
        opts = {p: make_optimizer(m.parameters(), TrainingConfig()) for p, m in models.items()}

        def step(path, batch):
            return train_step(models[path], opts[path], *batch, 3e-4,
                              torch.Generator().manual_seed(11), loss, accum=1,
                              gradient_clip=5.0)
        paths = 2 * cfg.n_layers
        ffns = paths * len(_inner_dims(cfg))
        batch = _batch(torch.Generator().manual_seed(SEED + 6), parity_mb, seg, DEV)
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        got = step("kernel", batch)
        torch.cuda.synchronize()
        sec, peak = time.perf_counter() - t0, torch.cuda.max_memory_allocated()
        launches = {k: fn.launches for k, fn in counters.items()}
        if tag == "small":
            need = {"flash_attention_fp32": paths, "flash_attention_fp32_backward": paths,
                    "swiglu_ffn_fp32": ffns, "swiglu_ffn_fp32_backward": ffns, "stft": 1}
        else:
            if not launches["dropout_mask"] > 0:
                raise AssertionError("xlarge fp32 step drew no dropout mask on the card")
            need = {"swiglu_ffn_fp32": 2 * ffns, "swiglu_ffn_fp32_backward": ffns, "stft": 1,
                    "dropout_mask": launches["dropout_mask"]}
        _check_launches(f"fp32 unfused step {tag}", launches, need)
        ref = step("plain", batch)
        rel = {k: abs(float(got[k]) - float(ref[k])) / abs(float(ref[k]))
               for k in ("total_loss", "grad_norm")}
        print(f"[fp32-unfused-train] {tag}, use_amp false, micro-batch {parity_mb} x "
              f"{seg / SR:g} s: loss kernel {float(got['total_loss']):.6f} plain "
              f"{float(ref['total_loss']):.6f}; relative differences "
              + ", ".join(f"{k} {v:.2e}" for k, v in rel.items())
              + f" (bound {FP32_LOSS_REL:g}); kernel-path step {sec:.3f} s (the first), peak "
              f"{peak / 2**30:.2f} GiB")
        if not max(rel.values()) <= FP32_LOSS_REL:
            raise AssertionError(f"fp32 unfused step {tag}: {rel}")
        out[tag] = dict(launches=launches, rel=rel, sec=sec, peak=peak, mb=parity_mb, seg=seg)
        if full_mb:
            del batch
            full = _batch(torch.Generator().manual_seed(SEED + 7), full_mb, seg, DEV)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            step("kernel", full)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            t0 = time.perf_counter()
            for _ in range(reps):
                step("kernel", full)
            torch.cuda.synchronize()
            sec = (time.perf_counter() - t0) / reps
            print(f"[fp32-unfused-train] {tag}, use_amp false, kernel path at the published "
                  f"batch {full_mb} x {seg / SR:g} s: {sec:.3f} s/step, peak "
                  f"{peak / 2**30:.2f} GiB")
            out[tag].update(full_sec=sec, full_peak=peak, full_mb=full_mb)
            del full
        del models, opts
        torch.cuda.empty_cache()
    return out


def phase_mfu(forward, train_time):
    """``utils/flops.py`` on the card: ``device_peak_flops`` (the H100's
    dense bf16 peak from its name), and the MFU of the base forward (the
    engine batch) and of the base train step (one micro-batch), from the
    analytic FLOP and the measured times."""
    import torch
    from mss_tf_locoformer_tpu_torch.utils import flops as FL
    peak = FL.device_peak_flops()
    name = torch.cuda.get_device_name(0)
    if peak is None:
        raise AssertionError(f"device_peak_flops knows no peak for {name}")
    cfg = base_model_config()
    fwd_flop = FL.tflocoformer_forward_flops(cfg, BATCH, CHUNK)
    step_flop = FL.train_step_flops(cfg, TRAIN_MB, SEGMENT)
    fwd_s, step_s = forward["kernel"][0] / 1e3, train_time["kernel"][0]
    out = {"peak": peak, "forward_flop": fwd_flop, "step_flop": step_flop,
           "forward_mfu": fwd_flop / fwd_s / peak, "step_mfu": step_flop / step_s / peak}
    print(f"[mfu] device_peak_flops ({name}): {peak / 1e12:.1f} TFLOP/s dense bf16; base "
          f"forward [{BATCH}, {CHUNK}] {fwd_flop / 1e12:.3f} TFLOP in {1e3 * fwd_s:.1f} ms: MFU "
          f"{100 * out['forward_mfu']:.2f}%; base train step [{TRAIN_MB}, {SEGMENT}] "
          f"{step_flop / 1e12:.3f} TFLOP in {step_s:.3f} s: MFU {100 * out['step_mfu']:.2f}%")
    return out


def _trace_file(log_dir, tag):
    """The one ``torch.profiler`` trace a training run with ``profile_steps``
    leaves under ``log_dir/plugins/profile``; fails if there is none or it
    holds no device kernel."""
    import glob
    files = glob.glob(os.path.join(log_dir, "plugins", "profile", "*", "*.pt.trace.json"))
    if len(files) != 1:
        raise AssertionError(f"{tag}: traces {files}")
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    print(f"[profile] {tag}: {files[0]} ({os.path.getsize(files[0])} bytes, "
          f"{len(events)} events, {kernels} device kernels)")
    if not kernels:
        raise AssertionError(f"{tag}: the trace holds no device kernel")
    return files[0]


# ------------------------------------------------------------ parallel runs

TP_MPS = (2, 4)
TP_FFN_KEYS = ("ffn.0.conv1d.weight", "ffn.0.conv1d.bias", "ffn.0.deconv1d.weight")
TP_ATTN_KEYS = ("attn.qkv.weight", "attn.aggregate_heads.0.weight")
RANK_TIMEOUT_S = 300   # each spawned rank; a rank that hangs fails the phase


def _tp_cases(cfg, bias):
    """Per fused step: (split keys, the whole kernel, its plain version, the
    partial-sum kernel of one of mp shards, its plain version), all as
    ``fn(x, gamma, *weights)``."""
    from mss_tf_locoformer_tpu_torch.ops.cuda import attention_block as AB
    from mss_tf_locoformer_tpu_torch.ops.cuda import swiglu_block as FB
    k, gr, eps, h = cfg.conv1d_kernel, cfg.num_groups, cfg.eps, cfg.n_heads
    return {
        "ffn_step": (
            TP_FFN_KEYS,
            lambda x, gm, *w: FB.fused_norm_ffn_residual(x, gm, *w, bias, k, gr, eps),
            lambda x, gm, *w: FB.reference_norm_ffn_residual(x, gm, *w, bias, k, gr, eps),
            lambda mp, *d: lambda x, gm, *w: FB.fused_norm_ffn_residual(
                x, gm, *w, None, k, gr, eps, *d, residual=False),
            lambda mp, *d: lambda x, gm, *w: FB.reference_norm_ffn_residual(
                x, gm, *w, None, k, gr, eps, *d, residual=False)),
        "attention_step": (
            TP_ATTN_KEYS,
            lambda x, gm, *w: AB.fused_attention_block(x, gm, *w, h, gr, eps),
            lambda x, gm, *w: AB.reference_attention_block(x, gm, *w, h, gr, eps),
            lambda mp, *d: lambda x, gm, *w: AB.fused_attention_block(
                x, gm, *w, h // mp, gr, eps, True, 10000.0, *d, residual=False),
            lambda mp, *d: lambda x, gm, *w: AB.reference_attention_block(
                x, gm, *w, h // mp, gr, eps, True, 10000.0, *d, residual=False))}


def phase_partial_kernels(results):
    """#2-#5's partial-sum mode (``residual=False``, the tensor-parallel
    steps') at the base config's full width (C 96, 4 heads of 24, I 384) and
    the base training shapes, with mp 2 and 4: each shard's forward and
    backward on the card (``parallel/sharding.py``'s shards: at mp 4 one
    head of 24), summed, the bias and the residual added outside, against
    the whole step's kernel and its plain version at dropout 0 (outputs and
    dx by STEP_TOL, gamma and the gathered weight gradients by relative L2);
    at dropout 0.1 on a 16-row slice, one shard's kernels against its plain
    version (the in-kernel masks replayed from forward to backward) and the
    masks' keep rates; each shard's kernels timed beside the whole ones."""
    import torch
    from mss_tf_locoformer_tpu_torch.ops.cuda import attention_block as AB
    from mss_tf_locoformer_tpu_torch.ops.cuda import swiglu_block as FB
    from mss_tf_locoformer_tpu_torch.parallel.sharding import shard_tensor, unshard_tensor
    cfg = base_model_config()
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(SEED + 12)
    for path, rows, seq in _train_steps(cfg):
        x, gamma, ffn, attn = _step_inputs(gen, rows, seq, dev)
        g = _rand(gen, (rows, seq, 96)).to(dev, torch.bfloat16)
        for name, (keys, full, plain, part, plain_part) in _tp_cases(cfg, ffn[3]).items():
            whole = ffn[:3] if name == "ffn_step" else attn
            add = ffn[3].float() if name == "ffn_step" else 0.0
            out_full, grads_full = _autograd(full, x, [gamma, *whole], g)
            out_plain, grads_plain = _autograd(plain, x.float(), [gamma, *whole], g.float())
            torch.cuda.synchronize()
            full_ms = _timed_grad(full, x, [gamma, *whole], g)
            for mp in TP_MPS:
                label = f"{name} {path} [{rows}, {seq}, 96], mp {mp}"
                out_sum, dx_sum, dgamma, dws = x.float() + add, g.float(), 0.0, []
                for i in range(mp):
                    shards = [shard_tensor(kk, w, i, mp) for kk, w in zip(keys, whole)]
                    o, gr = _autograd(part(mp), x, [gamma, *shards], g)
                    out_sum, dx_sum = out_sum + o.float(), dx_sum + gr[0].float()
                    dgamma, dws = dgamma + gr[1], dws + [gr[2:]]
                    del o, gr
                summed = out_sum.to(torch.bfloat16)
                err = max(_compare(f"{label}: summed shards vs the whole kernel", summed,
                                   out_full, STEP_TOL, null=x),
                          _compare(f"{label}: summed shards vs the plain version", summed,
                                   out_plain, STEP_TOL, null=x))
                got = [dx_sum.to(torch.bfloat16), dgamma,
                       *[unshard_tensor(kk, [d[j] for d in dws]) for j, kk in enumerate(keys)]]
                gerr, grel = _check_grads(f"{label}: summed shards' backward vs plain", got,
                                          grads_plain, g)
                for i, (a, b) in enumerate(zip(got, grads_full)):
                    rel = _rel_l2(a, b)
                    if not rel <= GRAD_REL_L2:
                        raise AssertionError(f"{label}: gradient {i} against the whole kernel's "
                                             f"relative L2 {rel:.3e}")
                shards = [shard_tensor(kk, w, 0, mp) for kk, w in zip(keys, whole)]
                fwd_ms, bwd_ms = _timed_grad(part(mp), x, [gamma, *shards], g)
                pf, pb = _timed_grad(plain_part(mp), x, [gamma, *shards], g, iters=1)
                r = results.setdefault(name + "_partial", dict(err=0.0, rel_l2=0.0))
                r["err"], r["rel_l2"] = max(r["err"], err, gerr), max(r["rel_l2"], grel)
                d_ff, d_at = 384 // mp, 96 // mp
                work = (ffn_work(rows, seq, inner=d_ff) + (0.0,) if name == "ffn_step"
                        else attn_work(rows, seq, a=d_at, h=4 // mp))
                r[f"{path} mp{mp}"] = dict(
                    rows=rows, seq=seq, fwd_ms=fwd_ms, ms=bwd_ms, plain_fwd_ms=pf, plain_ms=pb,
                    full_fwd_ms=full_ms[0], full_ms=full_ms[1],
                    fwd_bound=_bound(work[0], work[1], work[4]),
                    bound=_bound(work[2], work[3], work[4]))
                print(f"[tp-kernels] {label}: shard forward {fwd_ms:.3f} ms, backward "
                      f"{bwd_ms:.3f} ms (whole step {full_ms[0]:.3f} / {full_ms[1]:.3f} ms; "
                      f"plain shard {pf:.3f} / {pb:.3f} ms)")
                del shards, dws, got, out_sum, dx_sum, summed
            del out_full, grads_full, out_plain, grads_plain
            torch.cuda.empty_cache()

            # dropout 0.1 on 16 rows: the in-kernel masks of one shard, forward
            # and backward, against its plain version (the same masks)
            r0 = rows // 2
            xs, gs = x[r0:r0 + 16].contiguous(), g[r0:r0 + 16].contiguous()
            for mp in TP_MPS:
                shards = [shard_tensor(kk, w, mp - 1, mp) for kk, w in zip(keys, whole)]
                out, got = _autograd(part(mp, 0.1, 777, r0), xs, [gamma, *shards], gs)
                ref_out, ref = _autograd(plain_part(mp, 0.1, 777, r0), xs.float(),
                                         [gamma, *shards], gs.float())
                torch.cuda.synchronize()
                _compare(f"{name} {path} rows {r0}..{r0 + 16}, mp {mp}, dropout 0.1 forward",
                         out, ref_out, STEP_TOL)
                _check_grads(f"{name} {path} rows {r0}..{r0 + 16}, mp {mp}, dropout 0.1", got,
                             ref, gs)
                if name == "ffn_step":
                    keep = FB.inner_mask(777, torch.empty(16, 384 // mp, seq + 3, device=dev),
                                         r0, 0.1)
                else:
                    keep = AB.probability_mask(777, torch.arange(r0, r0 + 16, device=dev),
                                               4 // mp, seq, 0.1, device=dev)
                rate = keep.float().mean().item()
                print(f"[tp-kernels] {name} {path} mp {mp}: in-kernel keep rate {rate:.4f} "
                      f"(p 0.1)")
                if not abs(rate - 0.9) < 0.01:
                    raise AssertionError(f"{name} mp {mp}: keep rate {rate}")
                del out, got, ref_out, ref, keep
            torch.cuda.empty_cache()
        del x, g, ffn, attn
        torch.cuda.empty_cache()


def _spawn_ranks(argvs, workdir, tag, env=None):
    """Run one process per argv (from this checkout, PYTHONPATH set) and
    wait for all, each under RANK_TIMEOUT_S; a failure or a hang kills them
    all and raises.  Returns each one's output."""
    env = dict(os.environ, PYTHONPATH=HERE, **(env or {}))
    logs = [open(os.path.join(workdir, f"{tag}_{i}.log"), "w+") for i in range(len(argvs))]
    procs = [subprocess.Popen(a, cwd=HERE, env=env, stdout=f, stderr=subprocess.STDOUT)
             for a, f in zip(argvs, logs)]
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        rcs = [p.wait(timeout=max(1.0, deadline - time.monotonic())) for p in procs]
    except subprocess.TimeoutExpired:
        rcs = ["timeout"] * len(procs)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for f in logs:
        f.seek(0)
        outs.append(f.read())
        f.close()
    if any(rc != 0 for rc in rcs):
        raise AssertionError(f"{tag}: ranks exited {rcs}:\n" + "\n".join(
            f"--- rank {i}\n{o[-4000:]}" for i, o in enumerate(outs)))
    return outs


def _free_port():
    import socket
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


TP_STEPS = 2       # optimizer steps of each parallel training run
TP_BATCH = 4       # the global batch: 2 micro-batches of 2 x 3 s


def _tp_train_runs(model_path, batch_path, mesh, counters, log=print):
    """``TP_STEPS`` AdamW steps (dropout 0, clip 5, accumulation 2) of the
    base model from ``model_path`` on the global batch of ``batch_path``
    under ``mesh`` (None: one process); returns per step (loss, grad_norm,
    seconds) and the launches of #2-#5."""
    import torch
    from mss_tf_locoformer_tpu_torch.core.config import LossConfig, TrainingConfig
    from mss_tf_locoformer_tpu_torch.core.precision import BF16
    from mss_tf_locoformer_tpu_torch.models import build_model
    from mss_tf_locoformer_tpu_torch.parallel import mesh as M
    from mss_tf_locoformer_tpu_torch.parallel import multihost as MH
    from mss_tf_locoformer_tpu_torch.parallel.sharding import shard_module
    from mss_tf_locoformer_tpu_torch.train.state import make_optimizer
    from mss_tf_locoformer_tpu_torch.train.step import train_step
    import dataclasses
    cfg = dataclasses.replace(base_model_config(), dropout=0.0)
    model = build_model(cfg, BF16)
    model.load_state_dict(torch.load(model_path, weights_only=True), strict=True)
    model = model.to("cuda").train()
    mix, tg = torch.load(batch_path, weights_only=True)
    if mesh is not None:
        shard_module(model, mesh)
        if mesh.dp > 1:
            mix, tg = M.shard_batch(mesh, mix), M.shard_batch(mesh, tg)
    mix, tg = mix.cuda(), {k: v.cuda() for k, v in tg.items()}
    opt = make_optimizer(model.parameters(), TrainingConfig())
    for fn in counters.values():
        fn.launches = 0
    out = []
    with M.activate_mesh(mesh):
        for _ in range(TP_STEPS):
            MH.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ld = train_step(model, opt, mix, tg, 5e-4, torch.Generator().manual_seed(11),
                            LossConfig(), accum=2, gradient_clip=5.0)
            loss, norm = float(ld["total_loss"]), float(ld["grad_norm"])
            torch.cuda.synchronize()
            out.append((loss, norm, time.perf_counter() - t0))
    launches = {k: counters[k].launches for k in ("ffn_step", "attention_step",
                                                  "ffn_step_backward", "attention_step_backward")}
    del model, opt
    torch.cuda.empty_cache()
    return out, launches


def rank_main(argv):
    """``chip_smoke.py --rank train RANK WORLD PORT WORKDIR``: one rank of
    ``phase_parallel``'s training runs (2 ranks on one card over gloo):
    mesh dp 2 then mp 2; writes ``WORKDIR/train_rank<RANK>.json``."""
    sys.path.insert(0, HERE)
    import torch.distributed as dist
    from mss_tf_locoformer_tpu_torch.parallel import mesh as M
    from mss_tf_locoformer_tpu_torch.parallel import multihost as MH
    mode, rank, world, port, workdir = argv
    rank, world = int(rank), int(world)
    dev = MH.initialize(f"127.0.0.1:{port}", world, rank, device="cuda:0", timeout=120.0)
    print(f"[rank {rank}] device {dev}, backend {dist.get_backend()}", flush=True)
    counters = _counters()
    out = {"backend": dist.get_backend()}
    for dp, mp in ((2, 1), (1, 2)):
        steps, launches = _tp_train_runs(os.path.join(workdir, "base.pth"),
                                         os.path.join(workdir, "batch.pt"), M.make_mesh(dp, mp),
                                         counters)
        out[f"dp{dp} mp{mp}"] = {"steps": steps, "launches": launches}
        print(f"[rank {rank}] dp {dp} mp {mp}: {steps}; launches {launches}", flush=True)
    with open(os.path.join(workdir, f"{mode}_rank{rank}.json"), "w") as f:
        json.dump(out, f)
    MH.barrier()
    dist.destroy_process_group()


def phase_parallel(workdir):
    """Parallel runs on the card: two ranks share cuda:0 over gloo (NCCL
    refuses two ranks on one GPU).  (1) The base model trained TP_STEPS
    steps at mesh dp 2 mp 1 and dp 1 mp 2 (dropout 0): losses and grad_norm
    per step against the single-process run on the same global batch, the
    launches of #2-#5 per rank exactly, the step timed.  (2) The evaluation
    CLI on 2 ranks: its merged ``results.json`` equal to a one-rank run's.
    (3) A world-1 NCCL process group, under which the training CLI runs one
    step.  Returns the numbers for the report and the kernel line."""
    import torch
    from mss_tf_locoformer_tpu_torch.cli import evaluate as eval_cli
    from mss_tf_locoformer_tpu_torch.models import build_model
    cfg = base_model_config()
    torch.save(build_model(cfg, generator=torch.Generator().manual_seed(SEED)).state_dict(),
               os.path.join(workdir, "base.pth"))
    mix, tg = _batch(torch.Generator().manual_seed(SEED + 6), TP_BATCH, SEGMENT, "cpu")
    torch.save((mix, tg), os.path.join(workdir, "batch.pt"))
    port = _free_port()
    argv = lambda r: [sys.executable, os.path.join(HERE, "chip_smoke.py"), "--rank", "train",
                      str(r), "2", str(port), workdir]
    t0 = time.perf_counter()
    _spawn_ranks([argv(0), argv(1)], workdir, "train")
    ranks_wall = time.perf_counter() - t0
    single, single_launches = _tp_train_runs(os.path.join(workdir, "base.pth"),
                                             os.path.join(workdir, "batch.pt"), None, _counters())
    out = {"single": single, "ranks_wall": ranks_wall}
    # per micro-batch 2 paths x 4 layers: 2 FFN steps and 1 attention step each
    micro = {"dp2 mp1": 2, "dp1 mp2": 2}
    for r in (0, 1):
        with open(os.path.join(workdir, f"train_rank{r}.json")) as f:
            res = json.load(f)
        if res["backend"] != "gloo":
            raise AssertionError(f"two ranks on one card took {res['backend']}, not gloo")
        for run, n in micro.items():
            steps, launches = res[run]["steps"], res[run]["launches"]
            need = {"ffn_step": 16 * n * TP_STEPS, "attention_step": 8 * n * TP_STEPS}
            need.update({k + "_backward": v for k, v in need.items()})
            _check_launches(f"parallel {run} rank {r}", launches, need)
            for i, ((loss, norm, sec), (l1, n1, _)) in enumerate(zip(steps, single)):
                rl, rn = abs(loss - l1) / abs(l1), abs(norm - n1) / abs(n1)
                print(f"[parallel] {run} rank {r} step {i}: loss {loss:.5f} (one process "
                      f"{l1:.5f}, relative {rl:.2e}), grad_norm {norm:.4f} ({n1:.4f}, "
                      f"relative {rn:.2e}), {sec:.3f} s")
                if not (rl <= STEP_LOSS_REL and rn <= STEP_LOSS_REL):
                    raise AssertionError(f"parallel {run} rank {r} step {i}: loss or grad_norm "
                                         f"off the one-process run (bound {STEP_LOSS_REL:g})")
            out[f"{run} rank {r}"] = res[run]
    _check_launches("parallel one process", single_launches,
                    {"ffn_step": 32 * TP_STEPS, "attention_step": 16 * TP_STEPS,
                     "ffn_step_backward": 32 * TP_STEPS, "attention_step_backward": 16 * TP_STEPS})

    # (2) the evaluation CLI: one rank here, then 2 ranks on the card
    root = os.path.join(workdir, "musdb")
    _write_musdb(root, n_train=8, n_test=2, seconds=EVAL_TRACK_S)
    cfg_path = os.path.join(workdir, "eval.json")
    with open(cfg_path, "w") as f:
        json.dump(_eval_config(root, cfg), f)
    args = ["--config", cfg_path, "--checkpoint", os.path.join(workdir, "base.pth")]
    one = eval_cli.main(args + ["--output_dir", os.path.join(workdir, "eval1"), "--device", "cuda"])
    port = _free_port()
    t0 = time.perf_counter()
    _spawn_ranks([[sys.executable, "-m", "mss_tf_locoformer_tpu_torch.cli.evaluate", *args,
                   "--output_dir", os.path.join(workdir, "eval2"), "--device", "cuda:0",
                   "--coordinator_address", f"127.0.0.1:{port}", "--num_processes", "2",
                   "--process_id", str(r)] for r in (0, 1)], workdir, "evaluate")
    out["eval_wall"] = time.perf_counter() - t0
    with open(os.path.join(workdir, "eval2", "results.json")) as f:
        two = json.load(f)
    if two != json.loads(json.dumps(one)):
        raise AssertionError(f"2-rank results.json differs from the one-rank run's:\n{two}\n{one}")
    print(f"[parallel] evaluation CLI on 2 ranks: results.json equal to the one-rank run's "
          f"({sorted(two['per_track'])}), {out['eval_wall']:.1f} s with start-up")

    # (3) world-1 NCCL under the training CLI: one step (8 tracks, batch 8)
    train_path = os.path.join(workdir, "train.json")
    raw = _train_config(root, 1)
    raw["model"]["dropout"] = 0.0
    with open(train_path, "w") as f:
        json.dump(raw, f)
    t0 = time.perf_counter()
    log = _spawn_ranks([[sys.executable, "-m", "mss_tf_locoformer_tpu_torch.cli.train",
                         "--config", train_path, "--device", "cuda", "--distributed",
                         "--output_dir", os.path.join(workdir, "nccl")]], workdir, "nccl",
                       env={"WORLD_SIZE": "1", "RANK": "0", "LOCAL_RANK": "0",
                            "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port())})[0]
    out["nccl_wall"] = time.perf_counter() - t0
    if "1 ranks over nccl" not in log or "epoch 0 step 1 " not in log:
        raise AssertionError(f"world-1 NCCL training run: {log[-3000:]}")
    if not os.path.exists(os.path.join(workdir, "nccl", "checkpoints",
                                       "checkpoint_epoch0000.pth")):
        raise AssertionError("world-1 NCCL training run wrote no checkpoint")
    print(f"[parallel] training CLI under a world-1 NCCL process group: 1 step, validation "
          f"and a checkpoint in {out['nccl_wall']:.1f} s with start-up")
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
    phase_fp32_gates()
    results = {}
    phase_kernels(results)
    phase_slice_parity(need={"stft": 1, "ffn_step": 16, "attention_step": 8})
    with tempfile.TemporaryDirectory() as workdir:
        launches, wall, seconds = phase_slice(workdir)
    # the fused steps and nothing else: 2 forwards (3 chunks in batches of 2)
    _check_launches("slice", launches, {"stft": 2, "ffn_step": 32, "attention_step": 16})
    forward = phase_forward()
    _mark("base serving")

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
    _mark("xlarge serving")

    phase_train_kernels(results)
    phase_attention_stream(results)
    with tempfile.TemporaryDirectory() as workdir:
        train_launches, train_wall = phase_train(workdir)
    phase_train_parity()
    train_time = phase_train_timing()
    mfu = phase_mfu(forward, train_time)
    peak_gib = train_time["kernel"][1] / 2**30
    print(f"[train] kernel-path train step peak {peak_gib:.3f} GiB (bound "
          f"{BASE_TRAIN_PEAK_GIB} GiB, the wmma backward's)")
    if not peak_gib <= BASE_TRAIN_PEAK_GIB:
        raise AssertionError(f"train step: peak {peak_gib:.3f} GiB above the wmma backward's "
                             f"{BASE_TRAIN_PEAK_GIB} GiB")

    _mark("base training")
    phase_unfused_train_kernels(results)
    xl_train, xl_train_launches, xl_next_peak = phase_xlarge_train_step()
    phase_xlarge_train_parity()
    unfused_cli = {}
    for tag in ("small", "xlarge"):
        with tempfile.TemporaryDirectory() as workdir:
            unfused_cli[tag] = phase_unfused_train_cli(workdir, tag)

    _mark("unfused training")
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

    _mark("istft, BS serving, evaluation")
    t_speech = time.perf_counter()
    phase_speech_gates()
    phase_speech_kernels(results)
    phase_fp32_kernels(results)
    _mark("speech and fp32 kernels")
    phase_speech_parity()
    phase_fp32_speech_parity()
    with tempfile.TemporaryDirectory() as workdir:
        speech_launches, speech_wall, speech_audio_s = phase_speech_serving(workdir)
    with tempfile.TemporaryDirectory() as workdir:
        speech_train = phase_speech_train(workdir)
    speech_time = phase_speech_train_timing()
    fp32_train = phase_fp32_train_steps()
    _mark("speech training, fp32 train steps")
    with tempfile.TemporaryDirectory() as workdir:
        speech_eval = phase_speech_evaluate(workdir)
    phase_bs_train_parity()
    with tempfile.TemporaryDirectory() as workdir:
        bs_train = phase_bs_train(workdir)
    bs_time = phase_train_timing(cfg=bs)
    t_speech = time.perf_counter() - t_speech

    t_fp32u = time.perf_counter()
    phase_unfused_fp32_gates()
    phase_unfused_fp32_kernels(results)
    _mark("fp32 unfused kernels")
    with tempfile.TemporaryDirectory() as workdir:
        xl_fp32 = phase_xlarge_fp32_serving(workdir)
    fp32_unfused_train = phase_fp32_unfused_steps()
    with tempfile.TemporaryDirectory() as workdir:
        small_fp32_cli = phase_unfused_train_cli(workdir, "small", amp=False)
    t_fp32u = time.perf_counter() - t_fp32u
    _mark("fp32 unfused serving and training")

    t_parallel = time.perf_counter()
    phase_partial_kernels(results)
    with tempfile.TemporaryDirectory() as workdir:
        parallel = phase_parallel(workdir)
    t_parallel = time.perf_counter() - t_parallel

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
    r = results["attention_step"]
    for path in ("freq", "time"):
        split = "; ".join(f"{n} {t:.3f} ms" for n, t in r["kernels"][path].items())
        print(f"[timing] attention_step {path} kernels: {split}; SDPA on the core alone "
              f"{r['core_library_ms'][path]:.3f} ms {card}")
    s = r["stream"]
    print(f"[timing] attention_step streaming core {list(s['shape'])}, dropout 0.1: forward "
          f"{s['fwd_ms']:.3f} ms (bound {s['fwd_bound'][0]:.3f}), backward {s['ms']:.3f} ms "
          f"(bound {s['bound'][0]:.3f}) {card}")
    for k in ("ffn_step_backward", "attention_step_backward"):
        for path in ("freq", "time"):
            r = results[k][path]
            split = "".join(f"; {n} {t:.3f} ms" for n, t in r.get("kernels", {}).items())
            print(f"[timing] training {k[:-9]} {path} [{r['rows']}, {r['seq']}, 96], dropout "
                  f"0.1: forward (stash) {r['fwd_ms']:.3f} ms (plain {r['plain_fwd_ms']:.3f}, "
                  f"bound {r['fwd_bound'][0]:.3f} ms); backward {r['ms']:.3f} ms{split} (plain "
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
    for k in ("ffn_step", "attention_step"):
        for tag, r in results[k].items():
            if tag.startswith("speech"):   # the serving shapes
                print(f"[timing] {k} {tag} {list(r['shape'])}: kernel {r['ms']:.3f} ms, plain "
                      f"{r['plain_ms']:.3f} ms, bound {r['bound'][0]:.3f} ms ({r['bound'][1]}) "
                      f"{card}")
    for k in ("ffn_step_backward", "attention_step_backward"):
        for tag, r in results[k].items():
            if isinstance(r, dict) and tag.startswith(("speech", "bs")):
                print(f"[timing] training {k[:-9]} {tag} [{r['rows']}, {r['seq']}, {r['c']}], "
                      f"dropout {r['drop']:g}: forward (stash) {r['fwd_ms']:.3f} ms (plain "
                      f"{r['plain_fwd_ms']:.3f}, bound {r['fwd_bound'][0]:.3f} ms, "
                      f"{r['fwd_bound'][1]}); backward {r['ms']:.3f} ms (plain {r['plain_ms']:.3f},"
                      f" bound {r['bound'][0]:.3f} ms, {r['bound'][1]}) {card}")
    print(f"[timing] speech separation CLI, wsj0-2mix, {len(SPEECH_SERVE_S)} utterances of "
          f"{speech_audio_s:g} s in all: {speech_wall:.3f} s wall, "
          f"{speech_audio_s / speech_wall:.2f}x realtime {card}")
    for run, (_, w) in speech_train.items():
        print(f"[timing] speech training CLI, {run}: 2 steps of {SPEECH_BATCH} x "
              f"{SPEECH_SEGMENT_S:g} s and 2 validation utterances in {w:.1f} s (build, data, "
              f"checkpoint included) {card}")
    for cfg_name, paths in speech_time.items():
        for path, (sec, peak) in paths.items():
            print(f"[timing] speech train step, {cfg_name}, {path} path, batch {SPEECH_BATCH} x "
                  f"{SPEECH_SEGMENT_S:g} s: {sec:.4f} s/step, peak {peak / 2**30:.2f} GiB {card}")
    print(f"[timing] speech evaluation CLI, wsj0-2mix: 2 utterances (5 + 6 s) in "
          f"{speech_eval[0]:.1f} s, STOI included {card}")
    for epoch, (_, w) in bs_train.items():
        print(f"[timing] BS-Locoformer training CLI, epoch {epoch}: 2 steps of 4 x 2 x 3 s and "
              f"validation in {w:.1f} s (build, data, checkpoint included) {card}")
    for path, (sec, peak, mb) in bs_time.items():
        print(f"[timing] BS-Locoformer train step, {path} path, micro-batch {mb} x 3 s stereo, "
              f"dropout 0.1: {sec:.3f} s/step, {mb * SEGMENT / SR / sec:.2f} s of audio per s, "
              f"peak {peak / 2**30:.2f} GiB {card}")
    print(f"[timing] the speech and BS-training phases took {t_speech:.1f} s")
    def fp32_bound(r, pre=""):
        """The fp32 row's bound as printed: 3xTF32's with the FFMA bound
        beside it, else the FFMA bound."""
        b = r[f"{pre}bound"]
        if f"{pre}ffma_bound" not in r:
            return f"fp32 bound {b[0]:.3f} ms, {b[1]}"
        return (f"3xTF32 bound {b[0]:.3f} ms, {b[1]}; FFMA bound "
                f"{r[f'{pre}ffma_bound'][0]:.3f} ms")
    for k in ("ffn_step_fp32", "attention_step_fp32"):
        for tag, r in results[k].items():
            if isinstance(r, dict):
                print(f"[timing] {k} {tag} {list(r['shape'])}: kernel {r['ms']:.3f} ms (bf16 "
                      f"kernel {r['bf16_ms']:.3f}), plain {r['plain_ms']:.3f} ms, "
                      f"{fp32_bound(r)} {card}")
    for k in ("ffn_step_fp32_backward", "attention_step_fp32_backward"):
        for tag, r in results[k].items():
            if isinstance(r, dict):
                print(f"[timing] training {k[:-9]} {tag} [{r['rows']}, {r['seq']}, {r['c']}], "
                      f"dropout {r['drop']:g}: forward (stash) {r['fwd_ms']:.3f} ms (bf16 "
                      f"{r['bf16_fwd_ms']:.3f}, plain {r['plain_fwd_ms']:.3f}, "
                      f"{fp32_bound(r, 'fwd_')}); backward {r['ms']:.3f} ms (bf16 "
                      f"{r['bf16_ms']:.3f}, plain {r['plain_ms']:.3f}, {fp32_bound(r)}) {card}")
    for tag, r in fp32_train.items():
        print(f"[timing] use_amp false train step, {tag}, kernel path: {r['sec']:.4f} s/step, "
              f"peak {r['peak'] / 2**30:.2f} GiB {card}")
    print(f"[timing] MFU (dense bf16 peak {mfu['peak'] / 1e12:.1f} TFLOP/s): base forward "
          f"{100 * mfu['forward_mfu']:.2f}%, base train step {100 * mfu['step_mfu']:.2f}% "
          f"{card}")
    for step in ("ffn_step_partial", "attention_step_partial"):
        for tag, r in results[step].items():
            if isinstance(r, dict):
                print(f"[timing] {step[:-8]} partial-sum mode, one shard, base training {tag} "
                      f"[{r['rows']}, {r['seq']}, 96]: forward {r['fwd_ms']:.3f} ms (whole step "
                      f"{r['full_fwd_ms']:.3f}, plain shard {r['plain_fwd_ms']:.3f}, bound "
                      f"{r['fwd_bound'][0]:.3f} ms); backward {r['ms']:.3f} ms (whole step "
                      f"{r['full_ms']:.3f}, plain shard {r['plain_ms']:.3f}, bound "
                      f"{r['bound'][0]:.3f} ms) {card}")
    for run in ("dp2 mp1", "dp1 mp2"):
        for r in (0, 1):
            steps = parallel[f"{run} rank {r}"]["steps"]
            print(f"[timing] parallel base training, {run}, rank {r} of 2 sharing one card over "
                  f"gloo, global batch {TP_BATCH} x 3 s (accumulation 2): step 2 {steps[-1][2]:.3f} "
                  f"s (one process on the card: {parallel['single'][-1][2]:.3f} s) {card}")
    for k in ("flash_attention_fp32", "swiglu_ffn_fp32", "flash_attention_fp32_backward",
              "swiglu_ffn_fp32_backward"):
        for tag, r in results[k].items():
            if isinstance(r, dict):
                lib = "" if r["library_ms"] is None else f", SDPA fp32 {r['library_ms']:.3f} ms"
                bound = (f"3xTF32 bound {r['bound'][0]:.3f} ms ({r['bound'][1]}), FFMA bound "
                         f"{r['ffma_bound'][0]:.3f} ms" if "ffma_bound" in r else
                         f"fp32 bound {r['bound'][0]:.3f} ms ({r['bound'][1]})")
                print(f"[timing] {k} {tag} {list(r['shape'])}: kernel {r['ms']:.3f} ms (bf16 "
                      f"kernel {r['bf16_ms']:.3f}), plain {r['plain_ms']:.3f} ms{lib}, "
                      f"{bound} {card}")
    launches_xl32, wall_xl32, peak_xl32, err_xl32 = xl_fp32
    print(f"[timing] xlarge separation CLI, --precision fp32, {XL_FP32_SERVE_S:g} s (one engine "
          f"batch): {wall_xl32:.2f} s wall, {XL_FP32_SERVE_S / wall_xl32:.3f}x realtime, peak "
          f"{peak_xl32 / 2**30:.2f} GiB; stems at {XL_FP32_LAYERS} layers within "
          f"{err_xl32:.2e} of the plain route's peak {card}")
    for tag, r in fp32_unfused_train.items():
        full = (f"; at {r['full_mb']} x {r['seg'] / SR:g} s {r['full_sec']:.3f} s/step, peak "
                f"{r['full_peak'] / 2**30:.2f} GiB" if "full_sec" in r else "")
        print(f"[timing] use_amp false train step, {tag}, kernel path: {r['mb']} x "
              f"{r['seg'] / SR:g} s {r['sec']:.3f} s (first step), peak {r['peak'] / 2**30:.2f} "
              f"GiB{full} {card}")
    w = small_fp32_cli[1]
    print(f"[timing] training CLI, small config, use_amp false: first run {w[1]:.1f} s for 2 "
          f"steps, resumed run {w[2]:.1f} s for 2 steps (data, validation, checkpoint "
          f"included) {card}")
    print(f"[timing] the fp32 unfused-route phases took {t_fp32u:.1f} s")
    print(f"[timing] the parallel phases took {t_parallel:.1f} s (2-rank evaluation CLI "
          f"{parallel['eval_wall']:.1f} s, world-1 NCCL training CLI {parallel['nccl_wall']:.1f} s, "
          f"start-up included)")

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
        "istft_overlap_add": ("csrc/stft.cu", "ops/pallas/stft_kernel.py:279", None, None),
        # the partial-sum mode (residual=False) of the TP steps, at mp 2
        "ffn_step_partial": ("csrc/swiglu_block.cu", "ops/pallas/swiglu_block.py:224",
                             None, None),
        "ffn_step_backward_partial": ("csrc/swiglu_block.cu", "ops/pallas/swiglu_block.py:450",
                                      None, None),
        "attention_step_partial": ("csrc/attention_block.cu",
                                   "ops/pallas/attention_block.py:304", None, None),
        "attention_step_backward_partial": ("csrc/attention_block.cu",
                                            "ops/pallas/attention_block.py:621", None, None),
        # fp32 rows of #2-#5: speech serving's and use_amp false training's
        # (#2/#5: the 3xTF32 GEMMs, with step_fp32.cu's norms, mask, sums)
        "ffn_step_fp32": ("csrc/ffn_core_fp32.cu", "ops/pallas/swiglu_block.py:279", None,
                          None),
        "attention_step_fp32": ("csrc/step_fp32.cu", "ops/pallas/attention_block.py:393",
                                None, None),
        "ffn_step_fp32_backward": ("csrc/ffn_core_fp32.cu", "ops/pallas/swiglu_block.py:456",
                                   None, None),
        "attention_step_fp32_backward": ("csrc/step_fp32.cu",
                                         "ops/pallas/attention_block.py:626", None, None),
        # fp32 rows of #6-#9: xlarge --precision fp32 serving's and small
        # use_amp false training's
        "flash_attention_fp32": ("csrc/attn_fp32.cu", "ops/pallas/flash_attention.py:207",
                                 None, None),
        "swiglu_ffn_fp32": ("csrc/ffn_core_fp32.cu", "ops/pallas/swiglu_ffn.py:221", None,
                            None),
        "flash_attention_fp32_backward": ("csrc/attn_fp32.cu",
                                          "ops/pallas/flash_attention.py:315", None, None),
        "swiglu_ffn_fp32_backward": ("csrc/ffn_core_fp32.cu", "ops/pallas/swiglu_ffn.py:363",
                                     None, None)}
    kernels = []
    for k, (src, tpu, bound, library_ms) in sources.items():
        # a step's partial-sum forward and backward share one results entry
        r = results[k.replace("_backward_partial", "_partial")]
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
        elif k in ("ffn_step_fp32", "attention_step_fp32"):
            # the main path: the speech serving CLI (fp32 by default); timed
            # at wsj0-2mix serving's freq shape
            f = r["speech wsj0-2mix serving freq"]
            ms, plain_ms, bound = f["ms"], f["plain_ms"], f["bound"]
            main_path = speech_launches
        elif k in ("flash_attention_fp32", "swiglu_ffn_fp32"):
            # the main path: the xlarge separation CLI at --precision fp32;
            # timed at the xlarge engine batch's freq shape
            f = r["xlarge freq"]
            ms, plain_ms, bound, library_ms = f["ms"], f["plain_ms"], f["bound"], f["library_ms"]
            main_path = launches_xl32
        elif k in ("flash_attention_fp32_backward", "swiglu_ffn_fp32_backward"):
            # the main path: the small config's training CLI at use_amp
            # false; timed at its training freq shape
            f = r["small training freq"]
            ms, plain_ms, bound, library_ms = f["ms"], f["plain_ms"], f["bound"], f["library_ms"]
            main_path = small_fp32_cli[0]
        elif k.endswith("_fp32_backward"):
            # the main path: a use_amp false base train step; timed at base
            # training freq, dropout 0.1
            f = r["base training freq"]
            ms, plain_ms, bound = f["ms"], f["plain_ms"], f["bound"]
            main_path = fp32_train["base"]["launches"]
        elif k.endswith("_partial"):
            # one shard at mp 2, base training freq; the launches of rank 0's
            # TP training run (dp 1 mp 2)
            base = k[:-8]
            f = r["freq mp2"]
            fwd = not base.endswith("_backward")
            ms, plain_ms = (f["fwd_ms"], f["plain_fwd_ms"]) if fwd else (f["ms"], f["plain_ms"])
            bound = f["fwd_bound"] if fwd else f["bound"]
            main_path = {k: parallel["dp1 mp2 rank 0"]["launches"][base]}
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
        if k == "ffn_step_backward":
            entry["kernels"] = r["freq"]["kernels"]
        if k == "attention_step":
            # device ms per call kernel by kernel; SDPA on the same q, k, v
            # shape at dropout 0, the core alone (library_ms stays null: no
            # one PyTorch call computes the whole step)
            entry["kernels"] = r["kernels"]["freq"]
            entry["core_library_ms"] = r["core_library_ms"]["freq"]
        if k == "attention_step_backward":
            entry["kernels"] = r["freq"]["kernels"]
            entry["core_library_ms"] = r["freq"]["core_library_ms"]
        if main_path is launches:
            entry["launches_training"] = train_launches[k]
            entry["launches_bs"] = bs_launches[k]
        if k in ("ffn_step", "attention_step", "ffn_step_backward", "attention_step_backward"):
            # the bf16 speech and BS training paths, each counted from 0
            # around its run (speech serving and evaluation run fp32)
            entry["launches_speech_training"] = speech_train["wsj0_2mix 0"][0][k]
            entry["launches_speech_training_dns"] = speech_train["dns 0"][0][k]
            entry["launches_bs_training"] = bs_train[0][0][k]
        if "_fp32" in k:
            entry["bf16_ms"] = f["bf16_ms"]   # the bf16 kernel on the same values
        if k.startswith(("swiglu_ffn_fp32", "flash_attention_fp32", "attention_step_fp32",
                         "ffn_step_fp32")):
            # bound_ms is 3xTF32's (the design's products); the FFMA bound
            # beside it, and the device ms of each kernel a call launches
            entry["ffma_bound_ms"] = f["ffma_bound"][0]
            entry["kernels"] = f["kernels"]
        if k.startswith("attention_step_fp32"):
            # the chain's attention core (csrc/attn_fp32.cu) among its launches
            entry["core_source"] = "mss_tf_locoformer_tpu_torch/csrc/attn_fp32.cu"
        if k.startswith("ffn_step_fp32"):
            # the norms, the outer mask and the reductions around the GEMMs
            entry["chain_source"] = "mss_tf_locoformer_tpu_torch/csrc/step_fp32.cu"
        if k.startswith(("ffn_step_fp32", "attention_step_fp32")):
            entry["launches_speech_evaluation"] = speech_eval[1].get(k, 0)
            entry["launches_use_amp_false_speech_step"] = \
                fp32_train["speech wsj0-2mix"]["launches"][k]
        if k.startswith(("flash_attention_fp32", "swiglu_ffn_fp32")):
            # each counted from 0 around its run: the small CLI's epoch (or
            # the xlarge serving CLI's forward), a small use_amp false step
            # and an xlarge micro-batch's (2 layers, remat, dropout 0.1)
            entry["launches_small_training_cli"] = small_fp32_cli[0][k]
            entry["launches_xlarge_serving_cli"] = launches_xl32[k]
            for tag, run in fp32_unfused_train.items():
                entry["launches_use_amp_false_" + tag.replace(" ", "_")] = run["launches"][k]
        kernels.append(entry)
    print(f"[done] chip_smoke.py took {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:] == ["--profile-xlarge-train"]:
        profile_main()
    elif sys.argv[1:2] == ["--rank"]:
        rank_main(sys.argv[2:])
    else:
        main()
