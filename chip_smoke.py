#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Drives the port (``mss_tf_locoformer_tpu_torch``) at the base config of
``configs/musdb18.yaml`` (built here in code: the GPU machine may have no
PyYAML), with seeded random weights.  Phases, each of which raises on
failure (exit code != 0, no result line):

  1. device: require CUDA; print the card's name and power limit;
  2. build: compile the three CUDA kernels from ``csrc/`` with nvcc;
  3. kernels: each kernel against its plain PyTorch version at the shapes
     the main path gives it (one engine batch: 2 chunks of 8 s; the plain
     attention's [R, H, L, L] fp32 scores take ~23 GB at the freq path);
  4. slice parity: the whole model with its kernels against the same model
     with every kernel replaced by its plain version (1 s, batch 1, bf16);
  5. the slice: the separation CLI on a 20 s stereo WAV (3 chunks of 8 s in
     2 batches of 2), 4 stereo stems checked, launch counters checked;
  6. timings: each kernel against its plain version, one model forward of
     the engine batch on the kernel path against the plain path (in turns,
     with peak device memory), and the separation's wall time and realtime
     factor.

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
# the plain path through the whole bf16 model (four blocks of bf16 rounding
# taken at different places).
SLICE_REL_L2 = 5e-2


def _model_pair():
    """The bf16 base model on the card twice, on the same seeded weights: with
    its kernels, and with every kernel replaced by its plain version."""
    import torch
    from mss_tf_locoformer_tpu_torch.core.precision import BF16
    from mss_tf_locoformer_tpu_torch.models import build_model
    cfg = base_model_config()
    dev = torch.device("cuda", 0)
    fused = build_model(cfg, BF16, torch.Generator().manual_seed(SEED)).to(dev).eval()
    plain = build_model(_plain_config(cfg), BF16).to(dev).eval()
    plain.load_state_dict(fused.state_dict(), strict=True)
    return fused, plain


def phase_slice_parity():
    import torch
    fused, plain = _model_pair()
    gen = torch.Generator().manual_seed(SEED + 1)
    mix = _rand(gen, (1, SR), 0.1).to(fused.deconv.weight.device)
    with torch.inference_mode():
        a = fused(mix)
        torch.cuda.synchronize()
        b = plain(mix)
    worst = 0.0
    for name in a:
        if a[name].shape != (1, SR) or not torch.isfinite(a[name]).all():
            raise AssertionError(f"slice parity: stem {name} is not finite [1, {SR}]")
        rel = ((a[name] - b[name]).norm() / b[name].norm()).item()
        worst = max(worst, rel)
        print(f"[parity] {name}: relative L2 {rel:.3e} (bound {SLICE_REL_L2:g})")
    if not worst <= SLICE_REL_L2:
        raise AssertionError(f"slice parity: relative L2 {worst:.3e} above {SLICE_REL_L2:g}")


def phase_slice(workdir):
    import dataclasses

    import numpy as np
    import torch
    from mss_tf_locoformer_tpu_torch.cli import separate as cli
    from mss_tf_locoformer_tpu_torch.models import build_model
    from mss_tf_locoformer_tpu_torch.ops.cuda import attention_block as AB
    from mss_tf_locoformer_tpu_torch.ops.cuda import stft_kernel as SK
    from mss_tf_locoformer_tpu_torch.ops.cuda import swiglu_block as FB
    from mss_tf_locoformer_tpu_torch.utils.audio import load_audio, save_audio
    cfg = base_model_config()
    model = build_model(cfg, generator=torch.Generator().manual_seed(SEED))
    ckpt = os.path.join(workdir, "base_random.pth")
    torch.save(model.state_dict(), ckpt)
    cfg_path = os.path.join(workdir, "musdb18_model.json")
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

    counters = {"stft": SK.stft_fused, "ffn_step": FB.fused_norm_ffn_residual,
                "attention_step": AB.fused_attention_block}
    for fn in counters.values():
        fn.launches = 0
    cli.main(argv)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}

    forwards = 2  # 3 chunks in batches of 2
    need = {"stft": 1 * forwards, "ffn_step": 16 * forwards,
            "attention_step": 8 * forwards}
    for name, n in launches.items():
        print(f"[slice] {name}: {n} launches (need >= {need[name]})")
        if n < need[name]:
            raise AssertionError(f"{name} launched {n} times, fewer than {need[name]}")
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


def phase_forward(reps: int = 3):
    """One model forward of an engine batch, kernel path against plain path
    on the same weights: a warm-up forward of each (its peak device memory
    kept), then ``reps`` forwards per turn in the order plain, kernel,
    kernel, plain, host clock around synchronised forwards.  Returns
    ``{path: (mean ms per forward, peak bytes)}``."""
    import torch
    models = dict(zip(("kernel", "plain"), _model_pair()))
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
    return {path: (1e3 * sum(t) / len(t), peak[path]) for path, t in times.items()}


def main():
    if not os.path.isdir(os.path.join(HERE, "mss_tf_locoformer_tpu_torch")):
        raise SystemExit("chip_smoke.py: run it from a checkout of the repository "
                         "(mss_tf_locoformer_tpu_torch/ not found beside it)")
    sys.path.insert(0, HERE)
    import torch

    name, smi = phase_device()
    phase_build()
    results = {}
    phase_kernels(results)
    phase_slice_parity()
    with tempfile.TemporaryDirectory() as workdir:
        launches, wall, seconds = phase_slice(workdir)
    forward = phase_forward()

    card = f"({smi})"
    print(f"[timing] stft [{BATCH}, {CHUNK}]: kernel {results['stft']['ms']:.3f} ms, "
          f"plain {results['stft']['plain_ms']:.3f} ms {card}")
    for k in ("ffn_step", "attention_step"):
        for path in ("freq", "time"):
            rows, ms, plain_ms = results[k][path]
            print(f"[timing] {k} {path} ({rows} rows): kernel {ms:.3f} ms, "
                  f"plain {plain_ms:.3f} ms {card}")
    audio_s = BATCH * CHUNK / SR
    for path, (ms, peak) in forward.items():
        print(f"[timing] forward [{BATCH}, {CHUNK}], {path} path: {ms:.1f} ms, "
              f"{1e3 * audio_s / ms:.2f}x realtime, peak {peak / 2**30:.2f} GiB {card}")
    print(f"[timing] separation of {seconds} s: {wall:.3f} s wall, "
          f"{seconds / wall:.2f}x realtime {card}")

    sources = {"stft": ("csrc/stft.cu", "ops/pallas/stft_kernel.py:150"),
               "ffn_step": ("csrc/swiglu_block.cu", "ops/pallas/swiglu_block.py:279"),
               "attention_step": ("csrc/attention_block.cu",
                                  "ops/pallas/attention_block.py:393")}
    kernels = []
    for k, (src, tpu) in sources.items():
        r = results[k]
        ms, plain_ms = (r["ms"], r["plain_ms"]) if k == "stft" else r["freq"][1:]
        kernels.append({"name": k, "route": "cuda",
                        "source": f"mss_tf_locoformer_tpu_torch/{src}",
                        "replaces": f"mss_tf_locoformer_tpu/{tpu}",
                        "launches": launches[k], "max_abs_err": r["err"],
                        "ms": ms, "plain_ms": plain_ms})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
