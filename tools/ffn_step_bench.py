#!/usr/bin/env python3
"""Time the FFN-step kernels (#2 forward, #5 backward) on the card and count
the tensor-core and copy instructions in their SASS.

    python3 tools/ffn_step_bench.py [--parent DIR] [--reps N] [--only TAG]
    python3 tools/ffn_step_bench.py --fp32 [--parent DIR] [--reps N] [--only TAG]

Builds ``csrc/swiglu_block.cu`` of this tree and, with ``--parent``, the
same file of another checkout unpacked at ``DIR`` (into
``build/ffn_step_parent/``), which is driven through that checkout's own
wrapper (``ops/cuda/swiglu_block.py``: the two may bind different C
signatures).  It times with CUDA events, at every shipped shape of the
fused FFN step:

  * #2 at base serving ``[1380, 1025, 96]`` / ``[2050, 690, 96]`` and
    BS-Locoformer serving ``[1380, 62, 128]`` / ``[124, 690, 128]``;
  * #2 and #5 at base training ``[518, 1025, 96]`` / ``[2050, 259, 96]``,
    dropout 0.1;
  * with a parent, in turns: parent, this tree, this tree, parent;

beside the plain version (cuDNN's convolutions; for #5 its autograd
backward) and the bound (``chip_smoke.ffn_work``), and #5's device time
kernel by kernel from a ``torch.profiler`` trace (the dx kernel, the
weight-gradient kernels once per row group, the reductions).  Then
``cuobjdump -sass`` of each library: per kernel the count of ``HGMMA``,
``UTMALDG`` / ``UBLKCP``, ``HMMA`` and ``LDGSTS`` instructions.  The last
line is one JSON object with every number.

With ``--fp32`` it times the fp32 rows instead, on fp32 inputs
(``step_fp32.ffn_forward`` / ``ffn_backward``): #2 and #5 at base training
(micro-batch 2 x 3 s, dropout 0.1) and wsj0-2mix training (4 x 4 s,
dropout 0), #2 at wsj0-2mix and DNS serving (8 s), each launch of the
chain by CUDA events (``chip_smoke._fp32_core_kernels``: the GEMMs by
kernel and epilogue, the norms, the outer mask, the reductions), beside
both bounds (3xTF32: 3 x FLOP at 494.7 TFLOP/s; FFMA: FLOP at 67 TFLOP/s;
bytes at 3.35 TB/s); then one ``use_amp: false`` optimizer step of the
base config (2 x 3 s) and of the wsj0-2mix config (4 x 4 s), the whole
model's.  With ``--parent`` the other checkout's ``ops/cuda/step_fp32.py``
(and ``unfused_fp32.py``) drive its own ``csrc/step_fp32.cu`` (and
``csrc/ffn_core_fp32.cu``), built into ``build/flash_parent/``
(``tools/flash_bench.py``'s loader), in turns with this tree's: parent,
tree, tree, parent, each call and each whole step (the steps' FFN and
attention layers switched to the other checkout's chain; everything else
is this tree's).
``git archive HEAD | tar -x -C build/parent`` first, then ``python3
tools/ffn_step_bench.py --fp32 --parent build/parent`` through the chip
tool with a 900 s limit.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "tools"))

K, GROUPS, EPS, DROP, SEED = 4, 4, 1e-5, 0.1, 777
KERNELS = ("ffn_step_kernel", "ffn_bwd_dx_kernel", "ffn_step_wg_kernel",
           "ffn_step_dx_wg_kernel", "ffn_wgrad_gemm_kernel", "wgrad_kernel", "reduce_kernel")


def shapes():
    """(tag, rows, sequence, C, inner, backward) of the timed calls."""
    import chip_smoke as cs
    base, bs = cs.base_model_config(), cs.bs_model_config()
    out = [(f"base serving {p}", r, s, 96, 384, False) for p, r, s in cs._main_path_steps(base)]
    out += [(f"bs serving {p}", r, s, 128, 384, False) for p, r, s in cs._bs_main_path_steps(bs)]
    out += [(f"base training {p}", r, s, 96, 384, True) for p, r, s in cs._train_steps(base)]
    return out


def _parent_wrapper(root: str):
    """The parent checkout's ``ops/cuda/swiglu_block.py`` as a module of its
    own, bound to its own library (built into ``build/ffn_step_parent/``);
    its relative imports resolve to this tree's package (dropout, norms,
    the loader)."""
    from mss_tf_locoformer_tpu_torch.ops import cuda as kernels
    pkg = os.path.join(root, "mss_tf_locoformer_tpu_torch")
    out_dir = os.path.join(HERE, "build", "ffn_step_parent")
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, "libswiglu_block.so")
    src = os.path.join(pkg, "csrc", "swiglu_block.cu")
    proc = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", lib, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}{proc.stderr}")
    spec = importlib.util.spec_from_file_location(
        "mss_tf_locoformer_tpu_torch.ops.cuda._parent_swiglu_block",
        os.path.join(pkg, "ops", "cuda", "swiglu_block.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    handle = ctypes.CDLL(lib)
    mod.load = lambda name: handle
    return mod, lib


def _inputs(rows, seq, c, inner, seed):
    import torch
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = (0.5 * torch.randn(rows, seq, c, generator=gen, device=dev)).to(torch.bfloat16)
    gamma = 1.0 + 0.1 * torch.randn(c, generator=gen, device=dev)
    b = (c * K) ** -0.5
    w = [(torch.rand(*s, generator=gen, device=dev) * 2 - 1) * b
         for s in ((2 * inner, c, K), (2 * inner,), (inner, c, K), (c,))]
    g = torch.randn(rows, seq, c, generator=gen, device=dev).to(torch.bfloat16)
    return x, gamma, w, g


def time_wrapper(label, mod, tag, x, gamma, w, g, bwd, reps) -> dict:
    from chip_smoke import _kernel_device_ms, _time_ms, ffn_step_bwd_launches
    rows, seq, c = x.shape
    p = DROP if bwd else 0.0
    out = {}
    call = lambda: mod.ffn_step_forward(x, gamma, *w, K, GROUPS, EPS, p, SEED, 0)
    out["fwd_ms"] = _time_ms(call, iters=reps)
    out["fwd_kernels"] = _kernel_device_ms(call, "ffn_", reps=reps)
    if bwd:
        call = lambda: mod.ffn_step_backward(g, x, gamma, *w[:3], K, GROUPS, EPS, p, SEED, 0)
        out["bwd_ms"] = _time_ms(call, iters=reps)
        out["bwd_kernels"] = _kernel_device_ms(
            call, "(?:ffn_|wgrad_|reduce_)",
            ffn_step_bwd_launches(mod, rows, seq, c, w[2].shape[0], K), reps=reps)
    print(f"[{label}] {tag}: {json.dumps(out)}")
    return out


def time_plain(tag, x, gamma, w, g, bwd) -> dict:
    import torch
    from chip_smoke import _time_ms
    from mss_tf_locoformer_tpu_torch.ops.cuda import swiglu_block as FB
    p = DROP if bwd else 0.0
    out = {"fwd_ms": _time_ms(lambda: FB.reference_norm_ffn_residual(
        x, gamma, *w, K, GROUPS, EPS, p, SEED, 0), iters=2)}
    if bwd:
        xp = x.detach().requires_grad_(True)
        wp = [t.detach().requires_grad_(True) for t in (gamma, *w)]
        pout = FB.reference_norm_ffn_residual(xp, *wp, K, GROUPS, EPS, p, SEED, 0)
        out["bwd_ms"] = _time_ms(lambda: torch.autograd.grad(pout, [xp, *wp], g,
                                                             retain_graph=True), iters=1)
        del xp, wp, pout
    print(f"[plain] {tag}: {json.dumps(out)}")
    return out


def l2_read_rate(mib: int = 16, iters: int = 50) -> float:
    """Bytes per second that ``torch.sum`` reads from an L2-resident bf16
    tensor of ``mib`` MiB (the card's L2 holds 50 MB): a lower bound on
    the rate at which the blocks can stream the weights from L2."""
    import torch
    from chip_smoke import _time_ms
    a = torch.ones(mib << 19, dtype=torch.bfloat16, device="cuda")
    ms = _time_ms(lambda: a.sum(), iters=iters)
    return (mib << 20) / (ms * 1e-3)


# ------------------------------------------------------------------ fp32

def fp32_shapes():
    """(tag, model config, rows, sequence, dropout, backward) of the fp32
    timings."""
    import chip_smoke as cs
    base, sp = cs.base_model_config(), cs.speech_config("wsj0_2mix")
    dns = cs.speech_config("dns")
    out = [(f"base training {p}", base, r, s, 0.1, True) for p, r, s in cs._train_steps(base)]
    out += [(f"wsj0-2mix serving {p}", sp.separator, r, s, 0.0, False)
            for p, r, s in cs._speech_steps(sp, 1, 8.0)]
    out += [(f"wsj0-2mix training {p}", sp.separator, r, s, 0.0, True)
            for p, r, s in cs._speech_steps(sp, cs.SPEECH_BATCH, cs.SPEECH_SEGMENT_S)]
    out += [(f"dns serving {p}", dns.separator, r, s, 0.0, False)
            for p, r, s in cs._speech_steps(dns, 1, 8.0)]
    return out


def fp32_bounds(cfg, rows, seq) -> dict:
    """{forward / backward: {tf32x3, ffma}: (ms, what bounds it)} of one
    fp32 FFN step."""
    import chip_smoke as cs
    inner = cs._inner_dims(cfg)[0]
    ff, fb, bf, bb = cs.ffn_work(rows, seq, cfg.emb_dim, inner, cfg.conv1d_kernel, row_bytes=4)
    both = lambda f, b: {"tf32x3": cs._bound(f, b, peak=cs.PEAK_TF32, passes=cs.TF32_PASSES),
                         "ffma": cs._bound(f, b, peak=cs.PEAK_FP32)}
    return {"fwd": both(ff, fb), "bwd": both(bf, bb)}


def time_fp32(label, S, U, tag, cfg, rows, seq, drop, backward, reps) -> dict:
    """#2 (and #5) of the fp32 chain of ``S`` / ``U`` at one shape: ms a
    call and each launch's device ms (CUDA events)."""
    import torch
    import chip_smoke as cs
    c, k, inner = cfg.emb_dim, cfg.conv1d_kernel, cs._inner_dims(cfg)[0]
    gen = torch.Generator().manual_seed(18)
    x, gamma, w, _ = cs._step_inputs(gen, rows, seq, "cuda", c, inner, k)
    x = x.float()
    args = (k, cfg.num_groups, cfg.eps, drop, SEED, 0)
    fwd = lambda: S.ffn_forward(x, gamma, *w, *args)
    kern = lambda fn, bwd: cs._fp32_core_kernels(f"{label} {tag}", fn, bwd, reps, S, U,
                                                 check=label == "tree", tag="fp32-bench")
    out = {"fwd_ms": cs._time_ms(fwd, iters=reps), "fwd_kernels": kern(fwd, False)}
    if backward:
        g = torch.randn(rows, seq, c, generator=gen).to("cuda")
        bwd = lambda: S.ffn_backward(g, x, gamma, *w[:3], *args)
        out.update(bwd_ms=cs._time_ms(bwd, iters=reps), bwd_kernels=kern(bwd, True))
        del g
    del x, w
    torch.cuda.empty_cache()
    print(f"[{label}] #2/#5 fp32 {tag}: {json.dumps(out)}")
    return out


def fp32_steps(mods, order, reps) -> dict:
    """s per ``use_amp: false`` optimizer step of the base config (2 x 3 s,
    dropout 0.1) and the wsj0-2mix config (4 x 4 s), the FFN and attention
    steps on each label's chain in turn (``swiglu_block``'s and
    ``attention_block``'s ``step_fp32``), after one warm-up step each."""
    import time

    import torch
    import chip_smoke as cs
    from mss_tf_locoformer_tpu_torch.core.config import LossConfig, TrainingConfig
    from mss_tf_locoformer_tpu_torch.core.precision import FP32
    from mss_tf_locoformer_tpu_torch.ops.cuda import attention_block as AB
    from mss_tf_locoformer_tpu_torch.ops.cuda import swiglu_block as FB
    from mss_tf_locoformer_tpu_torch.train.speech import speech_train_step
    from mss_tf_locoformer_tpu_torch.train.state import make_optimizer
    from mss_tf_locoformer_tpu_torch.train.step import train_step
    tree = FB.step_fp32
    base = cs.base_model_config()
    model = cs._train_models(base, FP32)[0]
    opt = make_optimizer(model.parameters(), TrainingConfig())
    batch = cs._batch(torch.Generator().manual_seed(cs.SEED + 5), cs.TRAIN_MB, cs.SEGMENT, "cuda")
    sp = cs.speech_config("wsj0_2mix")
    smodel = cs._speech_pair(sp, FP32)[0].train()
    sopt = make_optimizer(smodel.parameters(), sp.training)
    n = int(cs.SPEECH_SEGMENT_S * sp.dataset.sample_rate)
    src = cs._rand(torch.Generator().manual_seed(cs.SEED + 22), (cs.SPEECH_BATCH, 2, n),
                   0.1).to("cuda")
    steps = {
        "base": lambda: train_step(model, opt, *batch, 5e-4, torch.Generator().manual_seed(11),
                                   LossConfig(), accum=1, gradient_clip=5.0),
        "wsj0-2mix": lambda: speech_train_step(smodel, sopt, src.sum(1), src, 1e-4,
                                               torch.Generator().manual_seed(1), sp)}
    out = {}
    try:
        for tag, step in steps.items():
            out[tag] = []
            for label in order:
                FB.step_fp32 = AB.step_fp32 = mods[label][0]
                step()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(reps):
                    step()
                torch.cuda.synchronize()
                sec = (time.perf_counter() - t0) / reps
                print(f"[{label}] use_amp false train step, {tag}: {sec:.4f} s/step")
                out[tag].append({"label": label, "sec": sec})
    finally:
        FB.step_fp32 = AB.step_fp32 = tree
    del model, opt, smodel, sopt, batch, src
    torch.cuda.empty_cache()
    return out


def main_fp32(args, smi):
    import torch
    from flash_bench import _parent_fp32
    from mss_tf_locoformer_tpu_torch.ops import cuda as kernels
    from mss_tf_locoformer_tpu_torch.ops.cuda import step_fp32 as S
    from mss_tf_locoformer_tpu_torch.ops.cuda import unfused_fp32 as U
    stale = os.path.join(kernels.BUILD_DIR, "libffn_core_fp32.so")
    if os.path.exists(stale):   # build here, so that ptxas's report is printed
        os.remove(stale)
    kernels.load("ffn_core_fp32")
    for line in kernels.BUILD_LOG.get("ffn_core_fp32", "").splitlines():
        if any(w in line for w in ("Compiling entry", "Used", "spill")):
            print(f"[build] {line.strip()}")
    kernels.load("step_fp32")
    mods = {"tree": (S, U)}
    if args.parent:
        mods["parent"] = _parent_fp32(args.parent)[:2]
    order = ["parent", "tree", "tree", "parent"] if args.parent else ["tree"]
    result = {"card": smi, "fp32": True, "shapes": {}}
    for tag, cfg, rows, seq, drop, backward in fp32_shapes():
        if args.only not in tag:
            continue
        entry = {"shape": [rows, seq, cfg.emb_dim], "inner": cfg.ffn_hidden_dim,
                 "dropout": drop, "bounds": fp32_bounds(cfg, rows, seq), "runs": []}
        for label in order:
            entry["runs"].append({"label": label, **time_fp32(
                label, *mods[label], tag, cfg, rows, seq, drop, backward, args.reps)})
        result["shapes"][tag] = entry
        b = entry["bounds"]
        print(f"[bound] {tag}: forward 3xTF32 {b['fwd']['tf32x3']}, FFMA {b['fwd']['ffma']}; "
              f"backward 3xTF32 {b['bwd']['tf32x3']}, FFMA {b['bwd']['ffma']}")
    if not args.only:
        result["steps"] = fp32_steps(mods, order, max(1, args.reps // 2))
    print(json.dumps(result))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="an unpacked checkout to compare with")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--only", default="", help="time only the shapes whose tag holds this")
    ap.add_argument("--fp32", action="store_true", help="time the fp32 rows (#2/#5) instead")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("ffn_step_bench.py needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi)
    if args.fp32:
        return main_fp32(args, smi)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs
    from ffn_bench import sass_counts
    from mss_tf_locoformer_tpu_torch.ops import cuda as kernels
    from mss_tf_locoformer_tpu_torch.ops.cuda import swiglu_block as FB
    stale = os.path.join(kernels.BUILD_DIR, "libswiglu_block.so")
    if os.path.exists(stale):   # build here, so that ptxas's report is printed
        os.remove(stale)
    kernels.load("swiglu_block")
    for line in kernels.BUILD_LOG.get("swiglu_block", "").splitlines():
        if any(w in line for w in ("Compiling entry", "Used", "spill", "C7512")):
            print(f"[build] {line.strip()}")
    mods, paths = {"tree": FB}, {"tree": stale}
    if args.parent:
        mods["parent"], paths["parent"] = _parent_wrapper(args.parent)
    order = ["parent", "tree", "tree", "parent"] if args.parent else ["tree"]
    result = {"card": smi, "shapes": {}, "l2_read_rate": l2_read_rate()}
    print(f"[l2] torch.sum over an L2-resident 16 MiB: {result['l2_read_rate'] / 1e12:.2f} TB/s")
    for tag, rows, seq, c, inner, bwd in shapes():
        if args.only not in tag:
            continue
        x, gamma, w, g = _inputs(rows, seq, c, inner, 8)
        fl, fby, bfl, bby = cs.ffn_work(rows, seq, c, inner, K)
        entry = {"shape": [rows, seq, c], "inner": inner, "dropout": DROP if bwd else 0.0,
                 "fwd_bound": cs._bound(fl, fby),
                 "bwd_bound": cs._bound(bfl, bby) if bwd else None,
                 "plain": time_plain(tag, x, gamma, w, g, bwd), "runs": []}
        for label in order:
            entry["runs"].append({"label": label, **time_wrapper(
                label, mods[label], tag, x, gamma, w, g, bwd, args.reps)})
        result["shapes"][tag] = entry
        print(f"[bound] {tag}: forward {entry['fwd_bound']}, backward {entry['bwd_bound']}")
        del x, gamma, w, g
        torch.cuda.empty_cache()
    result["sass"] = {label: sass_counts(p, KERNELS) for label, p in paths.items()}
    for label, counts in result["sass"].items():
        for name, ops in counts.items():
            print(f"[sass] {label} {name}: {ops}")
    print(json.dumps(result))


if __name__ == "__main__":
    main()
