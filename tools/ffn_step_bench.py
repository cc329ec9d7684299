#!/usr/bin/env python3
"""Time the FFN-step kernels (#2 forward, #5 backward) on the card and count
the tensor-core and copy instructions in their SASS.

    python3 tools/ffn_step_bench.py [--parent DIR] [--reps N] [--only TAG]

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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="an unpacked checkout to compare with")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--only", default="", help="time only the shapes whose tag holds this")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("ffn_step_bench.py needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi)
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
