#!/usr/bin/env python3
"""Time the FFN-core kernels (#8 forward, #9 backward) on the card and count
the tensor-core and bulk-copy instructions in their SASS.

    python3 tools/ffn_bench.py [--parent DIR] [--reps N]

Builds ``csrc/swiglu_ffn.cu`` of this tree and, with ``--parent``, the same
file of another checkout unpacked at ``DIR`` (into ``build/ffn_parent/``),
which is driven through that checkout's own wrapper
(``ops/cuda/swiglu_ffn.py``: the two may bind different C signatures).  It
times with CUDA events, at the shapes of the main paths:

  * #8 at the xlarge serving shapes ``[690, 2055, 256]`` / ``[4098, 351,
    256]``;
  * #8 and #9 at the xlarge training shapes ``[646, 2055, 256]`` / ``[2049,
    652, 256]`` and the small training shapes (C 48, I 192);
  * with a parent, in turns: parent, this tree, this tree, parent;

beside the plain version (cuDNN's convolutions; for #9 their autograd
backward) and the bound (``chip_smoke.ffn_core_work``,
``ffn_core_bwd_work``), and each kernel's device time per call from a
``torch.profiler`` trace (#9's dx, weight and reduction kernels apart).
Then ``cuobjdump -sass`` of each library: per kernel the count of ``HGMMA``
(wgmma), ``UTMALDG`` / ``UBLKCP`` (tensor and bulk copies), ``HMMA``
(mma.sync) and ``LDGSTS`` (cp.async) instructions.  The last line is one
JSON object with every number.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import importlib.util
import json
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

K = 4
OPCODES = ("HGMMA", "UTMALDG", "UBLKCP", "HMMA", "LDGSTS")
KERNELS = ("ffn_core_bwd_dx_kernel", "ffn_core_bwd_w_kernel", "ffn_core_kernel",
           "ffn_core_wg_kernel", "ffn_bwd_dx_wg_kernel", "ffn_wgrad_gemm_kernel",
           "wgrad_kernel", "reduce_kernel")


def shapes():
    """(tag, rows, sequence, C, inner, forward, backward) of the timed calls."""
    import chip_smoke as cs
    xl = cs.xlarge_model_config()
    out = [(f"xlarge serving {p}", r, s, xl.emb_dim, xl.ffn_hidden_dim[0], True, False)
           for p, r, s in cs._main_path_steps(xl)]
    for name, path, rows, _, seq, _, c, inner in cs._unfused_train_shapes():
        out.append((f"{name} training {path}", rows, seq, c, inner, True, True))
    return out


def _parent_wrapper(root: str):
    """The parent checkout's ``ops/cuda/swiglu_ffn.py`` as a module of its
    own, bound to its own library (built into ``build/ffn_parent/``); its
    relative imports resolve to this tree's package (dropout, panels, the
    loader), which the FFN-core kernels share."""
    from mss_tf_locoformer_tpu_torch.ops import cuda as kernels
    pkg = os.path.join(root, "mss_tf_locoformer_tpu_torch")
    out_dir = os.path.join(HERE, "build", "ffn_parent")
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, "libswiglu_ffn.so")
    src = os.path.join(pkg, "csrc", "swiglu_ffn.cu")
    proc = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", lib, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}{proc.stderr}")
    spec = importlib.util.spec_from_file_location(
        "mss_tf_locoformer_tpu_torch.ops.cuda._parent_swiglu_ffn",
        os.path.join(pkg, "ops", "cuda", "swiglu_ffn.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    handle = ctypes.CDLL(lib)
    mod.load = lambda name: handle
    return mod, lib


def _inputs(rows, seq, c, inner, seed):
    import torch
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(seed)
    lin = seq + 2 * (K - 1)
    x = torch.zeros(rows, lin, c, dtype=torch.bfloat16, device=dev)
    x[:, K - 1:K - 1 + seq] = torch.randn(rows, seq, c, generator=gen, device=dev)
    b = (c * K) ** -0.5
    w = [(torch.rand(*s, generator=gen, device=dev) * 2 - 1) * b
         for s in ((2 * inner, c, K), (2 * inner,), (inner, c, K), (c,))]
    g = torch.randn(rows, lin, c, generator=gen, device=dev).to(torch.bfloat16)
    return x, w, g


def time_wrapper(label, mod, tag, x, w, g, fwd, bwd, reps) -> dict:
    from chip_smoke import _kernel_device_ms, _time_ms, ffn_bwd_launches
    rows, lin, c = x.shape
    out = {}
    if fwd:
        call = lambda: mod.core_forward(x, *w, K)
        out["fwd_ms"] = _time_ms(call, iters=reps)
        out["fwd_kernels"] = _kernel_device_ms(call, "ffn_", reps=reps)
    if bwd:
        call = lambda: mod.swiglu_ffn_backward(g, x, *w[:3], K)
        out["bwd_ms"] = _time_ms(call, iters=reps)
        out["bwd_kernels"] = _kernel_device_ms(
            call, "(?:ffn_|wg::reduce_)", ffn_bwd_launches(mod, rows, lin, c, w[2].shape[0], K),
            reps=reps)
    print(f"[{label}] {tag}: {json.dumps(out)}")
    return out


def time_plain(tag, x, w, g, fwd, bwd) -> dict:
    import torch
    from chip_smoke import _time_ms
    from mss_tf_locoformer_tpu_torch.ops.cuda import swiglu_ffn as SF
    out = {}
    if fwd:
        out["fwd_ms"] = _time_ms(lambda: SF.reference_swiglu_conv_deconv(x, *w, K), iters=2)
    if bwd:
        xp = x.detach().requires_grad_(True)
        wp = [t.detach().requires_grad_(True) for t in w]
        pout = SF.reference_swiglu_conv_deconv(xp, *wp, K)
        out["bwd_ms"] = _time_ms(lambda: torch.autograd.grad(pout, [xp, *wp], g,
                                                             retain_graph=True), iters=1)
        del xp, wp, pout
    print(f"[plain] {tag}: {json.dumps(out)}")
    return out


def sass_counts(so_path: str) -> dict:
    """Per kernel function of ``so_path``: the count of each of ``OPCODES``."""
    from mss_tf_locoformer_tpu_torch.ops.cuda import _nvcc
    cuobjdump = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", so_path], capture_output=True, text=True,
                          check=True).stdout
    out = {}
    for chunk in text.split("Function : ")[1:]:
        name = chunk.split("\n", 1)[0].strip()
        known = [k for k in KERNELS if k in name]
        tmpl = re.search(r"ILi(\d+)E", name)
        key = (max(known, key=len) if known else name) + (f"<{tmpl.group(1)}>" if tmpl else "")
        ops = collections.Counter(
            mm.group(1).split(".")[0]
            for mm in re.finditer(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)",
                                  chunk))
        out[key] = {op: ops.get(op, 0) for op in OPCODES}
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="an unpacked checkout to compare with")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--only", default="", help="time only the shapes whose tag holds this")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("ffn_bench.py needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi)
    import chip_smoke as cs
    from mss_tf_locoformer_tpu_torch.ops import cuda as kernels
    from mss_tf_locoformer_tpu_torch.ops.cuda import swiglu_ffn as SF
    stale = os.path.join(kernels.BUILD_DIR, "libswiglu_ffn.so")
    if os.path.exists(stale):   # build here, so that ptxas's report is printed
        os.remove(stale)
    kernels.load("swiglu_ffn")
    log = kernels.BUILD_LOG.get("swiglu_ffn", "")
    for line in log.splitlines():   # registers, spills, serialised wgmma
        if any(w in line for w in ("Compiling entry", "Used", "spill", "C7512")):
            print(f"[build] {line.strip()}")
    mods = {"tree": SF}
    paths = {"tree": stale}
    if args.parent:
        mods["parent"], paths["parent"] = _parent_wrapper(args.parent)
    order = ["parent", "tree", "tree", "parent"] if args.parent else ["tree"]
    result = {"card": smi, "shapes": {}}
    for tag, rows, seq, c, inner, fwd, bwd in shapes():
        if args.only not in tag:
            continue
        x, w, g = _inputs(rows, seq, c, inner, 8)
        fl, by = cs.ffn_core_work(rows, seq, c, inner, K)
        bfl, bby = cs.ffn_core_bwd_work(rows, seq, c, inner, K)
        entry = {"shape": [rows, seq + 2 * (K - 1), c], "inner": inner,
                 "fwd_bound": cs._bound(fl, by) if fwd else None,
                 "bwd_bound": cs._bound(bfl, bby) if bwd else None,
                 "runs": [], "plain": time_plain(tag, x, w, g, fwd, bwd)}
        for label in order:
            entry["runs"].append({"label": label, **time_wrapper(
                label, mods[label], tag, x, w, g, fwd, bwd, args.reps)})
        result["shapes"][tag] = entry
        del x, w, g
        torch.cuda.empty_cache()
    result["sass"] = {label: sass_counts(p) for label, p in paths.items()}
    for label, counts in result["sass"].items():
        for name, ops in counts.items():
            print(f"[sass] {label} {name}: {ops}")
    print(json.dumps(result))


if __name__ == "__main__":
    main()
