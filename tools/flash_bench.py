#!/usr/bin/env python3
"""Time the flash-attention kernels (#6 forward, #7 backward) on the card and
count the instructions of the forward's inner loop in their SASS.

    python3 tools/flash_bench.py [--parent DIR] [--sass-out FILE] [--fp32] [--reps N]

Builds ``csrc/flash_attention.cu`` (and, with ``--parent``, the same file of
another checkout unpacked at ``DIR``, into ``build/flash_parent/``: both
export the same C functions, so one wrapper drives either library) and times,
with CUDA events, at the shapes of the main paths:

  * #6 at the xlarge serving shapes ``[690, 16, 2049, 16]`` / ``[4098, 16,
    345, 16]`` and the small training shapes ``[8272, 4, 513, 12]`` /
    ``[8208, 4, 517, 12]``, beside ``scaled_dot_product_attention``;
  * #7 at the small training shapes and the xlarge freq shape, beside the
    autograd backward of ``scaled_dot_product_attention``, and each of its
    kernels' device time from a ``torch.profiler`` trace;
  * with a parent, in turns: parent, this tree, this tree, parent.

Then ``cuobjdump -sass`` of each library: for the forward kernel at DP 16
(and the resident backward), the loop holding the most ``MUFU.EX2`` (the
forward's key loop, the backward's query-tile loop), its instructions by
opcode and the non-MUFU instructions per ``MUFU.EX2``, over the whole loop
and over its hot path (without the block that a ``VOTE.ANY``'s branch
skips: the exact rescale).  The last line is one JSON object with every
number; ``--sass-out`` writes the loops' SASS.

With ``--fp32`` it times the fp32 rows instead, on fp32 inputs: #6
(``unfused_fp32.flash_forward_fp32``: qkv_split and the core's forward) at
the xlarge serving shapes and, with its stash, the small training shapes;
#7 (``flash_backward_fp32``) at the small training shapes; the fused
attention step's fp32 rows #3 and #4 (``step_fp32.attention_forward`` /
``attention_backward``) at the base training shapes (micro-batch 2 x 3 s,
dropout 0.1) and #3 at the speech serving shapes (wsj0-2mix, 8 s); the
fp32 norms alone (``norm_fwd``, ``norm_bwd`` with the residual's gradient)
at the base training and wsj0-2mix serving shapes, beside their bytes
bounds.  Each call's launches are timed apart by CUDA events around each
kernel of the chain (the GEMMs by kernel, epilogue and K x N: QKV,
out-projection, do, dxn, the weight products), the backward core's two
kernels (dq, dk/dv) from a ``torch.profiler`` trace; beside them ``scaled_dot_product_attention``'s
fp32 memory-efficient backend (#6, #7) and both bounds: fp32 FFMA at 67
TFLOP/s, and the larger of 3 x FLOP at the TF32 peak, one exponential a
score and the bytes.  With ``--parent`` the other checkout's
``ops/cuda/step_fp32.py`` and ``unfused_fp32.py`` drive its own
``csrc/step_fp32.cu`` (and ``csrc/attn_fp32.cu`` where it has one), built
into ``build/flash_parent/``, in turns with this tree's; ``cuobjdump
-sass`` counts the core kernels' ``HMMA``, ``MUFU.EX2``, ``LDS`` and
``FFMA``.  On one H100, within 900 s: ``git archive HEAD |
tar -x -C build/parent`` first, then ``python3 tools/flash_bench.py --fp32
--parent build/parent``.
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

FWD_SHAPES = {"xlarge freq": (690, 16, 2049, 16), "xlarge time": (4098, 16, 345, 16),
              "small freq": (8272, 4, 513, 12), "small time": (8208, 4, 517, 12)}
BWD_SHAPES = {"small freq": (8272, 4, 513, 12), "small time": (8208, 4, 517, 12),
              "xlarge freq": (690, 16, 2049, 16)}


def _build_parent(root: str) -> ctypes.CDLL:
    from mss_tf_locoformer_tpu_torch.ops import cuda as kernels
    src = os.path.join(root, "mss_tf_locoformer_tpu_torch", "csrc", "flash_attention.cu")
    out_dir = os.path.join(HERE, "build", "flash_parent")
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, "libflash_attention.so")
    proc = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", lib, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(lib)


def _inputs(shape, grad: bool, seed: int):
    import torch
    rows, h, seq, d = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    qkv = (1.5 * torch.randn(rows, seq, 3, h, d, generator=gen, device="cuda")).to(
        torch.bfloat16)
    go = (torch.randn(rows, h, seq, d, generator=gen, device="cuda").to(torch.bfloat16)
          if grad else None)
    return qkv, go


def _kernel_ms(prof) -> dict:
    """Device ms per launch of each flash kernel in a profile, over the
    launches the trace holds."""
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
        m = re.search(r"(flash_\w+)", e.key)
        if t and m and e.count:
            out[m.group(1)] = t / 1e3 / e.count
    return out


def time_library(label: str, lib, reps: int = 3) -> dict:
    import torch
    from chip_smoke import _time_ms
    from mss_tf_locoformer_tpu_torch.ops import cuda as kernels
    from mss_tf_locoformer_tpu_torch.ops.cuda import flash_attention as FA
    kernels._LIBS["flash_attention"] = lib
    out = {"fwd": {}, "bwd": {}, "bwd_kernels": {}}
    for tag, shape in FWD_SHAPES.items():
        qkv, _ = _inputs(shape, False, 6)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        out["fwd"][tag] = _time_ms(lambda: FA.flash_attention(q, k, v, True), iters=reps)
        del qkv, q, k, v
        torch.cuda.empty_cache()
    for tag, shape in BWD_SHAPES.items():
        qkv, go = _inputs(shape, True, 7)
        q4, k4, v4 = qkv.permute(2, 0, 3, 1, 4)
        o, lse = FA._forward(q4, k4, v4, True, 10000.0, True)
        g = go.permute(0, 2, 1, 3)
        call = lambda: FA.flash_attention_backward(g, q4, k4, v4, o, lse, True, 10000.0)
        out["bwd"][tag] = _time_ms(call, iters=reps)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                call()
            torch.cuda.synchronize()
        out["bwd_kernels"][tag] = _kernel_ms(prof)
        del qkv, go, q4, k4, v4, o, lse, g
        torch.cuda.empty_cache()
    print(f"[{label}] forward ms {json.dumps(out['fwd'])}")
    print(f"[{label}] backward ms {json.dumps(out['bwd'])}; by kernel "
          f"{json.dumps(out['bwd_kernels'])}")
    return out


def time_library_calls(reps: int = 3) -> dict:
    """``scaled_dot_product_attention`` on pre-rotated q, k (forward), and
    its autograd backward, at the same shapes."""
    import torch
    import torch.nn.functional as F
    from chip_smoke import _time_ms
    from mss_tf_locoformer_tpu_torch.ops.rope import apply_rope
    out = {"fwd": {}, "bwd": {}}
    for tag, shape in FWD_SHAPES.items():
        qkv, _ = _inputs(shape, False, 6)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        qr, kr = apply_rope(q), apply_rope(k)
        out["fwd"][tag] = _time_ms(lambda: F.scaled_dot_product_attention(qr, kr, v),
                                   iters=reps)
        del qkv, q, k, v, qr, kr
        torch.cuda.empty_cache()
    for tag, shape in BWD_SHAPES.items():
        qkv, go = _inputs(shape, True, 7)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        qr, kr = (apply_rope(t).requires_grad_(True) for t in (q, k))
        vr = v.detach().requires_grad_(True)
        o = F.scaled_dot_product_attention(qr, kr, vr)
        out["bwd"][tag] = _time_ms(lambda: torch.autograd.grad(o, (qr, kr, vr), go,
                                                               retain_graph=True), iters=reps)
        del qkv, go, q, k, v, qr, kr, vr, o
        torch.cuda.empty_cache()
    print(f"[sdpa] forward ms {json.dumps(out['fwd'])}; backward ms {json.dumps(out['bwd'])}")
    return out


_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")


KERNELS = ("flash_fwd_kernelILi16E", "flash_bwd_resident_kernelILi3E")


def sass_loops(so_path: str, kernels=KERNELS):
    """The SASS of each function of ``so_path`` whose name holds one of
    ``kernels`` (the forward at DP 16, the resident backward at 3 slabs a
    warp): of the loops (a backward branch's span) holding a ``MUFU.EX2``
    and a shared-memory load, the innermost with the most ``MUFU.EX2``, with
    its opcode counts."""
    from mss_tf_locoformer_tpu_torch.ops.cuda import _nvcc
    cuobjdump = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", so_path], capture_output=True, text=True,
                          check=True).stdout
    out = {}
    for chunk in text.split("Function : ")[1:]:
        name = chunk.split("\n", 1)[0].strip()
        if not any(k in name for k in kernels):
            continue
        insns, labels = [], {}
        for line in chunk.splitlines():
            lab = re.match(r"\s*(\.L_x_\d+):", line)
            if lab:
                labels[lab.group(1)] = len(insns)
            m = _INSN.search(line)
            if m:
                insns.append((int(m.group(1), 16), m.group(3), m.group(4), line.strip()))
        addr_index = {a: i for i, (a, *_) in enumerate(insns)}
        loops = []
        for i, (addr, op, args, _) in enumerate(insns):
            if op.split(".")[0] != "BRA":
                continue
            t = re.search(r"0x([0-9a-f]+)", args)
            lab = re.search(r"(\.L_x_\d+)", args)
            j = (addr_index.get(int(t.group(1), 16)) if t else
                 labels.get(lab.group(1)) if lab else None)
            if j is not None and j <= i:
                body = insns[j:i + 1]
                ex2 = sum(1 for b in body if b[1].startswith("MUFU.EX2"))
                loops.append((ex2, -(i - j), j, i))
        # innermost of the loops holding an exp and a shared-memory load (a
        # retry loop around the exps alone is not the key loop)
        loops = [lp for lp in loops if lp[0] > 0 and any(
            b[1].startswith(("LDSM", "LDS")) for b in insns[lp[2]:lp[3] + 1])]
        inner = [lp for lp in loops if not any(
            o is not lp and lp[2] <= o[2] and o[3] <= lp[3] for o in loops)]
        if not inner:
            continue
        ex2, _, j, i = max(inner)
        body = insns[j:i + 1]
        # the hot path: without the block a VOTE.ANY's branch skips (the
        # forward's exact rescale, taken when a row's max moves)
        hot = body
        for n, b in enumerate(body):
            if b[1].startswith("VOTE.ANY"):
                for a in body[n + 1:n + 4]:
                    t = re.search(r"0x([0-9a-f]+)", a[2])
                    if a[1].startswith("BRA") and t and int(t.group(1), 16) > a[0]:
                        hot = [x for x in body if not a[0] < x[0] < int(t.group(1), 16)]
                        break
        info = {}
        for tag, part in (("loop", body), ("hot", hot)):
            ops = collections.Counter(b[1] for b in part)
            e = ops.get("MUFU.EX2", 0)
            non_mufu = sum(n for o, n in ops.items() if not o.startswith("MUFU"))
            info[tag] = {"instructions": len(part), "mufu_ex2": e,
                         "non_mufu_per_ex2": non_mufu / max(e, 1),
                         "opcodes": dict(ops.most_common())}
        out[name] = {**info, "sass": "\n".join(b[3] for b in body)}
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="an unpacked checkout to compare with")
    ap.add_argument("--sass-out", help="write the key loops' SASS here")
    ap.add_argument("--fp32", action="store_true",
                    help="time the fp32 rows (#6/#7 and #3/#4's core) instead")
    ap.add_argument("--reps", type=int, default=3, help="calls a timing (--fp32)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("flash_bench.py needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi)
    if args.fp32:
        return main_fp32(args, smi)
    from mss_tf_locoformer_tpu_torch.ops import cuda as kernels
    stale = os.path.join(kernels.BUILD_DIR, "libflash_attention.so")
    if os.path.exists(stale):   # build here, so that ptxas's report is printed
        os.remove(stale)
    libs = {"tree": kernels.load("flash_attention")}
    paths = {"tree": os.path.join(kernels.BUILD_DIR, "libflash_attention.so")}
    print(f"[build] {kernels.BUILD_LOG.get('flash_attention', '').strip()}")
    if args.parent:
        libs["parent"] = _build_parent(args.parent)
        paths["parent"] = os.path.join(HERE, "build", "flash_parent", "libflash_attention.so")
    order = ["parent", "tree", "tree", "parent"] if args.parent else ["tree"]
    result = {"card": smi, "runs": []}
    for label in order:
        result["runs"].append({"label": label, **time_library(label, libs[label])})
    kernels._LIBS["flash_attention"] = libs["tree"]
    result["sdpa"] = time_library_calls()
    result["sass"] = {}
    dump = []
    for label, path in paths.items():
        for name, info in sass_loops(path).items():
            dump.append(f"=== {label}: {name}\n{info.pop('sass')}")
            result["sass"][f"{label}: {name}"] = info
            for tag in ("loop", "hot"):
                i = info[tag]
                print(f"[sass] {label} {name[:60]}: key {tag} {i['instructions']} "
                      f"instructions, {i['mufu_ex2']} MUFU.EX2, {i['non_mufu_per_ex2']:.2f} "
                      f"others per EX2; {i['opcodes']}")
    if args.sass_out:
        os.makedirs(os.path.dirname(os.path.abspath(args.sass_out)), exist_ok=True)
        with open(args.sass_out, "w") as f:
            f.write("\n\n".join(dump))
    print(json.dumps(result))


# ------------------------------------------------------------------ fp32

FP32_FWD = {"xlarge freq": ((690, 16, 2049, 16), False), "xlarge time": ((4098, 16, 345, 16), False),
            "small freq": ((8272, 4, 513, 12), True), "small time": ((8208, 4, 517, 12), True)}
FP32_BWD = ("small freq", "small time")
FP32_CORE = ("attn_fwd_tc", "attn_dq_tc", "attn_dkdv_tc", "attn_fwd", "attn_dq", "attn_dkdv")


def _parent_fp32(root: str):
    """The other checkout's ``ops/cuda/step_fp32.py`` and ``unfused_fp32.py``
    driving its own ``csrc/step_fp32.cu`` (and ``csrc/attn_fp32.cu`` where it
    has one), built into ``build/flash_parent/``; other relative imports
    resolve to this tree's package (dropout, the loader, the panel cache)."""
    from mss_tf_locoformer_tpu_torch.ops import cuda as kernels
    pkg = os.path.join(root, "mss_tf_locoformer_tpu_torch")
    out_dir = os.path.join(HERE, "build", "flash_parent")
    os.makedirs(out_dir, exist_ok=True)
    handles, paths = {}, {}
    for name in ("step_fp32", "attn_fp32", "ffn_core_fp32"):
        src = os.path.join(pkg, "csrc", f"{name}.cu")
        if not os.path.exists(src):
            continue
        lib = os.path.join(out_dir, f"lib{name}.so")
        proc = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", lib, src],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}{proc.stderr}")
        handles[name], paths[name] = ctypes.CDLL(lib), lib
    mods = {}
    for name in ("step_fp32", "unfused_fp32"):
        spec = importlib.util.spec_from_file_location(
            f"mss_tf_locoformer_tpu_torch.ops.cuda._parent_{name}",
            os.path.join(pkg, "ops", "cuda", f"{name}.py"))
        mods[name] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mods[name])
        mods[name].load = lambda n: handles[n]
    mods["unfused_fp32"].S = mods["step_fp32"]
    # a checkout whose fused steps run on unfused_fp32's GEMMs imports it
    # lazily (``step_fp32._core``): give it its own
    mods["step_fp32"]._core = lambda: mods["unfused_fp32"]
    return mods["step_fp32"], mods["unfused_fp32"], paths


def _launch_ms(label, S, U, fn, reps: int, backward: bool = False) -> dict:
    """Per launch of the chain ``fn`` runs on ``S.CudaPrims`` and
    ``U.CorePrims`` (``S`` / ``U`` a checkout's ``step_fp32`` /
    ``unfused_fp32``): ``[launches, device ms]`` a call (CUDA events,
    ``chip_smoke._fp32_attn_launches``; this tree's chain must run no FFMA
    GEMM), after one call to warm up."""
    from chip_smoke import _fp32_attn_launches
    fn()
    return _fp32_attn_launches(f"bench {label}", fn, backward, reps, S, U,
                               check=label == "tree")


def _core_kernel_ms(fn, reps: int) -> dict:
    """Device ms a call of each attention-core kernel ``fn`` launches, from a
    ``torch.profiler`` trace (the backward's dq and dk/dv kernels share one
    C call, so no event falls between them)."""
    import torch
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
        m = re.search(r"(attn_(?:fwd|dq|dkdv)(?:_tc)?)\b", e.key)
        if t and m:
            out[m.group(1)] = out.get(m.group(1), 0.0) + t / 1e3 / reps
    return out


def _fp32_flash(label, S, U, tag, reps) -> dict:
    """#6 (and at the small shapes #7) on ``S`` / ``U`` at one shape."""
    import torch
    from chip_smoke import _time_ms
    (rows, h, seq, d), stash = FP32_FWD[tag]
    gen = torch.Generator(device="cuda").manual_seed(16)
    qkv = 1.5 * torch.randn(rows, seq, 3, h, d, generator=gen, device="cuda")
    q4, k4, v4 = qkv.permute(2, 0, 3, 1, 4)
    fwd = lambda: U.flash_forward_fp32(q4, k4, v4, True, 10000.0, stash)
    out = {"fwd_ms": _time_ms(fwd, iters=reps),
           "fwd_launches": _launch_ms(label, S, U, fwd, reps),
           "fwd_kernels": _core_kernel_ms(fwd, reps)}
    if tag in FP32_BWD:
        o, lse = U.flash_forward_fp32(q4, k4, v4, True, 10000.0, True)
        g = torch.randn(rows, seq, h, d, generator=gen, device="cuda")
        bwd = lambda: U.flash_backward_fp32(g, q4, k4, v4, o, lse, True, 10000.0)
        out.update(bwd_ms=_time_ms(bwd, iters=reps),
                   bwd_launches=_launch_ms(label, S, U, bwd, reps, True),
                   bwd_kernels=_core_kernel_ms(bwd, reps))
        del o, lse, g
    del qkv, q4, k4, v4
    torch.cuda.empty_cache()
    print(f"[{label}] #6/#7 fp32 {tag}: {json.dumps(out)}")
    return out


def _step_shapes():
    """(tag, config, rows, sequence, dropout, backward) of the attention-step
    timings: base training (micro-batch 2 x 3 s) and wsj0-2mix serving (8 s)."""
    import chip_smoke as cs
    base = cs.base_model_config()
    out = [(f"base training {p}", base, r, s, 0.1, True) for p, r, s in cs._train_steps(base)]
    sp = cs.speech_config("wsj0_2mix")
    out += [(f"speech serving {p}", sp.separator, r, s, 0.0, False)
            for p, r, s in cs._speech_steps(sp, 1, 8.0)]
    return out


def _fp32_step(label, S, U, tag, cfg, rows, seq, drop, backward, reps) -> dict:
    """#3 (and #4) of the fp32 chain ``S`` / ``U`` (a checkout's
    ``step_fp32`` / ``unfused_fp32``)."""
    import torch
    import chip_smoke as cs
    from chip_smoke import _time_ms
    c, h = cfg.emb_dim, cfg.n_heads
    gen = torch.Generator().manual_seed(17)
    x, gamma, _, (w_qkv, w_out) = cs._step_inputs(gen, rows, seq, "cuda", c, 4 * c, 4)
    x = x.float()
    args = (h, cfg.num_groups, cfg.eps, cfg.pos_enc == "rope", 10000.0, drop, 777, 0)
    fwd = lambda: S.attention_forward(x, gamma, w_qkv, w_out, *args, stash=backward)
    out = {"fwd_ms": _time_ms(fwd, iters=reps),
           "fwd_launches": _launch_ms(label, S, U, fwd, reps),
           "fwd_kernels": _core_kernel_ms(fwd, reps)}
    if backward:
        _, stash = fwd()
        g = torch.randn(rows, seq, c, device="cuda")
        bwd = lambda: S.attention_backward(g, x, gamma, w_qkv, w_out, stash, *args)
        out.update(bwd_ms=_time_ms(bwd, iters=reps),
                   bwd_launches=_launch_ms(label, S, U, bwd, reps, True),
                   bwd_kernels=_core_kernel_ms(bwd, reps))
        del stash, g
    del x
    torch.cuda.empty_cache()
    print(f"[{label}] #3/#4 fp32 {tag}: {json.dumps(out)}")
    return out


def _norm_shapes():
    """(tag, positions, C, groups) of the norm timings: the base training
    freq and time shapes (micro-batch 2 x 3 s) and wsj0-2mix serving's
    freq shape (8 s)."""
    import chip_smoke as cs
    base, sp = cs.base_model_config(), cs.speech_config("wsj0_2mix")
    out = [(f"base training {p}", r * s, base.emb_dim, base.num_groups)
           for p, r, s in cs._train_steps(base)]
    p, r, s = cs._speech_steps(sp, 1, 8.0)[0]
    return out + [(f"speech serving {p}", r * s, sp.separator.emb_dim, sp.separator.num_groups)]


def _fp32_norms(label, S, npos, c, groups, reps) -> dict:
    """``norm_fwd`` and ``norm_bwd`` (with the residual's gradient) of the
    checkout ``S`` alone at ``npos`` positions of ``C``: ms a call (CUDA
    events over ``reps`` calls after a warm-up) and the bytes bounds (x read,
    xn written; x, dxn and the residual's gradient read, dx written; each at
    3.35 TB/s)."""
    import torch
    from chip_smoke import HBM_RATE, _time_ms
    P = S.CudaPrims()
    gen = torch.Generator(device="cuda").manual_seed(18)
    x, dxn, gres = (torch.randn(npos, c, generator=gen, device="cuda") for _ in range(3))
    gamma = 1 + 0.1 * torch.randn(c, generator=gen, device="cuda")
    xn, dx = torch.empty_like(x), torch.empty_like(x)
    part = torch.empty(-(-npos // S.NP), c, device="cuda")
    row = 4.0 * npos * c
    out = {"norm_fwd_ms": _time_ms(lambda: P.norm_fwd(x, gamma, xn, npos, c, groups, 1e-5),
                                   iters=reps),
           "norm_bwd_ms": _time_ms(lambda: P.norm_bwd(x, gamma, dxn, gres, dx, part, npos, c,
                                                      groups, 1e-5), iters=reps),
           "norm_fwd_bound_ms": 2 * row / HBM_RATE * 1e3,
           "norm_bwd_bound_ms": 4 * row / HBM_RATE * 1e3}
    del x, dxn, gres, xn, dx, part
    torch.cuda.empty_cache()
    print(f"[{label}] norms [{npos}, {c}], {groups} groups: {json.dumps(out)}")
    return out


def _fp32_sdpa(tag, reps) -> dict:
    """``scaled_dot_product_attention``'s fp32 memory-efficient backend on
    pre-rotated q, k at #6's shape (and its autograd backward at #7's)."""
    import torch
    from chip_smoke import _sdpa_fp32, _time_ms
    from mss_tf_locoformer_tpu_torch.ops.rope import apply_rope
    (rows, h, seq, d), _ = FP32_FWD[tag]
    gen = torch.Generator(device="cuda").manual_seed(16)
    qkv = 1.5 * torch.randn(rows, seq, 3, h, d, generator=gen, device="cuda")
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    qr, kr = apply_rope(q), apply_rope(k)
    out = {"fwd_ms": _time_ms(lambda: _sdpa_fp32(qr, kr, v), iters=reps)}
    if tag in FP32_BWD:
        qr, kr = qr.requires_grad_(True), kr.requires_grad_(True)
        vr = v.detach().requires_grad_(True)
        o = _sdpa_fp32(qr, kr, vr)
        g = torch.randn_like(o)
        out["bwd_ms"] = _time_ms(lambda: torch.autograd.grad(o, (qr, kr, vr), g,
                                                             retain_graph=True), iters=reps)
        del o, g, vr
    del qkv, q, k, v, qr, kr
    torch.cuda.empty_cache()
    print(f"[sdpa fp32] {tag}: {json.dumps(out)}")
    return out


def _fp32_bounds():
    """Per timing: the 3xTF32 bound (the larger of 3 x FLOP at the TF32 peak,
    one exponential a score at the special-function rate and the bytes) and
    the FFMA bound (FLOP at 67 TFLOP/s), (ms, what bounds it)."""
    import chip_smoke as cs
    both = lambda f, b, e: {"tf32x3": cs._bound(f, b, e, peak=cs.PEAK_TF32,
                                                 passes=cs.TF32_PASSES),
                            "ffma": cs._bound(f, b, e, peak=cs.PEAK_FP32)}
    out = {}
    for tag, (shape, _) in FP32_FWD.items():
        out[f"#6 {tag}"] = both(*cs.flash_work(*shape, row_bytes=4))
        if tag in FP32_BWD:
            out[f"#7 {tag}"] = both(*cs.flash_bwd_work(*shape, row_bytes=4))
    for tag, cfg, rows, seq, _, backward in _step_shapes():
        ff, fb, bf, bb, ex = cs.attn_work(rows, seq, cfg.emb_dim, cfg.attention_dim,
                                          cfg.n_heads, row_bytes=4)
        out[f"#3 {tag}"] = both(ff, fb, ex)
        if backward:
            out[f"#4 {tag}"] = both(bf, bb, ex)
    return out


def main_fp32(args, smi):
    import torch
    from mss_tf_locoformer_tpu_torch.ops import cuda as kernels
    from mss_tf_locoformer_tpu_torch.ops.cuda import step_fp32 as S
    from mss_tf_locoformer_tpu_torch.ops.cuda import unfused_fp32 as U
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from ffn_bench import sass_counts
    torch.backends.cuda.matmul.allow_tf32 = False
    stale = os.path.join(kernels.BUILD_DIR, "libattn_fp32.so")
    if os.path.exists(stale):   # build here, so that ptxas's report is printed
        os.remove(stale)
    kernels.load("attn_fp32")
    for line in kernels.BUILD_LOG.get("attn_fp32", "").splitlines():
        if any(w in line for w in ("Compiling entry", "Used", "spill")):
            print(f"[build] {line.strip()}")
    kernels.load("step_fp32")
    mods = {"tree": (S, U)}
    paths = {"tree": stale}
    if args.parent:
        ps, pu, ppaths = _parent_fp32(args.parent)
        mods["parent"] = (ps, pu)
        paths.update({f"parent {n}": p for n, p in ppaths.items() if n != "ffn_core_fp32"})
    order = ["parent", "tree", "tree", "parent"] if args.parent else ["tree"]
    result = {"card": smi, "fp32": True, "bounds": _fp32_bounds(), "flash": {}, "step": {},
              "sdpa": {}}
    for tag in FP32_FWD:
        result["flash"][tag] = [{"label": lb, **_fp32_flash(lb, *mods[lb], tag, args.reps)}
                                for lb in order]
        result["sdpa"][tag] = _fp32_sdpa(tag, args.reps)
    for tag, cfg, rows, seq, drop, backward in _step_shapes():
        result["step"][tag] = [{"label": lb, **_fp32_step(lb, *mods[lb], tag, cfg, rows, seq,
                                                          drop, backward, args.reps)}
                               for lb in order]
    result["norms"] = {tag: [{"label": lb, **_fp32_norms(lb, mods[lb][0], npos, c, groups,
                                                          args.reps)} for lb in order]
                       for tag, npos, c, groups in _norm_shapes()}
    for name, bound in result["bounds"].items():
        print(f"[bound] {name}: 3xTF32 {bound['tf32x3'][0]:.3f} ms ({bound['tf32x3'][1]}), "
              f"FFMA {bound['ffma'][0]:.3f} ms ({bound['ffma'][1]})")
    ops = ("HMMA", "MUFU", "LDS", "LDGSTS", "SHFL", "FFMA")
    result["sass"] = {label: sass_counts(p, FP32_CORE, ops, known_only=True)
                      for label, p in paths.items()}
    for label, counts in result["sass"].items():
        for name, n in counts.items():
            print(f"[sass] {label} {name}: {n}")
    print(json.dumps(result))


if __name__ == "__main__":
    main()
