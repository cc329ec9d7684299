#!/usr/bin/env python3
"""Time the flash-attention kernels (#6 forward, #7 backward) on the card and
count the instructions of the forward's inner loop in their SASS.

    python3 tools/flash_bench.py [--parent DIR] [--sass-out FILE]

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
"""

from __future__ import annotations

import argparse
import collections
import ctypes
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
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("flash_bench.py needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi)
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


if __name__ == "__main__":
    main()
