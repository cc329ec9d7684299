#!/usr/bin/env python3
"""Time the attention-step kernels (#3 forward, #4 backward) on the card and
count the tensor-core and exponential instructions in their SASS.

    python3 tools/attn_step_bench.py [--parent DIR] [--reps N] [--only TAG]
                                     [--sass-out FILE]

Builds ``csrc/attention_block.cu`` of this tree and, with ``--parent``, the
same file of another checkout unpacked at ``DIR`` (into
``build/attn_parent/``), which is driven through that checkout's own wrapper
(``ops/cuda/attention_block.py``: the two may bind different C signatures).
It times with CUDA events, at every shipped shape of the fused attention
step:

  * #3 at base serving ``[1380, 1025, 96]`` / ``[2050, 690, 96]`` and
    BS-Locoformer serving ``[1380, 62, 128]`` / ``[124, 690, 128]``;
  * #3 (with the training stash) and #4 at base training ``[518, 1025,
    96]`` / ``[2050, 259, 96]``, dropout 0.1, and at dropout 0 beside it
    (what the probability mask costs);
  * #3 and #4 at ``chip_smoke.ATTN_STREAM_SHAPE`` ``[16, 1900, 96]``,
    beyond the resident core's gate (the streaming core);
  * with a parent, in turns: parent, this tree, this tree, parent;

beside the plain version (for #4 its autograd backward), the bound
(``chip_smoke.attn_work``) and ``scaled_dot_product_attention`` on the same
q, k and v at dropout 0 (the core alone: no one PyTorch call computes the
whole step), and each call's device time kernel by kernel from a
``torch.profiler`` trace (#3: QKV, core, out-projection; #4: pre, dq, dk/dv,
final, the two weight products and the reductions).  Then ``cuobjdump
-sass`` of each library: per kernel the count of ``HMMA``, ``HGMMA``,
``MUFU.EX2``, ``LDGSTS`` and ``SHFL``, and for the kernels with a score
loop (the resident core, the two backward passes) that loop's ``MUFU.EX2``
per score and other instructions per ``MUFU.EX2``, over the whole loop and
over its hot path (without the exact-rescale block).  The last line is one
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
sys.path.insert(0, os.path.join(HERE, "tools"))

GROUPS, EPS, DROP, SEED, THETA = 4, 1e-5, 0.1, 777, 10000.0
OPCODES = ("HMMA", "HGMMA", "MUFU.EX2", "LDGSTS", "SHFL")
KERNEL_PREFIX = "(?:attn_|wgrad_|reduce_)"
# Scores a lane handles per pass of a kernel's score loop, for MUFU.EX2 per
# score: the register kernels' 64-key (or 64-query) tiles, a warp's 16 rows
# by 64, are 32 scores a lane.  The first design's kernels walk a row's 32
# columns four at a time (4 scores a pass).
SCORES_PER_PASS = {"attn_core_kernel": 4, "attn_bwd_dq_kernel": 4, "attn_bwd_dkdv_kernel": 4,
                   "attn_core_res_kernel": 32, "attn_bwd_dq_reg_kernel": 32,
                   "attn_bwd_dkdv_reg_kernel": 32}


def shapes():
    """(tag, rows, sequence, C, A, H, dropout, backward) of the timed calls."""
    import chip_smoke as cs
    base, bs = cs.base_model_config(), cs.bs_model_config()
    out = [(f"base serving {p}", r, s, 96, 96, 4, 0.0, False)
           for p, r, s in cs._main_path_steps(base)]
    out += [(f"bs serving {p}", r, s, 128, 128, 4, 0.0, False)
            for p, r, s in cs._bs_main_path_steps(bs)]
    for p, r, s in cs._train_steps(base):
        out += [(f"base training {p}", r, s, 96, 96, 4, DROP, True),
                (f"base training {p} dropout 0", r, s, 96, 96, 4, 0.0, True)]
    r, s, c = cs.ATTN_STREAM_SHAPE
    out.append((f"streaming [{r}, {s}, {c}]", r, s, c, c, 4, DROP, True))
    return out


def _parent_wrapper(root: str):
    """The parent checkout's ``ops/cuda/attention_block.py`` as a module of
    its own, bound to its own library (built into ``build/attn_parent/``);
    its relative imports resolve to this tree's package."""
    from mss_tf_locoformer_tpu_torch.ops import cuda as kernels
    pkg = os.path.join(root, "mss_tf_locoformer_tpu_torch")
    out_dir = os.path.join(HERE, "build", "attn_parent")
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, "libattention_block.so")
    src = os.path.join(pkg, "csrc", "attention_block.cu")
    proc = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", lib, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}{proc.stderr}")
    spec = importlib.util.spec_from_file_location(
        "mss_tf_locoformer_tpu_torch.ops.cuda._parent_attention_block",
        os.path.join(pkg, "ops", "cuda", "attention_block.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    handle = ctypes.CDLL(lib)
    mod.load = lambda name: handle
    return mod, lib


def _inputs(rows, seq, c, a, seed):
    """Rows and weights as ``chip_smoke._step_inputs`` draws them (QKV at
    twice torch's init scale: a peaked softmax)."""
    import torch
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = (0.5 * torch.randn(rows, seq, c, generator=gen, device=dev)).to(torch.bfloat16)
    gamma = 1.0 + 0.1 * torch.randn(c, generator=gen, device=dev)
    w_qkv = (torch.rand(3 * a, c, generator=gen, device=dev) * 2 - 1) * 2 * c ** -0.5
    w_out = (torch.rand(c, a, generator=gen, device=dev) * 2 - 1) * a ** -0.5
    g = torch.randn(rows, seq, c, generator=gen, device=dev).to(torch.bfloat16)
    return x, gamma, w_qkv, w_out, g


def time_wrapper(label, mod, tag, x, gamma, w_qkv, w_out, g, h, p, bwd, reps) -> dict:
    from chip_smoke import _kernel_device_ms, _time_ms, attn_bwd_launches
    args = (h, GROUPS, EPS, True, THETA, p, SEED, 0)
    out = {}
    call = lambda: mod.attention_step_forward(x, gamma, w_qkv, w_out, *args, stash=bwd)
    out["fwd_ms"] = _time_ms(call, iters=reps)
    out["fwd_kernels"] = _kernel_device_ms(call, KERNEL_PREFIX, reps=reps)
    if bwd:
        _, stash = call()
        call = lambda: mod.attention_step_backward(g, x, gamma, w_qkv, w_out, stash, *args)
        out["bwd_ms"] = _time_ms(call, iters=reps)
        out["bwd_kernels"] = _kernel_device_ms(call, KERNEL_PREFIX, attn_bwd_launches(mod),
                                               reps=reps)
        del stash
    print(f"[{label}] {tag}: {json.dumps(out)}")
    return out


def time_plain(tag, x, gamma, w_qkv, w_out, g, h, p, bwd) -> dict:
    import torch
    from chip_smoke import _time_ms
    from mss_tf_locoformer_tpu_torch.ops.cuda import attention_block as AB
    args = (h, GROUPS, EPS, True, THETA, p, SEED, 0)
    out = {"fwd_ms": _time_ms(lambda: AB.reference_attention_block(
        x, gamma, w_qkv, w_out, *args), iters=2)}
    if bwd:
        xp = x.detach().requires_grad_(True)
        wp = [t.detach().requires_grad_(True) for t in (gamma, w_qkv, w_out)]
        pout = AB.reference_attention_block(xp, *wp, *args)
        out["bwd_ms"] = _time_ms(lambda: torch.autograd.grad(pout, [xp, *wp], g,
                                                             retain_graph=True), iters=1)
        del xp, wp, pout
    print(f"[plain] {tag}: {json.dumps(out)}")
    return out


def time_sdpa(x, h, a, bwd, reps) -> dict:
    """``scaled_dot_product_attention`` forward (and its autograd backward)
    on q, k, v ``[R, H, L, A/H]`` bf16 at dropout 0: the core alone."""
    import torch
    import torch.nn.functional as F
    from chip_smoke import _time_ms
    rows, seq, _ = x.shape
    gen = torch.Generator(device=x.device).manual_seed(5)
    q, k, v = (torch.randn(rows, h, seq, a // h, generator=gen, device=x.device,
                           dtype=torch.bfloat16).requires_grad_(bwd) for _ in range(3))
    out = {"fwd_ms": _time_ms(lambda: F.scaled_dot_product_attention(q, k, v), iters=reps)}
    if bwd:
        o = F.scaled_dot_product_attention(q, k, v)
        go = torch.randn_like(o)
        out["bwd_ms"] = _time_ms(lambda: torch.autograd.grad(o, [q, k, v], go,
                                                             retain_graph=True), iters=reps)
    return out


_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")


def sass_summary(so_path: str, sass_out=None) -> dict:
    """Per kernel function of ``so_path``: the count of each of ``OPCODES``
    and, for the kernels of ``SCORES_PER_PASS``, their score loop (the
    innermost backward branch's span holding the most ``MUFU.EX2``): its
    instructions, ``MUFU.EX2`` per score and other instructions per
    ``MUFU.EX2``."""
    from mss_tf_locoformer_tpu_torch.ops.cuda import _nvcc
    cuobjdump = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", so_path], capture_output=True, text=True,
                          check=True).stdout
    out, dump = {}, []
    for chunk in text.split("Function : ")[1:]:
        name = chunk.split("\n", 1)[0].strip()
        known = [k for k in (*SCORES_PER_PASS, "attn_qkv_kernel", "attn_out_kernel",
                             "attn_bwd_pre_kernel", "attn_bwd_final_kernel", "wgrad_kernel",
                             "reduce_kernel") if k in name]
        key = max(known, key=len) if known else name
        tmpl = re.findall(r"L[ib](\d+)E", name.split("Ev")[0])   # template arguments
        key += f"<{', '.join(tmpl)}>" if tmpl else ""
        insns = [(int(m.group(1), 16), m.group(3), m.group(4), line.strip())
                 for line in chunk.splitlines() for m in [_INSN.search(line)] if m]
        ops = collections.Counter(i[1] for i in insns)
        entry = {op: sum(n for o, n in ops.items() if o.split(".")[0] == op or o.startswith(op))
                 for op in OPCODES}
        scores = SCORES_PER_PASS.get(max(known, key=len)) if known else None
        if scores:
            index = {a: i for i, (a, *_) in enumerate(insns)}
            loops = []
            for i, (addr, op, args, _) in enumerate(insns):
                t = re.search(r"0x([0-9a-f]+)", args)
                if op.split(".")[0] == "BRA" and t and index.get(int(t.group(1), 16), i + 1) <= i:
                    j = index[int(t.group(1), 16)]
                    ex2 = sum(1 for b in insns[j:i + 1] if b[1].startswith("MUFU.EX2"))
                    if ex2:
                        loops.append((j, i, ex2))
            inner = [lp for lp in loops if not any(
                o is not lp and lp[0] <= o[0] and o[1] <= lp[1] for o in loops)]
            if inner:
                j, i, ex2 = max(inner, key=lambda lp: (lp[2], lp[0] - lp[1]))
                body = insns[j:i + 1]
                # the hot path: without the block a VOTE.ANY's forward branch
                # skips (the forward's exact rescale, taken when a row's max
                # moves), as tools/flash_bench.py counts it
                hot = body
                for n, b in enumerate(body):
                    if b[1].startswith("VOTE.ANY"):
                        for a in body[n + 1:n + 4]:
                            tgt = re.search(r"0x([0-9a-f]+)", a[2])
                            if a[1].startswith("BRA") and tgt and int(tgt.group(1), 16) > a[0]:
                                end = int(tgt.group(1), 16)
                                hot = [x for x in body if not a[0] < x[0] < end]
                                break
                for tag, part in (("loop", body), ("hot", hot)):
                    e = sum(1 for b in part if b[1].startswith("MUFU.EX2"))
                    entry[tag] = {"instructions": len(part), "mufu_ex2": e,
                                  "scores_per_pass": scores, "mufu_ex2_per_score": e / scores,
                                  "non_mufu_per_ex2": (len(part) - sum(
                                      1 for b in part if b[1].startswith("MUFU"))) / max(e, 1)}
                dump.append(f"=== {key}\n" + "\n".join(b[3] for b in body))
        out[key] = entry
    if sass_out:
        os.makedirs(os.path.dirname(os.path.abspath(sass_out)), exist_ok=True)
        with open(sass_out, "w") as f:
            f.write("\n".join(dump))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="an unpacked checkout to compare with")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--only", default="", help="time only the shapes whose tag holds this")
    ap.add_argument("--sass-out", help="write the score loops' SASS here")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("attn_step_bench.py needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs
    from mss_tf_locoformer_tpu_torch.ops import cuda as kernels
    from mss_tf_locoformer_tpu_torch.ops.cuda import attention_block as AB
    stale = os.path.join(kernels.BUILD_DIR, "libattention_block.so")
    if os.path.exists(stale):   # build here, so that ptxas's report is printed
        os.remove(stale)
    kernels.load("attention_block")
    for line in kernels.BUILD_LOG.get("attention_block", "").splitlines():
        if any(w in line for w in ("Compiling entry", "Used", "spill")):
            print(f"[build] {line.strip()}")
    mods, paths = {"tree": AB}, {"tree": stale}
    if args.parent:
        mods["parent"], paths["parent"] = _parent_wrapper(args.parent)
    order = ["parent", "tree", "tree", "parent"] if args.parent else ["tree"]
    result = {"card": smi, "shapes": {}}
    for tag, rows, seq, c, a, h, p, bwd in shapes():
        if args.only not in tag:
            continue
        x, gamma, w_qkv, w_out, g = _inputs(rows, seq, c, a, 8)
        fl, fby, bfl, bby, exps = cs.attn_work(rows, seq, c, a, h)
        entry = {"shape": [rows, seq, c], "heads": h, "dropout": p,
                 "fwd_bound": cs._bound(fl, fby, exps),
                 "bwd_bound": cs._bound(bfl, bby, exps) if bwd else None,
                 "plain": time_plain(tag, x, gamma, w_qkv, w_out, g, h, p, bwd)
                 if "dropout 0" not in tag else None,
                 "sdpa_core": time_sdpa(x, h, a, bwd, args.reps), "runs": []}
        print(f"[sdpa] {tag}: {json.dumps(entry['sdpa_core'])}")
        for label in order:
            entry["runs"].append({"label": label, **time_wrapper(
                label, mods[label], tag, x, gamma, w_qkv, w_out, g, h, p, bwd, args.reps)})
        result["shapes"][tag] = entry
        print(f"[bound] {tag}: forward {entry['fwd_bound']}, backward {entry['bwd_bound']}")
        del x, gamma, w_qkv, w_out, g
        torch.cuda.empty_cache()
    result["sass"] = {}
    for label, path in paths.items():
        out = args.sass_out and f"{args.sass_out}.{label}"
        result["sass"][label] = sass_summary(path, out)
        for name, info in result["sass"][label].items():
            print(f"[sass] {label} {name}: {json.dumps(info)}")
    print(json.dumps(result))


if __name__ == "__main__":
    main()
