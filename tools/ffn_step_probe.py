#!/usr/bin/env python3
"""Where the FFN-step forward kernel (#2, Hopper route) spends its cycles.

    python3 tools/ffn_step_probe.py

Builds an instrumented copy of ``csrc/swiglu_block.cu`` into
``build/ffn_step_probe/``: ``ffn_step_wg_kernel`` reads ``clock64()`` around
each phase of its chunk loop, and lane 0 of every warp adds its cycles per
phase into a device counter.  Runs the forward through this tree's wrapper
at the base serving freq shape and BS-Locoformer's two serving shapes and
prints each phase's share of the warps' cycles: the prologue (barriers,
the x tile and its norm), the conv's waits for a weight stage to arrive and
for its products (``retire``: the previous stage's products, thread 0's
refills), the drain before SwiGLU, SwiGLU, the h barrier, the deconv's
stage and product waits, and the epilogue.  The clock reads cost a few
percent of the time; the shares, not the time, are its result.
"""

from __future__ import annotations

import ctypes
import importlib.util
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
CSRC = os.path.join(HERE, "mss_tf_locoformer_tpu_torch", "csrc")
PHASES = ("prologue", "conv stage wait", "conv retire", "conv drain", "swiglu", "h barrier",
          "deconv stage wait", "deconv retire", "epilogue")

# (text of csrc/swiglu_block.cu's forward kernel, its instrumented form)
EDITS = (
    ("  using Y = FLay<C>;\n  extern __shared__",
     "  using Y = FLay<C>;\n"
     "  unsigned long long T0 = clock64(), TT = T0, acc_[10] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};\n"
     "#define TICK(k) { const unsigned long long t_ = clock64(); acc_[k] += t_ - TT; TT = t_; }\n"
     "  extern __shared__"),
    ("  norm_tile<C>(xs, (float*)hs, (float*)(hs + 12288), x, f, Q0, gamma, dpg, rdpg, eps);\n"
     "  __syncthreads();\n",
     "  norm_tile<C>(xs, (float*)hs, (float*)(hs + 12288), x, f, Q0, gamma, dpg, rdpg, eps);\n"
     "  __syncthreads();\n  TICK(0)\n"),
    ("    conv_chunk<C, Y::NS>(y, xt, 64 * cw, K, ring, s, pending, lane);\n"
     "    ring.drain(pending, lane);   // y, and the previous chunk's deconv (it read h)\n"
     "    fence_regs<64>(y);",
     "    for (int t = 0; t < K; ++t) {\n"
     "      const uint32_t sb = ring.wait(s);\n      TICK(1)\n      wgmma_fence();\n"
     "#pragma unroll\n      for (int kk = 0; kk < C / 16; ++kk)\n"
     "        wgmma_ss_kt_n128(y, tile_desc(xt, 64 * cw + t, kk),\n"
     "                         desc_sw128(sb + kk * 2048, C * 128, 1024), t || kk);\n"
     "      wgmma_commit();\n      ring.retire(s, pending, lane);\n      TICK(2)\n    }\n"
     "    ring.drain(pending, lane);\n    fence_regs<64>(y);\n    TICK(3)"),
    ("    fence_proxy_async();   // the deconv reads h through the async proxy\n"
     "    named_sync(1, 256);",
     "    fence_proxy_async();\n    TICK(4)\n    named_sync(1, 256);\n    TICK(5)"),
    ("    for (int tp = 0; tp < K2; ++tp) {\n      const uint32_t sb = ring.wait(s);\n"
     "      wgmma_fence();",
     "    for (int tp = 0; tp < K2; ++tp) {\n      const uint32_t sb = ring.wait(s);\n"
     "      TICK(6)\n      wgmma_fence();"),
    ("      wgmma_commit();\n      ring.retire(s, pending, lane);\n    }\n  }\n"
     "  ring.drain(pending, lane);\n  fence_regs<C / 2>(z);",
     "      wgmma_commit();\n      ring.retire(s, pending, lane);\n      TICK(7)\n    }\n  }\n"
     "  ring.drain(pending, lane);\n  fence_regs<C / 2>(z);"),
)


def instrumented_source() -> str:
    src = open(os.path.join(CSRC, "swiglu_block.cu")).read()
    a = src.index("ffn_step_wg_kernel(")
    b = src.index("ffn_step_dx_wg_kernel(")
    body = src[a:b]
    for old, new in EDITS:
        if body.count(old) != 1:
            raise SystemExit(f"ffn_step_probe.py: the forward kernel no longer holds {old!r}")
        body = body.replace(old, new)
    end = body.rindex("}\n\n// One block per tile")
    body = (body[:end] + "  TICK(8)\n  acc_[9] = clock64() - T0;\n  if (lane == 0)\n"
            "    for (int i = 0; i < 10; ++i) atomicAdd(&g_prof[i], acc_[i]);\n#undef TICK\n"
            + body[end:])
    src = src[:a] + body + src[b:]
    src = src.replace("namespace stp {", "namespace stp {\n__device__ unsigned long long g_prof[10];",
                      1)
    return src + ('\nextern "C" int probe_counts(void* dst) {\n'
                  "  cudaError_t e = cudaMemcpyFromSymbol(dst, stp::g_prof, sizeof(stp::g_prof));\n"
                  "  unsigned long long z[10] = {0};\n"
                  "  cudaMemcpyToSymbol(stp::g_prof, z, sizeof(z));\n"
                  "  return (int)e;\n}\n")


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("ffn_step_probe.py needs a CUDA device")
    from mss_tf_locoformer_tpu_torch.ops import cuda as kernels
    out = os.path.join(HERE, "build", "ffn_step_probe")
    os.makedirs(out, exist_ok=True)
    src, lib = os.path.join(out, "swiglu_block_probe.cu"), os.path.join(out, "libprobe.so")
    with open(src, "w") as fh:
        fh.write(instrumented_source())
    proc = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", CSRC, "-o", lib, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    spec = importlib.util.spec_from_file_location(
        "mss_tf_locoformer_tpu_torch.ops.cuda._probe_swiglu_block",
        os.path.join(HERE, "mss_tf_locoformer_tpu_torch", "ops", "cuda", "swiglu_block.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    handle = ctypes.CDLL(lib)
    mod.load = lambda name: handle
    counts = handle.probe_counts
    counts.argtypes = [ctypes.c_void_p]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda", 0)
    for tag, rows, seq, c in (("base serving freq", 1380, 1025, 96),
                              ("bs serving freq", 1380, 62, 128),
                              ("bs serving time", 124, 690, 128)):
        gen = torch.Generator(device=dev).manual_seed(0)
        x = (0.5 * torch.randn(rows, seq, c, generator=gen, device=dev)).to(torch.bfloat16)
        gamma = 1 + 0.1 * torch.randn(c, generator=gen, device=dev)
        b = (4 * c) ** -0.5
        w = [(torch.rand(*s, generator=gen, device=dev) * 2 - 1) * b
             for s in ((768, c, 4), (768,), (384, c, 4), (c,))]
        mod.ffn_step_forward(x, gamma, *w, 4, 4, 1e-5)   # build the stages, warm up
        buf = (ctypes.c_ulonglong * 10)()
        torch.cuda.synchronize()
        counts(buf)
        mod.ffn_step_forward(x, gamma, *w, 4, 4, 1e-5)
        torch.cuda.synchronize()
        counts(buf)
        print(f"{tag} [{rows}, {seq}, {c}]: " + "; ".join(
            f"{name} {100 * buf[i] / buf[9]:.1f}%" for i, name in enumerate(PHASES)))


if __name__ == "__main__":
    main()
