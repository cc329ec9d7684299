#!/usr/bin/env python3
"""The fp32 FFN step's errors (#2 forward, #5 backward at fp32) against a
float64 run of its plain version, beside the fp32 plain version's own.

    python3 tools/ffn_step_errors.py

On the card, at the base training shapes (micro-batch 2 x 3 s, dropout
0.1) and wsj0-2mix training's freq shape: the kernels' output and every
gradient, and the plain version's in fp32, each against the plain version
in float64 (max error over max|f64| and relative L2).  It shows which side
of an fp32 comparison carries the error: the fp32 plain version's conv
weight gradient is cuDNN's fp32 sum over every position.
"""

import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

NAMES = ("dx", "dgamma", "dconv_w", "dconv_b", "ddeconv_w", "ddeconv_b")


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("ffn_step_errors.py needs a CUDA device")
    import chip_smoke as cs
    from mss_tf_locoformer_tpu_torch.ops.cuda import swiglu_block as FB
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    base = cs.base_model_config()
    shapes = [(f"base training {p}", r, s, 96, 0.1) for p, r, s in cs._train_steps(base)]
    sp = cs.speech_config("wsj0_2mix")
    shapes += [(f"wsj0-2mix training {p}", r, s, 128, 0.0) for p, r, s in
               cs._speech_steps(sp, cs.SPEECH_BATCH, cs.SPEECH_SEGMENT_S)[:1]]
    rel = lambda a, b: ((a.double() - b).norm() / b.norm()).item()
    mx = lambda a, b: ((a.double() - b).abs().max() / b.abs().max()).item()
    for tag, rows, seq, c, drop in shapes:
        gen = torch.Generator().manual_seed(cs.SEED + 30)
        x16, gamma, w, _ = cs._step_inputs(gen, rows, seq, "cuda", c, 384, 4)
        x, g = x16.float(), cs._rand(gen, (rows, seq, c)).to("cuda")
        args = (4, 4, 1e-5, drop, 777, 0, True)
        run = lambda fn, dt: cs._autograd(lambda x_, *p: fn(x_, *p, *args), x.to(dt),
                                          [t.to(dt) for t in (gamma, *w)], g.to(dt))
        kout, kg = run(FB.fused_norm_ffn_residual, torch.float32)
        pout, pg = run(FB.reference_norm_ffn_residual, torch.float32)
        dout, dg = run(FB.reference_norm_ffn_residual, torch.float64)
        print(f"[{tag}] out: kernel {mx(kout, dout):.3e}, plain fp32 {mx(pout, dout):.3e} "
              f"of max|f64|")
        for n, a, b, d in zip(NAMES, kg, pg, dg):
            print(f"[{tag}] {n}: relative L2 to f64: kernel {rel(a, d):.3e}, plain fp32 "
                  f"{rel(b, d):.3e}; kernel to plain fp32 {rel(a, b.double()):.3e}")
        del kout, kg, pout, pg, dout, dg, x, x16, g
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
