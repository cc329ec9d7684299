"""Fused FFN-step kernel wrapper (``csrc/swiglu_block.cu``) and its plain
PyTorch version.

Replaces the JAX package's Pallas
``ops/pallas/swiglu_block.py::fused_norm_ffn_residual`` (forward, dropout 0):

    x + Deconv1d(SwiGLU(Conv1d(RMSGroupNorm(x))))

on rows ``x [R, L, C]``; stride 1, lead pad and crop of ``k - 1``.

Dispatch: a CPU tensor takes :func:`reference_norm_ffn_residual`; a CUDA
tensor launches the kernel or raises.  The kernel takes bf16 rows only
(fp32 rows on the card are a later item, ROADMAP.md).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ...nn.norms import rms_group_norm
from . import check, load, ptr, stream_handle

__all__ = ["fused_norm_ffn_residual", "reference_norm_ffn_residual",
           "ffn_panels", "IC"]

IC = 32                       # inner channels per kernel chunk
_CHANNELS = (32, 64, 96, 128)  # template instantiations in the .cu file


def reference_norm_ffn_residual(x, gamma, conv_w, conv_b, deconv_w, deconv_b,
                                kernel: int, num_groups: int, eps: float):
    """Plain version (the JAX ``reference_norm_ffn_residual`` in torch):
    normed rows rounded to ``x.dtype``, convs in ``x.dtype``."""
    dt = x.dtype
    diff = kernel - 1
    inner = deconv_w.shape[0]
    xn = rms_group_norm(x, gamma, num_groups, eps).to(dt)
    xp = F.pad(xn.transpose(1, 2), (diff, diff))              # [R, C, L+2(k-1)]
    y = F.conv1d(xp, conv_w.to(dt), conv_b.to(dt))            # [R, 2I, L+k-1]
    h = y[:, :inner] * F.silu(y[:, inner:])
    z = F.conv_transpose1d(h, deconv_w.to(dt), deconv_b.to(dt))  # [R, C, L+2(k-1)]
    return x + z[:, :, diff:diff + x.shape[1]].transpose(1, 2)


def ffn_panels(conv_w, conv_b, deconv_w, dtype=torch.bfloat16):
    """Kernel weight layouts, chunked by ``IC`` inner channels:

    * conv ``[I/IC, k*C, 2*IC]``: rows tap-major ``t*C + c``, columns the
      chunk's IC value channels then its IC gate channels;
    * conv bias ``[I/IC, 2*IC]`` fp32, same column order;
    * deconv ``[I/IC, k, IC, C]``.
    """
    two_i, c, k = conv_w.shape
    inner = two_i // 2
    nch = inner // IC
    w = conv_w.to(torch.float32).reshape(2, nch, IC, c, k)   # [vg, ch, i, c, t]
    wc = w.permute(1, 4, 3, 0, 2).reshape(nch, k * c, 2 * IC)
    bc = conv_b.to(torch.float32).reshape(2, nch, IC).permute(1, 0, 2)
    wd = deconv_w.to(torch.float32).reshape(nch, IC, c, k).permute(0, 3, 1, 2)
    return (wc.to(dtype).contiguous(), bc.reshape(nch, 2 * IC).contiguous(),
            wd.to(dtype).contiguous())


def _lib():
    fn = load("swiglu_block").ffn_step_forward
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_void_p])
    return fn


def fused_norm_ffn_residual(x, gamma, conv_w, conv_b, deconv_w, deconv_b,
                            kernel: int, num_groups: int, eps: float):
    """``x [R, L, C]`` -> ``x + FFN(RMSGroupNorm(x))`` ``[R, L, C]``; weights in
    torch layouts (``conv_w [2I, C, k]``, ``deconv_w [I, C, k]``)."""
    if x.device.type == "cpu":
        return reference_norm_ffn_residual(x, gamma, conv_w, conv_b, deconv_w,
                                           deconv_b, kernel, num_groups, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_norm_ffn_residual: unsupported device {x.device}")
    r, seq, c = x.shape
    inner = deconv_w.shape[0]
    if x.dtype != torch.bfloat16:
        raise TypeError(f"fused_norm_ffn_residual: the CUDA kernel takes bf16 "
                        f"rows, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("fused_norm_ffn_residual: x must be contiguous")
    if c not in _CHANNELS or inner % IC or not 2 <= kernel <= 8 or c % num_groups:
        raise ValueError(f"fused_norm_ffn_residual: unsupported shape C={c} "
                         f"I={inner} k={kernel} groups={num_groups}")
    if conv_w.shape != (2 * inner, c, kernel) or deconv_w.shape != (inner, c, kernel):
        raise ValueError("fused_norm_ffn_residual: weight shapes do not match")
    for t in (gamma, conv_w, conv_b, deconv_w, deconv_b):
        if t.device != x.device:
            raise ValueError("fused_norm_ffn_residual: tensors on different devices")
    wc, bc, wd = ffn_panels(conv_w, conv_b, deconv_w)
    g32 = gamma.to(torch.float32).contiguous()
    bd32 = deconv_b.to(torch.float32).contiguous()
    out = torch.empty_like(x)
    check(_lib()(ptr(x), ptr(g32), ptr(wc), ptr(bc), ptr(wd), ptr(bd32),
                 ptr(out), r, seq, c, inner, kernel, num_groups, float(eps),
                 stream_handle(x.device)), "ffn_step")
    fused_norm_ffn_residual.launches += 1
    return out


fused_norm_ffn_residual.launches = 0
