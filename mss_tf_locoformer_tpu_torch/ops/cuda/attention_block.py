"""Fused attention-step kernel wrapper (``csrc/attention_block.cu``) and its
plain PyTorch version.

Replaces the JAX package's Pallas
``ops/pallas/attention_block.py::fused_attention_block`` (forward, dropout 0):

    x + OutProj(softmax(RoPE(q) RoPE(k)^T / sqrt(D)) v),  q, k, v = QKV(RMSGroupNorm(x))

on rows ``x [R, L, C]``, attention over L.

Dispatch: a CPU tensor takes :func:`reference_attention_block`; a CUDA
tensor launches the kernel (two launches: norm+QKV+RoPE, then flash
attention+out-projection+residual) or raises.  The kernel takes bf16 rows
only (fp32 rows on the card are a later item, ROADMAP.md).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ...nn.norms import rms_group_norm
from ..attention import dot_product_attention
from ..rope import apply_rope, rope_angles
from . import check, load, ptr, stream_handle

__all__ = ["fused_attention_block", "reference_attention_block"]

_DP = 32   # head dim padded for the MMA depth
_TQ = 64   # positions per kernel tile


def reference_attention_block(x, gamma, w_qkv, w_out, n_heads: int,
                              num_groups: int, eps: float, rope: bool = True,
                              theta: float = 10000.0):
    """Plain version: norm, QKV, RoPE, explicit fp32 ``softmax(QK^T/sqrt(D))V``,
    out-projection, residual.  Holds ``[R, H, L, L]`` fp32 scores."""
    dt = x.dtype
    r, seq, _ = x.shape
    a = w_qkv.shape[0] // 3
    d = a // n_heads
    xn = rms_group_norm(x, gamma, num_groups, eps).to(dt)
    qkv = (xn @ w_qkv.to(dt).T).reshape(r, seq, 3, n_heads, d)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)                       # [R, H, L, D]
    if rope:
        q, k = apply_rope(q, theta), apply_rope(k, theta)
    o = dot_product_attention(q, k, v).transpose(1, 2).reshape(r, seq, a)
    return x + o @ w_out.to(dt).T


@functools.lru_cache(maxsize=16)
def _rope_tables(seq: int, d: int, theta: float, rope: bool, device):
    """Device cos/sin ``[L, D/2]`` fp32 (identity rotation without RoPE),
    kept so that a call copies nothing from the host."""
    if rope:
        return rope_angles(seq, d, theta, device)
    cos = torch.ones(seq, d // 2, dtype=torch.float32, device=device)
    return cos, torch.zeros_like(cos)


def _lib():
    fn = load("attention_block").attention_step_forward
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    return fn


def fused_attention_block(x, gamma, w_qkv, w_out, n_heads: int,
                          num_groups: int, eps: float, rope: bool = True,
                          theta: float = 10000.0):
    """``x [R, L, C]`` -> ``x + MHSA(RMSGroupNorm(x))``; ``w_qkv [3A, C]`` and
    ``w_out [C, A]`` in torch ``Linear`` layouts."""
    if x.device.type == "cpu":
        return reference_attention_block(x, gamma, w_qkv, w_out, n_heads,
                                         num_groups, eps, rope, theta)
    if x.device.type != "cuda":
        raise ValueError(f"fused_attention_block: unsupported device {x.device}")
    r, seq, c = x.shape
    a = w_qkv.shape[0] // 3
    d = a // n_heads
    if x.dtype != torch.bfloat16:
        raise TypeError(f"fused_attention_block: the CUDA kernel takes bf16 "
                        f"rows, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("fused_attention_block: x must be contiguous")
    if (c % 16 or a % 16 or d % 2 or d > _DP or a != n_heads * d
            or c % num_groups or w_qkv.shape != (3 * a, c)
            or w_out.shape != (c, a)):
        raise ValueError(f"fused_attention_block: unsupported shape C={c} "
                         f"A={a} H={n_heads}")
    for t in (gamma, w_qkv, w_out):
        if t.device != x.device:
            raise ValueError("fused_attention_block: tensors on different devices")
    dev = x.device
    lpad = -(-seq // _TQ) * _TQ
    wqkv = w_qkv.to(torch.bfloat16).contiguous()
    # out-projection as [H*32, C]: row h*32 + j is head h, dim j (zero for j >= D)
    wo = torch.zeros(n_heads, _DP, c, dtype=torch.bfloat16, device=dev)
    wo[:, :d] = w_out.to(torch.bfloat16).T.reshape(n_heads, d, c)
    g32 = gamma.to(torch.float32).contiguous()
    cos, sin = _rope_tables(seq, d, float(theta), bool(rope), dev)
    q, k, v = (torch.empty(r, n_heads, lpad, _DP, dtype=torch.bfloat16, device=dev)
               for _ in range(3))
    out = torch.empty_like(x)
    check(_lib()(ptr(x), ptr(g32), ptr(wqkv), ptr(wo), ptr(cos), ptr(sin),
                 ptr(q), ptr(k), ptr(v), ptr(out), r, seq, lpad, c, n_heads, d,
                 num_groups, float(eps), int(rope), stream_handle(dev)),
          "attention_step")
    fused_attention_block.launches += 1
    return out


fused_attention_block.launches = 0
