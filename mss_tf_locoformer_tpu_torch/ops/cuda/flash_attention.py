"""Flash-attention kernels (``csrc/flash_attention.cu``), their autograd
Function and their plain PyTorch version.

Replaces the JAX package's Pallas
``ops/pallas/flash_attention.py::flash_attention`` (forward
``_flash_forward``, TPU kernel #6, and backward ``_flash_backward_pallas``,
#7): ``softmax(q k^T / sqrt(D)) v`` over ``[..., L, D]``,
with the interleaved-pair RoPE optionally applied to q and k inside (fp32
rotation); no mask, no dropout (a caller that drops attention
probabilities takes the plain path, as the JAX package's
``ops/attention.py`` routes it).

The kernel takes q, k and v as strided views: the unfused MHSA hands it the
``[B, H, L, D]`` views of its QKV product ``[B, L, 3, H, D]`` and gets back
a ``[B, H, L, D]`` view of a ``[B, L, H, D]`` buffer, so neither side of the
kernel needs a transpose.

Dispatch: a CPU tensor takes :func:`reference_flash_attention` (RoPE from
``ops/rope.py``, then the plain ``dot_product_attention``; autograd through
it is the backward's plain version); a CUDA tensor runs the kernels through
:class:`FlashAttention` or raises.  The kernels of this module take bf16
with an even head_dim up to 64; fp32 tensors take the fp32 kernels of
``ops/cuda/unfused_fp32.py`` (``csrc/attn_fp32.cu``, the same head dims,
their own launch counts), and nothing casts fp32 to bf16; any other dtype
raises.  When a gradient is asked for, the forward also stashes
each query's log-sum-exp (fp32 ``[B*H, L]``) and the backward kernels
recompute the probabilities from it, q and k rotated in the kernel and the
cotangents rotated back there (:func:`flash_attention_backward`).

Two gates, from the ``.cu`` layouts, pick each call's kernels (one counted
launch either way): :func:`forward_resident` (q, k and v of a (row, head)
held in shared memory for all its queries, else 64-key tiles streamed per
128 queries) and :func:`backward_resident` (one persistent pass per (row, head)
with q, k, v, dO and o resident, D <= 16 and L <= 528; else a delta pre-pass,
a dq launch and a dk/dv launch).
"""

from __future__ import annotations

import ctypes

import torch

from ..attention import dot_product_attention
from ..rope import apply_rope
from . import SMEM_OPTIN, check, load, ptr, stream_handle, unfused_fp32
from .attention_block import _rope_tables

__all__ = ["flash_attention", "flash_attention_backward", "FlashAttention",
           "reference_flash_attention", "supports_shape", "MAX_HEAD_DIM",
           "forward_resident_bytes", "backward_resident_bytes", "forward_resident",
           "backward_resident"]

MAX_HEAD_DIM = 64   # D padded to a multiple of 16 (the MMA depth) up to 64
# The resident backward (csrc/flash_attention.cu, BW_WARPS, BW_SLABS): up to
# 11 warps of at most 3 slabs of 16 keys, D <= 16.
_BW_WARPS, _BW_SLABS = 11, 3


def supports_shape(d: int, dtype: torch.dtype = torch.bfloat16) -> bool:
    """Whether the kernels (forward and backward) take head_dim ``d`` in
    ``dtype``: bf16 this module's, fp32 ``unfused_fp32.supports_flash``."""
    if dtype == torch.float32:
        return unfused_fp32.supports_flash(d)
    return dtype == torch.bfloat16 and d % 2 == 0 and 0 < d <= MAX_HEAD_DIM


def _rows_bytes(lp: int, d: int) -> int:
    """``Rows<DP>::bytes``: ``lp`` rows of DP / 8 chunks of 16 bytes, a row
    stride of one chunk more where the count is not a power of two."""
    nch = -(-d // 16) * 2
    return lp * (nch if nch & (nch - 1) == 0 else nch + 1) * 16


def forward_resident_bytes(seq: int, d: int) -> int:
    """Shared memory of the resident forward's layout (q', k', v ``[L,
    DP]``), 0 where it exceeds a block's 227 KB and the streaming kernel
    runs."""
    lp = -(-seq // 16) * 16
    n = 3 * _rows_bytes(lp, d)
    return n if n <= SMEM_OPTIN else 0


def backward_resident_bytes(seq: int, d: int) -> int:
    """Shared memory of the resident backward's layout (two buffers of q',
    k, v, dO, o ``[L, 16]`` and -lse, -delta ``[L]``; two slots of 11
    warps' dQ partials, ``[16, 24]`` fp32 each), 0 outside its gate (D >
    16, more than 3 slabs of 16 keys per warp, or more than 227 KB): then
    the streaming kernels run."""
    lp = -(-seq // 16) * 16
    per_warp = -(-(lp // 16) // _BW_WARPS)
    n = 2 * (5 * _rows_bytes(lp, 16) + 2 * lp * 4) + 2 * _BW_WARPS * 16 * 24 * 4
    return n if d <= 16 and per_warp <= _BW_SLABS and n <= SMEM_OPTIN else 0


def forward_resident(seq: int, d: int) -> bool:
    """Whether the forward keeps a (row, head)'s q, k and v resident."""
    return forward_resident_bytes(seq, d) > 0


def backward_resident(seq: int, d: int) -> bool:
    """Whether the backward takes its one-pass resident kernel."""
    return backward_resident_bytes(seq, d) > 0


def compiled_resident_bytes(seq: int, d: int):
    """``(forward, backward)`` bytes as the compiled library computes them
    (the card's tests hold the Python gates against these)."""
    lib = load("flash_attention")
    out = []
    for name in ("flash_forward_resident_bytes", "flash_backward_resident_bytes"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_longlong
        fn.argtypes = [ctypes.c_int, ctypes.c_int]
        out.append(int(fn(seq, d)))
    return tuple(out)


def reference_flash_attention(q, k, v, rope: bool = False,
                              theta: float = 10000.0) -> torch.Tensor:
    """Plain version: q and k rotated (fp32, rounded to their dtype), then
    fp32-softmax attention; ``[..., L, D]`` -> ``[..., L, D]``."""
    if rope:
        q, k = apply_rope(q, theta), apply_rope(k, theta)
    return dot_product_attention(q, k, v)


def _fn():
    fn = load("flash_attention").flash_attention_forward
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_float]
                   + [ctypes.c_longlong] * 12 + [ctypes.c_void_p])
    return fn


def _bwd_fn():
    fn = load("flash_attention").flash_attention_backward
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 5 + [ctypes.c_float]
                   + [ctypes.c_void_p] * 2)
    return fn


def _as4(t: torch.Tensor) -> torch.Tensor:
    """``[..., L, D]`` as ``[B, H, L, D]`` (a view where the strides allow)."""
    if t.dim() == 3:
        return t.unsqueeze(1)
    if t.dim() == 4:
        return t
    return t.reshape(-1, *t.shape[-3:])


def _check(q, k, v):
    if q.shape != k.shape or q.shape != v.shape or q.dim() < 3:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} must share one [..., L, D] shape")
    if q.dtype not in (torch.bfloat16, torch.float32) or {k.dtype, v.dtype} != {q.dtype}:
        raise TypeError(f"flash_attention: the CUDA kernels take bf16 or fp32, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: tensors on different devices")
    d = q.shape[-1]
    if not supports_shape(d, q.dtype) or q.shape[-2] < 1:
        raise ValueError(f"flash_attention: head_dim {d} must be even and <= "
                         f"{MAX_HEAD_DIM}, L {q.shape[-2]} >= 1")


def _strides(t: torch.Tensor):
    """Element strides (batch, head, position) of a ``[B, H, L, D]`` view
    whose pairs (d, d+1) the kernel reads as one 4-byte word."""
    sb, sh, sl, sd = t.stride()
    if sd != 1 or sb % 2 or sh % 2 or sl % 2 or t.data_ptr() % 4:
        raise ValueError(f"flash_attention: the kernel reads (d, d+1) pairs as "
                         f"4-byte words: strides {t.stride()} must be even with "
                         f"unit stride in D")
    return sb, sh, sl


def _forward(q4, k4, v4, rope: bool, theta: float, stash: bool):
    """One launch of the forward kernel: ``(out [B, L, H, D], lse or None)``;
    fp32 tensors take ``unfused_fp32.flash_forward_fp32``."""
    if q4.dtype == torch.float32:
        return unfused_fp32.flash_forward_fp32(q4, k4, v4, rope, theta, stash)
    b, h, seq, d = q4.shape
    out = torch.empty(b, seq, h, d, dtype=q4.dtype, device=q4.device)
    o4 = out.permute(0, 2, 1, 3)                    # [B, H, L, D] view
    lse = (torch.empty(b * h, seq, dtype=torch.float32, device=q4.device)
           if stash else None)
    cos, sin = _rope_tables(seq, d, float(theta), bool(rope), q4.device)
    strides = [s for t in (q4, k4, v4, o4) for s in _strides(t)]
    check(_fn()(ptr(q4), ptr(k4), ptr(v4), ptr(out), ptr(cos), ptr(sin),
                None if lse is None else ptr(lse), b, h, seq, d, int(rope),
                d ** -0.5, *strides, stream_handle(q4.device)), "flash_attention")
    flash_attention.launches += 1
    return out, lse


def flash_attention_backward(g, q4, k4, v4, out, lse, rope: bool, theta: float):
    """The backward kernels (one counted launch): ``g`` the cotangent of
    ``out [B, L, H, D]``, the rest as :func:`_forward` took and gave them;
    returns ``(dq, dk, dv)`` as ``[B, H, L, D]`` views of ``[B, L, H, D]``
    buffers.  fp32 tensors take ``unfused_fp32.flash_backward_fp32``."""
    if q4.dtype == torch.float32:
        return unfused_fp32.flash_backward_fp32(g, q4, k4, v4, out, lse, rope, theta)
    b, h, seq, d = q4.shape
    dev = q4.device
    g4 = g.to(q4.dtype).contiguous().permute(0, 2, 1, 3)
    o4 = out.permute(0, 2, 1, 3)
    grads = [torch.empty(b, seq, h, d, dtype=q4.dtype, device=dev).permute(0, 2, 1, 3)
             for _ in range(3)]
    delta = torch.empty(b * h, seq, dtype=torch.float32, device=dev)
    cos, sin = _rope_tables(seq, d, float(theta), bool(rope), dev)
    strides = (ctypes.c_longlong * 24)(
        *[s for t in (q4, k4, v4, o4, g4, *grads) for s in _strides(t)])
    check(_bwd_fn()(ptr(q4), ptr(k4), ptr(v4), ptr(o4), ptr(g4), ptr(lse), ptr(delta),
                    *(ptr(t) for t in grads), ptr(cos), ptr(sin), b, h, seq, d,
                    int(rope), d ** -0.5, ctypes.cast(strides, ctypes.c_void_p),
                    stream_handle(dev)), "flash_attention_backward")
    flash_attention_backward.launches += 1
    return tuple(grads)


class FlashAttention(torch.autograd.Function):
    """Flash attention through its kernels on ``[B, H, L, D]`` views: the
    forward kernel (with the log-sum-exp stash when a gradient is asked for)
    and the backward kernels, which recompute the probabilities."""

    @staticmethod
    def forward(ctx, q4, k4, v4, rope, theta):
        stash = any(ctx.needs_input_grad[:3])
        out, lse = _forward(q4, k4, v4, rope, theta, stash)
        if stash:
            ctx.args = (rope, theta)
            ctx.save_for_backward(q4, k4, v4, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        dq, dk, dv = flash_attention_backward(g, *ctx.saved_tensors, *ctx.args)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    rope: bool = False, theta: float = 10000.0) -> torch.Tensor:
    """Attention over the second-to-last axis of ``[..., L, D]``; with
    ``rope`` the interleaved-pair rotary embedding (fp32, base ``theta``) is
    applied to q and k first.  The JAX ``flash_attention`` contract."""
    if q.device.type == "cpu":
        return reference_flash_attention(q, k, v, rope, theta)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    _check(q, k, v)
    out = FlashAttention.apply(_as4(q), _as4(k), _as4(v), bool(rope), float(theta))
    return out.permute(0, 2, 1, 3).reshape(q.shape)


flash_attention.launches = 0
flash_attention_backward.launches = 0
