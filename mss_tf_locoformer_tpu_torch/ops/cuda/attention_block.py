"""Fused attention-step kernels (``csrc/attention_block.cu``), their
autograd Function and their plain PyTorch version.

Replaces the JAX package's Pallas
``ops/pallas/attention_block.py::fused_attention_block`` (forward
``_attn_forward`` and backward ``_attn_backward_pallas``):

    x + drop_proj(OutProj(drop_prob(softmax(RoPE(q) RoPE(k)^T / sqrt(D))) v)),
    q, k, v = QKV(RMSGroupNorm(x))

on rows ``x [R, L, C]``, attention over L.  The probability site drops after
normalising (the softmax denominator is the undropped sum, as in torch and
the JAX kernel); masks come from ``ops/dropout.py`` at (row, head, key,
query) and (row, position, channel); ``row0`` is the absolute row of
``x[0]``.

``residual=False`` is the partial-sum mode of the tensor-parallel step
(``parallel/tp_fused.py``, over a shard of the heads): ``OutProj(MHSA(
RMSGroupNorm(x)))`` alone, a partial sum over heads, with no out-projection
mask and no residual (the caller applies both to the sum over shards); the
probability mask stays, it is per head.  The JAX package's
``residual=False`` (``ops/pallas/attention_block.py:304, :484-487``).

Dispatch: a CPU tensor takes :func:`reference_attention_block` (autograd
through plain ops); a CUDA tensor runs the kernels through
:class:`FusedAttentionStep` or raises.  The forward keeps what the backward
needs only when a gradient is asked for: q' = R(q) scale log2 e, k after
RoPE, v, the head outputs o and the per-query log-sum-exp in log2 units.
bf16 rows take the kernels of this module; fp32 rows take the fp32
kernels of ``ops/cuda/step_fp32.py`` (``csrc/step_fp32.cu``, the core in
``csrc/attn_fp32.cu``: the same contract, the stash in fp32), and no fp32
tensor is cast to bf16.

:func:`supports_block` is the block's gate: whether the kernels serve a step
of width C, attention width A and H heads in the rows' dtype (fp32:
``step_fp32.supports_attention``), decided from the shared-memory layouts
of the .cu file (the QKV launch, the streaming core, the
out-projection and, in training, the four backward launches) before any
launch, the same on the CPU and on the card.  Per call, the sequence length
decides between the resident and the streaming core
(:func:`core_resident`).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ...nn.norms import rms_group_norm
from .. import dropout as D
from ..attention import dot_product_attention
from ..rope import apply_rope, rope_angles
from . import SMEM_OPTIN, check, load, ptr, step_fp32, stream_handle, wgrad_splits

__all__ = ["fused_attention_block", "reference_attention_block",
           "FusedAttentionStep", "probability_mask", "launch_bytes",
           "compiled_launch_bytes", "core_resident_bytes", "core_resident",
           "compiled_core_resident_bytes", "supports_block"]

_DP = 32   # head dim padded for the MMA depth
_TQ = 64   # positions per QKV / out-projection tile (Lpad a multiple)
_MAX_CHUNKS = 8   # the resident core's staged chunks of 256 keys
# Kernels one backward call launches more than once (each other once): the
# two weight-gradient products and their reductions, dgamma's in two
# levels.  chip_smoke.py splits a call's trace by them.
BACKWARD_LAUNCHES = {"wgrad_kernel": 2, "reduce_kernel": 4}
_CHANNELS = (32, 64, 96, 128)


def launch_bytes(c: int, a: int, h: int, training: bool = False) -> dict:
    """Dynamic shared memory of each attention-step launch at width ``c``,
    attention width ``a`` and ``h`` heads (csrc/attention_block.cu): the QKV
    launch (``qkv_bytes``: 64 rows of x and one part's ``a`` rows of Wqkv,
    each ``c / 8 + 1`` chunks of 16 bytes), the streaming core (k and v
    tiles, two stages) and the out-projection (64 rows of o and 128 rows of
    Wo, 128 head dims at a time: rows of 17 and ``c / 8 + 1`` chunks); in
    training also the backward's pre, dq, dk/dv and final launches.  The QKV
    launch stages ``a`` rounded up to 16 rows.  The
    resident core's bytes depend on L (:func:`core_resident_bytes`) and it
    runs only where they fit, so the gate leaves it out."""
    tile = 64 * _DP * 2   # one 64-row tile of [*, 32] bf16
    out = {"qkv": (_TQ + -(-a // 16) * 16) * (c // 8 + 1) * 16,
           "core": 2 * 2 * tile, "out": _TQ * 17 * 16 + 128 * (c // 8 + 1) * 16}
    if training:
        out.update(
            bwd_pre=_TQ * (c + 16) * 2 + _TQ * (h * _DP + 4) * 4, bwd_dq=2 * 2 * tile,
            bwd_dkdv=2 * (2 * tile + 2 * 64 * 4 + 2 * 64 * 8),
            bwd_final=max(_TQ * (c + 4) * 4, _TQ * 17 * 16 + 128 * (c // 8 + 1) * 16))
    return out


def core_resident_bytes(seq: int) -> int:
    """Shared memory of the resident core (``attn_core_res_kernel``) at
    sequence length ``seq``: k and v as swizzled ``[pad16(L), 32]`` bf16
    rows and one mbarrier per staged chunk of 256 keys (8); 0 where that is
    above :data:`SMEM_OPTIN` (L > 1808) and the streaming core
    (``attn_core_stream_kernel``) takes the call."""
    lp = -(-seq // 16) * 16
    n = 2 * lp * _DP * 2 + _MAX_CHUNKS * 8
    return n if n <= SMEM_OPTIN and -(-lp // 256) <= _MAX_CHUNKS else 0


def core_resident(seq: int) -> bool:
    """Whether a call at sequence length ``seq`` takes the resident core."""
    return core_resident_bytes(seq) > 0


def compiled_launch_bytes(c: int, a: int, h: int, training: bool = False) -> dict:
    """:func:`launch_bytes` as the compiled kernels count it (needs the built
    library)."""
    fn = load("attention_block").attention_step_smem_bytes
    fn.restype = ctypes.c_longlong
    fn.argtypes = [ctypes.c_int] * 4
    names = ("qkv", "core", "out", "bwd_pre", "bwd_dq", "bwd_dkdv", "bwd_final")
    return {n: fn(c, a, h, i) for i, n in enumerate(names[:7 if training else 3])}


def compiled_core_resident_bytes(seq: int) -> int:
    """:func:`core_resident_bytes` as the compiled kernels count it."""
    fn = load("attention_block").attention_core_resident_bytes
    fn.restype = ctypes.c_longlong
    fn.argtypes = [ctypes.c_int]
    return fn(seq)


def supports_block(c: int, a: int, h: int, training: bool,
                   dtype: torch.dtype = torch.bfloat16) -> bool:
    """Whether the attention-step kernels serve a step of rows of
    ``dtype``: for bf16 an instantiated width, even head_dim <= 32, an
    attention width of whole 16-byte chunks (a multiple of 8: 24 is a shard
    of one head of 24), and layouts within :data:`SMEM_OPTIN`; for fp32
    ``step_fp32.supports_attention``."""
    if dtype == torch.float32:
        return step_fp32.supports_attention(c, a, h, training)
    d = a // h if a % h == 0 else 0
    return (c in _CHANNELS and a % 8 == 0 and d % 2 == 0 and 0 < d <= _DP
            and max(launch_bytes(c, a, h, training).values()) <= SMEM_OPTIN)


def probability_mask(seed: int, rows, n_heads: int, seq: int, p: float,
                     device=None):
    """Keep mask ``[R, H, L(query), L(key)]`` of the probability site for
    the absolute ``rows`` (an int64 tensor)."""
    ar = torch.arange(seq, device=device)
    return D.keep_mask(seed, D.SITE_ATTN_PROB, rows.reshape(-1, 1, 1, 1),
                       torch.arange(n_heads, device=device)[None, :, None, None],
                       ar[None, None, None, :], ar[None, None, :, None], p=p)


def reference_attention_block(x, gamma, w_qkv, w_out, n_heads: int,
                              num_groups: int, eps: float, rope: bool = True,
                              theta: float = 10000.0, drop_rate: float = 0.0,
                              seed: int = 0, row0: int = 0, residual: bool = True):
    """Plain version: norm, QKV, RoPE, explicit fp32 ``softmax(QK^T/sqrt(D))V``
    with the kernels' probability mask, out-projection with its mask,
    residual (with ``residual=False`` the out-projection alone).  Holds
    ``[R, H, L, L]`` fp32 scores."""
    dt = x.dtype
    r, seq, _ = x.shape
    a = w_qkv.shape[0] // 3
    d = a // n_heads
    xn = rms_group_norm(x, gamma, num_groups, eps).to(dt)
    qkv = (xn @ w_qkv.to(dt).T).reshape(r, seq, 3, n_heads, d)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)                       # [R, H, L, D]
    if rope:
        q, k = apply_rope(q, theta), apply_rope(k, theta)
    o = dot_product_attention(q, k, v, drop_rate, seed,
                              torch.arange(row0, row0 + r, device=x.device))
    o = o.transpose(1, 2).reshape(r, seq, a)
    z = o @ w_out.to(dt).T
    if not residual:
        return z
    if drop_rate > 0.0:
        z = D.apply_mask(z, D.row_mask(seed, D.SITE_ATTN_PROJ, x, row0, drop_rate), drop_rate)
    return x + z


@functools.lru_cache(maxsize=16)
def _rope_tables(seq: int, d: int, theta: float, rope: bool, device):
    """Device cos/sin ``[L, D/2]`` fp32 (identity rotation without RoPE),
    kept so that a call copies nothing from the host."""
    if rope:
        return rope_angles(seq, d, theta, device)
    cos = torch.ones(seq, d // 2, dtype=torch.float32, device=device)
    return cos, torch.zeros_like(cos)


def _fwd_fn():
    fn = load("attention_block").attention_step_forward
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_int] + [ctypes.c_uint32] * 3
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    return fn


def _bwd_fn():
    fn = load("attention_block").attention_step_backward
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 26 + [ctypes.c_int] * 7
                   + [ctypes.c_float] + [ctypes.c_int] * 2
                   + [ctypes.c_uint32] * 3
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    return fn


def _check(x, gamma, w_qkv, w_out, n_heads, num_groups):
    r, seq, c = x.shape
    a = w_qkv.shape[0] // 3
    d = a // n_heads
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"fused_attention_block: the CUDA kernels take bf16 or fp32 "
                        f"rows, got {x.dtype}")
    if x.dtype == torch.float32 and x.data_ptr() % 16:
        raise ValueError("fused_attention_block: fp32 x must be 16-byte aligned")
    if not x.is_contiguous():
        raise ValueError("fused_attention_block: x must be contiguous")
    if (c not in _CHANNELS or a % 8 or d % 2 or d > _DP or a != n_heads * d
            or c % num_groups or w_qkv.shape != (3 * a, c)
            or w_out.shape != (c, a)):
        raise ValueError(f"fused_attention_block: unsupported shape C={c} "
                         f"A={a} H={n_heads}")
    for t in (gamma, w_qkv, w_out):
        if t.device != x.device:
            raise ValueError("fused_attention_block: tensors on different devices")


def _panels(w_qkv, w_out, n_heads):
    """bf16 kernel weights: ``wqkv [3A, C]``; the out-projection as
    ``[H*32, C]`` (row h*32 + j is head h, dim j; zero for j >= D)."""
    c, a = w_out.shape
    d = a // n_heads
    wo = torch.zeros(n_heads, _DP, c, dtype=torch.bfloat16, device=w_out.device)
    wo[:, :d] = w_out.to(torch.bfloat16).T.reshape(n_heads, d, c)
    return w_qkv.to(torch.bfloat16).contiguous(), wo.reshape(n_heads * _DP, c)


def attention_step_forward(x, gamma, w_qkv, w_out, n_heads, num_groups, eps,
                           rope=True, theta=10000.0, drop_rate=0.0, seed=0,
                           row0=0, residual=True, stash=False):
    """The forward kernels (no autograd).  Returns ``out`` or, with
    ``stash``, ``(out, (q, k, v, o, lse))`` for the backward.  fp32 rows take
    ``step_fp32.attention_forward``."""
    if x.dtype == torch.float32:
        return step_fp32.attention_forward(x, gamma, w_qkv, w_out, n_heads, num_groups, eps,
                                           rope, theta, drop_rate, seed, row0, residual, stash)
    r, seq, c = x.shape
    a = w_qkv.shape[0] // 3
    d = a // n_heads
    dev = x.device
    lpad = -(-seq // _TQ) * _TQ
    wqkv, wo = _panels(w_qkv, w_out, n_heads)
    g32 = gamma.to(torch.float32).contiguous()
    cos, sin = _rope_tables(seq, d, float(theta), bool(rope), dev)
    q, k, v = (torch.empty(r, n_heads, lpad, _DP, dtype=torch.bfloat16, device=dev)
               for _ in range(3))
    # the head outputs meet in the out-projection launch (kept in training)
    o = torch.empty(r, lpad, n_heads * _DP, dtype=torch.bfloat16, device=dev)
    lse = (torch.empty(r, n_heads, lpad, dtype=torch.float32, device=dev) if stash
           else None)
    out = torch.empty_like(x)
    check(_fwd_fn()(ptr(x), ptr(g32), ptr(wqkv), ptr(wo), ptr(cos), ptr(sin),
                    ptr(q), ptr(k), ptr(v), ptr(out), ptr(o),
                    ptr(lse) if stash else ctypes.c_void_p(None),
                    r, seq, lpad, c, n_heads, d, num_groups, float(eps), int(rope),
                    *D.kernel_args(drop_rate, seed, row0), int(residual), stream_handle(dev)),
          "attention_step")
    fused_attention_block.launches += 1
    return (out, (q, k, v, o, lse)) if stash else out


def attention_step_backward(g, x, gamma, w_qkv, w_out, stash, n_heads,
                            num_groups, eps, rope=True, theta=10000.0,
                            drop_rate=0.0, seed=0, row0=0, residual=True):
    """The backward kernels (one counted launch) from the forward's stash:
    returns ``(dx, dgamma, dw_qkv, dw_out)`` in torch layouts (fp32 for the
    weights, ``x.dtype`` for dx).  fp32 rows take
    ``step_fp32.attention_backward``."""
    if x.dtype == torch.float32:
        return step_fp32.attention_backward(g, x, gamma, w_qkv, w_out, stash, n_heads,
                                            num_groups, eps, rope, theta, drop_rate, seed,
                                            row0, residual)
    r, seq, c = x.shape
    a = w_qkv.shape[0] // 3
    d = a // n_heads
    dev = x.device
    q, k, v, o, lse = stash
    lpad = q.shape[2]
    hd = n_heads * _DP
    g = g.to(x.dtype).contiguous()
    wqkv, wo = _panels(w_qkv, w_out, n_heads)
    g32 = gamma.to(torch.float32).contiguous()
    cos, sin = _rope_tables(seq, d, float(theta), bool(rope), dev)
    tiles = lpad // _TQ
    s1 = wgrad_splits(3 * a, 1, r * seq)
    s2 = wgrad_splits(hd, 1, r * seq)
    mq, mo = -(-3 * a // 64) * 64, -(-hd // 64) * 64
    f32, bf = dict(dtype=torch.float32, device=dev), dict(dtype=torch.bfloat16, device=dev)
    dx = torch.empty_like(x)
    dproj = torch.empty(r, lpad, c, **bf)
    dout = torch.empty(r, n_heads, lpad, _DP, **bf)
    dsum = torch.empty(r, n_heads, lpad, **f32)
    dqkv = torch.empty(r, lpad, 3 * a, **bf)
    # the probability mask as the dq pass draws it, for the dk/dv pass: a
    # 64-bit word per (row, head, 64-key tile, query)
    mbits = (torch.empty(r * n_heads * (lpad // 64) * lpad, dtype=torch.int64, device=dev)
             if drop_rate > 0.0 else None)
    xn = torch.empty(r, lpad, c, **bf)
    segs = -(-(r * tiles) // 64)   # the blocks' dgamma partials, summed 64 at a time
    part = torch.empty(segs * 64, c, **f32)
    part[r * tiles:].zero_()
    pmid = torch.empty(segs, c, **f32)
    wpart_q, wpart_o = torch.empty(s1, mq, c, **f32), torch.empty(s2, mo, c, **f32)
    out_qkv, out_o, out_g = (torch.empty(mq, c, **f32), torch.empty(mo, c, **f32),
                             torch.empty(c, **f32))
    check(_bwd_fn()(ptr(x), ptr(g), ptr(g32), ptr(wqkv), ptr(wo), ptr(cos),
                    ptr(sin), ptr(q), ptr(k), ptr(v), ptr(o), ptr(lse), ptr(dx),
                    ptr(dproj), ptr(dout), ptr(dsum), ptr(dqkv),
                    ctypes.c_void_p(None) if mbits is None else ptr(mbits), ptr(xn),
                    ptr(part), ptr(pmid), ptr(wpart_q), ptr(wpart_o), ptr(out_qkv),
                    ptr(out_o), ptr(out_g), r, seq, lpad, c, n_heads, d,
                    num_groups, float(eps), s1, s2,
                    *D.kernel_args(drop_rate, seed, row0), int(residual), stream_handle(dev)),
          "attention_step_backward")
    attention_step_backward.launches += 1
    dw_out = out_o[:hd].reshape(n_heads, _DP, c)[:, :d].reshape(a, c).T.contiguous()
    return dx, out_g, out_qkv[:3 * a].clone(), dw_out


class FusedAttentionStep(torch.autograd.Function):
    """The attention step through its kernels; the forward keeps q/k/v, o
    and the log-sum-exp for the backward kernels."""

    @staticmethod
    def forward(ctx, x, gamma, w_qkv, w_out, n_heads, num_groups, eps, rope,
                theta, drop_rate, seed, row0, residual):
        args = (n_heads, num_groups, eps, rope, theta, drop_rate, seed, row0, residual)
        if not any(ctx.needs_input_grad[:4]):
            return attention_step_forward(x, gamma, w_qkv, w_out, *args)
        out, stash = attention_step_forward(x, gamma, w_qkv, w_out, *args, stash=True)
        ctx.args = args
        ctx.save_for_backward(x, gamma, w_qkv, w_out, *stash)
        return out

    @staticmethod
    def backward(ctx, g):
        x, gamma, w_qkv, w_out, *stash = ctx.saved_tensors
        dx, dgamma, dw_qkv, dw_out = attention_step_backward(
            g, x, gamma, w_qkv, w_out, stash, *ctx.args)
        return (dx, dgamma.to(gamma.dtype), dw_qkv.to(w_qkv.dtype),
                dw_out.to(w_out.dtype)) + (None,) * 9


def fused_attention_block(x, gamma, w_qkv, w_out, n_heads: int,
                          num_groups: int, eps: float, rope: bool = True,
                          theta: float = 10000.0, drop_rate: float = 0.0,
                          seed: int = 0, row0: int = 0, residual: bool = True):
    """``x [R, L, C]`` -> ``x + drop(MHSA_drop(RMSGroupNorm(x)))``; ``w_qkv
    [3A, C]`` and ``w_out [C, A]`` in torch ``Linear`` layouts; ``seed`` an
    int32 drawn per call, ``row0`` the absolute row of ``x[0]``.
    ``residual=False``: the partial-sum mode (module docstring)."""
    if x.device.type == "cpu":
        return reference_attention_block(x, gamma, w_qkv, w_out, n_heads,
                                         num_groups, eps, rope, theta,
                                         drop_rate, seed, row0, residual)
    if x.device.type != "cuda":
        raise ValueError(f"fused_attention_block: unsupported device {x.device}")
    _check(x, gamma, w_qkv, w_out, n_heads, num_groups)
    return FusedAttentionStep.apply(x, gamma, w_qkv, w_out, n_heads, num_groups,
                                    eps, bool(rope), float(theta), float(drop_rate),
                                    int(seed), int(row0), bool(residual))


fused_attention_block.launches = 0
attention_step_backward.launches = 0
