"""Fused FFN-step kernels (``csrc/swiglu_block.cu``), their autograd Function
and their plain PyTorch version.

Replaces the JAX package's Pallas
``ops/pallas/swiglu_block.py::fused_norm_ffn_residual`` (forward
``_blk_forward`` and backward ``_blk_backward``):

    x + drop_outer(Deconv1d(drop_inner(SwiGLU(Conv1d(RMSGroupNorm(x))))))

on rows ``x [R, L, C]``; stride 1, lead pad and crop of ``k - 1``.  Dropout
masks come from ``ops/dropout.py`` (the kernels' Philox in plain torch):
the inner site at (row, conv position, inner channel), the outer one at
(row, position, channel); ``row0`` is the absolute row of ``x[0]``.

Dispatch: a CPU tensor takes :func:`reference_norm_ffn_residual` (autograd
through plain ops); a CUDA tensor runs the kernels through
:class:`FusedFFNStep` (forward kernel, and the backward kernels when a
gradient is asked for) or raises.  The kernels take bf16 rows only (fp32
rows on the card are a later item, ROADMAP.md).

:func:`supports_step` is the block's gate: whether the kernels serve a step
of width C, inner I and k taps, decided from the shared-memory layouts
(``Lay<C>`` and, in training, ``BLay<C>`` of the .cu file) before any
launch, with the same answer on the CPU and on the card.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ...nn.norms import rms_group_norm
from .. import dropout as D
from . import SMEM_OPTIN, check, load, ptr, stream_handle, wgrad_splits

__all__ = ["fused_norm_ffn_residual", "reference_norm_ffn_residual",
           "ffn_panels", "inner_mask", "FusedFFNStep", "IC", "step_bytes",
           "compiled_step_bytes", "supports_step"]

IC = 32                       # inner channels per kernel chunk
_M = 64                       # conv outputs per kernel tile
_CHANNELS = (32, 64, 96, 128)  # template instantiations in the .cu file


def step_bytes(c: int, k: int, training: bool = False) -> int:
    """Dynamic shared memory of the FFN-step kernels at width ``c`` and ``k``
    taps: the forward's ``Lay<C>::bytes(k)`` and, in training, the larger of
    it and the backward's ``BLay<C>::bytes(k)`` (csrc/swiglu_block.cu)."""
    rows = _M + 16
    wc = max(k * c * (2 * IC + 8) * 2, _M * (c + 4) * 4)   # panel or staging
    tail = wc + k * IC * (c + 8) * 2 + 2 * IC * 4
    fwd = (rows * (c + 16) * 2 + rows * (IC + 16) * 2 + _M * (2 * IC + 4) * 4
           + tail)
    if not training:
        return fwd
    bwd = (2 * rows * (c + 16) * 2 + _M * (2 * IC + 4) * 4 + _M * (IC + 4) * 4
           + rows * (2 * IC + 16) * 2 + tail)
    return max(fwd, bwd)


def compiled_step_bytes(c: int, k: int, training: bool = False) -> int:
    """:func:`step_bytes` as the compiled kernels count it (needs the built
    library; 0 for a width with no instantiation)."""
    fn = load("swiglu_block").ffn_step_smem_bytes
    fn.restype = ctypes.c_longlong
    fn.argtypes = [ctypes.c_int] * 3
    return fn(c, k, int(training))


def supports_step(c: int, inner: int, k: int, training: bool) -> bool:
    """Whether the FFN-step kernels serve a step: an instantiated width, whole
    inner chunks, 2 <= k <= 8, and layouts within :data:`SMEM_OPTIN`."""
    return (c in _CHANNELS and inner % IC == 0 and 2 <= k <= 8
            and step_bytes(c, k, training) <= SMEM_OPTIN)


def reference_norm_ffn_residual(x, gamma, conv_w, conv_b, deconv_w, deconv_b,
                                kernel: int, num_groups: int, eps: float,
                                drop_rate: float = 0.0, seed: int = 0,
                                row0: int = 0):
    """Plain version (the JAX ``reference_norm_ffn_residual`` in torch, with
    the kernels' dropout masks): normed rows rounded to ``x.dtype``, convs in
    ``x.dtype``."""
    dt = x.dtype
    diff = kernel - 1
    inner = deconv_w.shape[0]
    xn = rms_group_norm(x, gamma, num_groups, eps).to(dt)
    xp = F.pad(xn.transpose(1, 2), (diff, diff))              # [R, C, L+2(k-1)]
    y = F.conv1d(xp, conv_w.to(dt), conv_b.to(dt))            # [R, 2I, L+k-1]
    h = y[:, :inner] * F.silu(y[:, inner:])
    if drop_rate > 0.0:
        h = D.apply_mask(h, inner_mask(seed, h, row0, drop_rate), drop_rate)
    z = F.conv_transpose1d(h, deconv_w.to(dt), deconv_b.to(dt))  # [R, C, L+2(k-1)]
    z = z[:, :, diff:diff + x.shape[1]].transpose(1, 2)
    if drop_rate > 0.0:
        z = D.apply_mask(z, D.row_mask(seed, D.SITE_FFN_OUTER, x, row0, drop_rate), drop_rate)
    return x + z


def inner_mask(seed: int, h: torch.Tensor, row0: int, p: float) -> torch.Tensor:
    """Keep mask of the inner site for the SwiGLU output ``h [R, I, L+k-1]``
    (channels first, as torch's convolutions give it), at (absolute row,
    conv position, inner channel)."""
    r, inner, lc = h.shape
    dev = h.device
    return D.keep_mask(seed, D.SITE_FFN_INNER,
                       torch.arange(row0, row0 + r, device=dev)[:, None, None],
                       torch.arange(lc, device=dev)[None, None],
                       torch.arange(inner, device=dev)[None, :, None], p=p)


def ffn_panels(conv_w, conv_b, deconv_w, dtype=torch.bfloat16, ic: int = IC):
    """Kernel weight layouts, chunked by ``ic`` inner channels (the inner
    dimension zero-padded to a multiple of ``ic``: a zero channel gives
    ``h = 0`` and adds nothing):

    * conv ``[I/ic, k*C, 2*ic]``: rows tap-major ``t*C + c``, columns the
      chunk's ic value channels then its ic gate channels;
    * conv bias ``[I/ic, 2*ic]`` fp32, same column order;
    * deconv ``[I/ic, k, ic, C]``.
    """
    two_i, c, k = conv_w.shape
    inner = two_i // 2
    nch = -(-inner // ic)
    pad = nch * ic - inner
    w = F.pad(conv_w.to(torch.float32).reshape(2, inner, c, k), (0, 0, 0, 0, 0, pad))
    b = F.pad(conv_b.to(torch.float32).reshape(2, inner), (0, pad))
    d = F.pad(deconv_w.to(torch.float32), (0, 0, 0, 0, 0, pad))
    w = w.reshape(2, nch, ic, c, k)                          # [vg, ch, i, c, t]
    wc = w.permute(1, 4, 3, 0, 2).reshape(nch, k * c, 2 * ic)
    bc = b.reshape(2, nch, ic).permute(1, 0, 2)
    wd = d.reshape(nch, ic, c, k).permute(0, 3, 1, 2)
    return (wc.to(dtype).contiguous(), bc.reshape(nch, 2 * ic).contiguous(),
            wd.to(dtype).contiguous())


def _fwd_fn():
    fn = load("swiglu_block").ffn_step_forward
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                   + [ctypes.c_float] + [ctypes.c_uint32] * 3
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    return fn


def _bwd_fn():
    fn = load("swiglu_block").ffn_step_backward
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 19 + [ctypes.c_int] * 6
                   + [ctypes.c_float] + [ctypes.c_int] * 2
                   + [ctypes.c_uint32] * 3
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    return fn


def _check(x, gamma, conv_w, conv_b, deconv_w, deconv_b, kernel, num_groups):
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


def ffn_step_forward(x, gamma, conv_w, conv_b, deconv_w, deconv_b, kernel,
                     num_groups, eps, drop_rate=0.0, seed=0, row0=0):
    """One launch of the forward kernel (no autograd)."""
    r, seq, c = x.shape
    inner = deconv_w.shape[0]
    wc, bc, wd = ffn_panels(conv_w, conv_b, deconv_w)
    g32 = gamma.to(torch.float32).contiguous()
    bd32 = deconv_b.to(torch.float32).contiguous()
    out = torch.empty_like(x)
    check(_fwd_fn()(ptr(x), ptr(g32), ptr(wc), ptr(bc), ptr(wd), ptr(bd32),
                    ptr(out), r, seq, c, inner, kernel, num_groups, float(eps),
                    *D.kernel_args(drop_rate, seed, row0), stream_handle(x.device)),
          "ffn_step")
    fused_norm_ffn_residual.launches += 1
    return out


def ffn_step_backward(g, x, gamma, conv_w, conv_b, deconv_w, kernel,
                      num_groups, eps, drop_rate=0.0, seed=0, row0=0):
    """The backward kernels (one counted launch): returns ``(dx, dgamma,
    dconv_w, dconv_b, ddeconv_w, ddeconv_b)`` in torch layouts (fp32 for the
    weights, ``x.dtype`` for dx)."""
    r, seq, c = x.shape
    inner = deconv_w.shape[0]
    k = kernel
    dev = x.device
    g = g.to(x.dtype).contiguous()
    wc, bc, wd = ffn_panels(conv_w, conv_b, deconv_w)
    g32 = gamma.to(torch.float32).contiguous()
    lt = _M - (k - 1)
    tiles = -(-seq // lt)
    lc = seq + k - 1
    n = r * lc
    s1 = wgrad_splits(2 * inner, k, n)
    s2 = wgrad_splits(inner, k, n)
    mc, md = -(-2 * inner // 64) * 64, -(-inner // 64) * 64
    f32, bf = dict(dtype=torch.float32, device=dev), dict(dtype=torch.bfloat16, device=dev)
    dx = torch.empty_like(x)
    xn, dz = torch.empty(r, seq, c, **bf), torch.empty(r, seq, c, **bf)
    dy, hd = torch.empty(r, lc, 2 * inner, **bf), torch.empty(r, lc, inner, **bf)
    part = torch.empty(r * tiles, 2 * c, **f32)
    wpart_c, colsum_c = torch.empty(k, s1, mc, c, **f32), torch.empty(s1, mc, **f32)
    wpart_d = torch.empty(k, s2, md, c, **f32)
    out_c, out_cb = torch.empty(k, mc, c, **f32), torch.empty(mc, **f32)
    out_d, out_gb = torch.empty(k, md, c, **f32), torch.empty(2 * c, **f32)
    check(_bwd_fn()(ptr(x), ptr(g), ptr(g32), ptr(wc), ptr(bc), ptr(wd), ptr(dx),
                    ptr(xn), ptr(dz), ptr(dy), ptr(hd), ptr(part), ptr(wpart_c),
                    ptr(colsum_c), ptr(wpart_d), ptr(out_c), ptr(out_cb),
                    ptr(out_d), ptr(out_gb), r, seq, c, inner, k, num_groups,
                    float(eps), s1, s2, *D.kernel_args(drop_rate, seed, row0),
                    stream_handle(dev)), "ffn_step_backward")
    ffn_step_backward.launches += 1
    return (dx, out_gb[:c].clone(), out_c[:, :2 * inner].permute(1, 2, 0).contiguous(),
            out_cb[:2 * inner].clone(), out_d[:, :inner].permute(1, 2, 0).contiguous(),
            out_gb[c:].clone())


class FusedFFNStep(torch.autograd.Function):
    """The FFN step through its kernels: the forward kernel, and the backward
    kernels, which recompute from the saved inputs (nothing else is kept)."""

    @staticmethod
    def forward(ctx, x, gamma, conv_w, conv_b, deconv_w, deconv_b, kernel,
                num_groups, eps, drop_rate, seed, row0):
        ctx.args = (kernel, num_groups, eps, drop_rate, seed, row0)
        ctx.bias_dtype = deconv_b.dtype
        ctx.save_for_backward(x, gamma, conv_w, conv_b, deconv_w)
        return ffn_step_forward(x, gamma, conv_w, conv_b, deconv_w, deconv_b,
                                kernel, num_groups, eps, drop_rate, seed, row0)

    @staticmethod
    def backward(ctx, g):
        x, gamma, conv_w, conv_b, deconv_w = ctx.saved_tensors
        dx, dgamma, dcw, dcb, ddw, ddb = ffn_step_backward(
            g, x, gamma, conv_w, conv_b, deconv_w, *ctx.args)
        return (dx, dgamma.to(gamma.dtype), dcw.to(conv_w.dtype),
                dcb.to(conv_b.dtype), ddw.to(deconv_w.dtype), ddb.to(ctx.bias_dtype),
                None, None, None, None, None, None)


def fused_norm_ffn_residual(x, gamma, conv_w, conv_b, deconv_w, deconv_b,
                            kernel: int, num_groups: int, eps: float,
                            drop_rate: float = 0.0, seed: int = 0,
                            row0: int = 0):
    """``x [R, L, C]`` -> ``x + drop(FFN(drop(RMSGroupNorm(x))))`` ``[R, L, C]``;
    weights in torch layouts (``conv_w [2I, C, k]``, ``deconv_w [I, C, k]``);
    ``seed`` an int32 drawn per call, ``row0`` the absolute row of ``x[0]``."""
    if x.device.type == "cpu":
        return reference_norm_ffn_residual(x, gamma, conv_w, conv_b, deconv_w,
                                           deconv_b, kernel, num_groups, eps,
                                           drop_rate, seed, row0)
    if x.device.type != "cuda":
        raise ValueError(f"fused_norm_ffn_residual: unsupported device {x.device}")
    _check(x, gamma, conv_w, conv_b, deconv_w, deconv_b, kernel, num_groups)
    return FusedFFNStep.apply(x, gamma, conv_w, conv_b, deconv_w, deconv_b,
                              kernel, num_groups, eps, float(drop_rate),
                              int(seed), int(row0))


fused_norm_ffn_residual.launches = 0
ffn_step_backward.launches = 0
