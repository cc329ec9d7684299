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

``residual=False`` is the partial-sum mode of the tensor-parallel step
(``parallel/tp_fused.py``, over a shard of the inner channels):
``Deconv1d(drop_inner(SwiGLU(Conv1d(RMSGroupNorm(x)))))`` alone, with no
outer mask and no residual, and no deconv bias (``deconv_b`` is None: the
caller adds the bias, the outer site and the residual to the sum over
shards, where autograd gives the bias its gradient).  The JAX package's
``residual=False`` (``ops/pallas/swiglu_block.py:224-230``) with a zero bias.

Dispatch: a CPU tensor takes :func:`reference_norm_ffn_residual` (autograd
through plain ops); a CUDA tensor runs the kernels through
:class:`FusedFFNStep` (forward kernel, and the backward kernels when a
gradient is asked for) or raises.  bf16 rows take the kernels of this
module; fp32 rows take the fp32 kernels of ``ops/cuda/step_fp32.py``
(``csrc/step_fp32.cu``), and no fp32 tensor is cast to bf16.  For bf16
rows, two routes, by width
(:func:`hopper_route`): at C 96 and 128 the Hopper kernels (wgmma, bulk
copies and mbarrier rings; 128 conv positions a block; the inner dimension
in 64-channel chunks, zero-padded to a multiple of 64), whose weight stages
the wrapper lays out in the swizzled order wgmma reads
(:func:`wg_step_panels`) and whose backward runs in row groups that bound
its bf16 scratch (:func:`wg_step_plan`) and takes its weight gradients on
the FFN core's GEMM; at C 32 and 64 the wmma kernels (64 conv outputs a
block, 32-channel chunks, :func:`ffn_panels`).

:func:`supports_step` is the block's gate: whether the kernels serve a step
of width C, inner I and k taps in the rows' dtype, decided from the
shared-memory layouts of the .cu file (forward and, in training, backward;
fp32: ``step_fp32.supports_ffn``) before any launch, with the same answer
on the CPU and on the card.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

from ...nn.norms import rms_group_norm
from .. import dropout as D
from . import (SMEM_OPTIN, cached_panels, check, load, ptr, step_fp32, stream_handle,
               weight_splits, wgrad_splits)

__all__ = ["fused_norm_ffn_residual", "reference_norm_ffn_residual",
           "ffn_panels", "inner_mask", "FusedFFNStep", "IC", "step_bytes",
           "compiled_step_bytes", "supports_step", "hopper_route", "wg_step_bytes",
           "wg_step_panels", "wg_step_plan", "flat_tiles", "SCRATCH_CAP"]

IC = 32                       # inner channels per chunk of the wmma kernels
_M = 64                       # conv outputs per wmma-kernel tile
_CHANNELS = (32, 64, 96, 128)  # the widths the .cu file takes
# The Hopper route (``stp`` in csrc/swiglu_block.cu): the base config's C 96
# and the C 128 configs; C 32 and 64 keep the wmma kernels.
WG_WIDTHS = (96, 128)
SICH = 64                     # inner channels per Hopper chunk (value and gate each)
WG_M = 128                    # conv positions per Hopper block
WG_ROWS = WG_M + 8            # staged rows: tile, halo, zeros
MAX_GROUPS = 16               # the Hopper prologue's inverse RMS: 136 rows x 16 groups
SCRATCH_CAP = 1 << 30         # bytes of the Hopper backward's bf16 scratch
_CG = 128                     # the GEMM's taps of 128 channels (C 96 padded)


def hopper_route(c: int) -> bool:
    """Whether width ``c`` takes the Hopper kernels (else the wmma ones)."""
    return c in WG_WIDTHS


def wg_step_bytes(c: int) -> dict:
    """Dynamic shared memory of the Hopper kernels at width ``c``: the
    forward's ``FLay`` (1 KB of alignment slack, the normed tile of two
    64-channel columns and the h tile as swizzled rows of 128 bytes, a ring
    of stages of 256 C bytes, its barriers), the dx kernel's ``DLay``
    (normed, dz and dyvg tiles of two columns each, the ring) and the FFN
    core's weight-gradient GEMM."""
    from .swiglu_ffn import _ring_stages, wg_bytes
    col = WG_ROWS * 128
    out = {}
    for name, fixed in (("fwd", 1024 + 3 * col), ("dx", 1024 + 6 * col)):
        n = _ring_stages(fixed, 256 * c)
        out[name] = fixed + n * 256 * c + (2 * n + 1) * 8
    out["gemm"] = wg_bytes(c)["gemm"]
    return out


def step_bytes(c: int, k: int, training: bool = False) -> int:
    """Dynamic shared memory of the FFN-step kernels at width ``c`` and ``k``
    taps: the forward's and, in training, the largest of it and the
    backward's -- the Hopper kernels' (:func:`wg_step_bytes`) at C 96 and
    128, else ``Lay<C>::bytes(k)`` and ``BLay<C>::bytes(k)``
    (csrc/swiglu_block.cu)."""
    if hopper_route(c):
        b = wg_step_bytes(c)
        return max(b.values()) if training else b["fwd"]
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


def groups_fit(c: int, num_groups: int) -> bool:
    """Whether the kernels take ``num_groups`` norm groups at width ``c``: on
    the Hopper route at most :data:`MAX_GROUPS` groups of a multiple of 8
    channels (whole 16-byte chunks of the prologue's rows)."""
    return (c % num_groups == 0 and (not hopper_route(c)
                                     or (num_groups <= MAX_GROUPS and c // num_groups % 8 == 0)))


def supports_step(c: int, inner: int, k: int, training: bool, num_groups: int = 1,
                  dtype: torch.dtype = torch.bfloat16) -> bool:
    """Whether the FFN-step kernels serve a step of rows of ``dtype``: for
    bf16 a width of the .cu file, 2 <= k <= 8, whole 32-channel chunks on
    the wmma route (the Hopper route pads the inner dimension), norm groups
    the kernels take (:func:`groups_fit`), and layouts within
    :data:`SMEM_OPTIN`; for fp32 ``step_fp32.supports_ffn``."""
    if dtype == torch.float32:
        return step_fp32.supports_ffn(c, inner, k, training, num_groups)
    return (c in _CHANNELS and inner > 0 and (hopper_route(c) or inner % IC == 0)
            and 2 <= k <= 8 and groups_fit(c, num_groups)
            and step_bytes(c, k, training) <= SMEM_OPTIN)


def reference_norm_ffn_residual(x, gamma, conv_w, conv_b, deconv_w, deconv_b,
                                kernel: int, num_groups: int, eps: float,
                                drop_rate: float = 0.0, seed: int = 0,
                                row0: int = 0, residual: bool = True):
    """Plain version (the JAX ``reference_norm_ffn_residual`` in torch, with
    the kernels' dropout masks): normed rows rounded to ``x.dtype``, convs in
    ``x.dtype``; ``deconv_b`` None adds no bias."""
    dt = x.dtype
    diff = kernel - 1
    inner = deconv_w.shape[0]
    xn = rms_group_norm(x, gamma, num_groups, eps).to(dt)
    xp = F.pad(xn.transpose(1, 2), (diff, diff))              # [R, C, L+2(k-1)]
    y = F.conv1d(xp, conv_w.to(dt), conv_b.to(dt))            # [R, 2I, L+k-1]
    h = y[:, :inner] * F.silu(y[:, inner:])
    if drop_rate > 0.0:
        h = D.apply_mask(h, inner_mask(seed, h, row0, drop_rate), drop_rate)
    z = F.conv_transpose1d(h, deconv_w.to(dt),
                           None if deconv_b is None else deconv_b.to(dt))  # [R, C, L+2(k-1)]
    z = z[:, :, diff:diff + x.shape[1]].transpose(1, 2)
    if not residual:
        return z
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


def wg_step_panels(conv_w, conv_b, deconv_w, dtype=torch.bfloat16):
    """The Hopper kernels' weight stages, each of 256 C bytes and 128-byte
    swizzled (csrc/swiglu_block.cu reads them by descriptor): per 64-channel
    chunk (the inner dimension zero-padded to a multiple of 64), per tap
    ``t`` the conv's ``[C][128]`` (row c: the chunk's 64 value then 64 gate
    channels' ``conv_w[o, c, t]``; the forward reads it as [C k][128 n], the
    dx kernel again as [C n][128 k]), then per pair of taps the deconv's
    ``[2][C][64]`` (row c of tap t: ``deconv_w[i, c, t]`` over the chunk's
    i; a tap past k is zeros) -> ``([nch, k + ceil(k/2), 128 C], bc [nch,
    128] fp32)``."""
    from .swiglu_ffn import _sw128, _wg_pad
    w, b, d = _wg_pad(conv_w, conv_b, deconv_w, SICH)   # [2, nch, 64, C, k], [nch, 64, C, k]
    nch, _, c, k = d.shape
    conv = _sw128(w.permute(1, 4, 3, 0, 2).reshape(nch, k, c, 2 * SICH))
    k2 = -(-k // 2)
    dec = F.pad(d.permute(0, 3, 2, 1), (0, 0, 0, 0, 0, 2 * k2 - k))   # [nch, 2 k2, C, 64]
    dec = _sw128(dec).reshape(nch, k2, 128 * c)
    panels = torch.cat([conv.reshape(nch, k, 128 * c), dec], dim=1)
    return panels.to(dtype).contiguous(), b


# The Hopper stages of the weights they were laid out from (cached_panels)
_PANELS = WeakIdKeyDictionary()


def _step_panels(conv_w, conv_b, deconv_w):
    return cached_panels(_PANELS, conv_w, (conv_b, deconv_w),
                         lambda: wg_step_panels(conv_w, conv_b, deconv_w))


def wg_step_plan(rows: int, seq: int, c: int, inner: int, k: int,
                 scratch_cap: int = SCRATCH_CAP) -> dict:
    """The Hopper backward's plan: the padded inner width, the rows per
    group (the bf16 scratch -- xn and dz [rows, Lin, C], dyvg [rows, Lin,
    2 Ip], h [rows, Lin, Ip], Lin = L + 2(k-1) -- within ``scratch_cap``
    bytes), the groups, the dx kernel's blocks over all groups
    (:func:`flat_tiles` each), the weight-gradient GEMM's tiles (128 of k x
    128 channel rows x 256 of its 3 Ip columns) and position splits (about
    four blocks an SM, at least 8 steps of 64 positions a split), and the
    scratch and fp32 partials' bytes."""
    ip = -(-inner // 64) * 64
    lin = seq + 2 * (k - 1)
    per_row = lin * (3 * ip + 2 * c) * 2
    group = max(1, min(rows, scratch_cap // per_row))
    groups = -(-rows // group)
    blocks = ((groups - 1) * flat_tiles(group, seq, k)
              + flat_tiles(rows - (groups - 1) * group, seq, k))
    tiles = k * _CG // 128 * (-(-2 * ip // 256) + -(-ip // 256))
    splits = weight_splits(tiles, group * lin // 64, least=8)
    return {"ip": ip, "rows": group, "groups": groups, "blocks": blocks, "tiles": tiles,
            "splits": splits, "scratch_bytes": group * per_row,
            "partial_bytes": splits * (k * _CG * 3 * ip + 2 * ip) * 4}


def flat_tiles(rows: int, seq: int, k: int) -> int:
    """Blocks of the Hopper kernels over ``rows`` rows: tiles of 128 - (k-1)
    outputs over the rows laid end to end with their 2(k-1) padding
    positions each (``Flat`` in csrc/swiglu_block.cu), so that a tile packs
    the end of one row and the start of the next."""
    lt = WG_M - (k - 1)
    return -(-(rows * (seq + 2 * (k - 1)) - (k - 1)) // lt)


def _fwd_fn():
    fn = load("swiglu_block").ffn_step_forward
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                   + [ctypes.c_float] + [ctypes.c_uint32] * 3
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    return fn


def _bwd_fn():
    fn = load("swiglu_block").ffn_step_backward
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 19 + [ctypes.c_int] * 6
                   + [ctypes.c_float] + [ctypes.c_int] * 2
                   + [ctypes.c_uint32] * 3
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    return fn


def _wg_fwd_fn():
    fn = load("swiglu_block").ffn_step_wg_forward
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_float]
                   + [ctypes.c_uint32] * 3
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    return fn


def _wg_bwd_fn():
    fn = load("swiglu_block").ffn_step_wg_backward
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 17 + [ctypes.c_int] * 6 + [ctypes.c_float]
                   + [ctypes.c_int] * 2 + [ctypes.c_uint32] * 3
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    return fn


def _check(x, gamma, conv_w, conv_b, deconv_w, deconv_b, kernel, num_groups):
    r, seq, c = x.shape
    inner = deconv_w.shape[0]
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"fused_norm_ffn_residual: the CUDA kernels take bf16 or fp32 "
                        f"rows, got {x.dtype}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("fused_norm_ffn_residual: x must be contiguous and 16-byte aligned")
    fits = (step_fp32.supports_ffn(c, inner, kernel, False, num_groups)
            if x.dtype == torch.float32 else
            c in _CHANNELS and (hopper_route(c) or inner % IC == 0) and 2 <= kernel <= 8
            and groups_fit(c, num_groups))
    if not fits:
        raise ValueError(f"fused_norm_ffn_residual: unsupported shape C={c} "
                         f"I={inner} k={kernel} groups={num_groups}")
    if conv_w.shape != (2 * inner, c, kernel) or deconv_w.shape != (inner, c, kernel):
        raise ValueError("fused_norm_ffn_residual: weight shapes do not match")
    for t in (gamma, conv_w, conv_b, deconv_w, deconv_b):
        if t is not None and t.device != x.device:
            raise ValueError("fused_norm_ffn_residual: tensors on different devices")


def ffn_step_forward(x, gamma, conv_w, conv_b, deconv_w, deconv_b, kernel,
                     num_groups, eps, drop_rate=0.0, seed=0, row0=0, residual=True):
    """One launch of the forward kernel (no autograd); ``residual=False``
    takes ``deconv_b`` None.  fp32 rows take ``step_fp32.ffn_forward``."""
    if x.dtype == torch.float32:
        return step_fp32.ffn_forward(x, gamma, conv_w, conv_b, deconv_w, deconv_b, kernel,
                                     num_groups, eps, drop_rate, seed, row0, residual)
    r, seq, c = x.shape
    inner = deconv_w.shape[0]
    g32 = gamma.to(torch.float32).contiguous()
    bd32 = (torch.zeros(c, dtype=torch.float32, device=x.device) if deconv_b is None
            else deconv_b.to(torch.float32).contiguous())
    out = torch.empty_like(x)
    args = (*D.kernel_args(drop_rate, seed, row0), int(residual), stream_handle(x.device))
    if hopper_route(c):
        panels, bc = _step_panels(conv_w, conv_b, deconv_w)
        check(_wg_fwd_fn()(ptr(x), ptr(g32), ptr(panels), ptr(bc), ptr(bd32), ptr(out), r,
                           seq, c, panels.shape[0] * SICH, kernel, num_groups, float(eps),
                           *args), "ffn_step")
    else:
        wc, bc, wd = ffn_panels(conv_w, conv_b, deconv_w)
        check(_fwd_fn()(ptr(x), ptr(g32), ptr(wc), ptr(bc), ptr(wd), ptr(bd32),
                        ptr(out), r, seq, c, inner, kernel, num_groups, float(eps),
                        *args), "ffn_step")
    fused_norm_ffn_residual.launches += 1
    return out


def _wg_backward(g, x, g32, conv_w, conv_b, deconv_w, k, num_groups, eps, drop_rate, seed,
                 row0, residual, scratch_cap):
    """The Hopper backward: per row group the dx kernel (dx; xn, dz, dyvg
    and h into the scratch; dgamma and deconv-bias partials per block) and
    the weight-gradient GEMM (fp32 partials per position split, accumulated
    across groups), then the partials summed in order: the GEMM's per split,
    the blocks' in segments of 64 and then the segments."""
    from .swiglu_ffn import wg_unpack_grads
    r, seq, c = x.shape
    inner = deconv_w.shape[0]
    dev = x.device
    plan = wg_step_plan(r, seq, c, inner, k, scratch_cap)
    ip, group, splits = plan["ip"], plan["rows"], plan["splits"]
    lin = seq + 2 * (k - 1)
    panels, bc = _step_panels(conv_w, conv_b, deconv_w)
    f32, bf = dict(dtype=torch.float32, device=dev), dict(dtype=torch.bfloat16, device=dev)
    dx = torch.empty_like(x)
    sxn, sdz = torch.empty(group, lin, c, **bf), torch.empty(group, lin, c, **bf)
    sy, sh = torch.empty(group, lin, 2 * ip, **bf), torch.empty(group, lin, ip, **bf)
    segs = -(-plan["blocks"] // 64)   # the blocks' partials, summed 64 at a time
    part = torch.empty(segs * 64, 2 * c, **f32)
    part[plan["blocks"]:].zero_()
    pmid = torch.empty(segs, 2 * c, **f32)
    wpart, bpart = torch.empty(splits, k * _CG, 3 * ip, **f32), torch.empty(splits, 2 * ip, **f32)
    out_w, out_b = torch.empty(k, _CG, 3 * ip, **f32), torch.empty(2 * ip, **f32)
    out_gb = torch.empty(2 * c, **f32)
    check(_wg_bwd_fn()(ptr(x), ptr(g), ptr(g32), ptr(panels), ptr(bc), ptr(dx), ptr(sxn),
                       ptr(sdz), ptr(sy), ptr(sh), ptr(part), ptr(pmid), ptr(wpart),
                       ptr(bpart),
                       ptr(out_w), ptr(out_b), ptr(out_gb), r, seq, c, ip, k, num_groups,
                       float(eps), group, splits, *D.kernel_args(drop_rate, seed, row0),
                       int(residual), stream_handle(dev)), "ffn_step_backward")
    dcw, dcb, ddw = wg_unpack_grads(out_w[:, :c], out_b, inner, SICH)
    return dx, out_gb[:c].clone(), dcw, dcb, ddw, out_gb[c:].clone()


def ffn_step_backward(g, x, gamma, conv_w, conv_b, deconv_w, kernel,
                      num_groups, eps, drop_rate=0.0, seed=0, row0=0,
                      residual=True, scratch_cap=SCRATCH_CAP):
    """The backward kernels (one counted launch): returns ``(dx, dgamma,
    dconv_w, dconv_b, ddeconv_w, ddeconv_b)`` in torch layouts (fp32 for the
    weights, ``x.dtype`` for dx; ``ddeconv_b`` zero with ``residual=False``).
    ``scratch_cap`` bounds the Hopper route's scratch (its row groups), and
    the fp32 route's (``step_fp32.ffn_backward``)."""
    if x.dtype == torch.float32:
        return step_fp32.ffn_backward(g, x, gamma, conv_w, conv_b, deconv_w, kernel,
                                      num_groups, eps, drop_rate, seed, row0, residual,
                                      scratch_cap=scratch_cap)
    r, seq, c = x.shape
    inner = deconv_w.shape[0]
    k = kernel
    dev = x.device
    g = g.to(x.dtype).contiguous()
    g32 = gamma.to(torch.float32).contiguous()
    if hopper_route(c):
        grads = _wg_backward(g, x, g32, conv_w, conv_b, deconv_w, k, num_groups, eps,
                             drop_rate, seed, row0, residual, scratch_cap)
        ffn_step_backward.launches += 1
        return grads
    wc, bc, wd = ffn_panels(conv_w, conv_b, deconv_w)
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
                    int(residual), stream_handle(dev)), "ffn_step_backward")
    ffn_step_backward.launches += 1
    return (dx, out_gb[:c].clone(), out_c[:, :2 * inner].permute(1, 2, 0).contiguous(),
            out_cb[:2 * inner].clone(), out_d[:, :inner].permute(1, 2, 0).contiguous(),
            out_gb[c:].clone())


class FusedFFNStep(torch.autograd.Function):
    """The FFN step through its kernels: the forward kernel, and the backward
    kernels, which recompute from the saved inputs (nothing else is kept)."""

    @staticmethod
    def forward(ctx, x, gamma, conv_w, conv_b, deconv_w, deconv_b, kernel,
                num_groups, eps, drop_rate, seed, row0, residual):
        ctx.args = (kernel, num_groups, eps, drop_rate, seed, row0, residual)
        ctx.bias_dtype = None if deconv_b is None else deconv_b.dtype
        ctx.save_for_backward(x, gamma, conv_w, conv_b, deconv_w)
        return ffn_step_forward(x, gamma, conv_w, conv_b, deconv_w, deconv_b,
                                kernel, num_groups, eps, drop_rate, seed, row0, residual)

    @staticmethod
    def backward(ctx, g):
        x, gamma, conv_w, conv_b, deconv_w = ctx.saved_tensors
        dx, dgamma, dcw, dcb, ddw, ddb = ffn_step_backward(
            g, x, gamma, conv_w, conv_b, deconv_w, *ctx.args)
        return (dx, dgamma.to(gamma.dtype), dcw.to(conv_w.dtype),
                dcb.to(conv_b.dtype), ddw.to(deconv_w.dtype),
                None if ctx.bias_dtype is None else ddb.to(ctx.bias_dtype),
                None, None, None, None, None, None, None)


def fused_norm_ffn_residual(x, gamma, conv_w, conv_b, deconv_w, deconv_b,
                            kernel: int, num_groups: int, eps: float,
                            drop_rate: float = 0.0, seed: int = 0,
                            row0: int = 0, residual: bool = True):
    """``x [R, L, C]`` -> ``x + drop(FFN(drop(RMSGroupNorm(x))))`` ``[R, L, C]``;
    weights in torch layouts (``conv_w [2I, C, k]``, ``deconv_w [I, C, k]``);
    ``seed`` an int32 drawn per call, ``row0`` the absolute row of ``x[0]``.
    ``residual=False``: the partial-sum mode (module docstring), with
    ``deconv_b`` None."""
    if (deconv_b is None) == residual:
        raise ValueError("fused_norm_ffn_residual: the deconv bias is given with "
                         "residual=True and None with residual=False")
    if x.device.type == "cpu":
        return reference_norm_ffn_residual(x, gamma, conv_w, conv_b, deconv_w,
                                           deconv_b, kernel, num_groups, eps,
                                           drop_rate, seed, row0, residual)
    if x.device.type != "cuda":
        raise ValueError(f"fused_norm_ffn_residual: unsupported device {x.device}")
    _check(x, gamma, conv_w, conv_b, deconv_w, deconv_b, kernel, num_groups)
    return FusedFFNStep.apply(x, gamma, conv_w, conv_b, deconv_w, deconv_b,
                              kernel, num_groups, eps, float(drop_rate),
                              int(seed), int(row0), bool(residual))


fused_norm_ffn_residual.launches = 0
ffn_step_backward.launches = 0
