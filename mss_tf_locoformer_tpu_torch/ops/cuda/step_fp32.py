"""fp32 rows of the fused FFN step (#2, #5) and attention step (#3, #4):
the kernels of ``csrc/step_fp32.cu``, ``csrc/ffn_core_fp32.cu`` and
``csrc/attn_fp32.cu`` chained into the four steps.

The JAX package's Pallas step kernels take fp32 rows with fp32 products
(their gates take an ``itemsize``: ``nn/ffn.py:42-66``,
``ops/pallas/attention_block.py:142-146``), and its speech separator runs
fp32 by default.  The bf16 kernels (``swiglu_block.cu``,
``attention_block.cu``) keep bf16 rows; an fp32 CUDA tensor given to
``fused_norm_ffn_residual`` or ``fused_attention_block`` comes here, and
nothing casts it to bf16.  Same contracts as the bf16 kernels (the
RMSGroupNorm prologue, both dropout sites of each step at the same Philox
coordinates, ``row0``, the partial-sum mode ``residual=False``), with fp32
operands and fp32 sums throughout.  Every GEMM of the four steps runs on
the tensor cores in three TF32 passes (``csrc/ffn_core_fp32.cu``, the
unfused FFN core's kernels, ``unfused_fp32.CorePrims``: ``core_nn`` and
``core_tn``; as accurate as FFMA: one TF32 pass would round operands to 11
significant bits), as does the attention core (``csrc/attn_fp32.cu``); the
norms, the outer / projection mask, the RoPE split and the fixed-order
sums are ``csrc/step_fp32.cu``'s (the norms a warp per position, reading
rows coalesced).

Each step is a chain of launches through device memory (the .cu files'
headers list the kernels):

* FFN forward, per row group: norm -> conv (``core_nn``) with the SwiGLU
  epilogue (the inner mask) -> deconv (``core_nn``) with the output
  epilogue (bias, outer mask, residual).  The conv reads the normed rows
  as windows of ``k C`` consecutive floats that start ``k - 1`` positions
  early (zero outside the row), so no padded copy is made; weight panels
  interleave each inner channel's value and gate columns, K-major and
  split into TF32 halves once (``unfused_fp32.core_panels``).
* FFN backward, per row group: the forward's norm and conv again (keeping
  the pre-activation), the outer mask on g (``mask_rows``), dh by the
  transposed deconv with the SwiGLU backward in its epilogue, dxn by the
  transposed conv (both ``core_nn``), the norm's backward (dx and dgamma
  partials), and the weight gradients (``core_tn``) and bias gradients
  (``core_colsum``) as per-split partials over positions; all partials
  summed in a fixed order (``reduce``) once every group has run.
* Attention forward: norm -> QKV (``core_nn``, store) -> q, k (RoPE), v
  as ``[R, H, Lp, 32]`` -> the core (``attn_fp32.cu``: 3xTF32 scores and
  products, the softmax in the exp2 domain with a lazy max) -> the
  out-projection (``core_nn`` with the output epilogue: no bias, the
  projection mask at (row, position, channel), the residual; with no
  residual the products alone).  The stash for the backward: q, k, v, o
  and the log-sum-exp.
* Attention backward: the projection mask on g, do = dproj W_out
  (``core_nn``), the core's dq and dk/dv kernels (``attn_fp32.cu``, RoPE
  undone), the forward's norm again, dxn = dqkv W_qkv (``core_nn``), the
  norm's backward, the weight gradients (``core_tn``) as per-split
  partials summed in a fixed order.  The four weight panels (``W_qkv^T``,
  ``W_out^T`` and the weights as stored, K-major and split into TF32
  halves: :func:`attn_panels`) are made once per weight version.

Each step counts one launch per call on its own function (:func:`ffn_forward`,
:func:`ffn_backward`, :func:`attention_forward`, :func:`attention_backward`),
beside the bf16 kernels' counts.  The chain runs on ``prims`` (the CUDA
kernels by default); a test hands it the kernels' arithmetic in plain torch.

:func:`supports_ffn` and :func:`supports_attention` are the fp32 gates, from
the kernels' shared-memory layouts (:func:`ffn_launch_bytes`,
:func:`launch_bytes`).
"""

from __future__ import annotations

import ctypes
import math
from collections import namedtuple

import torch
from torch.utils.weak import WeakIdKeyDictionary

from .. import dropout as D
from . import SMEM_OPTIN, cached_panels, check, load, ptr, stream_handle

__all__ = ["Win", "attn_launch_bytes", "compiled_attn_launch_bytes", "launch_bytes",
           "compiled_launch_bytes", "ffn_launch_bytes", "compiled_ffn_launch_bytes",
           "supports_ffn", "supports_attention", "ffn_rows", "ffn_forward", "ffn_backward",
           "attention_forward", "attention_backward", "ffn_panels", "attn_panels",
           "SCRATCH_CAP", "EPI_STORE", "EPI_SWIGLU", "EPI_SWIGLU_BWD", "EPI_OUT"]

CHANNELS = (32, 64, 96, 128)    # the step widths the gates admit, as for bf16 rows
QT = 64                         # rows of q, k, v padded to a multiple of this
DP = 32                         # head dims, zero-padded
ATTN_STAGES, ATTN_CHUNK = 3, 64   # the attention core's cp.async ring of 64-row chunks
NORM_WARPS = 8                  # warps a norm block, a position a warp at a time
NP = 32                         # positions a norm block (4 a warp): dgamma partial rows
SCRATCH_CAP = 1 << 30           # bytes of fp32 scratch per FFN row group
_SMS = 132
EPI_STORE, EPI_SWIGLU, EPI_SWIGLU_BWD, EPI_OUT = range(4)

# A matrix whose row m = (r, p), r = m // P, is the window of ``t``'s row r
# (``rs`` elements apart) from offset ``p * ps + shift``; elements outside
# [0, lim) of the row are zero.
Win = namedtuple("Win", "t rs P ps shift lim")


def _dense(t: torch.Tensor, rows: int, width: int) -> Win:
    return Win(t, 0, rows, width, 0, rows * width)


def attn_launch_bytes(dp: int) -> dict:
    """Shared memory of the attention core's launches (``csrc/attn_fp32.cu``)
    at a padded head width ``dp``: ``attn`` (the forward and the dq kernel)
    three stages of 64 rows of k and v, ``dp + 4`` floats a row; ``dkdv``
    three of q and dO with their log-sum-exps and deltas."""
    ring = ATTN_STAGES * 2 * ATTN_CHUNK
    return {"attn": ring * (dp + 4) * 4, "dkdv": ring * (dp + 4) * 4 + ring * 4}


def compiled_attn_launch_bytes(dp: int) -> dict:
    """:func:`attn_launch_bytes` as the compiled kernels count them."""
    fn = load("attn_fp32").f32_attn_smem_bytes
    fn.restype = ctypes.c_longlong
    fn.argtypes = [ctypes.c_int] * 2
    return {"attn": fn(0, dp), "dkdv": fn(1, dp)}


def _norm_bwd_bytes(c: int) -> int:
    """The norm backward's shared memory: its warps' dgamma partials."""
    return NORM_WARPS * c * 4


def _compiled_norm_bwd_bytes(c: int) -> int:
    fn = load("step_fp32").step_fp32_smem_bytes
    fn.restype = ctypes.c_longlong
    fn.argtypes = [ctypes.c_int] * 2
    return fn(0, c)


def _attn_layouts(nn: dict, attn: dict, norm_bwd: int, c: int, a: int, training: bool) -> dict:
    U = _core()
    tile = lambda n: nn[U.NN_KEY[U.core_tile(n)]]
    out = {"qkv": tile(3 * a), "attn": attn["attn"], "proj": tile(c)}
    if training:
        out.update(dout=tile(a), dkdv=attn["dkdv"], dxn=tile(c), tn=nn["tn"], norm_bwd=norm_bwd)
    return out


def launch_bytes(c: int, a: int, training: bool = False) -> dict:
    """Shared memory of each launch of the attention step: ``core_nn`` at the
    tile width (``unfused_fp32.core_tile``) of the QKV product (N = 3A) and
    the out-projection (N = C), the attention core's at DP 32
    (:func:`attn_launch_bytes`); in training also ``core_nn`` for do (N = A)
    and dxn (N = C), ``core_tn``, the core's dk/dv kernel and the norm
    backward's dgamma partials."""
    return _attn_layouts(_core().core_launch_bytes(), attn_launch_bytes(DP), _norm_bwd_bytes(c),
                         c, a, training)


def compiled_launch_bytes(c: int, a: int, training: bool = False) -> dict:
    """:func:`launch_bytes` as the compiled kernels count them."""
    return _attn_layouts(_core().compiled_core_launch_bytes(), compiled_attn_launch_bytes(DP),
                         _compiled_norm_bwd_bytes(c), c, a, training)


def compiled_norm_positions() -> int:
    """:data:`NP` as the compiled norm backward counts it."""
    fn = load("step_fp32").step_fp32_norm_positions
    fn.restype, fn.argtypes = ctypes.c_int, []
    return fn()


def _core():
    """``unfused_fp32``, whose 3xTF32 GEMMs and split panels the FFN step
    runs on (imported at first use: it imports this module)."""
    from . import unfused_fp32
    return unfused_fp32


def _ffn_layouts(nn: dict, norm_bwd, c: int, inner: int, training: bool) -> dict:
    U = _core()
    tile = lambda n: nn[U.NN_KEY[U.core_tile(n)]]
    out = {"conv": tile(2 * inner), "deconv": tile(c)}
    if training:
        out.update(dh=tile(inner), dx=tile(c), tn=nn["tn"], norm_bwd=norm_bwd)
    return out


def ffn_launch_bytes(c: int, inner: int, training: bool = False) -> dict:
    """Shared memory of each launch of the FFN step: ``core_nn`` at the tile
    width (``unfused_fp32.core_tile``) of the conv (N = 2I) and the deconv
    (N = C); in training also of dh (N = I) and dx (N = C), ``core_tn``,
    and the norm backward's dgamma partials (a row of C floats a warp)."""
    return _ffn_layouts(_core().core_launch_bytes(), _norm_bwd_bytes(c), c, inner, training)


def compiled_ffn_launch_bytes(c: int, inner: int, training: bool = False) -> dict:
    """:func:`ffn_launch_bytes` as the compiled kernels count them."""
    return _ffn_layouts(_core().compiled_core_launch_bytes(), _compiled_norm_bwd_bytes(c), c,
                        inner, training)


def supports_ffn(c: int, inner: int, k: int, training: bool, num_groups: int = 1) -> bool:
    """The fp32 FFN-step gate: a step width of :data:`CHANNELS`, an inner
    width of whole float4s, 2 <= k <= 8, whole norm groups, and layouts
    within :data:`SMEM_OPTIN`."""
    return (c in CHANNELS and inner > 0 and inner % 4 == 0 and 2 <= k <= 8
            and c % num_groups == 0
            and max(ffn_launch_bytes(c, inner, training).values()) <= SMEM_OPTIN)


def supports_attention(c: int, a: int, h: int, training: bool) -> bool:
    """The fp32 attention-step gate: a step width of :data:`CHANNELS`, an
    attention width of whole 8-float chunks, an even head_dim <= 32, and
    layouts within :data:`SMEM_OPTIN`."""
    d = a // h if a % h == 0 else 0
    return (c in CHANNELS and a % 8 == 0 and d % 2 == 0 and 0 < d <= DP
            and max(launch_bytes(c, a, training).values()) <= SMEM_OPTIN)


def ffn_rows(rows: int, seq: int, c: int, inner: int, k: int, training: bool,
             scratch_cap: int = SCRATCH_CAP) -> int:
    """Rows per group of an FFN step: the fp32 scratch (forward: xn [L, C]
    and h [Lc, I] a row; backward: xn, dz, dxn and y, h, dy, Lc = L + k - 1)
    within ``scratch_cap`` bytes."""
    lc = seq + k - 1
    per_row = 4 * ((3 * seq * c + 5 * lc * inner) if training else (seq * c + lc * inner))
    return max(1, min(rows, scratch_cap // per_row))


def _col_splits(total: int) -> int:
    return max(1, min(4 * _SMS, total // 256))


# --------------------------------------------------------------- panels

def ffn_panels(conv_w, conv_b, deconv_w):
    """fp32 weight panels of the FFN GEMMs (k taps, inner I, width C; value
    and gate columns interleaved, ``2i`` the value and ``2i + 1`` the gate of
    inner channel i):

    * ``wc [k C, 2I]``: the conv, row ``s C + c`` = tap s, channel c;
    * ``bc [2I]``: its bias;
    * ``wdf [k I, C]``: the deconv as the forward reads it, row ``s I + i`` =
      tap ``k - 1 - s``;
    * ``wd2 [k C, I]``: the deconv transposed (dh), row ``t C + c``;
    * ``w2 [k 2I, C]``: the conv transposed (dxn), row ``s 2I + o`` = tap
      ``k - 1 - s``."""
    two_i, c, k = conv_w.shape
    inner = two_i // 2
    w = conv_w.detach().to(torch.float32).reshape(2, inner, c, k)
    d = deconv_w.detach().to(torch.float32)
    wc = w.permute(3, 2, 1, 0).reshape(k * c, two_i)
    bc = conv_b.detach().to(torch.float32).reshape(2, inner).T.reshape(two_i)
    wdf = d.flip(-1).permute(2, 0, 1).reshape(k * inner, c)
    wd2 = d.permute(2, 1, 0).reshape(k * c, inner)
    w2 = w.flip(-1).permute(3, 1, 0, 2).reshape(k * two_i, c)
    return tuple(t.contiguous() for t in (wc, bc, wdf, wd2, w2))


def _unpack_ffn_grads(dwc, dbc, dwd, inner, c, k):
    """The interleaved GEMM layouts back to torch's: ``dwc [2I, k C]`` ->
    ``[2I, C, k]``, ``dbc [2I]``, ``dwd [I, k C]`` -> ``[I, C, k]``."""
    dcw = dwc.reshape(inner, 2, k, c).permute(1, 0, 3, 2).reshape(2 * inner, c, k)
    dcb = dbc.reshape(inner, 2).T.reshape(2 * inner)
    ddw = dwd.reshape(inner, k, c).permute(0, 2, 1)
    return dcw.contiguous(), dcb.contiguous(), ddw.contiguous()


def attn_panels(w_qkv, w_out):
    """The attention step's GEMM panels, split for the tensor cores
    (``unfused_fp32.split_panel``): the QKV product's ``W_qkv^T [C, 3A]``,
    the out-projection's ``W_out^T [A, C]``, and for the backward do's
    ``W_out [C, A]`` and dxn's ``W_qkv [3A, C]``."""
    U = _core()
    wq = w_qkv.detach().to(torch.float32)
    wo = w_out.detach().to(torch.float32)
    return tuple(U.split_panel(p) for p in (wq.T, wo.T, wo, wq))


# The attention step's panels of the weights they were laid out from
# (``cached_panels``)
_PANELS = WeakIdKeyDictionary()


def _attn_panels(w_qkv, w_out):
    return cached_panels(_PANELS, w_qkv, (w_out,), lambda: attn_panels(w_qkv, w_out))


# ------------------------------------------------------------ CUDA kernels

def _win_types():
    return [ctypes.c_void_p] + [ctypes.c_longlong] * 5


def _win_args(w: Win):
    return (ptr(w.t), w.rs, w.P, w.ps, w.shift, w.lim)


def _opt(t):
    return ctypes.c_void_p(None) if t is None else ptr(t)


class CudaPrims:
    """The kernels of ``csrc/step_fp32.cu`` and the attention core of
    ``csrc/attn_fp32.cu`` (``attn_fwd``, ``attn_bwd``), launched on the
    current stream; every step's GEMMs are ``unfused_fp32.CorePrims``'.
    Every tensor is fp32, contiguous and 16-byte aligned."""

    def __init__(self):
        libs = {"step_fp32": load("step_fp32"), "attn_fp32": load("attn_fp32")}
        u, i, ll, f, vp = (ctypes.c_uint32, ctypes.c_int, ctypes.c_longlong, ctypes.c_float,
                           ctypes.c_void_p)
        self._fn = {}
        for name, args in (
                ("f32_reduce", [vp, ll, ll, ll, vp, vp]),
                ("f32_norm_fwd", [vp, vp, vp, ll, i, i, f, vp]),
                ("f32_norm_bwd", [vp] * 6 + [ll, i, i, f, vp]),
                ("f32_mask_rows", [vp, vp, ll, i, i] + [u] * 4 + [f, vp]),
                ("f32_qkv_split", [vp] * 6 + [i] * 6 + [vp]),
                ("f32_attn_fwd", [vp] * 5 + [i] * 6 + [f] + [u] * 3 + [f, i, vp]),
                ("f32_attn_bwd", [vp] * 11 + [i] * 6 + [f] + [u] * 3 + [f, i, vp])):
            fn = getattr(libs["attn_fp32" if name.startswith("f32_attn") else "step_fp32"], name)
            fn.restype, fn.argtypes = ctypes.c_int, args
            self._fn[name] = fn

    def _call(self, name, *args, device):
        check(self._fn[name](*args, stream_handle(device)), name)

    def reduce(self, part, s, n, seg, out):
        self._call("f32_reduce", ptr(part), s, n, seg, ptr(out), device=out.device)

    def norm_fwd(self, x, gamma, xn, npos, c, groups, eps):
        self._call("f32_norm_fwd", ptr(x), ptr(gamma), ptr(xn), npos, c, groups, eps,
                   device=xn.device)

    def norm_bwd(self, x, gamma, dxn, gres, dx, part, npos, c, groups, eps):
        self._call("f32_norm_bwd", ptr(x), ptr(gamma), ptr(dxn), _opt(gres), ptr(dx), ptr(part),
                   npos, c, groups, eps, device=dx.device)

    def mask_rows(self, g, dz, n, seq, c, site, drop):
        self._call("f32_mask_rows", ptr(g), ptr(dz), n, seq, c, site, *drop[:4],
                   device=dz.device)

    # The attention kernels take the padded head width from q's last axis
    # (their instantiations: 16, 32 and 64); attn_fwd and attn_bwd are
    # attn_fp32.cu's (attn_bwd: its dq kernel, then its dk/dv kernel).
    def qkv_split(self, qkv, cos, sin, q, k, v, r, seq, lp, h, d):
        self._call("f32_qkv_split", ptr(qkv), ptr(cos), ptr(sin), ptr(q), ptr(k), ptr(v),
                   r, seq, lp, h, d, q.shape[-1], device=q.device)

    def attn_fwd(self, q, k, v, o, lse, r, h, seq, lp, d, scale, drop):
        self._call("f32_attn_fwd", ptr(q), ptr(k), ptr(v), ptr(o), _opt(lse), r, h, seq, lp,
                   d, q.shape[-1], scale, *drop, device=o.device)

    def attn_bwd(self, q, k, v, o, dout, lse, dop, delta, dqkv, cos, sin, r, h, seq, lp, d,
                 scale, drop):
        self._call("f32_attn_bwd", *(ptr(t) for t in (q, k, v, o, dout, lse, dop, delta, dqkv,
                                                       cos, sin)),
                   r, h, seq, lp, d, q.shape[-1], scale, *drop, device=dqkv.device)


_CUDA = []


def _prims(prims):
    if prims is not None:
        return prims
    if not _CUDA:
        _CUDA.append(CudaPrims())
    return _CUDA[0]


def _reduce(P, part, out):
    """``out[n] = sum_s part[s, n]`` in a fixed order: segments of 256, then
    the segments."""
    s, n = part.shape[0], out.numel()
    if s > 256:
        segs = -(-s // 256)
        mid = torch.empty(segs, n, dtype=torch.float32, device=out.device)
        P.reduce(part, s, n, 256, mid)
        part, s = mid, segs
    P.reduce(part, s, n, s, out)
    return out


# -------------------------------------------------------------- FFN step

def ffn_forward(x, gamma, conv_w, conv_b, deconv_w, deconv_b, kernel, num_groups, eps,
                drop_rate=0.0, seed=0, row0=0, residual=True, prims=None,
                scratch_cap=SCRATCH_CAP):
    """#2 on fp32 rows ``x [R, L, C]`` (one counted launch):
    ``x + drop(Deconv(drop(SwiGLU(Conv(RMSGroupNorm(x))))))``, or with
    ``residual=False`` the deconv alone (no bias, no outer mask)."""
    P = _prims(prims)
    U = _core()
    G = U._core_gemms(P)
    r, seq, c = x.shape
    inner, k = deconv_w.shape[0], kernel
    diff, lc = kernel - 1, seq + kernel - 1
    f32 = dict(dtype=torch.float32, device=x.device)
    wc, bc, wdf, _, _ = U._panels(conv_w, conv_b, deconv_w)
    bd = (None if deconv_b is None or not residual
          else deconv_b.detach().to(torch.float32).contiguous())
    g32 = gamma.detach().to(torch.float32).contiguous()
    rg = ffn_rows(r, seq, c, inner, k, False, scratch_cap)
    xn, h = torch.empty(rg, seq, c, **f32), torch.empty(rg, lc, inner, **f32)
    out = torch.empty_like(x)
    for g0 in range(0, r, rg):
        n = min(rg, r - g0)
        drop = D.kernel_args(drop_rate, seed, row0 + g0)
        xg = x[g0:g0 + n]
        P.norm_fwd(xg, g32, xn, n * seq, c, num_groups, eps)
        G.gemm_nn(EPI_SWIGLU, Win(xn, seq * c, lc, c, -diff * c, seq * c), n * lc, k * c, wc,
                  2 * inner, h, inner, bias=bc, p=lc, site=D.SITE_FFN_INNER, drop=drop)
        G.gemm_nn(EPI_OUT, Win(h, lc * inner, seq, inner, 0, lc * inner), n * seq, k * inner,
                  wdf, c, out[g0:g0 + n], c, bias=bd, res=xg if residual else None, p=seq,
                  site=D.SITE_FFN_OUTER, drop=drop)
    ffn_forward.launches += 1
    return out


def ffn_backward(g, x, gamma, conv_w, conv_b, deconv_w, kernel, num_groups, eps,
                 drop_rate=0.0, seed=0, row0=0, residual=True, prims=None,
                 scratch_cap=SCRATCH_CAP):
    """#5 on fp32 rows (one counted launch): ``(dx, dgamma, dconv_w, dconv_b,
    ddeconv_w, ddeconv_b)`` in torch layouts, ``ddeconv_b`` zero with
    ``residual=False``."""
    P = _prims(prims)
    U = _core()
    G = U._core_gemms(P)
    r, seq, c = x.shape
    inner, k = deconv_w.shape[0], kernel
    diff, lc = kernel - 1, seq + kernel - 1
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    wc, bc, _, wd2, w2 = U._panels(conv_w, conv_b, deconv_w)
    g = g.to(torch.float32).contiguous()
    g32 = gamma.detach().to(torch.float32).contiguous()
    rg = ffn_rows(r, seq, c, inner, k, True, scratch_cap)
    groups = -(-r // rg)
    xn, dxn = torch.empty(rg, seq, c, **f32), torch.empty(rg, seq, c, **f32)
    dzb = torch.empty(rg, seq, c, **f32) if residual and drop_rate > 0.0 else None
    y, dy = torch.empty(rg, lc, 2 * inner, **f32), torch.empty(rg, lc, 2 * inner, **f32)
    h = torch.empty(rg, lc, inner, **f32)
    s1, s2 = U._tn_splits(2 * inner, k * c, rg * lc), U._tn_splits(inner, k * c, rg * lc)
    sb, sdb = _col_splits(rg * lc), _col_splits(rg * seq)
    pw, pd = torch.empty(groups * s1, 2 * inner, k * c, **f32), \
        torch.empty(groups * s2, inner, k * c, **f32)
    pb, pdb = torch.empty(groups * sb, 2 * inner, **f32), torch.empty(groups * sdb, c, **f32)
    blocks = [-(-min(rg, r - g0) * seq // NP) for g0 in range(0, r, rg)]
    pg = torch.empty(sum(blocks), c, **f32)
    dx = torch.empty_like(x)
    for gi, g0 in enumerate(range(0, r, rg)):
        n = min(rg, r - g0)
        drop = D.kernel_args(drop_rate, seed, row0 + g0)
        xg, gg = x[g0:g0 + n], g[g0:g0 + n]
        xwin = Win(xn, seq * c, lc, c, -diff * c, seq * c)
        P.norm_fwd(xg, g32, xn, n * seq, c, num_groups, eps)
        G.gemm_nn(EPI_SWIGLU, xwin, n * lc, k * c, wc, 2 * inner, h, inner, bias=bc, y=y,
                  p=lc, site=D.SITE_FFN_INNER, drop=drop)
        dz = gg
        if dzb is not None:
            dz = dzb[:n]
            P.mask_rows(gg, dz, n * seq * c, seq, c, D.SITE_FFN_OUTER, drop)
        zwin = Win(dz, seq * c, lc, c, -diff * c, seq * c)
        G.gemm_nn(EPI_SWIGLU_BWD, zwin, n * lc, k * c, wd2, inner, dy, 2 * inner, y=y, p=lc,
                  site=D.SITE_FFN_INNER, drop=drop)
        G.gemm_nn(EPI_STORE, Win(dy, lc * 2 * inner, seq, 2 * inner, 0, lc * 2 * inner),
                  n * seq, k * 2 * inner, w2, c, dxn, c)
        b0 = sum(blocks[:gi])
        P.norm_bwd(xg, g32, dxn, gg if residual else None, dx[g0:g0 + n],
                   pg[b0:b0 + blocks[gi]], n * seq, c, num_groups, eps)
        dyd = _dense(dy, n * lc, 2 * inner)
        G.gemm_tn(dyd, 2 * inner, xwin, k * c, n * lc, s1, pw[gi * s1:(gi + 1) * s1])
        G.colsum(dyd, 2 * inner, n * lc, sb, pb[gi * sb:(gi + 1) * sb])
        G.gemm_tn(_dense(h, n * lc, inner), inner, zwin, k * c, n * lc, s2,
                  pd[gi * s2:(gi + 1) * s2])
        if residual:
            G.colsum(_dense(dz, n * seq, c), c, n * seq, sdb, pdb[gi * sdb:(gi + 1) * sdb])
    red = lambda part, *shape: _reduce(P, part.reshape(part.shape[0], -1),
                                       torch.empty(*shape, **f32))
    dcw, dcb, ddw = _unpack_ffn_grads(red(pw, 2 * inner, k * c), red(pb, 2 * inner),
                                      red(pd, inner, k * c), inner, c, k)
    ddb = red(pdb, c) if residual else torch.zeros(c, **f32)
    ffn_backward.launches += 1
    return dx, red(pg, c), dcw, dcb, ddw, ddb


# -------------------------------------------------------- attention step

def _attn_tables(seq, d, theta, rope, device):
    from .attention_block import _rope_tables
    return _rope_tables(seq, d, float(theta), bool(rope), device)


def attention_forward(x, gamma, w_qkv, w_out, n_heads, num_groups, eps, rope=True,
                      theta=10000.0, drop_rate=0.0, seed=0, row0=0, residual=True,
                      stash=False, prims=None):
    """#3 on fp32 rows (one counted launch).  Returns ``out`` or, with
    ``stash``, ``(out, (q, k, v, o, lse))`` for :func:`attention_backward`:
    q and k after RoPE and v ``[R, H, Lp, 32]``, o ``[R, L, A]``, the
    natural log-sum-exp ``[R, H, L]``."""
    P = _prims(prims)
    G = _core()._core_gemms(P)
    r, seq, c = x.shape
    a = w_qkv.shape[0] // 3
    d = a // n_heads
    lp = -(-seq // QT) * QT
    f32 = dict(dtype=torch.float32, device=x.device)
    wq_p, wo_p, _, _ = _attn_panels(w_qkv, w_out)
    g32 = gamma.detach().to(torch.float32).contiguous()
    drop = D.kernel_args(drop_rate, seed, row0)
    xn = torch.empty(r, seq, c, **f32)
    P.norm_fwd(x, g32, xn, r * seq, c, num_groups, eps)
    qkv = torch.empty(r, seq, 3 * a, **f32)
    G.gemm_nn(EPI_STORE, _dense(xn, r * seq, c), r * seq, c, wq_p, 3 * a, qkv, 3 * a)
    del xn
    cos, sin = _attn_tables(seq, d, theta, rope, x.device)
    q, k, v = (torch.empty(r, n_heads, lp, DP, **f32) for _ in range(3))
    P.qkv_split(qkv, cos, sin, q, k, v, r, seq, lp, n_heads, d)
    del qkv
    o = torch.empty(r, seq, a, **f32)
    lse = torch.empty(r, n_heads, seq, **f32) if stash else None
    P.attn_fwd(q, k, v, o, lse, r, n_heads, seq, lp, d, 1.0 / math.sqrt(d), drop)
    out = torch.empty_like(x)
    G.gemm_nn(EPI_OUT, _dense(o, r * seq, a), r * seq, a, wo_p, c, out, c,
              res=x if residual else None, p=seq, site=D.SITE_ATTN_PROJ, drop=drop)
    attention_forward.launches += 1
    return (out, (q, k, v, o, lse)) if stash else out


def attention_backward(g, x, gamma, w_qkv, w_out, stash, n_heads, num_groups, eps,
                       rope=True, theta=10000.0, drop_rate=0.0, seed=0, row0=0,
                       residual=True, prims=None):
    """#4 on fp32 rows from the forward's stash (one counted launch):
    ``(dx, dgamma, dw_qkv, dw_out)`` in torch layouts."""
    P = _prims(prims)
    U = _core()
    G = U._core_gemms(P)
    r, seq, c = x.shape
    a = w_qkv.shape[0] // 3
    d = a // n_heads
    q, k, v, o, lse = stash
    lp = q.shape[2]
    npos = r * seq
    f32 = dict(dtype=torch.float32, device=x.device)
    g = g.to(torch.float32).contiguous()
    g32 = gamma.detach().to(torch.float32).contiguous()
    _, _, wo_b, wq_b = _attn_panels(w_qkv, w_out)
    drop = D.kernel_args(drop_rate, seed, row0)
    dproj = g
    if residual and drop_rate > 0.0:
        dproj = torch.empty_like(g)
        P.mask_rows(g, dproj, npos * c, seq, c, D.SITE_ATTN_PROJ, drop)
    dout = torch.empty(r, seq, a, **f32)
    G.gemm_nn(EPI_STORE, _dense(dproj, npos, c), npos, c, wo_b, a, dout, a)
    cos, sin = _attn_tables(seq, d, theta, rope, x.device)
    dop = torch.empty(r, n_heads, lp, DP, **f32)
    delta = torch.empty(r, n_heads, seq, **f32)
    dqkv = torch.empty(r, seq, 3 * a, **f32)
    P.attn_bwd(q, k, v, o, dout, lse, dop, delta, dqkv, cos, sin, r, n_heads, seq, lp, d,
               1.0 / math.sqrt(d), drop)
    del dop, delta, dout
    xn = torch.empty(r, seq, c, **f32)
    P.norm_fwd(x, g32, xn, npos, c, num_groups, eps)
    dxn = torch.empty(r, seq, c, **f32)
    G.gemm_nn(EPI_STORE, _dense(dqkv, npos, 3 * a), npos, 3 * a, wq_b, c, dxn, c)
    dx = torch.empty_like(x)
    pg = torch.empty(-(-npos // NP), c, **f32)
    P.norm_bwd(x, g32, dxn, g if residual else None, dx, pg, npos, c, num_groups, eps)
    so, sq = U._tn_splits(c, a, npos), U._tn_splits(3 * a, c, npos)
    po, pq = torch.empty(so, c, a, **f32), torch.empty(sq, 3 * a, c, **f32)
    G.gemm_tn(_dense(dproj, npos, c), c, _dense(o, npos, a), a, npos, so, po)
    G.gemm_tn(_dense(dqkv, npos, 3 * a), 3 * a, _dense(xn, npos, c), c, npos, sq, pq)
    red = lambda part, *shape: _reduce(P, part.reshape(part.shape[0], -1),
                                       torch.empty(*shape, **f32))
    attention_backward.launches += 1
    return dx, red(pg, c), red(pq, 3 * a, c), red(po, c, a)


ffn_forward.launches = 0
ffn_backward.launches = 0
attention_forward.launches = 0
attention_backward.launches = 0
