"""fp32 rows of the unfused route's kernels: flash attention (#6, #7) on
``csrc/step_fp32.cu``'s RoPE split and the 3xTF32 tensor-core attention
core of ``csrc/attn_fp32.cu``, and the FFN core (#8, #9) on the 3xTF32
tensor-core GEMMs of ``csrc/ffn_core_fp32.cu``.

The JAX package runs its Pallas flash-attention and FFN-core kernels in the
compute dtype, fp32 included (``nn/attention.py:146-157``,
``nn/ffn.py:163-170``; the kernels size their blocks by the itemsize), so
``--precision fp32`` serving and ``use_amp: false`` training of the xlarge,
small and LayerNorm configs run them at fp32.  The bf16 kernels
(``flash_attention.cu``, ``swiglu_ffn.cu``) keep bf16 rows; an fp32 CUDA
tensor given to ``flash_attention`` or ``swiglu_conv_deconv`` comes here,
and nothing casts it to bf16.  Same contracts as the bf16 kernels, with fp32
operands and fp32 sums throughout.  Every product runs on the tensor cores
in three TF32 passes: each operand split into TF32 hi and lo halves,
rounded to nearest, and lo hi' + hi lo' + hi hi' summed in fp32, each
stage's (the FFN core's 32-deep k stages, attention's 16-key tiles) total
added into an fp32 sum (the tensor cores truncate as they add), as
accurate as FFMA (one TF32 pass would round every operand to 11 bits:
~3e-4 of the output's peak).

Each kernel is a chain of launches through device memory:

* Flash forward (#6): ``qkv_split`` reads the ``[B, L, 3, H, D]`` QKV
  product that the ``[B, H, L, D]`` views of q, k and v come from (a copy
  is made only for other views) and writes q and k rotated by RoPE, and v,
  as ``[B, H, Lp, DP]`` (D zero-padded to DP = 16, 32 or 64; Lp a multiple
  of 64); ``attn_fwd`` (``csrc/attn_fp32.cu``: a warp's 16 or 32 queries
  in registers, 3xTF32 scores and P V, the softmax in the exp2 domain with
  a lazy max) writes o ``[B, L, H, D]`` and, with a gradient, the natural
  log-sum-exp ``[B, H, L]``.
* Flash backward (#7): ``qkv_split`` again (nothing rotated is kept), then
  ``attn_bwd``: the dq kernel (delta = do . o and dq, a warp's 16 queries)
  and the dk/dv kernel (a warp's 16 keys), P recomputed from the log-sum-
  exp, dq and dk rotated back in their epilogues, into one ``[B, L, 3, H,
  D]`` buffer whose ``[B, H, L, D]`` views are the gradients.
* FFN core forward (#8), per row group: the conv as ``core_nn`` (wgmma) on
  windows of ``k C`` consecutive floats of the pre-padded rows with the
  SwiGLU epilogue (the inner mask at ``inner_mask``'s coordinates), then
  the deconv as ``core_nn`` on windows of the SwiGLU output (``k - 1`` zero
  positions before it, none stored) with the bias; no norm, no residual, no
  outer mask: the caller crops and applies the outer site.
* FFN core backward (#9), per row group: the conv again keeping the pre-
  activation, dh by the transposed deconv with the SwiGLU backward in its
  epilogue, dx by the transposed conv (all ``core_nn``), and the weight and
  bias gradients as per-split partials (``core_tn`` on mma.sync,
  ``core_colsum``), summed in a fixed order (``step_fp32.cu``'s
  ``reduce``) once every group has run.

The weight panels are laid out K-major and split into TF32 halves once,
when they are made (:func:`core_panels`, cached per weight version); the
inner width is zero-padded to whole float4s in them, so every inner width
runs.  The fused FFN step's fp32 rows (#2, #5: ``step_fp32.ffn_forward`` /
``ffn_backward``) run on the same GEMMs and panels, ``core_nn`` with the
step's output epilogue (bias, outer mask, residual).  Each kernel counts one launch per call on its own function
(:func:`flash_forward_fp32`, :func:`flash_backward_fp32`,
:func:`ffn_core_fp32`, :func:`ffn_core_fp32_backward`), not on the bf16
kernels' counts.  The chains run on ``prims`` (``step_fp32.CudaPrims`` by
default, whose FFN-core GEMMs are :class:`CorePrims`); a test hands them the
kernels' arithmetic in plain torch.

:func:`supports_flash` and :func:`supports_core` are the fp32 gates, from
the launches' shared-memory layouts (:func:`flash_launch_bytes`,
:func:`core_launch_bytes`), reached through ``flash_attention.
supports_shape(d, dtype)`` and ``swiglu_ffn.supports_shape(..., dtype)``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

from .. import dropout as D
from . import SMEM_OPTIN, cached_panels, check, load, ptr, stream_handle
from . import step_fp32 as S

__all__ = ["MAX_HEAD_DIM", "SCRATCH_CAP", "head_pad", "flash_launch_bytes",
           "compiled_flash_launch_bytes", "core_tile", "core_launch_bytes",
           "compiled_core_launch_bytes", "supports_flash", "supports_core", "core_rows", "tf32_split", "split_panel",
           "panel_halves", "core_panels", "CorePrims", "flash_forward_fp32",
           "flash_backward_fp32", "ffn_core_fp32", "ffn_core_fp32_backward"]

MAX_HEAD_DIM = 64           # as the bf16 kernels: even head dims up to 64
SCRATCH_CAP = 1 << 30       # bytes of fp32 scratch per FFN-core row group
CORE_BM, CORE_BK = 128, 32        # the FFN-core GEMMs' tiles: rows, k a stage
CORE_NN_STAGES, CORE_STAGES = 4, 3   # core_nn's ring, core_tn's
_NO_DROP = D.kernel_args(0.0, 0, 0)   # a dropout request never reaches flash attention


def head_pad(d: int) -> int:
    """The instantiation a head_dim ``d`` runs at: D zero-padded to 16, 32
    or 64."""
    return 16 if d <= 16 else 32 if d <= 32 else 64


def flash_launch_bytes(d: int) -> dict:
    """Shared memory of the flash launches at head_dim ``d`` (``csrc/
    attn_fp32.cu`` at ``DP`` = :func:`head_pad`: ``step_fp32.
    attn_launch_bytes``): the forward and dq kernels' ring of k and v, the
    dk/dv kernel's of q and dO with their log-sum-exps and deltas."""
    return S.attn_launch_bytes(head_pad(d))


def compiled_flash_launch_bytes(d: int) -> dict:
    """:func:`flash_launch_bytes` as the compiled kernels count them."""
    return S.compiled_attn_launch_bytes(head_pad(d))


def core_tile(n: int) -> int:
    """``core_nn``'s tile width at an output width ``n`` (the .cu's
    ``nn_tile``): 96 at ``n`` 96, 64 where it pads fewer columns than 128,
    else 128."""
    if n == 96:
        return 96
    return 64 if -(-n // 64) * 64 < -(-n // 128) * 128 else 128


# core_launch_bytes' key of core_nn at each tile width
NN_KEY = {128: "nn", 64: "nn64", 96: "nn96"}


def core_launch_bytes() -> dict:
    """Shared memory of the FFN GEMMs' launches (``csrc/ffn_core_fp32.cu``):
    ``core_nn``'s four stages of the A tile and the B hi and lo tiles in rows
    of 32 floats (128 rows of A; 128 of B, 96 at N 96: ``nn96``, or 64 at a
    narrow N: ``nn64``) and 1 KB to align them to the swizzle's atoms;
    ``core_tn``'s three stages of 32 positions of A and B, 128 + 8 floats
    each (the column sums' 4 KB and ``reduce``'s none are no limit)."""
    row = CORE_BK * 4
    nn = lambda bn: CORE_NN_STAGES * (CORE_BM + 2 * bn) * row + 1024
    return {"nn": nn(128), "nn64": nn(64),
            "tn": CORE_STAGES * 2 * CORE_BK * (CORE_BM + 8) * 4, "nn96": nn(96)}


def compiled_core_launch_bytes() -> dict:
    """:func:`core_launch_bytes` as the compiled kernels count them."""
    fn = load("ffn_core_fp32").core_fp32_smem_bytes
    fn.restype = ctypes.c_longlong
    fn.argtypes = [ctypes.c_int]
    return {name: fn(i) for i, name in enumerate(("nn", "nn64", "tn", "nn96"))}


def supports_flash(d: int) -> bool:
    """The fp32 flash gate: an even head_dim up to :data:`MAX_HEAD_DIM` (every
    one the bf16 kernels take) and layouts within :data:`SMEM_OPTIN`."""
    return (d % 2 == 0 and 0 < d <= MAX_HEAD_DIM
            and max(flash_launch_bytes(d).values()) <= SMEM_OPTIN)


def supports_core(c: int, inner: int, k: int, training: bool = False) -> bool:
    """The fp32 FFN-core gate: a width of whole float4s (the GEMMs' windows
    load 4 channels at a time; a k8 step past K reads zeros), any inner
    width (padded in the panels), 2 <= k <= 8 as the bf16 kernels, and
    layouts within :data:`SMEM_OPTIN` (no layout depends on the widths, and
    the backward's GEMMs are the forward's and ``core_tn``, so training
    changes nothing)."""
    return (c > 0 and c % 4 == 0 and inner > 0 and 2 <= k <= 8
            and max(core_launch_bytes().values()) <= SMEM_OPTIN)


def core_rows(rows: int, lin: int, c: int, inner: int, k: int, training: bool,
              scratch_cap: int = SCRATCH_CAP) -> int:
    """Rows per group of an FFN-core call on ``[rows, lin, C]``: its fp32
    scratch (forward: the SwiGLU output h [Lc, Ip]; backward: the pre-
    activation y and dy [Lc, 2 Ip] and h, Lc = Lin - k + 1, Ip the padded
    inner width) within ``scratch_cap`` bytes."""
    lc, ip = lin - k + 1, -(-inner // 4) * 4
    per_row = 4 * lc * ip * (5 if training else 1)
    return max(1, min(rows, scratch_cap // per_row))


# ---------------------------------------------------------- flash attention

def _qkv_rows(q4, k4, v4) -> torch.Tensor:
    """The ``[B, L, 3 A]`` rows ``qkv_split`` reads: a view of the QKV
    product when q, k and v are its ``[B, H, L, D]`` views (the MHSA's),
    else a copy in that layout."""
    b, h, seq, d = q4.shape
    a = h * d
    stride = (seq * 3 * a, d, 3 * a, 1)
    base = q4.storage_offset()
    if (all(t.stride() == stride for t in (q4, k4, v4))
            and q4.untyped_storage().data_ptr() == k4.untyped_storage().data_ptr()
            == v4.untyped_storage().data_ptr()
            and (k4.storage_offset(), v4.storage_offset()) == (base + a, base + 2 * a)):
        return q4.as_strided((b, seq, 3 * a), (seq * 3 * a, 3 * a, 1))
    return torch.stack([t.transpose(1, 2) for t in (q4, k4, v4)], 2).reshape(b, seq, 3 * a)


def _rotated(P, q4, k4, v4, rope: bool, theta: float):
    """q and k rotated, and v, as ``[B, H, Lp, DP]``; the RoPE tables."""
    b, h, seq, d = q4.shape
    lp = -(-seq // S.QT) * S.QT
    cos, sin = S._attn_tables(seq, d, theta, rope, q4.device)
    q, k, v = (torch.empty(b, h, lp, head_pad(d), dtype=torch.float32, device=q4.device)
               for _ in range(3))
    P.qkv_split(_qkv_rows(q4, k4, v4), cos, sin, q, k, v, b, seq, lp, h, d)
    return q, k, v, cos, sin


def flash_forward_fp32(q4, k4, v4, rope: bool, theta: float, stash: bool, prims=None):
    """#6 on fp32 ``[B, H, L, D]`` views (one counted launch): ``(out [B, L,
    H, D], lse [B, H, L] or None)``, the log-sum-exp only with ``stash``."""
    P = S._prims(prims)
    b, h, seq, d = q4.shape
    q, k, v, _, _ = _rotated(P, q4, k4, v4, rope, theta)
    out = torch.empty(b, seq, h * d, dtype=torch.float32, device=q4.device)
    lse = torch.empty(b, h, seq, dtype=torch.float32, device=q4.device) if stash else None
    P.attn_fwd(q, k, v, out, lse, b, h, seq, q.shape[2], d, d ** -0.5, _NO_DROP)
    flash_forward_fp32.launches += 1
    return out.view(b, seq, h, d), lse


def flash_backward_fp32(g, q4, k4, v4, out, lse, rope: bool, theta: float, prims=None):
    """#7 on fp32 rows (one counted launch): ``g`` the cotangent of ``out
    [B, L, H, D]``, the rest as :func:`flash_forward_fp32` took and gave
    them; returns ``(dq, dk, dv)`` as ``[B, H, L, D]`` views of one ``[B, L,
    3, H, D]`` buffer."""
    P = S._prims(prims)
    b, h, seq, d = q4.shape
    dev = q4.device
    q, k, v, cos, sin = _rotated(P, q4, k4, v4, rope, theta)
    lp = q.shape[2]
    dout = g.to(torch.float32).contiguous()
    dop = torch.empty(b, h, lp, q.shape[3], dtype=torch.float32, device=dev)
    delta = torch.empty(b, h, seq, dtype=torch.float32, device=dev)
    dqkv = torch.empty(b, seq, 3 * h * d, dtype=torch.float32, device=dev)
    P.attn_bwd(q, k, v, out, dout, lse, dop, delta, dqkv, cos, sin, b, h, seq, lp, d,
               d ** -0.5, _NO_DROP)
    flash_backward_fp32.launches += 1
    dq, dk, dv = dqkv.view(b, seq, 3, h, d).permute(2, 0, 3, 1, 4)
    return dq, dk, dv


# ---------------------------------------------------------------- FFN core

def tf32_split(t: torch.Tensor):
    """``(hi, lo)`` of fp32 ``t``: ``hi`` rounded to nearest TF32 (ties away
    from zero, as ``cvt.rna``: the low 13 bits of the bit pattern dropped
    after adding half of their weight) and ``lo`` the remainder ``t - hi``
    (exact in fp32) rounded the same way; ``hi + lo`` is ``t`` to within
    2^-21 of ``|t|``."""
    def rna(v):
        return ((v.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)
    hi = rna(t)
    return hi, rna(t - hi)


def split_panel(p: torch.Tensor) -> torch.Tensor:
    """The ``[K, N]`` weight panel ``p`` as ``core_nn`` reads it: a ``[3, N,
    K]`` tensor of ``p^T`` (K-major) and its :func:`tf32_split` halves;
    returns the ``[K, N]`` view of its first slice, so that ``p``'s values
    stand where a GEMM's ``b`` is expected."""
    t = p.T.contiguous()
    return torch.stack([t, *tf32_split(t)])[0].T


def panel_halves(b: torch.Tensor, k: int, n: int):
    """The hi and lo ``[N, K]`` halves of a :func:`split_panel` view ``b``:
    the two ``[N, K]`` slices that follow its values in their storage (read
    from the storage, as views made under ``torch.inference_mode`` keep no
    ``_base``)."""
    base, off = b._base, b.storage_offset()
    if (tuple(b.shape) != (k, n) or b.stride() != (1, k)
            or (base is not None and tuple(base.shape) != (3, n, k))
            or b.untyped_storage().nbytes() < 4 * (off + 3 * n * k)):
        raise ValueError(f"core_nn: b must be a split_panel view of [{k}, {n}]")
    return (b.as_strided((n, k), (k, 1), off + n * k),
            b.as_strided((n, k), (k, 1), off + 2 * n * k))


def core_panels(conv_w, conv_b, deconv_w):
    """``step_fp32.ffn_panels`` of the weights with the inner width zero-
    padded to whole float4s (a padded channel's value, gate and deconv rows
    are 0, so its SwiGLU output is 0 and it adds nothing), the four GEMM
    panels split for the tensor cores (:func:`split_panel`): ``(wc, bc,
    wdf, wd2, w2)``."""
    two_i, c, k = conv_w.shape
    inner = two_i // 2
    pad = -inner % 4
    if pad:
        conv_w = F.pad(conv_w.detach().float().reshape(2, inner, c, k),
                       (0, 0, 0, 0, 0, pad)).reshape(2 * (inner + pad), c, k)
        conv_b = F.pad(conv_b.detach().float().reshape(2, inner), (0, pad)).reshape(-1)
        deconv_w = F.pad(deconv_w.detach().float(), (0, 0, 0, 0, 0, pad))
    wc, bc, wdf, wd2, w2 = S.ffn_panels(conv_w, conv_b, deconv_w)
    return split_panel(wc), bc, split_panel(wdf), split_panel(wd2), split_panel(w2)


# The panels of the weights they were laid out from (``cached_panels``)
_PANELS = WeakIdKeyDictionary()


def _panels(conv_w, conv_b, deconv_w):
    return cached_panels(_PANELS, conv_w, (conv_b, deconv_w),
                         lambda: core_panels(conv_w, conv_b, deconv_w))


class CorePrims:
    """The kernels of ``csrc/ffn_core_fp32.cu`` with ``step_fp32.CudaPrims``'
    ``gemm_nn`` / ``gemm_tn`` / ``colsum`` conventions, launched on the
    current stream: ``core_nn`` (wgmma, 3xTF32) takes every FFN epilogue
    (store, SwiGLU, its backward, the FFN step's output with its residual
    ``res``) and, as ``b``, a :func:`split_panel` view, whose halves it
    reads; ``core_tn`` (mma.sync, 3xTF32) the weight products;
    ``core_colsum`` the bias gradients' column sums.  Every tensor is fp32,
    contiguous and 16-byte aligned."""

    def __init__(self):
        lib = load("ffn_core_fp32")
        u, i, ll, f, vp = (ctypes.c_uint32, ctypes.c_int, ctypes.c_longlong, ctypes.c_float,
                           ctypes.c_void_p)
        win = S._win_types()
        self._nn, self._tn = lib.core_fp32_nn, lib.core_fp32_tn
        self._colsum = lib.core_fp32_colsum
        for fn in (self._nn, self._tn, self._colsum):
            fn.restype = ctypes.c_int
        self._nn.argtypes = ([i] + win + [ll, i, vp, vp, i, vp, ll, vp, vp, vp, ll] + [u] * 4
                             + [f, i, vp])
        self._tn.argtypes = win + [i] + win + [i, ll, i, vp, vp]
        self._colsum.argtypes = win + [i, ll, i, vp, vp]

    def gemm_nn(self, epi, a: S.Win, m, k, b, n, out, ldo, bias=None, y=None, res=None, p=1,
                site=0, drop=(0, 0, 0, 1.0, 0)):
        if res is not None and epi != S.EPI_OUT:
            raise ValueError("core_nn: only the output epilogue takes a residual")
        hi, lo = panel_halves(b, k, n)
        check(self._nn(epi, *S._win_args(a), m, k, ptr(hi), ptr(lo), n, ptr(out), ldo,
                       S._opt(bias), S._opt(y), S._opt(res), p, site, *drop,
                       stream_handle(out.device)), "core_nn")

    def gemm_tn(self, a: S.Win, m, b: S.Win, n, total, splits, part):
        check(self._tn(*S._win_args(a), m, *S._win_args(b), n, total, splits, ptr(part),
                       stream_handle(part.device)), "core_tn")

    def colsum(self, a: S.Win, w, total, splits, part):
        check(self._colsum(*S._win_args(a), w, total, splits, ptr(part),
                           stream_handle(part.device)), "core_colsum")


_CORE = []


def _core_gemms(P):
    """The FFN core's GEMMs and column sums: :class:`CorePrims` beside
    ``step_fp32``'s CUDA prims ``P`` (whose ``reduce`` the chain keeps), or
    ``P``'s own ``gemm_nn`` / ``gemm_tn`` / ``colsum`` when ``P`` is another
    implementation of the kernels (an emulation in plain torch)."""
    if not isinstance(P, S.CudaPrims):
        return P
    if not _CORE:
        _CORE.append(CorePrims())
    return _CORE[0]


def _tn_splits(m: int, n: int, total: int) -> int:
    """Position splits of a ``core_tn`` product: its 128 x 128 tiles about
    four times on the SMs (one block an SM: four waves), at least 256
    positions a split."""
    tiles = -(-m // CORE_BM) * -(-n // CORE_BM)
    return max(1, min(-(-4 * S._SMS // tiles), total // 256, 65535))


def ffn_core_fp32(x, conv_w, conv_b, deconv_w, deconv_b, kernel, drop_rate=0.0, seed=0,
                  row0=0, prims=None, scratch_cap=SCRATCH_CAP):
    """#8 on fp32 pre-padded rows ``x [R, Lin, C]`` (one counted launch):
    ``ConvT1d(drop_inner(SwiGLU(Conv1d(x)))) + b``, the full-length ``[R,
    Lin, C]``."""
    G = _core_gemms(S._prims(prims))
    r, lin, c = x.shape
    k = kernel
    lc = lin - k + 1
    wc, bc, wdf, _, _ = _panels(conv_w, conv_b, deconv_w)
    ip = wc.shape[1] // 2
    bd = deconv_b.detach().to(torch.float32).contiguous()
    rg = core_rows(r, lin, c, ip, k, False, scratch_cap)
    h = torch.empty(rg, lc, ip, dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    for g0 in range(0, r, rg):
        n = min(rg, r - g0)
        drop = D.kernel_args(drop_rate, seed, row0 + g0)
        G.gemm_nn(S.EPI_SWIGLU, S.Win(x[g0:g0 + n], lin * c, lc, c, 0, lin * c), n * lc, k * c,
                  wc, 2 * ip, h, ip, bias=bc, p=lc, site=D.SITE_FFN_INNER, drop=drop)
        G.gemm_nn(S.EPI_STORE, S.Win(h, lc * ip, lin, ip, -(k - 1) * ip, lc * ip), n * lin,
                  k * ip, wdf, c, out[g0:g0 + n], c, bias=bd)
    ffn_core_fp32.launches += 1
    return out


def ffn_core_fp32_backward(g, x, conv_w, conv_b, deconv_w, kernel, drop_rate=0.0, seed=0,
                           row0=0, prims=None, scratch_cap=SCRATCH_CAP):
    """#9 on fp32 rows (one counted launch): ``g`` the cotangent of the full-
    length output; returns ``(dx, dconv_w, dconv_b, ddeconv_w, ddeconv_b)``
    in torch layouts."""
    P = S._prims(prims)
    G = _core_gemms(P)
    r, lin, c = x.shape
    inner, k = deconv_w.shape[0], kernel
    lc = lin - k + 1
    f32 = dict(dtype=torch.float32, device=x.device)
    wc, bc, _, wd2, w2 = _panels(conv_w, conv_b, deconv_w)
    ip = wc.shape[1] // 2
    g = g.to(torch.float32).contiguous()
    rg = core_rows(r, lin, c, ip, k, True, scratch_cap)
    groups = -(-r // rg)
    y, dy = torch.empty(rg, lc, 2 * ip, **f32), torch.empty(rg, lc, 2 * ip, **f32)
    h = torch.empty(rg, lc, ip, **f32)
    s1, s2 = _tn_splits(2 * ip, k * c, rg * lc), _tn_splits(ip, k * c, rg * lc)
    sb, sdb = S._col_splits(rg * lc), S._col_splits(rg * lin)
    pw, pd = torch.empty(groups * s1, 2 * ip, k * c, **f32), \
        torch.empty(groups * s2, ip, k * c, **f32)
    pb, pdb = torch.empty(groups * sb, 2 * ip, **f32), torch.empty(groups * sdb, c, **f32)
    dx = torch.empty_like(x)
    for gi, g0 in enumerate(range(0, r, rg)):
        n = min(rg, r - g0)
        drop = D.kernel_args(drop_rate, seed, row0 + g0)
        xg, gg = x[g0:g0 + n], g[g0:g0 + n]
        xwin = S.Win(xg, lin * c, lc, c, 0, lin * c)
        gwin = S.Win(gg, lin * c, lc, c, 0, lin * c)
        G.gemm_nn(S.EPI_SWIGLU, xwin, n * lc, k * c, wc, 2 * ip, h, ip, bias=bc, y=y, p=lc,
                  site=D.SITE_FFN_INNER, drop=drop)
        G.gemm_nn(S.EPI_SWIGLU_BWD, gwin, n * lc, k * c, wd2, ip, dy, 2 * ip, y=y, p=lc,
                  site=D.SITE_FFN_INNER, drop=drop)
        G.gemm_nn(S.EPI_STORE, S.Win(dy, lc * 2 * ip, lin, 2 * ip, -(k - 1) * 2 * ip,
                                     lc * 2 * ip), n * lin, k * 2 * ip, w2, c, dx[g0:g0 + n], c)
        dyd = S._dense(dy, n * lc, 2 * ip)
        G.gemm_tn(dyd, 2 * ip, xwin, k * c, n * lc, s1, pw[gi * s1:(gi + 1) * s1])
        G.colsum(dyd, 2 * ip, n * lc, sb, pb[gi * sb:(gi + 1) * sb])
        G.gemm_tn(S._dense(h, n * lc, ip), ip, gwin, k * c, n * lc, s2,
                  pd[gi * s2:(gi + 1) * s2])
        G.colsum(S._dense(gg, n * lin, c), c, n * lin, sdb, pdb[gi * sdb:(gi + 1) * sdb])
    red = lambda part, *shape: S._reduce(P, part.reshape(part.shape[0], -1),
                                         torch.empty(*shape, **f32))
    dcw, dcb, ddw = S._unpack_ffn_grads(red(pw, 2 * ip, k * c), red(pb, 2 * ip),
                                        red(pd, ip, k * c), ip, c, k)
    if ip != inner:   # the padded channels' gradients go
        dcw = dcw.reshape(2, ip, c, k)[:, :inner].reshape(2 * inner, c, k)
        dcb = dcb.reshape(2, ip)[:, :inner].reshape(2 * inner)
        ddw = ddw[:inner]
    ffn_core_fp32_backward.launches += 1
    return dx, dcw, dcb, ddw, red(pdb, c)


flash_forward_fp32.launches = 0
flash_backward_fp32.launches = 0
ffn_core_fp32.launches = 0
ffn_core_fp32_backward.launches = 0
