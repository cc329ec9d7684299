"""fp32 rows of the unfused route's kernels: flash attention (#6, #7) and the
FFN core (#8, #9), on the kernels of ``csrc/step_fp32.cu``.

The JAX package runs its Pallas flash-attention and FFN-core kernels in the
compute dtype, fp32 included (``nn/attention.py:146-157``,
``nn/ffn.py:163-170``; the kernels size their blocks by the itemsize), so
``--precision fp32`` serving and ``use_amp: false`` training of the xlarge,
small and LayerNorm configs run them at fp32.  The bf16 kernels
(``flash_attention.cu``, ``swiglu_ffn.cu``) keep bf16 rows; an fp32 CUDA
tensor given to ``flash_attention`` or ``swiglu_conv_deconv`` comes here,
and nothing casts it to bf16.  Same contracts as the bf16 kernels, with fp32
operands and fp32 sums throughout: fp32 FFMA, no tensor cores (TF32 would
round operands to 10 mantissa bits).

Each kernel is a chain of launches of ``csrc/step_fp32.cu`` through device
memory, on the pieces of the fused steps' fp32 rows (``step_fp32.py``):

* Flash forward (#6): ``qkv_split`` reads the ``[B, L, 3, H, D]`` QKV
  product that the ``[B, H, L, D]`` views of q, k and v come from (a copy
  is made only for other views) and writes q and k rotated by RoPE, and v,
  as ``[B, H, Lp, DP]`` (D zero-padded to DP = 16, 32 or 64; Lp a multiple
  of 64); ``attn_fwd`` (one thread per query, 16-key steps of an online
  softmax in expf) writes o ``[B, L, H, D]`` and, with a gradient, the
  natural log-sum-exp ``[B, H, L]``.
* Flash backward (#7): ``qkv_split`` again (nothing rotated is kept), then
  ``attn_dq`` (delta = do . o and dq, one thread per query) and
  ``attn_dkdv`` (one thread per key), P recomputed from the log-sum-exp, dq
  and dk rotated back in their epilogues, into one ``[B, L, 3, H, D]``
  buffer whose ``[B, H, L, D]`` views are the gradients.
* FFN core forward (#8), per row group: the conv as ``gemm_nn`` on windows
  of ``k C`` consecutive floats of the pre-padded rows with the SwiGLU
  epilogue (the inner mask at ``inner_mask``'s coordinates), then the
  deconv as ``gemm_nn`` on windows of the SwiGLU output (``k - 1`` zero
  positions before it, none stored) with the bias; no norm, no residual, no
  outer mask: the caller crops and applies the outer site.
* FFN core backward (#9), per row group: the conv again keeping the pre-
  activation, dh by the transposed deconv with the SwiGLU backward in its
  epilogue, dx by the transposed conv, and the weight and bias gradients as
  per-split partials (``gemm_tn``, ``colsum``), summed in a fixed order
  (``reduce``) once every group has run.

The inner width is zero-padded to whole float4s in the weight panels, so
every inner width runs.  Each kernel counts one launch per call on its own
function (:func:`flash_forward_fp32`, :func:`flash_backward_fp32`,
:func:`ffn_core_fp32`, :func:`ffn_core_fp32_backward`), not on the bf16
kernels' counts.  The chains run on ``prims`` (``step_fp32.CudaPrims`` by
default); a test hands them the kernels' arithmetic in plain torch.

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
from . import SMEM_OPTIN, cached_panels, load
from . import step_fp32 as S

__all__ = ["MAX_HEAD_DIM", "SCRATCH_CAP", "head_pad", "flash_launch_bytes",
           "compiled_flash_launch_bytes", "core_launch_bytes", "supports_flash",
           "supports_core", "core_rows", "core_panels", "flash_forward_fp32",
           "flash_backward_fp32", "ffn_core_fp32", "ffn_core_fp32_backward"]

MAX_HEAD_DIM = 64           # as the bf16 kernels: even head dims up to 64
SCRATCH_CAP = 1 << 30       # bytes of fp32 scratch per FFN-core row group
_NO_DROP = D.kernel_args(0.0, 0, 0)   # a dropout request never reaches flash attention


def head_pad(d: int) -> int:
    """The instantiation a head_dim ``d`` runs at: D zero-padded to 16, 32
    or 64."""
    return 16 if d <= 16 else 32 if d <= 32 else 64


def flash_launch_bytes(d: int) -> dict:
    """Shared memory of the flash launches at head_dim ``d`` (csrc/
    step_fp32.cu): ``attn_fwd`` / ``attn_dq`` stage 64 keys of k and v,
    ``attn_dkdv`` 64 queries of q and do with their log-sum-exp and delta,
    ``DP`` floats a row."""
    dp = head_pad(d)
    return {"attn": 2 * S.QT * dp * 4, "dkdv": 2 * S.QT * dp * 4 + 2 * S.QT * 4}


def compiled_flash_launch_bytes(d: int) -> dict:
    """:func:`flash_launch_bytes` as the compiled kernels count them."""
    fn = load("step_fp32").f32_attn_smem_bytes
    fn.restype = ctypes.c_longlong
    fn.argtypes = [ctypes.c_int] * 2
    return {"attn": fn(0, head_pad(d)), "dkdv": fn(1, head_pad(d))}


def core_launch_bytes() -> dict:
    """Shared memory of the FFN core's launches: the GEMMs' (``gemm_nn``,
    ``gemm_tn``: two 8-deep stages of a 128 x 64 tile); ``colsum`` and
    ``reduce`` take none."""
    return {"gemm": S.launch_bytes(0)["gemm"]}


def supports_flash(d: int) -> bool:
    """The fp32 flash gate: an even head_dim up to :data:`MAX_HEAD_DIM` (every
    one the bf16 kernels take) and layouts within :data:`SMEM_OPTIN`."""
    return (d % 2 == 0 and 0 < d <= MAX_HEAD_DIM
            and max(flash_launch_bytes(d).values()) <= SMEM_OPTIN)


def supports_core(c: int, inner: int, k: int, training: bool = False) -> bool:
    """The fp32 FFN-core gate: a width of whole float4s (the GEMMs' windows
    load 4 channels at a time), any inner width (padded in the panels),
    2 <= k <= 8 as the bf16 kernels, and layouts within :data:`SMEM_OPTIN`
    (the backward's launches are the forward's, so training changes
    nothing)."""
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

def core_panels(conv_w, conv_b, deconv_w):
    """``step_fp32.ffn_panels`` of the weights with the inner width zero-
    padded to whole float4s (a padded channel's value, gate and deconv rows
    are 0, so its SwiGLU output is 0 and it adds nothing)."""
    two_i, c, k = conv_w.shape
    inner = two_i // 2
    pad = -inner % 4
    if pad:
        conv_w = F.pad(conv_w.detach().float().reshape(2, inner, c, k),
                       (0, 0, 0, 0, 0, pad)).reshape(2 * (inner + pad), c, k)
        conv_b = F.pad(conv_b.detach().float().reshape(2, inner), (0, pad)).reshape(-1)
        deconv_w = F.pad(deconv_w.detach().float(), (0, 0, 0, 0, 0, pad))
    return S.ffn_panels(conv_w, conv_b, deconv_w)


# The panels of the weights they were laid out from (``cached_panels``)
_PANELS = WeakIdKeyDictionary()


def _panels(conv_w, conv_b, deconv_w):
    return cached_panels(_PANELS, conv_w, (conv_b, deconv_w),
                         lambda: core_panels(conv_w, conv_b, deconv_w))


def ffn_core_fp32(x, conv_w, conv_b, deconv_w, deconv_b, kernel, drop_rate=0.0, seed=0,
                  row0=0, prims=None, scratch_cap=SCRATCH_CAP):
    """#8 on fp32 pre-padded rows ``x [R, Lin, C]`` (one counted launch):
    ``ConvT1d(drop_inner(SwiGLU(Conv1d(x)))) + b``, the full-length ``[R,
    Lin, C]``."""
    P = S._prims(prims)
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
        P.gemm_nn(S.EPI_SWIGLU, S.Win(x[g0:g0 + n], lin * c, lc, c, 0, lin * c), n * lc, k * c,
                  wc, 2 * ip, h, ip, bias=bc, p=lc, site=D.SITE_FFN_INNER, drop=drop)
        P.gemm_nn(S.EPI_STORE, S.Win(h, lc * ip, lin, ip, -(k - 1) * ip, lc * ip), n * lin,
                  k * ip, wdf, c, out[g0:g0 + n], c, bias=bd)
    ffn_core_fp32.launches += 1
    return out


def ffn_core_fp32_backward(g, x, conv_w, conv_b, deconv_w, kernel, drop_rate=0.0, seed=0,
                           row0=0, prims=None, scratch_cap=SCRATCH_CAP):
    """#9 on fp32 rows (one counted launch): ``g`` the cotangent of the full-
    length output; returns ``(dx, dconv_w, dconv_b, ddeconv_w, ddeconv_b)``
    in torch layouts."""
    P = S._prims(prims)
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
    s1, s2 = S._splits(2 * ip, k * c, rg * lc), S._splits(ip, k * c, rg * lc)
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
        P.gemm_nn(S.EPI_SWIGLU, xwin, n * lc, k * c, wc, 2 * ip, h, ip, bias=bc, y=y, p=lc,
                  site=D.SITE_FFN_INNER, drop=drop)
        P.gemm_nn(S.EPI_SWIGLU_BWD, gwin, n * lc, k * c, wd2, ip, dy, 2 * ip, y=y, p=lc,
                  site=D.SITE_FFN_INNER, drop=drop)
        P.gemm_nn(S.EPI_STORE, S.Win(dy, lc * 2 * ip, lin, 2 * ip, -(k - 1) * 2 * ip,
                                     lc * 2 * ip), n * lin, k * 2 * ip, w2, c, dx[g0:g0 + n], c)
        dyd = S._dense(dy, n * lc, 2 * ip)
        P.gemm_tn(dyd, 2 * ip, xwin, k * c, n * lc, s1, pw[gi * s1:(gi + 1) * s1])
        P.colsum(dyd, 2 * ip, n * lc, sb, pb[gi * sb:(gi + 1) * sb])
        P.gemm_tn(S._dense(h, n * lc, ip), ip, gwin, k * c, n * lc, s2,
                  pd[gi * s2:(gi + 1) * s2])
        P.colsum(S._dense(gg, n * lin, c), c, n * lin, sdb, pdb[gi * sdb:(gi + 1) * sdb])
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
