"""FFN-core kernels (``csrc/swiglu_ffn.cu``), their autograd Function and
their plain PyTorch version.

Replaces the JAX package's Pallas ``ops/pallas/swiglu_ffn.py::
swiglu_conv_deconv`` (forward ``_forward``, TPU kernel #8, and backward
``_backward_pallas``, #9):

    ConvTranspose1d(drop_inner(SwiGLU(Conv1d(x)))) + bias

on rows ``x [R, Lin, C]`` already zero-padded with the reference's pad
arithmetic (stride 1: ``k - 1`` on each side), returning the full-length
``[R, Lin, C]`` output; the caller crops and applies the outer dropout.
The inner dropout mask is the FFN-step kernel's (``inner_mask``: absolute
row, conv position, inner channel), so the fused-step and unfused routes
drop the same elements.

Dispatch: a CPU tensor takes :func:`reference_swiglu_conv_deconv` (cuDNN's
convolutions through ``torch.nn.functional`` on the card; autograd through
it is the backward's plain version); a CUDA tensor runs the kernels through
:class:`SwiGLUCore` or raises.  The kernels take bf16 rows, C a multiple of
16 up to 256 and 2 <= k <= 8 (:func:`supports_shape`, which the FFN module
consults before calling, with the backward's layouts in training).  Two
routes, by width (:func:`hopper_route`): at C 128 and 256 the Hopper
kernels (wgmma, bulk and tensor copies; the inner dimension in 64-channel
chunks forward, 32-channel ones backward, zero-padded to a multiple of
64), whose weight stages the wrapper
lays out in the swizzled order wgmma reads (:func:`wg_forward_panels`,
:func:`wg_backward_panels`) and whose backward runs in row groups that
bound its bf16 scratch (:func:`wg_backward_plan`); at the other widths the
mma.sync kernels (64-channel chunks; 8-channel ones in the backward's
weight-gradient kernel).  The backward recomputes conv and SwiGLU from the
saved input and replays the inner mask (:func:`swiglu_ffn_backward`).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .. import dropout as D
from . import SMEM_OPTIN, check, load, ptr, stream_handle, weight_splits
from .swiglu_block import ffn_panels, inner_mask

__all__ = ["swiglu_conv_deconv", "swiglu_ffn_backward", "SwiGLUCore",
           "reference_swiglu_conv_deconv", "supports_shape", "hopper_route", "core_bytes",
           "compiled_core_bytes", "backward_bytes", "compiled_backward_bytes",
           "wg_bytes", "wg_forward_panels", "wg_backward_panels", "wg_backward_plan",
           "wg_unpack_grads", "SCRATCH_CAP"]

IC = 64          # inner channels per kernel chunk (I is zero-padded to it)
WIC = 8          # inner channels per weight-gradient block of the backward
_M = 64          # conv outputs per kernel tile
MAX_C = 256      # the widths the .cu file instantiates: multiples of 16 up to 256
# The Hopper route (``wgk`` in csrc/swiglu_ffn.cu): its conv stages split C
# into two halves of whole 64-wide swizzle atoms, so it takes C 128 and 256;
# every other width takes the mma.sync kernels.
WG_WIDTHS = (128, 256)
ICH = 32         # inner channels per chunk of the Hopper backward (value and gate each)
FICH = 64        # and of the Hopper forward
WG_M = 128       # conv positions per Hopper block
WG_ROWS = WG_M + 8
SCRATCH_CAP = 1 << 30   # bytes of the Hopper backward's bf16 scratch (dyvg, h)


def hopper_route(c: int) -> bool:
    """Whether width ``c`` takes the Hopper kernels (else the mma.sync ones)."""
    return c in WG_WIDTHS


def _ring_stages(fixed: int, sb: int) -> int:
    n = 8
    while n > 2 and fixed + n * sb + (2 * n + 1) * 8 > SMEM_OPTIN:
        n -= 1
    return n


def wg_bytes(c: int) -> dict:
    """Dynamic shared memory of the Hopper kernels at width ``c``: the
    forward's ``FwdLay`` (1 KB of alignment slack, the x tile with its halo
    as swizzled 128-byte rows, two swizzled h tiles, a ring of 16 KB stages,
    its barriers), the dx kernel's ``DxLay`` (x and cotangent tiles, the
    swizzled dyvg rows, a ring of stages of 64 C bytes) and the weight-
    gradient GEMM's (4 stages of six 64 x 64 boxes)."""
    x = (c // 64) * WG_ROWS * 128
    layouts = {"fwd": (1024 + x + 2 * WG_ROWS * 128, 16384),
               "dx": (1024 + 2 * x + WG_ROWS * 128, 64 * c)}
    out = {}
    for name, (f, sb) in layouts.items():
        n = _ring_stages(f, sb)
        out[name] = f + n * sb + (2 * n + 1) * 8
    out["gemm"] = 1024 + 4 * 6 * 8192 + 8 * 8
    return out


def core_bytes(c: int) -> int:
    """Dynamic shared memory of the forward kernel at width ``c`` (any k):
    the Hopper forward's (:func:`wg_bytes`) at C 128 and 256, else the
    ``CoreLay`` of csrc/swiglu_ffn.cu (x rows with halo, h, one conv tap's
    panel, one deconv tap's panel, the chunk's conv bias)."""
    if hopper_route(c):
        return wg_bytes(c)["fwd"]
    rows = _M + 16
    return (rows * (c + 8) * 2 + rows * (IC + 8) * 2 + c * (2 * IC + 8) * 2
            + IC * (c + 8) * 2 + 2 * IC * 4)


def _wg_bytes_fn():
    fn = load("swiglu_ffn").swiglu_ffn_wg_smem_bytes
    fn.restype = ctypes.c_longlong
    fn.argtypes = [ctypes.c_int] * 2
    return fn


def compiled_core_bytes(c: int) -> int:
    """:func:`core_bytes` as the compiled kernel counts it (needs the built
    library)."""
    if hopper_route(c):
        return _wg_bytes_fn()(c, 0)
    fn = load("swiglu_ffn").swiglu_ffn_smem_bytes
    fn.restype = ctypes.c_longlong
    fn.argtypes = [ctypes.c_int]
    return fn(c)


def backward_bytes(c: int, k: int) -> dict:
    """Dynamic shared memory of the backward's kernels at width ``c`` and
    ``k`` taps: on the Hopper route its dx kernel and weight-gradient GEMM
    (:func:`wg_bytes`); else ``DxLay`` (x and cotangent rows with halo, one
    tap's conv and deconv panels, the dyvg rows, the chunk's conv bias) and
    ``WLay`` (x and cotangent rows, the 8 channels' panels of every tap, two
    tap halves' fp32 partials, dyvg, h, bias) of csrc/swiglu_ffn.cu."""
    if hopper_route(c):
        b = wg_bytes(c)
        return {"dx": b["dx"], "w": b["gemm"]}
    rows = _M + 16
    dx = (2 * rows * (c + 8) * 2 + c * (2 * IC + 8) * 2 + IC * (c + 8) * 2
          + rows * (2 * IC + 8) * 2 + 2 * IC * 4)
    w = (2 * rows * (c + 8) * 2 + k * c * (2 * WIC + 8) * 2 + k * WIC * (c + 8) * 2
         + 2 * _M * 3 * WIC * 4 + _M * (2 * WIC + 8) * 2 + _M * WIC * 2 + 2 * WIC * 4)
    return {"dx": dx, "w": w}


def compiled_backward_bytes(c: int, k: int) -> dict:
    """:func:`backward_bytes` as the compiled kernels count it (needs the
    built library)."""
    if hopper_route(c):
        fn = _wg_bytes_fn()
        return {"dx": fn(c, 1), "w": fn(c, 2)}
    fn = load("swiglu_ffn").swiglu_ffn_bwd_smem_bytes
    fn.restype = ctypes.c_longlong
    fn.argtypes = [ctypes.c_int] * 3
    return {"dx": fn(c, k, 0), "w": fn(c, k, 1)}


def _sw128(t: torch.Tensor) -> torch.Tensor:
    """``[..., N, Kc]`` (Kc a multiple of 64) in the K-major 128-byte-swizzled
    order wgmma reads: ``[..., Kc/64, N, 64]``, the 16-byte chunk j of row n
    stored at chunk j ^ (n % 8)."""
    *lead, n, kc = t.shape
    t = t.reshape(-1, n, kc // 64, 8, 8).movedim(2, 1)          # [B, Kc/64, N, 8, 8]
    rows = torch.arange(n, device=t.device)[:, None]
    src = torch.arange(8, device=t.device)[None, :] ^ (rows % 8)  # chunk j' <- j' ^ (n % 8)
    return t[:, :, rows, src].reshape(*lead, kc // 64, n, 64)


def _wg_pad(conv_w, conv_b, deconv_w, ich=ICH):
    """Weights in fp32 with the inner dimension zero-padded to a multiple of
    64, in chunks of ``ich``: ``w [2, nch, ich, C, k]``, ``b [nch, 2 ich]``
    (value, then gate), ``d [nch, ich, C, k]``."""
    two_i, c, k = conv_w.shape
    inner = two_i // 2
    ip = -(-inner // 64) * 64
    nch = ip // ich
    w = F.pad(conv_w.to(torch.float32).reshape(2, inner, c, k),
              (0, 0, 0, 0, 0, ip - inner)).reshape(2, nch, ich, c, k)
    b = F.pad(conv_b.to(torch.float32).reshape(2, inner), (0, ip - inner))
    b = b.reshape(2, nch, ich).permute(1, 0, 2).reshape(nch, 2 * ich).contiguous()
    d = F.pad(deconv_w.to(torch.float32), (0, 0, 0, 0, 0, ip - inner)).reshape(nch, ich, c, k)
    return w, b, d


def _conv_stages(w):
    """The dx kernel's conv stages, per chunk and tap two ``[64 n = (value |
    gate, i)] x [C/2 k]`` halves: ``[nch, k, 2, 32 C]`` (swizzled)."""
    _, nch, _, c, k = w.shape
    st = w.permute(1, 4, 0, 2, 3).reshape(nch, k, 2 * ICH, 2, c // 2).transpose(2, 3)
    return _sw128(st).reshape(nch, k, 2, 32 * c)


def wg_forward_panels(conv_w, conv_b, deconv_w, dtype=torch.bfloat16):
    """The Hopper forward's weight stages in the order it streams them, each
    ``[128 n] x [64 k]`` (swizzled): per 64-channel chunk, per tap the
    conv's C/64 stages (n = 64 value then 64 gate channels, k = 64 of C),
    then per tap the deconv's C/128 (n = 128 output channels, k = the
    chunk's 64) -> ``([nch, k (C/64 + C/128), 8192], bc [nch, 128] fp32)``."""
    w, b, d = _wg_pad(conv_w, conv_b, deconv_w, FICH)
    nch, _, c, k = d.shape
    conv = w.permute(1, 4, 0, 2, 3).reshape(nch, k, 2 * FICH, c // 64, 64).transpose(2, 3)
    dec = d.permute(0, 3, 2, 1).reshape(nch, k, c // 128, 128, FICH)
    panels = torch.cat([_sw128(conv).reshape(nch, -1, 8192),
                        _sw128(dec).reshape(nch, -1, 8192)], dim=1)
    return panels.to(dtype).contiguous(), b


def wg_backward_panels(conv_w, conv_b, deconv_w, dtype=torch.bfloat16):
    """The Hopper dx kernel's weight stages in the order it streams them:
    per chunk, per tap the conv's two halves and the deconv's adjoint
    ``[32 n = i] x [C k]``, then per tap dx's two ``[C/2 n] x [64 k = (value
    | gate, i)]`` halves -> ``([nch, 5k, 32 C], bc [nch, 64] fp32)``."""
    w, b, d = _wg_pad(conv_w, conv_b, deconv_w)
    nch, _, c, k = d.shape
    dh = _sw128(d.permute(0, 3, 1, 2)).reshape(nch, k, 1, 32 * c)
    front = torch.cat([_conv_stages(w), dh], dim=2).reshape(nch, 3 * k, 32 * c)
    dxs = w.permute(1, 4, 3, 0, 2).reshape(nch, k, 2, c // 2, 2 * ICH)
    dxs = _sw128(dxs).reshape(nch, 2 * k, 32 * c)
    return torch.cat([front, dxs], dim=1).to(dtype).contiguous(), b


def wg_backward_plan(rows: int, lin: int, c: int, inner: int, k: int,
                     scratch_cap: int = SCRATCH_CAP) -> dict:
    """The Hopper backward's plan: the padded inner width, the rows per
    group (the bf16 scratch dyvg [rows, Lin, 2 Ip] and h [rows, Lin, Ip]
    within ``scratch_cap`` bytes), the groups, the weight-gradient GEMM's
    tiles (128 of k C x 256 of its 3 Ip columns) and position splits (about
    four blocks an SM, at least 8 steps of 64 positions a split), and the
    scratch and fp32 partials' bytes."""
    ip = -(-inner // 64) * 64
    per_row = lin * 3 * ip * 2
    group = max(1, min(rows, scratch_cap // per_row))
    tiles = (k * c // 128) * (-(-2 * ip // 256) + -(-ip // 256))
    splits = weight_splits(tiles, group * lin // 64, least=8)
    return {"ip": ip, "rows": group, "groups": -(-rows // group), "tiles": tiles,
            "splits": splits, "scratch_bytes": group * per_row,
            "partial_bytes": splits * (k * c * 3 * ip + 2 * ip) * 4}


def supports_shape(c: int, inner: int, k: int, training: bool = False) -> bool:
    """Whether the kernels take width ``c``, ``inner`` channels and ``k``
    taps (stride 1); in training the backward's layouts must fit too."""
    return (c % 16 == 0 and 0 < c <= MAX_C and inner > 0 and 2 <= k <= 8
            and core_bytes(c) <= SMEM_OPTIN
            and (not training or max(backward_bytes(c, k).values()) <= SMEM_OPTIN))


def reference_swiglu_conv_deconv(x, conv_w, conv_b, deconv_w, deconv_b,
                                 kernel: int, drop_rate: float = 0.0,
                                 seed: int = 0, row0: int = 0):
    """Plain version: the convolutions in ``x.dtype`` through
    ``torch.nn.functional``; ``x [R, Lin, C]`` -> ``[R, Lin, C]``."""
    dt = x.dtype
    inner = deconv_w.shape[0]
    y = F.conv1d(x.transpose(1, 2), conv_w.to(dt), conv_b.to(dt))   # [R, 2I, l1]
    h = y[:, :inner] * F.silu(y[:, inner:])
    if drop_rate > 0.0:
        h = D.apply_mask(h, inner_mask(seed, h, row0, drop_rate), drop_rate)
    z = F.conv_transpose1d(h, deconv_w.to(dt), deconv_b.to(dt))     # [R, C, Lin]
    return z.transpose(1, 2)


def _fn():
    fn = load("swiglu_ffn").swiglu_ffn_forward
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                   + [ctypes.c_uint32] * 3 + [ctypes.c_float, ctypes.c_int,
                                              ctypes.c_void_p])
    return fn


def _bwd_fn():
    fn = load("swiglu_ffn").swiglu_ffn_backward
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 7 + [ctypes.c_uint32] * 3
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    return fn


def _check(x, conv_w, conv_b, deconv_w, deconv_b, kernel):
    r, lin, c = x.shape
    inner = deconv_w.shape[0]
    if x.dtype != torch.bfloat16:
        raise TypeError(f"swiglu_conv_deconv: the CUDA kernel takes bf16 rows, "
                        f"got {x.dtype}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("swiglu_conv_deconv: x must be contiguous and 16-byte aligned")
    if not supports_shape(c, inner, kernel) or lin < kernel:
        raise ValueError(f"swiglu_conv_deconv: unsupported shape C={c} I={inner} "
                         f"k={kernel} Lin={lin}")
    if (conv_w.shape != (2 * inner, c, kernel) or conv_b.shape != (2 * inner,)
            or deconv_w.shape != (inner, c, kernel) or deconv_b.shape != (c,)):
        raise ValueError("swiglu_conv_deconv: weight shapes do not match")
    params = (conv_w, conv_b, deconv_w, deconv_b)
    if any(t.device != x.device for t in params):
        raise ValueError("swiglu_conv_deconv: tensors on different devices")
    if (torch.is_grad_enabled() and any(t.requires_grad for t in (x,) + params)
            and not supports_shape(c, inner, kernel, training=True)):
        raise ValueError(f"swiglu_conv_deconv: the backward kernels do not take "
                         f"C={c} k={kernel} (shared memory)")


def _wg_fwd_fn():
    fn = load("swiglu_ffn").swiglu_ffn_wg_forward
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_uint32] * 3
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    return fn


def _wg_bwd_fn():
    fn = load("swiglu_ffn").swiglu_ffn_wg_backward
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 + [ctypes.c_uint32] * 3
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    return fn


def core_forward(x, conv_w, conv_b, deconv_w, deconv_b, kernel, drop_rate=0.0,
                 seed=0, row0=0):
    """One launch of the forward kernel (no autograd)."""
    r, lin, c = x.shape
    bd = deconv_b.to(torch.float32).contiguous()
    out = torch.empty_like(x)
    args = (*D.kernel_args(drop_rate, seed, row0), stream_handle(x.device))
    if hopper_route(c):
        panels, bc = wg_forward_panels(conv_w, conv_b, deconv_w)
        check(_wg_fwd_fn()(ptr(x), ptr(panels), ptr(bc), ptr(bd), ptr(out), r, lin, c,
                           panels.shape[0] * FICH, kernel, *args), "swiglu_ffn")
    else:
        wc, bc, wd = ffn_panels(conv_w, conv_b, deconv_w, ic=IC)   # I padded to IC
        check(_fn()(ptr(x), ptr(wc), ptr(bc), ptr(wd), ptr(bd), ptr(out), r, lin, c,
                    wc.shape[0] * IC, kernel, *args), "swiglu_ffn")
    swiglu_conv_deconv.launches += 1
    return out


def _wg_backward(g, x, conv_w, conv_b, deconv_w, k, drop_rate, seed, row0, scratch_cap):
    """The Hopper backward: per row group the dx kernel (dx, and dyvg and h
    into the scratch) and the weight-gradient GEMM (fp32 partials per
    position split, accumulated across groups), then the partials summed in
    order of split."""
    r, lin, c = x.shape
    inner = deconv_w.shape[0]
    dev = x.device
    plan = wg_backward_plan(r, lin, c, inner, k, scratch_cap)
    ip, group, splits = plan["ip"], plan["rows"], plan["splits"]
    panels, bc = wg_backward_panels(conv_w, conv_b, deconv_w)
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty_like(x)
    sy = torch.empty(group, lin, 2 * ip, dtype=torch.bfloat16, device=dev)
    sh = torch.empty(group, lin, ip, dtype=torch.bfloat16, device=dev)
    part = torch.empty(splits, k * c, 3 * ip, **f32)
    part_b = torch.empty(splits, 2 * ip, **f32)
    out_w = torch.empty(k, c, 3 * ip, **f32)
    out_b = torch.empty(2 * ip, **f32)
    check(_wg_bwd_fn()(ptr(x), ptr(g), ptr(panels), ptr(bc), ptr(dx), ptr(sy), ptr(sh),
                       ptr(part), ptr(part_b), ptr(out_w), ptr(out_b), r, lin, c, ip, k,
                       group, splits, *D.kernel_args(drop_rate, seed, row0),
                       stream_handle(dev)), "swiglu_ffn_backward")
    return (dx, *wg_unpack_grads(out_w, out_b, inner))


def wg_unpack_grads(out_w, out_b, inner: int, ich: int = ICH):
    """The Hopper GEMM's sums in torch layouts: ``out_w [k, C, 3 Ip]``
    (columns [0, 2 Ip) chunk-major: ``ich`` value then ``ich`` gate
    channels; [2 Ip, 3 Ip) the inner channels) and ``out_b [2 Ip]`` ->
    ``(dconv_w [2I, C, k], dconv_b [2I], ddeconv_w [I, C, k])``."""
    k, c, ip3 = out_w.shape
    ip = ip3 // 3
    nch = ip // ich
    dwc = out_w[:, :, :2 * ip].reshape(k, c, nch, 2, ich).permute(3, 2, 4, 1, 0)
    dconv_w = dwc.reshape(2, ip, c, k)[:, :inner].reshape(2 * inner, c, k)
    dconv_b = out_b.reshape(nch, 2, ich).permute(1, 0, 2).reshape(2, ip)[:, :inner]
    ddeconv_w = out_w[:, :, 2 * ip:].permute(2, 1, 0)[:inner].contiguous()
    return dconv_w, dconv_b.reshape(2 * inner), ddeconv_w


def swiglu_ffn_backward(g, x, conv_w, conv_b, deconv_w, kernel, drop_rate=0.0,
                        seed=0, row0=0, scratch_cap=SCRATCH_CAP):
    """The backward kernels (one counted launch): ``g`` the cotangent of the
    full-length output; returns ``(dx, dconv_w, dconv_b, ddeconv_w,
    ddeconv_b)`` in torch layouts (fp32 for the weights, ``x.dtype`` for
    dx).  The deconv bias's gradient is the cotangent's sum, a torch
    reduction (the JAX package takes it outside its kernel too).
    ``scratch_cap`` bounds the Hopper route's scratch (its row groups)."""
    r, lin, c = x.shape
    k = kernel
    inner = deconv_w.shape[0]
    dev = x.device
    g = g.to(x.dtype).contiguous()
    if hopper_route(c):
        grads = _wg_backward(g, x, conv_w, conv_b, deconv_w, k, drop_rate, seed, row0,
                             scratch_cap)
        swiglu_ffn_backward.launches += 1
        return (*grads, g.to(torch.float32).sum((0, 1)))
    wc, bc, wd = ffn_panels(conv_w, conv_b, deconv_w, ic=IC)
    wc8, bc8, wd8 = ffn_panels(conv_w, conv_b, deconv_w, ic=WIC)
    ncw = wc8.shape[0]
    tg = -(-k // 4)
    units = r * -(-(lin - k + 1) // _M)
    splits = weight_splits(ncw * tg, units)
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty_like(x)
    n_c = k * ncw * c * 2 * WIC
    part_c, part_d = torch.empty(splits, n_c, **f32), torch.empty(splits, n_c // 2, **f32)
    part_b = torch.empty(splits, ncw * 2 * WIC, **f32)
    out_c = torch.empty(k, ncw, c, 2, WIC, **f32)
    out_d = torch.empty(k, ncw, c, WIC, **f32)
    out_b = torch.empty(ncw, 2, WIC, **f32)
    check(_bwd_fn()(ptr(x), ptr(g), ptr(wc), ptr(bc), ptr(wd), ptr(wc8), ptr(bc8),
                    ptr(wd8), ptr(dx), ptr(part_c), ptr(part_d), ptr(part_b),
                    ptr(out_c), ptr(out_d), ptr(out_b), r, lin, c, wc.shape[0] * IC,
                    ncw * WIC, k, splits, *D.kernel_args(drop_rate, seed, row0),
                    stream_handle(dev)), "swiglu_ffn_backward")
    swiglu_ffn_backward.launches += 1
    # [K, I8/8, C, (value | gate), 8] -> [2I, C, K]; [K, I8/8, C, 8] -> [I, C, K]
    halves = out_c.permute(3, 1, 4, 2, 0).reshape(2, ncw * WIC, c, k)[:, :inner]
    dconv_w = halves.reshape(2 * inner, c, k)
    dconv_b = out_b.permute(1, 0, 2).reshape(2, ncw * WIC)[:, :inner].reshape(2 * inner)
    ddeconv_w = out_d.permute(1, 3, 2, 0).reshape(ncw * WIC, c, k)[:inner].contiguous()
    ddeconv_b = g.to(torch.float32).sum((0, 1))
    return dx, dconv_w, dconv_b, ddeconv_w, ddeconv_b


class SwiGLUCore(torch.autograd.Function):
    """The FFN core through its kernels: the forward kernel, and the
    backward kernels, which recompute from the saved input and weights."""

    @staticmethod
    def forward(ctx, x, conv_w, conv_b, deconv_w, deconv_b, kernel, drop_rate, seed,
                row0):
        ctx.args = (kernel, drop_rate, seed, row0)
        ctx.bias_dtype = deconv_b.dtype
        ctx.save_for_backward(x, conv_w, conv_b, deconv_w)
        return core_forward(x, conv_w, conv_b, deconv_w, deconv_b, kernel, drop_rate,
                            seed, row0)

    @staticmethod
    def backward(ctx, g):
        x, conv_w, conv_b, deconv_w = ctx.saved_tensors
        dx, dcw, dcb, ddw, ddb = swiglu_ffn_backward(g, x, conv_w, conv_b, deconv_w,
                                                     *ctx.args)
        return (dx, dcw.to(conv_w.dtype), dcb.to(conv_b.dtype), ddw.to(deconv_w.dtype),
                ddb.to(ctx.bias_dtype), None, None, None, None)


def swiglu_conv_deconv(x, conv_w, conv_b, deconv_w, deconv_b, kernel: int,
                       drop_rate: float = 0.0, seed: int = 0, row0: int = 0):
    """``x [R, Lin, C]`` (pre-padded) -> the full-length stride-1 deconv
    output plus bias ``[R, Lin, C]``; weights in torch layouts (``conv_w
    [2I, C, k]`` value half first, ``deconv_w [I, C, k]``); ``seed`` an int32
    drawn per call, ``row0`` the absolute row of ``x[0]``.  The JAX
    ``swiglu_conv_deconv`` contract."""
    if x.device.type == "cpu":
        return reference_swiglu_conv_deconv(x, conv_w, conv_b, deconv_w, deconv_b,
                                            kernel, drop_rate, seed, row0)
    if x.device.type != "cuda":
        raise ValueError(f"swiglu_conv_deconv: unsupported device {x.device}")
    _check(x, conv_w, conv_b, deconv_w, deconv_b, kernel)
    return SwiGLUCore.apply(x, conv_w, conv_b, deconv_w, deconv_b, kernel,
                            float(drop_rate), int(seed), int(row0))


swiglu_conv_deconv.launches = 0
swiglu_ffn_backward.launches = 0
