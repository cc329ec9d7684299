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
consults before calling, with the backward's layouts in training); the
inner dimension is zero-padded to 64-channel chunks (8-channel ones in the
backward's weight-gradient kernel).  The backward recomputes conv and
SwiGLU from the saved input and replays the inner mask
(:func:`swiglu_ffn_backward`).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .. import dropout as D
from . import SMEM_OPTIN, check, load, ptr, stream_handle
from .swiglu_block import ffn_panels, inner_mask

__all__ = ["swiglu_conv_deconv", "swiglu_ffn_backward", "SwiGLUCore",
           "reference_swiglu_conv_deconv", "supports_shape", "core_bytes",
           "compiled_core_bytes", "backward_bytes", "compiled_backward_bytes"]

IC = 64          # inner channels per kernel chunk (I is zero-padded to it)
WIC = 8          # inner channels per weight-gradient block of the backward
_M = 64          # conv outputs per kernel tile
MAX_C = 256      # the widths the .cu file instantiates: multiples of 16 up to 256


def core_bytes(c: int) -> int:
    """Dynamic shared memory of the kernel at width ``c`` (any k): the
    ``CoreLay`` of csrc/swiglu_ffn.cu (x rows with halo, h, one conv tap's
    panel, one deconv tap's panel, the chunk's conv bias)."""
    rows = _M + 16
    return (rows * (c + 8) * 2 + rows * (IC + 8) * 2 + c * (2 * IC + 8) * 2
            + IC * (c + 8) * 2 + 2 * IC * 4)


def compiled_core_bytes(c: int) -> int:
    """:func:`core_bytes` as the compiled kernel counts it (needs the built
    library)."""
    fn = load("swiglu_ffn").swiglu_ffn_smem_bytes
    fn.restype = ctypes.c_longlong
    fn.argtypes = [ctypes.c_int]
    return fn(c)


def backward_bytes(c: int, k: int) -> dict:
    """Dynamic shared memory of the backward's kernels at width ``c`` and
    ``k`` taps: ``DxLay`` (x and cotangent rows with halo, one tap's conv
    and deconv panels, the dyvg rows, the chunk's conv bias) and ``WLay``
    (x and cotangent rows, the 8 channels' panels of every tap, two tap
    halves' fp32 partials, dyvg, h, bias) of csrc/swiglu_ffn.cu."""
    rows = _M + 16
    dx = (2 * rows * (c + 8) * 2 + c * (2 * IC + 8) * 2 + IC * (c + 8) * 2
          + rows * (2 * IC + 8) * 2 + 2 * IC * 4)
    w = (2 * rows * (c + 8) * 2 + k * c * (2 * WIC + 8) * 2 + k * WIC * (c + 8) * 2
         + 2 * _M * 3 * WIC * 4 + _M * (2 * WIC + 8) * 2 + _M * WIC * 2 + 2 * WIC * 4)
    return {"dx": dx, "w": w}


def compiled_backward_bytes(c: int, k: int) -> dict:
    """:func:`backward_bytes` as the compiled kernels count it (needs the
    built library)."""
    fn = load("swiglu_ffn").swiglu_ffn_bwd_smem_bytes
    fn.restype = ctypes.c_longlong
    fn.argtypes = [ctypes.c_int] * 3
    return {"dx": fn(c, k, 0), "w": fn(c, k, 1)}


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


def core_forward(x, conv_w, conv_b, deconv_w, deconv_b, kernel, drop_rate=0.0,
                 seed=0, row0=0):
    """One launch of the forward kernel (no autograd)."""
    r, lin, c = x.shape
    wc, bc, wd = ffn_panels(conv_w, conv_b, deconv_w, ic=IC)   # I padded to IC
    bd = deconv_b.to(torch.float32).contiguous()
    out = torch.empty_like(x)
    check(_fn()(ptr(x), ptr(wc), ptr(bc), ptr(wd), ptr(bd), ptr(out), r, lin, c,
                wc.shape[0] * IC, kernel, *D.kernel_args(drop_rate, seed, row0),
                stream_handle(x.device)), "swiglu_ffn")
    swiglu_conv_deconv.launches += 1
    return out


def weight_splits(blocks: int, units: int) -> int:
    """Position splits of the weight-gradient kernel: enough blocks to fill
    the card's 132 SMs about four times over, at least 4 units (64 conv
    positions each) per block."""
    return max(1, min(-(-4 * 132 // blocks), units // 4))


def swiglu_ffn_backward(g, x, conv_w, conv_b, deconv_w, kernel, drop_rate=0.0,
                        seed=0, row0=0):
    """The backward kernels (one counted launch): ``g`` the cotangent of the
    full-length output; returns ``(dx, dconv_w, dconv_b, ddeconv_w,
    ddeconv_b)`` in torch layouts (fp32 for the weights, ``x.dtype`` for
    dx).  The deconv bias's gradient is the cotangent's sum, a torch
    reduction (the JAX package takes it outside its kernel too)."""
    r, lin, c = x.shape
    k = kernel
    inner = deconv_w.shape[0]
    dev = x.device
    g = g.to(x.dtype).contiguous()
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
