"""FFN-core kernel (``csrc/swiglu_ffn.cu``) and its plain PyTorch version.

Replaces the JAX package's Pallas ``ops/pallas/swiglu_ffn.py::
swiglu_conv_deconv`` (forward ``_forward``):

    ConvTranspose1d(drop_inner(SwiGLU(Conv1d(x)))) + bias

on rows ``x [R, Lin, C]`` already zero-padded with the reference's pad
arithmetic (stride 1: ``k - 1`` on each side), returning the full-length
``[R, Lin, C]`` output; the caller crops and applies the outer dropout.
The inner dropout mask is the FFN-step kernel's (``inner_mask``: absolute
row, conv position, inner channel), so the fused-step and unfused routes
drop the same elements.

Dispatch: a CPU tensor takes :func:`reference_swiglu_conv_deconv` (cuDNN's
convolutions through ``torch.nn.functional`` on the card); a CUDA tensor
launches the kernel or raises.  The kernel takes bf16 rows, C a multiple
of 16 up to 256 and 2 <= k <= 8 (:func:`supports_shape`, which the FFN
module consults before calling); the inner dimension is zero-padded to its
64-channel chunks.  Its backward (TPU kernel #9)
belongs to the training slice of the unfused route (ROADMAP.md, Queue 2):
asking for a gradient through it on the card raises rather than returning a
detached output.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .. import dropout as D
from . import SMEM_OPTIN, check, load, ptr, stream_handle
from .swiglu_block import ffn_panels, inner_mask

__all__ = ["swiglu_conv_deconv", "reference_swiglu_conv_deconv",
           "supports_shape", "core_bytes", "compiled_core_bytes"]

IC = 64          # inner channels per kernel chunk (I is zero-padded to it)
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


def supports_shape(c: int, inner: int, k: int) -> bool:
    """Whether the kernel takes width ``c``, ``inner`` channels and ``k``
    taps (stride 1)."""
    return (c % 16 == 0 and 0 < c <= MAX_C and inner > 0 and 2 <= k <= 8
            and core_bytes(c) <= SMEM_OPTIN)


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
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x,) + params):
        raise NotImplementedError(
            "swiglu_conv_deconv: no backward kernel on the card yet (TPU kernel #9, "
            "the training slice of the unfused route in ROADMAP.md)")


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
    r, lin, c = x.shape
    wc, bc, wd = ffn_panels(conv_w, conv_b, deconv_w, ic=IC)   # I padded to IC
    bd = deconv_b.to(torch.float32).contiguous()
    out = torch.empty_like(x)
    check(_fn()(ptr(x), ptr(wc), ptr(bc), ptr(wd), ptr(bd), ptr(out), r, lin, c,
                wc.shape[0] * IC, kernel, *D.kernel_args(drop_rate, seed, row0),
                stream_handle(x.device)), "swiglu_ffn")
    swiglu_conv_deconv.launches += 1
    return out


swiglu_conv_deconv.launches = 0
