"""Counter-based dropout masks (Philox4x32-10) in plain PyTorch.

The CUDA kernels draw their masks from ``csrc/philox.cuh``; this module
computes the same bits with integer tensor arithmetic, so the plain versions
of the fused steps apply exactly the kernels' masks.  On the card
:func:`keep_mask` launches the mask kernel (``csrc/dropout.cu``, the same
bits again): the torch version takes ~220 int64 elementwise passes per
element, far too slow for the unfused route's masks at the xlarge config.  A mask element is
addressed by ``(seed, site, row, *index)`` with ``index = (a, b)`` or
``(a, b, c)``:

    key = (seed, site),  counter = (row, a, b >> 2, c),  word = b & 3,
    keep = word < round((1 - p) * 2**32)

Masks depend on the absolute row, so a call on rows ``[r0, r1)`` (passing
``row0 = r0``) gives the same masks as those rows of a full call, and a
backward regenerates the forward's masks without storing them.  Survivors
are scaled by ``1 / (1 - p)`` by the caller.

The JAX package draws its masks from the TPU's own generator
(``pltpu.prng_*``), whose bits cannot be matched: the port is compared with
it at dropout 0 only.
"""

from __future__ import annotations

import torch

__all__ = ["SITE_FFN_INNER", "SITE_FFN_OUTER", "SITE_ATTN_PROB",
           "SITE_ATTN_PROJ", "philox4x32_10", "keep_mask", "reference_keep_mask",
           "keep_threshold",
           "draw_seed", "row_mask", "apply_mask", "kernel_args"]

# the constants of csrc/philox.cuh
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK = 0xFFFFFFFF
SITE_FFN_INNER, SITE_FFN_OUTER, SITE_ATTN_PROB, SITE_ATTN_PROJ = 1, 2, 3, 4

# elements per chunk of mask generation: bounds the int64 temporaries
_CHUNK = 1 << 24


def keep_threshold(p: float) -> int:
    """The unsigned 32-bit keep threshold ``round((1 - p) * 2**32)``."""
    if not 0.0 <= p < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {p}")
    return min(int(round((1.0 - p) * 2 ** 32)), 2 ** 32)


def draw_seed(generator: torch.Generator) -> int:
    """A fresh non-negative int32 seed from a caller-owned generator."""
    return int(torch.randint(0, 2 ** 31 - 1, (1,), generator=generator).item())


def _mulhilo(m: int, x: torch.Tensor):
    """``(hi, lo)`` 32-bit halves of ``m * x`` for a 32-bit constant ``m``
    and int64 ``x`` in [0, 2**32), without leaving int64's range."""
    p_lo = x * (m & 0xFFFF)            # < 2**48
    p_hi = x * (m >> 16)               # < 2**48
    s = p_lo + ((p_hi & 0xFFFF) << 16)  # < 2**49
    return (s >> 32) + (p_hi >> 16), s & _MASK


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 of int64 counter tensors (values in [0, 2**32)) under
    the key ``(k0, k1)``; returns the four output words as int64 tensors."""
    for i in range(10):
        if i:
            k0 = (k0 + _W0) & _MASK
            k1 = (k1 + _W1) & _MASK
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _as_index(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.int64, device=device)


def _keep(seed, site, row, a, b, c, thr):
    c0, c1, c2, c3 = torch.broadcast_tensors(row, a, b >> 2, c)
    w = philox4x32_10(c0, c1, c2, c3, seed & _MASK, site)
    lane = b & 3
    word = torch.where(lane == 0, w[0], torch.where(
        lane == 1, w[1], torch.where(lane == 2, w[2], w[3])))
    return word < thr


def _index_parts(row, index, device):
    if len(index) not in (2, 3):
        raise ValueError("keep_mask takes (a, b) or (a, b, c) as index")
    if device is None:
        device = next((v.device for v in (row, *index)
                       if isinstance(v, torch.Tensor)), torch.device("cpu"))
    parts = [row, *index]
    if len(index) == 2:
        parts.append(0)
    return parts, torch.device(device)


def reference_keep_mask(seed: int, site: int, row, *index, p: float,
                        device=None) -> torch.Tensor:
    """Plain version of :func:`keep_mask` (torch integer arithmetic, on any
    device), generated in chunks along the first broadcast dimension so
    that only the boolean result is held at full size."""
    thr = keep_threshold(p)
    parts, device = _index_parts(row, index, device)
    parts = [_as_index(v, device) for v in parts]
    shape = torch.broadcast_shapes(*(t.shape for t in parts))
    if len(shape) == 0 or torch.Size(shape).numel() <= _CHUNK:
        return _keep(seed, site, *parts, thr).expand(shape)
    per = max(1, torch.Size(shape[1:]).numel())
    step = max(1, _CHUNK // per)
    parts = [t.reshape((1,) * (len(shape) - t.dim()) + tuple(t.shape)) for t in parts]
    out = torch.empty(shape, dtype=torch.bool, device=device)
    for i in range(0, shape[0], step):
        sl = [t[i:i + step] if t.shape[0] > 1 else t for t in parts]
        out[i:i + step] = _keep(seed, site, *sl, thr)
    return out


def _mask_fn():
    import ctypes
    from .cuda import load
    fn = load("dropout").dropout_keep_mask
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 7
                   + [ctypes.c_uint32] * 3 + [ctypes.c_void_p])
    return fn


def _cuda_keep_mask(seed, site, parts, device, thr) -> torch.Tensor:
    """The mask kernel (``csrc/dropout.cu``): each counter word a constant or
    a table along one axis of the mask."""
    import ctypes
    from .cuda import check, ptr, stream_handle
    shapes = [tuple(v.shape) if isinstance(v, torch.Tensor) else () for v in parts]
    shape = tuple(torch.broadcast_shapes(*shapes))
    nd = len(shape)
    if not 1 <= nd <= 4:
        raise ValueError(f"keep_mask: the CUDA kernel takes 1 to 4 dims, got {shape}")
    tabs, axes, csts = [], (ctypes.c_int * 4)(), (ctypes.c_longlong * 4)()
    for j, v in enumerate(parts):
        if not isinstance(v, torch.Tensor) or v.numel() == 1:
            tabs.append(None)
            axes[j] = -1
            csts[j] = int(v)
            continue
        full = (1,) * (nd - v.dim()) + tuple(v.shape)
        live = [d for d in range(nd) if full[d] != 1]
        if len(live) != 1:
            raise ValueError(f"keep_mask: the CUDA kernel takes each index along one "
                             f"axis, got a {tuple(v.shape)} index for a {shape} mask")
        tabs.append(v.to(device=device, dtype=torch.int64).reshape(-1).contiguous())
        axes[j] = live[0]
    out = torch.empty(shape, dtype=torch.bool, device=device)
    size = (ctypes.c_longlong * 4)(*shape, *([1] * (4 - nd)))
    check(_mask_fn()(ptr(out), nd, ctypes.cast(size, ctypes.c_void_p),
                     *(None if t is None else ptr(t) for t in tabs),
                     ctypes.cast(axes, ctypes.c_void_p), ctypes.cast(csts, ctypes.c_void_p),
                     seed & _MASK, site, min(thr, _MASK), stream_handle(device)),
          "dropout_keep_mask")
    keep_mask.launches += 1
    return out


def keep_mask(seed: int, site: int, row, *index, p: float,
              device=None) -> torch.Tensor:
    """Boolean keep mask of dropout rate ``p`` at ``(row, *index)``.

    ``row`` and the index entries are integers or int64 tensors that
    broadcast together; ``index`` is ``(a, b)`` or ``(a, b, c)``.  On the
    CPU the plain version (:func:`reference_keep_mask`) computes it; on the
    card the mask kernel, which takes each index as a constant or a tensor
    along one axis of the mask."""
    parts, device = _index_parts(row, index, device)
    if device.type == "cpu":
        return reference_keep_mask(seed, site, row, *index, p=p, device=device)
    if device.type != "cuda":
        raise ValueError(f"keep_mask: unsupported device {device}")
    return _cuda_keep_mask(seed, site, parts, device, keep_threshold(p))


keep_mask.launches = 0


def row_mask(seed: int, site: int, x: torch.Tensor, row0: int, p: float) -> torch.Tensor:
    """Keep mask of a ``[R, L, C]`` site at (absolute row, position, channel)."""
    r, seq, c = x.shape
    dev = x.device
    return keep_mask(seed, site, torch.arange(row0, row0 + r, device=dev)[:, None, None],
                     torch.arange(seq, device=dev)[None, :, None],
                     torch.arange(c, device=dev)[None, None], p=p)


def apply_mask(t: torch.Tensor, keep: torch.Tensor, p: float) -> torch.Tensor:
    """Survivors scaled by ``1 / (1 - p)``, the rest zero."""
    return torch.where(keep, t * (1.0 / (1.0 - p)),
                       torch.zeros((), dtype=t.dtype, device=t.device))


def kernel_args(p: float, seed: int, row0: int):
    """The CUDA kernels' dropout arguments: seed, keep threshold (capped to
    32 bits), absolute row of the first row, ``1 / (1 - p)``, on (0 at
    ``p = 0``: no mask, no scale)."""
    if p <= 0.0:
        return (0, 0, row0, 1.0, 0)
    return (seed & _MASK, min(keep_threshold(p), _MASK), row0, 1.0 / (1.0 - p), 1)
