"""Counter-based dropout masks (Philox4x32-10) in plain PyTorch.

The CUDA kernels draw their masks from ``csrc/philox.cuh``; this module
computes the same bits with integer tensor arithmetic, so the plain versions
of the fused steps apply exactly the kernels' masks.  A mask element is
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
           "SITE_ATTN_PROJ", "philox4x32_10", "keep_mask", "keep_threshold",
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


def keep_mask(seed: int, site: int, row, *index, p: float,
              device=None) -> torch.Tensor:
    """Boolean keep mask of dropout rate ``p`` at ``(row, *index)``.

    ``row`` and the index entries are integers or int64 tensors that
    broadcast together; ``index`` is ``(a, b)`` or ``(a, b, c)``.  The mask
    is generated in chunks along the first broadcast dimension, so only the
    boolean result is held at full size."""
    if len(index) not in (2, 3):
        raise ValueError("keep_mask takes (a, b) or (a, b, c) as index")
    thr = keep_threshold(p)
    if device is None:
        device = next((v.device for v in (row, *index)
                       if isinstance(v, torch.Tensor)), torch.device("cpu"))
    parts = [_as_index(v, device) for v in (row, *index)]
    if len(index) == 2:
        parts.append(torch.zeros((), dtype=torch.int64, device=device))
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
