"""The port's dropout masks worked out again in plain PyTorch.

A frozen copy of the arithmetic of the port's ``ops/dropout.py`` (the
kernels' Philox4x32-10 in ``csrc/philox.cuh``) and of its seed draws, so
that the reference applies the masks the program applies without reading
anything the program made.  A mask element at ``(seed, site, row, a, b,
c)`` is kept when word ``b & 3`` of Philox4x32-10 at counter ``(row, a, b >>
2, c)`` under key ``(seed, site)`` is below ``round((1 - p) 2**32)``.

This version computes each counter once and keeps all four of its words
(the port's plain version computes one counter per element), and forms
the high half of a 32 x 32-bit product from the int64 product, which
wraps modulo 2**64 on every device torch runs on.
"""

from __future__ import annotations

import torch

SITE_FFN_INNER, SITE_FFN_OUTER, SITE_ATTN_PROB, SITE_ATTN_PROJ = 1, 2, 3, 4

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK = 0xFFFFFFFF
CHUNK = 1 << 24          # counters per pass: bounds the int64 temporaries


def draw_seed(generator: torch.Generator) -> int:
    """A step's int32 dropout seed, drawn as the port draws it."""
    return int(torch.randint(0, 2 ** 31 - 1, (1,), generator=generator).item())


def threshold(p: float) -> int:
    if not 0.0 <= p < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {p}")
    return min(int(round((1.0 - p) * 2 ** 32)), 2 ** 32)


def _mulhilo(m: int, x: torch.Tensor):
    prod = x * m
    return (prod >> 32) & _MASK, prod & _MASK


def philox(c0, c1, c2, c3, k0: int, k1: int):
    for i in range(10):
        if i:
            k0 = (k0 + _W0) & _MASK
            k1 = (k1 + _W1) & _MASK
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def keep(seed: int, site: int, rows: torch.Tensor, a_len: int, c_len: int, b_len: int,
         p: float) -> torch.Tensor:
    """Keep mask ``[R, a_len, c_len, b_len]`` (bool) for the absolute rows
    ``rows [R]`` (int64), at index ``a`` along dim 1, ``c`` along dim 2 and
    ``b`` along dim 3."""
    thr = threshold(p)
    dev = rows.device
    b4 = -(-b_len // 4)
    out = torch.empty((rows.numel(), a_len, c_len, b_len), dtype=torch.bool, device=dev)
    per_row = a_len * c_len * b4
    step = max(1, CHUNK // per_row)
    a = torch.arange(a_len, dtype=torch.int64, device=dev).view(1, -1, 1, 1)
    c = torch.arange(c_len, dtype=torch.int64, device=dev).view(1, 1, -1, 1)
    b = torch.arange(b4, dtype=torch.int64, device=dev).view(1, 1, 1, -1)
    for r0 in range(0, rows.numel(), step):
        r = rows[r0:r0 + step].to(torch.int64).view(-1, 1, 1, 1)
        n = r.shape[0]
        shape = (n, a_len, c_len, b4)
        w = philox(r.expand(shape), a.expand(shape), b.expand(shape), c.expand(shape),
                   seed & _MASK, site)
        words = torch.stack(w, dim=-1).reshape(n, a_len, c_len, 4 * b4)[..., :b_len]
        out[r0:r0 + n] = words < thr
    return out
