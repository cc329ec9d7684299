"""Rotary position embedding, interleaved pairs (the GPT-J convention).

Same convention as the JAX package's ``ops/rope.py`` and
``rotary-embedding-torch`` 0.6.1: inverse frequencies ``theta ** -(2i/d)``
with theta 10000, one angle per *interleaved* (even, odd) pair — not the
half-split convention — angles computed in float64 with numpy, rotation in
fp32.  RoPE has no parameters.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["rope_angles", "apply_rope"]


@functools.lru_cache(maxsize=64)
def _angles_np(seq_len: int, dim: int, theta: float) -> np.ndarray:
    inv_freq = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
    return np.outer(np.arange(seq_len, dtype=np.float64), inv_freq)  # [L, d/2]


def rope_angles(seq_len: int, dim: int, theta: float = 10000.0,
                device=None):
    """cos/sin tables ``[L, d/2]`` (fp32), one angle per interleaved pair."""
    ang = _angles_np(seq_len, dim, float(theta))
    return (torch.from_numpy(np.cos(ang).astype(np.float32)).to(device),
            torch.from_numpy(np.sin(ang).astype(np.float32)).to(device))


def apply_rope(x: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """Rotate ``x [..., L, D]``: positions along -2, pairs along -1.  The
    rotation runs in fp32; the result is cast back to ``x.dtype``."""
    seq_len, dim = x.shape[-2], x.shape[-1]
    cos, sin = rope_angles(seq_len, dim, theta, x.device)
    xf = x.to(torch.float32).unflatten(-1, (dim // 2, 2))
    even, odd = xf[..., 0], xf[..., 1]
    out = torch.stack([even * cos - odd * sin, odd * cos + even * sin], dim=-1)
    return out.flatten(-2).to(x.dtype)
