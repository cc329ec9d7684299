"""Normalisation layers (the JAX package's ``nn/norms.py``).

``RMSGroupNorm``: per position, RMS over channel groups, computed in fp32
whatever the compute dtype, with the reference's ``x / (rms + eps)``
placement of eps.  ``LayerNorm`` over the last dim in fp32.  The
TF-Locoformer encoder's ``GroupNorm(1)`` is ``torch.nn.GroupNorm`` itself
(NCHW there); :class:`GroupNorm` is the same normalisation on channels-last
input (BS-Locoformer's band encoders and decoders).
"""

from __future__ import annotations

import torch
from torch import nn

__all__ = ["RMSGroupNorm", "LayerNorm", "GroupNorm", "rms_group_norm"]


def rms_group_norm(x: torch.Tensor, gamma: torch.Tensor, num_groups: int,
                   eps: float) -> torch.Tensor:
    """fp32 RMSGroupNorm of ``x [..., C]``; the result stays fp32."""
    x32 = x.to(torch.float32)
    g = x32.unflatten(-1, (num_groups, x.shape[-1] // num_groups))
    rms = g.pow(2).sum(-1, keepdim=True).sqrt() * (g.shape[-1] ** -0.5)
    return (g / (rms + eps)).flatten(-2) * gamma.to(torch.float32)


class RMSGroupNorm(nn.Module):
    def __init__(self, num_groups: int, dim: int, eps: float = 1e-8):
        super().__init__()
        if dim % num_groups:
            raise ValueError(f"dim {dim} not divisible by num_groups {num_groups}")
        self.num_groups, self.dim, self.eps = num_groups, dim, eps
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_group_norm(x, self.gamma, self.num_groups, self.eps).to(x.dtype)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = nn.functional.layer_norm(x.to(torch.float32), self.weight.shape,
                                       self.weight, self.bias, self.eps)
        return out.to(x.dtype)


class GroupNorm(nn.Module):
    """``torch.nn.GroupNorm`` on channels-last ``x [B, ...spatial, C]``:
    statistics per sample over (every spatial position, the channels of the
    group), in fp32; the result in ``x.dtype``.  Keys ``weight``, ``bias``."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5):
        super().__init__()
        self.num_groups, self.eps = num_groups, eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = nn.functional.group_norm(x.to(torch.float32).movedim(-1, 1),
                                       self.num_groups, self.weight, self.bias, self.eps)
        return out.movedim(1, -1).to(x.dtype)
