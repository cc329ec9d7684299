"""Plain scaled dot-product attention (the JAX package's ``ops/attention.py``
``xla`` backend): scores and softmax in fp32, no mask, probabilities rounded
to ``v.dtype`` for the value product.  Holds ``[..., L, L]`` fp32 scores:
the fused attention-step kernel is the path that never materialises them.
Dropout on the probabilities drops after normalising (the denominator is the
undropped sum), as torch's ``scaled_dot_product_attention`` does.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ["dot_product_attention"]


def dot_product_attention(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, keep: Optional[torch.Tensor] = None,
                          drop_rate: float = 0.0) -> torch.Tensor:
    """``drop(softmax(q k^T / sqrt(D))) v`` over ``[..., L, D]``; ``keep`` is a
    boolean ``[..., L, L]`` mask of rate ``drop_rate`` (survivors scaled by
    ``1 / (1 - drop_rate)``), or None for no dropout."""
    s = torch.einsum("...qd,...kd->...qk", q.float(), k.float()) / math.sqrt(q.shape[-1])
    p = torch.softmax(s, dim=-1)
    if keep is not None:
        p = torch.where(keep, p * (1.0 / (1.0 - drop_rate)), torch.zeros((), device=p.device))
    return torch.einsum("...qk,...kd->...qd", p.to(v.dtype), v).to(v.dtype)
