"""Plain scaled dot-product attention (the JAX package's ``ops/attention.py``
``xla`` backend): scores and softmax in fp32, no mask, probabilities rounded
to ``v.dtype`` for the value product.  Holds ``[..., L, L]`` fp32 scores:
the fused attention-step kernel is the path that never materialises them.
"""

from __future__ import annotations

import math

import torch

__all__ = ["dot_product_attention"]


def dot_product_attention(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor) -> torch.Tensor:
    """``softmax(q k^T / sqrt(D)) v`` over ``[..., L, D]``."""
    s = torch.einsum("...qd,...kd->...qk", q.float(), k.float()) / math.sqrt(q.shape[-1])
    p = torch.softmax(s, dim=-1)
    return torch.einsum("...qk,...kd->...qd", p.to(v.dtype), v).to(v.dtype)
