"""Plain scaled dot-product attention (the JAX package's ``ops/attention.py``
``xla`` and ``chunked`` backends): scores and softmax in fp32, no mask,
probabilities rounded to ``v.dtype`` for the value product.  Dropout on the
probabilities drops after normalising (the denominator is the undropped
sum), as torch's ``scaled_dot_product_attention`` does.

Scores take ``4 * rows * L * L`` bytes (rows: every leading index, heads
included).  Above :data:`MAX_SCORE_BYTES` (1 GiB, the JAX package's
``_DEFAULT_MAX_SCORE_BYTES``) the rows run in groups whose scores fit it, as
``_chunked_attention`` does there: at the xlarge config's freq path the
scores of one call would otherwise take ~185 GB.  The fused kernels (the
attention step, flash attention) never materialise scores at all.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ["dot_product_attention", "MAX_SCORE_BYTES"]

MAX_SCORE_BYTES = 1 << 30   # live fp32 scores of one group of rows


def _attention(q, k, v, keep, drop_rate):
    s = torch.einsum("...qd,...kd->...qk", q.float(), k.float()) / math.sqrt(q.shape[-1])
    p = torch.softmax(s, dim=-1)
    if keep is not None:
        p = torch.where(keep, p * (1.0 / (1.0 - drop_rate)), torch.zeros((), device=p.device))
    return torch.einsum("...qk,...kd->...qd", p.to(v.dtype), v).to(v.dtype)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, keep: Optional[torch.Tensor] = None,
                          drop_rate: float = 0.0) -> torch.Tensor:
    """``drop(softmax(q k^T / sqrt(D))) v`` over ``[..., L, D]``; ``keep`` is a
    boolean ``[..., L, L]`` mask of rate ``drop_rate`` (survivors scaled by
    ``1 / (1 - drop_rate)``), or None for no dropout.  Rows are grouped so
    that one group's fp32 scores stay within :data:`MAX_SCORE_BYTES`."""
    *lead, seq, d = q.shape
    rows = math.prod(lead)
    group = max(1, min(rows, MAX_SCORE_BYTES // (4 * seq * seq)))
    if group >= rows:
        return _attention(q, k, v, keep, drop_rate)
    qf, kf, vf = (t.reshape(rows, seq, d) for t in (q, k, v))
    kp = None if keep is None else keep.reshape(rows, seq, seq)
    out = [_attention(qf[r0:r0 + group], kf[r0:r0 + group], vf[r0:r0 + group],
                      None if kp is None else kp[r0:r0 + group], drop_rate)
           for r0 in range(0, rows, group)]
    return torch.cat(out).reshape(*lead, seq, d)
