"""Plain scaled dot-product attention (the JAX package's ``ops/attention.py``
``xla`` and ``chunked`` backends): scores and softmax in fp32, no mask,
probabilities rounded to ``v.dtype`` for the value product.  Dropout on the
probabilities drops after normalising (the denominator is the undropped
sum), as torch's ``scaled_dot_product_attention`` does.

Scores take ``4 * rows * L * L`` bytes (rows: every leading index, heads
included).  Above :data:`MAX_SCORE_BYTES` (1 GiB, the JAX package's
``_DEFAULT_MAX_SCORE_BYTES``) the rows run in groups whose scores fit it, as
``_chunked_attention`` does there: at the xlarge config's freq path the
scores of one call would otherwise take ~185 GB.  Each group builds its own
dropout keep mask (the kernels' Philox at (seed, absolute row, head, key,
query): the same bits as the whole mask of ``probability_mask``), and when
a gradient is asked for each group runs under ``torch.utils.checkpoint``, as
the JAX package's group body runs under ``jax.checkpoint``: the backward
recomputes a group's scores and mask instead of keeping every group's fp32
probabilities.  The fused kernels (the attention step, flash attention)
never materialise scores at all.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from . import dropout as D

__all__ = ["dot_product_attention", "group_keep_mask", "MAX_SCORE_BYTES"]

MAX_SCORE_BYTES = 1 << 30   # live fp32 scores of one group of rows


def group_keep_mask(seed: int, rows: torch.Tensor, n_heads: int, seq: int,
                    f0: int, f1: int, p: float) -> torch.Tensor:
    """Keep mask ``[f1 - f0, L(query), L(key)]`` of the probability site for
    the flattened (row, head) indices ``f0 .. f1 - 1`` of a call whose rows
    have the absolute ids ``rows``."""
    f = torch.arange(f0, f1, device=rows.device)
    ar = torch.arange(seq, device=rows.device)
    return D.keep_mask(seed, D.SITE_ATTN_PROB, rows[f // n_heads][:, None, None],
                       (f % n_heads)[:, None, None], ar[None, None, :],
                       ar[None, :, None], p=p)


def _attention(q, k, v, keep, drop_rate):
    s = torch.einsum("...qd,...kd->...qk", q.float(), k.float()) / math.sqrt(q.shape[-1])
    p = torch.softmax(s, dim=-1)
    if keep is not None:
        p = torch.where(keep, p * (1.0 / (1.0 - drop_rate)), torch.zeros((), device=p.device))
    return torch.einsum("...qk,...kd->...qd", p.to(v.dtype), v).to(v.dtype)


def _group(q, k, v, drop_rate, seed, rows, n_heads, f0):
    # a profiler range (no cost without a profiler), entered again by each
    # recompute: chip_smoke.py reads the plain attention's share of a
    # training step's device time from it
    with torch.profiler.record_function("plain_attention"):
        keep = None
        if drop_rate > 0.0:
            keep = group_keep_mask(seed, rows, n_heads, q.shape[-2], f0, f0 + q.shape[0],
                                   drop_rate)
        return _attention(q, k, v, keep, drop_rate)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          drop_rate: float = 0.0, seed: int = 0,
                          rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``drop(softmax(q k^T / sqrt(D))) v`` over ``[..., L, D]``.  With
    ``drop_rate > 0``, q is ``[R, H, L, D]`` and ``rows`` holds the R rows'
    absolute ids (int64): survivors of the probability site's mask for
    ``seed`` are scaled by ``1 / (1 - drop_rate)``.  Rows are grouped so that
    one group's fp32 scores stay within :data:`MAX_SCORE_BYTES`."""
    *lead, seq, d = q.shape
    n = math.prod(lead)
    n_heads = 1
    if drop_rate > 0.0:
        if q.dim() != 4 or rows is None or rows.numel() != q.shape[0]:
            raise ValueError("dropout needs q [R, H, L, D] and the R rows' ids")
        n_heads = q.shape[1]
        rows = rows.to(q.device)
    group = max(1, min(n, MAX_SCORE_BYTES // (4 * seq * seq)))
    qf, kf, vf = (t.reshape(n, seq, d) for t in (q, k, v))
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    out = []
    for f0 in range(0, n, group):
        args = (qf[f0:f0 + group], kf[f0:f0 + group], vf[f0:f0 + group], drop_rate,
                seed, rows, n_heads, f0)
        out.append(checkpoint(_group, *args, use_reentrant=False) if grad else _group(*args))
    return (out[0] if len(out) == 1 else torch.cat(out)).reshape(*lead, seq, d)
