"""Train and eval steps (the JAX package's ``train/step.py``).

``train_step`` runs ``accum`` micro-batches forward and backward in
training mode (dropout seeds from the caller's generator), each loss divided
by ``accum`` so the gradients average as the JAX scan does, then clips by
global norm and takes one AdamW step.  The loss dict is the mean over the
micro-batches plus the pre-clip ``grad_norm``; its values stay on the
device (no host sync).  ``eval_step`` with ``weights`` returns the weighted
mean of PER-SAMPLE losses, what chunked validation needs when a group mixes
full chunks with zero-padded tails.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch

from ..core.config import LossConfig
from ..losses.mss_loss import mss_loss
from .state import clip_by_global_norm, set_learning_rate

__all__ = ["train_step", "eval_step"]


def train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
               mixture: torch.Tensor, targets: Mapping[str, torch.Tensor],
               lr: float, generator: torch.Generator, loss_cfg: LossConfig,
               accum: int = 1, gradient_clip: float = 5.0) -> Dict[str, torch.Tensor]:
    """One optimizer step on ``mixture [B, T]`` and ``targets`` of ``[B, T]``;
    B must divide by ``accum``."""
    accum = max(1, accum)
    if mixture.shape[0] % accum:
        raise ValueError(f"batch {mixture.shape[0]} does not divide into {accum} "
                         f"micro-batches")
    micro = mixture.shape[0] // accum
    model.train()
    optimizer.zero_grad(set_to_none=True)
    totals: Dict[str, torch.Tensor] = {}
    for i in range(accum):
        sl = slice(i * micro, (i + 1) * micro)
        preds = model(mixture[sl], generator=generator)
        ld = mss_loss(preds, {k: v[sl] for k, v in targets.items()}, loss_cfg)
        (ld["total_loss"] / accum).backward()
        for k, v in ld.items():
            v = v.detach() / accum
            totals[k] = totals[k] + v if k in totals else v
    params = [p for p in model.parameters() if p.requires_grad]
    totals["grad_norm"] = clip_by_global_norm(params, gradient_clip)
    set_learning_rate(optimizer, lr)
    optimizer.step()
    return totals


@torch.no_grad()
def eval_step(model: torch.nn.Module, mixture: torch.Tensor,
              targets: Mapping[str, torch.Tensor], loss_cfg: LossConfig,
              weights: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """Losses in eval mode: the batch mean, or with ``weights [B]`` the
    weighted mean of per-sample losses."""
    model.eval()
    preds = model(mixture)
    if weights is None:
        return mss_loss(preds, targets, loss_cfg)
    w = weights.to(torch.float32)
    w = w / w.sum()
    out: Dict[str, torch.Tensor] = {}
    for b in range(mixture.shape[0]):
        ld = mss_loss({k: v[b:b + 1] for k, v in preds.items()},
                      {k: v[b:b + 1] for k, v in targets.items()}, loss_cfg)
        for k, v in ld.items():
            out[k] = out[k] + w[b] * v if k in out else w[b] * v
    return out
