"""Train and eval steps (the JAX package's ``train/step.py``).

``update_step`` is the optimizer step every trainer shares (the JAX
``make_update_step``; the speech trainer's step is ``train/speech.py``):
it runs ``accum`` micro-batches forward and backward in
training mode (dropout seeds from the caller's generator), each loss divided
by ``accum`` so the gradients average as the JAX scan does, then clips by
global norm and takes one AdamW step.  The loss dict is the mean over the
micro-batches plus the pre-clip ``grad_norm``; its values stay on the
device (no host sync).  ``eval_step`` with ``weights`` returns the weighted
mean of PER-SAMPLE losses, what chunked validation needs when a group mixes
full chunks with zero-padded tails.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Union

import torch

from ..core.config import LossConfig
from ..losses.mss_loss import mss_loss
from .state import clip_by_global_norm, set_learning_rate

__all__ = ["update_step", "train_step", "eval_step"]

Targets = Union[torch.Tensor, Mapping[str, torch.Tensor]]


def update_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                loss_of: Callable[[torch.Tensor, Targets], Dict[str, torch.Tensor]],
                mixture: torch.Tensor, targets: Targets, lr: float, accum: int = 1,
                gradient_clip: float = 5.0) -> Dict[str, torch.Tensor]:
    """One optimizer step: ``loss_of(mixture, targets)`` (a loss dict whose
    ``total_loss`` is minimised) on each micro-batch of the leading axis of
    ``mixture`` and ``targets`` (a tensor or a dict of tensors); B must
    divide by ``accum``."""
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
        tgt = ({k: v[sl] for k, v in targets.items()} if isinstance(targets, Mapping)
               else targets[sl])
        ld = loss_of(mixture[sl], tgt)
        (ld["total_loss"] / accum).backward()
        for k, v in ld.items():
            v = v.detach() / accum
            totals[k] = totals[k] + v if k in totals else v
    params = [p for p in model.parameters() if p.requires_grad]
    totals["grad_norm"] = clip_by_global_norm(params, gradient_clip)
    set_learning_rate(optimizer, lr)
    optimizer.step()
    return totals


def train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
               mixture: torch.Tensor, targets: Mapping[str, torch.Tensor],
               lr: float, generator: torch.Generator, loss_cfg: LossConfig,
               accum: int = 1, gradient_clip: float = 5.0) -> Dict[str, torch.Tensor]:
    """One optimizer step of the MSS loss on ``mixture [B, (2,) T]`` and
    ``targets`` of the same layout; B must divide by ``accum``."""
    return update_step(model, optimizer,
                       lambda mix, tgt: mss_loss(model(mix, generator=generator), tgt,
                                                 loss_cfg),
                       mixture, targets, lr, accum, gradient_clip)


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
