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

Under a mesh (``parallel/mesh.py::activate_mesh``) ``update_step`` takes
this rank's rows of the global batch: after the backward, one all-reduce
over the dp group (a plain all-reduce of the gradients flattened into one
buffer, not DDP) averages the gradients, and a second one the loss dict,
so that the step, the clip and the reported losses are those of the
global batch; under ``mp > 1`` the clip sums the shards' squared norms
over the mp group (``train/state.py::clip_by_global_norm``).
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Union

import torch
import torch.distributed as dist

from ..core.config import LossConfig
from ..losses.mss_loss import mss_loss
from ..parallel.mesh import active_mesh
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
    mesh = active_mesh()
    if mesh is not None and mesh.dp > 1:
        _dp_mean([p.grad for p in params if p.grad is not None], mesh)
        keys = sorted(totals)
        mean = _dp_mean([torch.stack([totals[k].to(torch.float32) for k in keys])], mesh)[0]
        totals = dict(zip(keys, mean.unbind()))
    totals["grad_norm"] = clip_by_global_norm(
        params, gradient_clip, mesh.mp_group if mesh is not None and mesh.mp > 1 else None)
    set_learning_rate(optimizer, lr)
    optimizer.step()
    return totals


def _dp_mean(tensors, mesh):
    """Average ``tensors`` in place over the dp group: one all-reduce of
    them flattened into one buffer per dtype."""
    by_dtype: Dict[torch.dtype, list] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.all_reduce(flat, group=mesh.dp_group)
        flat /= mesh.dp
        for t, v in zip(group, flat.split([t.numel() for t in group])):
            t.copy_(v.view_as(t))
    return tensors


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
