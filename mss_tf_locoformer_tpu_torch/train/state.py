"""Optimizer, clipping and the learning-rate controller (the JAX package's
``train/state.py``): ``torch.optim.AdamW`` with the config's lr, betas, eps
and weight decay on every parameter (as ``optax.adamw``), global-norm
clipping with optax's rule, and the learning rate set from the host-side
controller (warmup x plateau scale) before each update."""

from __future__ import annotations

from typing import Iterable

import torch
import torch.distributed as dist

from ..core.config import TrainingConfig
from .schedule import ReduceLROnPlateau

__all__ = ["make_optimizer", "set_learning_rate", "clip_by_global_norm",
           "LRController"]


def make_optimizer(params: Iterable[torch.nn.Parameter],
                   train_cfg: TrainingConfig) -> torch.optim.AdamW:
    opt = train_cfg.optimizer
    if opt.type.lower() != "adamw":
        raise ValueError(f"Unsupported optimizer type: {opt.type}")
    return torch.optim.AdamW(list(params), lr=opt.lr, betas=tuple(opt.betas),
                             eps=opt.eps, weight_decay=opt.weight_decay)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


def clip_by_global_norm(params, max_norm: float, mp_group=None) -> torch.Tensor:
    """Scale every gradient by ``max_norm / norm`` when the global norm
    exceeds ``max_norm`` (``optax.clip_by_global_norm``: no epsilon added to
    the norm, unlike ``torch.nn.utils.clip_grad_norm_``).  Returns the
    pre-clip norm as a 0-d fp32 tensor, without a host sync.

    With ``mp_group`` (a tensor-parallel run), the parameters that hold a
    shard (``tp_axis``, ``parallel/sharding.py``) add their squared norms
    over the group, and the whole ones count once, so that the norm and
    the clip are the single-process ones."""
    params = [p for p in params if p.grad is not None]
    grads = [p.grad for p in params]
    norms = torch.stack([torch.linalg.vector_norm(g.to(torch.float32)) for g in grads])
    if mp_group is None:
        norm = torch.linalg.vector_norm(norms)
    else:
        split = torch.tensor([getattr(p, "tp_axis", None) is not None for p in params],
                             device=norms.device)
        sq = torch.stack([(norms * norms * split).sum(), (norms * norms * ~split).sum()])
        sharded = sq[0].clone()
        dist.all_reduce(sharded, group=mp_group)
        norm = torch.sqrt(sharded + sq[1])
    scale = torch.where(norm > max_norm, max_norm / norm, torch.ones_like(norm))
    for g in grads:
        g.mul_(scale)
    return norm


class LRController:
    """LR = linear warmup(step) x plateau scale."""

    def __init__(self, train_cfg: TrainingConfig):
        self.base_lr = train_cfg.optimizer.lr
        sched = train_cfg.scheduler
        self.warmup_steps = sched.warmup_steps
        self.warmup_start_lr = sched.warmup_start_lr
        self.plateau = ReduceLROnPlateau(sched, self.base_lr)

    def lr_at(self, step: int) -> float:
        if self.warmup_steps > 0 and step < self.warmup_steps:
            frac = step / self.warmup_steps
            base = self.warmup_start_lr + (self.base_lr - self.warmup_start_lr) * frac
        else:
            base = self.base_lr
        return base * self.plateau.scale

    def on_validation(self, val_loss: float) -> float:
        return self.plateau.step(val_loss)

    def state_dict(self):
        return {"plateau": self.plateau.state_dict()}

    def load_state_dict(self, d):
        self.plateau.load_state_dict(d["plateau"])
