"""Common utilities (the JAX package's ``utils/common.py``): seeding,
parameter counts, running averages, time formatting, JSON files."""

from __future__ import annotations

import json
import random
from typing import Any, Dict

import numpy as np
import torch

__all__ = ["set_seed", "count_parameters", "AverageMeter", "format_time", "save_json"]


def set_seed(seed: int) -> None:
    """Seed Python's and numpy's global generators (the port's own random
    draws take explicit ``torch.Generator``s, which the caller seeds)."""
    random.seed(seed)
    np.random.seed(seed)


def count_parameters(module: torch.nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())


class AverageMeter:
    """Running weighted average."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: float = 1):
        self.val = val
        self.sum += val * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / self.count if self.count else 0.0


def format_time(seconds: float) -> str:
    """``1h 02m 03s`` style."""
    seconds = int(seconds)
    h, rem = divmod(seconds, 3600)
    m, s = divmod(rem, 60)
    if h:
        return f"{h}h {m:02d}m {s:02d}s"
    if m:
        return f"{m}m {s:02d}s"
    return f"{s}s"


def save_json(data: Dict[str, Any], path: str) -> None:
    """Indented JSON; numpy scalars are written as floats."""
    with open(path, "w") as f:
        json.dump(data, f, indent=2, default=float)
