"""Learning-rate control (the JAX package's ``train/schedule.py``): a
plateau controller with torch's ReduceLROnPlateau semantics (mode, factor,
patience, cooldown, min_lr) kept as a multiplicative scale, and early
stopping.  Host-side; the linear warmup lives in ``LRController``
(``train/state.py``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..core.config import EarlyStoppingConfig, SchedulerConfig

__all__ = ["ReduceLROnPlateau", "EarlyStopping"]


@dataclass
class ReduceLROnPlateau:
    config: SchedulerConfig
    base_lr: float
    scale: float = 1.0
    best: Optional[float] = None
    num_bad: int = 0
    cooldown_left: int = 0

    def _is_better(self, value: float) -> bool:
        if self.best is None:
            return True
        return value < self.best if self.config.mode == "min" else value > self.best

    def step(self, value: float) -> float:
        """Feed a validation metric; returns the LR scale."""
        if self._is_better(value):
            self.best = value
            self.num_bad = 0
        elif self.cooldown_left > 0:
            self.cooldown_left -= 1
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.config.patience:
                self.scale = max(self.scale * self.config.factor,
                                 self.config.min_lr / max(self.base_lr, 1e-30))
                self.cooldown_left = self.config.cooldown
                self.num_bad = 0
        return self.scale

    def state_dict(self) -> dict:
        return {"scale": self.scale, "best": self.best, "num_bad": self.num_bad,
                "cooldown_left": self.cooldown_left}

    def load_state_dict(self, d: dict):
        self.scale, self.best = d["scale"], d["best"]
        self.num_bad, self.cooldown_left = d["num_bad"], d["cooldown_left"]


@dataclass
class EarlyStopping:
    config: EarlyStoppingConfig
    best: Optional[float] = None
    num_bad: int = 0

    def step(self, value: float) -> bool:
        """Feed a validation metric; True when training should stop."""
        if not self.config.enabled:
            return False
        if self.best is None or value < self.best - self.config.min_delta:
            self.best = value
            self.num_bad = 0
            return False
        self.num_bad += 1
        return self.num_bad >= self.config.patience

    def state_dict(self) -> dict:
        return {"best": self.best, "num_bad": self.num_bad}

    def load_state_dict(self, d: dict):
        self.best, self.num_bad = d["best"], d["num_bad"]
