"""Model families and the config -> module factory (the JAX package's
``models/__init__.py::build_model``).  Only TF-Locoformer MSS is ported."""

from __future__ import annotations

from typing import Optional

import torch

from ..core.config import ModelConfig
from ..core.precision import FP32, Precision

__all__ = ["build_model"]


def build_model(model_cfg: ModelConfig, precision: Precision = FP32,
                generator: Optional[torch.Generator] = None):
    """Instantiate the audio -> stems model for a ``ModelConfig``."""
    if model_cfg.name.startswith("bs"):
        raise NotImplementedError(
            "BS-Locoformer is not ported yet (ROADMAP.md, Queue 1: the other "
            "model families)")
    if model_cfg.name != "tflocoformer_mss":
        raise ValueError(f"Unknown model.name {model_cfg.name!r} "
                         f"(expected tflocoformer_mss|bslocoformer)")
    from .mss_tflocoformer import TFLocoformerMSS
    return TFLocoformerMSS(model_cfg, precision=precision, generator=generator)
