"""Model families and the config -> module factory (the JAX package's
``models/__init__.py::build_model``): TF-Locoformer MSS and BS-Locoformer,
and the speech family's spectrogram-in, spectrogram-out
:class:`TFLocoformerSeparator`."""

from __future__ import annotations

from typing import Optional

import torch

from ..core.config import BSModelConfig, ModelConfig
from ..core.precision import FP32, Precision
from .tflocoformer import TFLocoformerSeparator

__all__ = ["build_model", "TFLocoformerSeparator"]


def build_model(model_cfg: ModelConfig, precision: Precision = FP32,
                generator: Optional[torch.Generator] = None):
    """Instantiate the audio -> stems model for a ``ModelConfig``
    (``name: tflocoformer_mss``) or a ``BSModelConfig`` (``name: bs...``)."""
    if isinstance(model_cfg, BSModelConfig):
        from .bslocoformer_mss import BSLocoformerMSS
        return BSLocoformerMSS(model_cfg, precision=precision, generator=generator)
    if model_cfg.name != "tflocoformer_mss":
        raise ValueError(f"Unknown model.name {model_cfg.name!r} "
                         f"(expected tflocoformer_mss|bslocoformer)")
    from .mss_tflocoformer import TFLocoformerMSS
    return TFLocoformerMSS(model_cfg, precision=precision, generator=generator)
