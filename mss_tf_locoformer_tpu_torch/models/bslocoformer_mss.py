"""BS-Locoformer end to end, audio -> stems (the JAX package's
``models/bslocoformer_mss.py``):

    STFT -> BSLocoformerSeparator over (time x band) -> iSTFT

for mono ``[B, T]`` or, with ``stereo``, ``[B, 2, T]`` mixtures; stems come
back in the same layout.  Both transforms are the plain ``ops/stft.py`` ones
(``torch.stft``/``torch.istft``), as the JAX model uses its jnp transforms.

The JAX model nests the separator under ``separator``; the reference
separator's checkpoints have no such level, so this class *is* the separator
(a subclass): its state_dict keys are the reference's, ``band_split_module.*``
and ``blocks.*``, at the top level.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..core.config import SOURCE_NAMES, BSModelConfig
from ..core.precision import FP32, Precision
from ..ops.stft import istft, stft
from .bslocoformer import BSLocoformerSeparator

__all__ = ["BSLocoformerMSS"]


class BSLocoformerMSS(BSLocoformerSeparator):
    def __init__(self, config: BSModelConfig, precision: Precision = FP32,
                 generator: Optional[torch.Generator] = None):
        if config.stft_size != config.n_fft:
            raise ValueError(f"BSLocoformerMSS needs stft_size == n_fft for its bands, "
                             f"got {config.stft_size} != {config.n_fft}")
        super().__init__(config, precision, generator)

    def forward(self, mixture: torch.Tensor, return_time_domain: bool = True,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """``mixture [B, T]`` (``[B, 2, T]`` stereo) -> stems of the same
        layout (or complex ``[B, (M,) F, N]`` with ``return_time_domain=False``)."""
        cfg = self.config
        if cfg.stereo and (mixture.dim() != 3 or mixture.shape[1] != 2):
            raise ValueError(f"stereo BS-Locoformer expects mixture [B, 2, T], "
                             f"got {tuple(mixture.shape)}")
        if not cfg.stereo and mixture.dim() != 2:
            raise ValueError(f"expected mixture [B, T], got {tuple(mixture.shape)}")
        length = mixture.shape[-1]
        x = mixture if cfg.stereo else mixture[:, None]
        spec = stft(x.to(torch.float32), cfg.n_fft, cfg.hop_length)  # [B, M, F, N]
        out = super().forward(spec.transpose(-1, -2) if cfg.stereo
                              else spec[:, 0].transpose(-1, -2), generator)
        spec_out = out.transpose(-1, -2)                              # [B, S, (M,) F, N]
        names = SOURCE_NAMES[:cfg.n_sources]
        if not return_time_domain:
            return {name: spec_out[:, i] for i, name in enumerate(names)}
        audio = istft(spec_out, cfg.n_fft, cfg.hop_length, length=length)
        return {name: audio[:, i] for i, name in enumerate(names)}
