"""TF-Locoformer for music source separation, audio -> 4 stems (the JAX
package's ``models/mss_tflocoformer.py::TFLocoformerMSS``).

  * STFT (n_fft, hop) -> ``[B, 2, T, F]`` real/imag planes; with
    ``fused_stft`` the STFT kernel (``ops/cuda/stft_kernel.py``) computes it.
  * fp32 encoder: Conv2d(2 -> emb, 3x3, pad 1) + GroupNorm(1).  In NCHW
    ``[B, 2, T, F]`` the kernel's first spatial tap runs over frames and the
    second over bins, the mapping of the JAX layout ``[B, T, F, C]``.
  * Cast to the compute dtype; ``n_layers`` TF-Locoformer blocks on
    channels-last ``[B, T, F, C]``.
  * fp32 decoder: ConvTranspose2d(emb -> 2*S, 3x3, pad 1); channel ``2s``
    is stem s's real part and ``2s+1`` its imaginary part.
  * ``torch.istft`` with ``length`` back to ``[B, T_samples]`` per stem.

The encoder, blocks and decoder are the speech separator's
(``models/tflocoformer.py``), which this class extends with the transforms.

Direct spectral mapping; stem order ``vocals, drums, bass, other``.
``train()``/``eval()`` decide dropout: in training mode the config's rate
applies at the four reference sites (two per FFN step, two per attention
step), with one seed per step drawn from the ``generator`` the caller passes
to ``forward`` -- the model keeps no random state of its own.

``remat_blocks`` (training only, the JAX model's per-block ``nn.remat``):
each ``TFLocoformerBlock`` runs under ``torch.utils.checkpoint`` with the
seeds it drew before running, so the backward recomputes the block's
activations, with the same dropout masks, instead of keeping them.
``remat_ffn`` (None: follow ``remat_blocks``) recomputes each torch-
convolution FFN inside a block likewise.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..core.config import SOURCE_NAMES, ModelConfig
from ..core.precision import FP32, Precision
from ..ops.cuda.stft_kernel import stft_fused
from ..ops.stft import istft, stft
from .tflocoformer import TFLocoformerSeparator, reset_parameters

__all__ = ["TFLocoformerMSS", "reset_parameters"]


class TFLocoformerMSS(TFLocoformerSeparator):
    def __init__(self, config: ModelConfig, precision: Precision = FP32,
                 generator: Optional[torch.Generator] = None):
        super().__init__(
            config, precision, generator, n_out=config.n_sources,
            remat_blocks=config.remat_blocks,
            remat_ffn=config.remat_blocks if config.remat_ffn is None else config.remat_ffn)

    def forward(self, mixture: torch.Tensor, return_time_domain: bool = True,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """``mixture [B, T_samples]`` -> stems ``[B, T_samples]`` each (or
        complex ``[B, F, N]`` spectrograms with ``return_time_domain=False``).
        ``generator`` (a CPU ``torch.Generator``) supplies the dropout seeds
        in training mode."""
        cfg = self.config
        length = mixture.shape[-1]
        transform = stft_fused if cfg.fused_stft else stft
        spec = transform(mixture.to(torch.float32), cfg.n_fft, cfg.hop_length)  # [B, F, N]
        spec_out = self.separate(spec.transpose(-1, -2), generator).transpose(-1, -2)
        names = SOURCE_NAMES[:cfg.n_sources]
        if not return_time_domain:
            return {name: spec_out[:, i] for i, name in enumerate(names)}
        audio = istft(spec_out, cfg.n_fft, cfg.hop_length, length=length)
        return {name: audio[:, i] for i, name in enumerate(names)}
