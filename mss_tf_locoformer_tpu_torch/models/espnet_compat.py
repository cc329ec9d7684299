"""ESPnet-style separator interface and end-to-end speech separation (the
JAX package's ``models/espnet_compat.py``).

``ESPnetSeparatorAdapter`` speaks the reference plugin's calling convention:
``forward(input, ilens)`` returns ``(list of num_spk complex [B, T, F],
ilens, OrderedDict())``.  ``SpeechSeparator`` is the waveform -> waveform
pipeline: std-normalise on the host (numpy, ``max(std, 1e-8)``), the plain
STFT of ``ops/stft.py`` at ``n_fft`` / ``hop_length`` (the JAX pipeline uses
its jnp transforms, not the Pallas STFT), the separator, the plain iSTFT at
the input's length, then the normalisation undone.  Both run the separator
in eval mode under ``torch.no_grad()`` on the device its weights are on.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.stft import istft, stft
from .tflocoformer import TFLocoformerSeparator

__all__ = ["ESPnetSeparatorAdapter", "SpeechSeparator", "separate_waveforms"]


def separate_waveforms(module: TFLocoformerSeparator, mixture: torch.Tensor,
                       n_fft: int, hop_length: int,
                       generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """``mixture [B, T]`` -> estimates ``[B, S, T]``: STFT, separator, iSTFT
    at the mixture's length (the pipeline of the speech trainer's step and
    of :class:`SpeechSeparator`)."""
    spec = stft(mixture, n_fft, hop_length).transpose(-1, -2)          # [B, N, F]
    out = module(spec, generator=generator)                            # [B, S, N, F]
    return istft(out.transpose(-1, -2), n_fft, hop_length, length=mixture.shape[-1])


class ESPnetSeparatorAdapter:
    """A ``TFLocoformerSeparator`` in the ESPnet ``AbsSeparator`` calling
    convention.  The TF-Locoformer maps spectra directly, so ``others`` is an
    empty OrderedDict (no masks to report).  Puts the module in eval mode."""

    def __init__(self, module: TFLocoformerSeparator):
        self.module = module.eval()

    @property
    def num_spk(self) -> int:
        return self.module.num_spk

    def forward(self, input: torch.Tensor, ilens: Optional[torch.Tensor] = None
                ) -> Tuple[list, Optional[torch.Tensor], OrderedDict]:
        with torch.no_grad():
            out = self.module(input)                        # [B, S, T, F] complex
        return [out[:, s] for s in range(out.shape[1])], ilens, OrderedDict()

    __call__ = forward


class SpeechSeparator:
    """Waveform -> per-speaker waveforms (ESPnet's ``SeparateSpeech``)."""

    def __init__(self, module: TFLocoformerSeparator, n_fft: int = 128,
                 hop_length: int = 64, normalize: bool = True):
        self.adapter = ESPnetSeparatorAdapter(module)
        self.n_fft = n_fft
        self.hop_length = hop_length
        self.normalize = normalize

    @property
    def num_spk(self) -> int:
        return self.adapter.num_spk

    def __call__(self, audio) -> np.ndarray:
        """``[T]`` or ``[B, T]`` mixture -> ``[B, num_spk, T]`` waveforms."""
        audio = np.asarray(audio, dtype=np.float32)
        if audio.ndim == 1:
            audio = audio[None]
        scale = audio.std(axis=-1, keepdims=True) if self.normalize else None
        if scale is not None:
            audio = audio / np.maximum(scale, 1e-8)
        module = self.adapter.module.eval()
        x = torch.from_numpy(np.ascontiguousarray(audio)).to(module.deconv.weight.device)
        with torch.no_grad():
            sep = separate_waveforms(module, x, self.n_fft, self.hop_length).cpu().numpy()
        if scale is not None:
            sep = sep * scale[:, None]
        return sep
