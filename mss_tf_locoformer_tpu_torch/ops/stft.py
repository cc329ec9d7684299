"""STFT / iSTFT with ``torch.stft``/``torch.istft`` default semantics.

The JAX package re-implements these transforms (``ops/stft.py``) so that
they agree with torch; here they are torch's own: periodic Hann window,
reflect centre pad, onesided, un-normalised, all in fp32.  The layout is the
JAX package's: ``[..., T]`` audio <-> complex ``[..., F, N]`` spectrogram.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["hann_window", "stft", "istft"]


def hann_window(win_length: int, device=None) -> torch.Tensor:
    """Periodic Hann window (fp32), ``torch.hann_window`` itself."""
    return torch.hann_window(win_length, periodic=True, dtype=torch.float32,
                             device=device)


def stft(audio: torch.Tensor, n_fft: int, hop_length: int) -> torch.Tensor:
    """``audio [..., T]`` -> complex ``[..., F, N]`` (fp32)."""
    lead = audio.shape[:-1]
    x = audio.to(torch.float32).reshape(-1, audio.shape[-1])
    spec = torch.stft(x, n_fft, hop_length, window=hann_window(n_fft, x.device),
                      center=True, pad_mode="reflect", onesided=True,
                      return_complex=True)
    return spec.reshape(lead + spec.shape[-2:])


def istft(spec: torch.Tensor, n_fft: int, hop_length: int,
          length: Optional[int] = None) -> torch.Tensor:
    """Complex ``spec [..., F, N]`` -> ``audio [..., T]`` (fp32)."""
    lead = spec.shape[:-2]
    flat = spec.reshape((-1,) + spec.shape[-2:])
    audio = torch.istft(flat, n_fft, hop_length,
                        window=hann_window(n_fft, spec.device), center=True,
                        onesided=True, length=length)
    return audio.reshape(lead + audio.shape[-1:])
