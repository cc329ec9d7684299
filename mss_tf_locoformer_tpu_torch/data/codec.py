"""Lossy-codec simulation for the MP3 augmentation (the JAX package's
``data/codec.py``, copied: importing any module of that package imports
JAX).

The reference's MP3 augmentation delegates to
``audiomentations.Mp3Compression`` (lameenc underneath); where that package
is not installed, this module reproduces the two artifact classes that
dominate MP3 at the reference's 96-192 kbps range, from the same signal
model MP3 uses:

  * **MDCT-domain quantization noise** -- a 50 %-overlap sine-window MDCT
    (1152-sample frames, the MP3 long-block geometry; Princen-Bradley TDAC
    so the unquantized path reconstructs exactly), coefficients companded
    by ``|x|^(3/4)`` (the MP3 quantizer's power law) and uniformly
    quantized per scalefactor-like band with a step tied to the bitrate.
  * **Bandwidth truncation** -- everything above the encoder's lowpass for
    the drawn bitrate is zeroed (lame's polyphase lowpass defaults:
    ~15 kHz at 96 kbps up to ~19.5 kHz at 192 kbps).

It is a simulation, not an MP3 codec; ``data/musdb.py`` prefers the real
encoder where audiomentations is installed.  Same numbers as the JAX
package's copy for the same input, bitrate and generator.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np

__all__ = ["mp3_like_compression", "mdct", "imdct"]

_FRAME = 1152  # MP3 long-block analysis window (2 granules x 576)


@functools.lru_cache(maxsize=4)
def _mdct_matrix(n: int) -> np.ndarray:
    """[n/2, n] windowed MDCT analysis matrix (sine window, TDAC)."""
    half = n // 2
    ns = np.arange(n)
    ks = np.arange(half)
    window = np.sin(np.pi / n * (ns + 0.5))
    basis = np.cos(np.pi / half * (ns[None, :] + 0.5 + half / 2)
                   * (ks[:, None] + 0.5))
    return (basis * window[None, :]).astype(np.float64)


def mdct(x: np.ndarray, frame: int = _FRAME) -> np.ndarray:
    """[T] -> [n_frames, frame/2] 50%-overlap MDCT (input is zero-padded by
    half a frame on each side so every sample is covered twice)."""
    hop = frame // 2
    x = np.concatenate([np.zeros(hop), np.asarray(x, np.float64),
                        np.zeros(frame)])
    n_frames = (len(x) - frame) // hop + 1
    idx = np.arange(frame)[None, :] + hop * np.arange(n_frames)[:, None]
    return x[idx] @ _mdct_matrix(frame).T


def imdct(coefs: np.ndarray, length: int, frame: int = _FRAME) -> np.ndarray:
    """Inverse of :func:`mdct` (TDAC: windowed overlap-add of the transposed
    basis reconstructs exactly)."""
    hop = frame // 2
    frames = coefs @ _mdct_matrix(frame) * (2.0 / hop)
    n_frames = coefs.shape[0]
    out = np.zeros(hop * (n_frames - 1) + frame)
    for i in range(n_frames):  # OLA (frame count is small; loop is fine)
        out[i * hop:i * hop + frame] += frames[i]
    return out[hop:hop + length]


def _lowpass_hz(bitrate_kbps: float) -> float:
    """lame's default polyphase lowpass vs bitrate (CBR, 44.1 kHz)."""
    pts = [(96.0, 15000.0), (128.0, 16500.0), (160.0, 18000.0),
           (192.0, 19500.0), (256.0, 20500.0)]
    xs, ys = zip(*pts)
    return float(np.interp(bitrate_kbps, xs, ys))


def mp3_like_compression(samples: np.ndarray, sample_rate: int,
                         bitrate_kbps: float,
                         rng: Optional[np.random.Generator] = None
                         ) -> np.ndarray:
    """Apply MP3-like artifacts to ``[T]`` or ``[C, T]`` float audio.

    Deterministic given (samples, bitrate); ``rng`` only dithers the
    quantizer (subtle, matches encoders' noise-shaping variance).
    """
    x = np.asarray(samples, np.float32)
    if x.ndim == 2:
        return np.stack([mp3_like_compression(ch, sample_rate, bitrate_kbps,
                                              rng) for ch in x])
    t = x.shape[-1]
    half = _FRAME // 2
    coefs = mdct(x)                                   # [F, 576]

    # bandwidth truncation at the bitrate's lowpass
    freqs = (np.arange(half) + 0.5) * sample_rate / _FRAME
    coefs[:, freqs > _lowpass_hz(bitrate_kbps)] = 0.0

    # per-band companded quantization: ~18 log-spaced scalefactor-like
    # bands; step scales with the band's own level (masking-floor stand-in)
    # and shrinks as bitrate grows (3 dB finer per ~32 kbps, anchored so
    # 128 kbps lands around 14-20 dB artifact SNR on dense material)
    edges = np.unique(np.round(
        np.geomspace(4, half, 19)).astype(int))
    step_scale = 0.045 * (2.0 ** (-(bitrate_kbps - 128.0) / 32.0))
    comp = np.sign(coefs) * np.abs(coefs) ** 0.75
    for lo, hi in zip(edges[:-1], edges[1:]):
        band = comp[:, lo:hi]
        level = np.max(np.abs(band))
        if level <= 0.0:
            continue
        step = step_scale * level
        if rng is not None:
            band = band + rng.uniform(-0.25, 0.25, band.shape) * step
        comp[:, lo:hi] = np.round(band / step) * step
    coefs = np.sign(comp) * np.abs(comp) ** (4.0 / 3.0)

    return imdct(coefs, t).astype(np.float32)
