"""Short-Time Objective Intelligibility (STOI) — Taal et al., 2011 (the JAX
package's ``eval/stoi.py``, copied: importing it would import JAX).

The speech evaluation reports SI-SNR, SDR and STOI.  Standard STOI recipe:
resample to 10 kHz, drop silent frames (40 dB VAD), 512-point STFT
(256-sample Hann frames, hop 128), 15 one-third-octave bands from 150 Hz,
384 ms analysis segments with normalization + (-15 dB) SDR clipping, mean
band/segment correlation.

Pure numpy, on the host.
"""

from __future__ import annotations

import functools

import numpy as np

from ..data.audio_io import resample

__all__ = ["compute_stoi"]

FS = 10000           # internal rate
N_FRAME = 256        # analysis frame (25.6 ms)
N_FFT = 512
NUM_BANDS = 15
MIN_FREQ = 150.0
SEG = 30             # frames per intelligibility segment (384 ms)
BETA = -15.0         # lower SDR bound (dB)
DYN_RANGE = 40.0     # VAD dynamic range (dB)


@functools.lru_cache(maxsize=4)
def _third_octave_bands(fs: int, n_fft: int, num_bands: int, min_freq: float):
    """Boolean band matrix [num_bands, n_fft//2 + 1]."""
    f = np.linspace(0, fs, n_fft, endpoint=False)[:n_fft // 2 + 1]
    k = np.arange(num_bands)
    cf = 2.0 ** (k / 3.0) * min_freq
    lo = 2.0 ** ((2 * k - 1) / 6.0) * min_freq
    hi = 2.0 ** ((2 * k + 1) / 6.0) * min_freq
    obm = np.zeros((num_bands, len(f)))
    for i in range(num_bands):
        lo_i = int(np.argmin((f - lo[i]) ** 2))
        hi_i = int(np.argmin((f - hi[i]) ** 2))
        obm[i, lo_i:hi_i] = 1.0
    return obm, cf


def _remove_silent_frames(x: np.ndarray, y: np.ndarray):
    w = np.hanning(N_FRAME + 2)[1:-1]
    hop = N_FRAME // 2
    n = 1 + (len(x) - N_FRAME) // hop
    if n < 1:
        return x, y
    frames_x = np.stack([x[i * hop:i * hop + N_FRAME] * w for i in range(n)])
    energies = 20 * np.log10(np.linalg.norm(frames_x, axis=1) + 1e-12)
    mask = energies > energies.max() - DYN_RANGE
    if not mask.any():
        return x, y
    frames_y = np.stack([y[i * hop:i * hop + N_FRAME] * w for i in range(n)])
    out_len = (mask.sum() - 1) * hop + N_FRAME
    xs = np.zeros(out_len)
    ys = np.zeros(out_len)
    pos = 0
    for i in np.flatnonzero(mask):
        xs[pos:pos + N_FRAME] += frames_x[i]
        ys[pos:pos + N_FRAME] += frames_y[i]
        pos += hop
    return xs, ys


def _stft_mag(x: np.ndarray) -> np.ndarray:
    """[n_frames, n_fft//2+1] magnitudes, 256-sample Hann frames, hop 128."""
    w = np.hanning(N_FRAME + 2)[1:-1]
    hop = N_FRAME // 2
    n = 1 + (len(x) - N_FRAME) // hop
    frames = np.stack([x[i * hop:i * hop + N_FRAME] * w for i in range(n)])
    return np.abs(np.fft.rfft(frames, n=N_FFT, axis=-1))


def compute_stoi(clean, processed, sample_rate: int) -> float:
    """STOI in [~0, 1] of ``processed`` against ``clean`` (1-D or [C, T];
    multichannel is averaged to mono first)."""
    x = np.asarray(clean, dtype=np.float64)
    y = np.asarray(processed, dtype=np.float64)
    if x.ndim > 1:
        x = x.mean(axis=0)
    if y.ndim > 1:
        y = y.mean(axis=0)
    n = min(len(x), len(y))
    x, y = x[:n], y[:n]
    if sample_rate != FS:
        x = resample(x.astype(np.float32), sample_rate, FS).astype(np.float64)
        y = resample(y.astype(np.float32), sample_rate, FS).astype(np.float64)

    x, y = _remove_silent_frames(x, y)
    if len(x) < N_FRAME * 2:
        return float("nan")

    obm, _ = _third_octave_bands(FS, N_FFT, NUM_BANDS, MIN_FREQ)
    X = np.sqrt(obm @ (_stft_mag(x).T ** 2))  # [bands, frames]
    Y = np.sqrt(obm @ (_stft_mag(y).T ** 2))
    if X.shape[1] < SEG:
        return float("nan")

    corrs = []
    for m in range(SEG, X.shape[1] + 1):
        Xs = X[:, m - SEG:m]                       # [bands, SEG]
        Ys = Y[:, m - SEG:m]
        # scale Y to X's energy per band, clip at -BETA dB
        alpha = np.linalg.norm(Xs, axis=1, keepdims=True) / \
            (np.linalg.norm(Ys, axis=1, keepdims=True) + 1e-12)
        Yp = np.minimum(Ys * alpha, Xs * (1 + 10 ** (-BETA / 20.0)))
        xm = Xs - Xs.mean(axis=1, keepdims=True)
        ym = Yp - Yp.mean(axis=1, keepdims=True)
        num = (xm * ym).sum(axis=1)
        den = np.linalg.norm(xm, axis=1) * np.linalg.norm(ym, axis=1) + 1e-12
        corrs.append(num / den)
    return float(np.mean(corrs))
