"""Segment reads of WAV files with numpy (the JAX package's
``data/audio_io.py`` numpy path): ``info``, ``read(path, start, frames)``
with zero padding past the end, ``write``, ``resample``.  The RIFF parsing is the port's
``utils/audio.py``.  FLAC (the JAX package's native decoder) is a later item
(ROADMAP.md, Queue 1: serving leftovers)."""

from __future__ import annotations

from dataclasses import dataclass
from math import gcd
from typing import Optional, Tuple

import numpy as np

from ..utils.audio import _decode, _header, _write_wav

__all__ = ["AudioInfo", "info", "read", "write", "resample"]


@dataclass(frozen=True)
class AudioInfo:
    frames: int
    sample_rate: int
    channels: int
    bits: int
    fmt: int  # 1 = PCM, 3 = IEEE float


def _no_flac(path: str) -> None:
    if path.lower().endswith(".flac"):
        raise NotImplementedError(
            f"{path}: FLAC is not ported yet (ROADMAP.md, Queue 1: serving leftovers); "
            f"MUSDB18-HQ ships WAV")


def info(path: str) -> AudioInfo:
    _no_flac(path)
    fmt, _, size = _header(path)
    frame_bytes = fmt["bits"] // 8 * fmt["channels"]
    return AudioInfo(size // frame_bytes, fmt["sample_rate"], fmt["channels"],
                     fmt["bits"], fmt["format"])


def read(path: str, start: int = 0,
         frames: Optional[int] = None) -> Tuple[np.ndarray, int]:
    """``([frames, channels] float32, sample_rate)`` from ``start``; frames
    past the end of the file are zeros."""
    _no_flac(path)
    fmt, offset, size = _header(path)
    ch, bits = fmt["channels"], fmt["bits"]
    frame_bytes = bits // 8 * ch
    total = size // frame_bytes
    if frames is None:
        frames = max(0, total - start)
    out = np.zeros((frames, ch), dtype=np.float32)
    n = min(frames, total - start)
    if n > 0:
        with open(path, "rb") as f:
            f.seek(offset + start * frame_bytes)
            raw = f.read(n * frame_bytes)
        n = len(raw) // frame_bytes
        out[:n] = _decode(raw[:n * frame_bytes], fmt).reshape(n, ch)
    return out, fmt["sample_rate"]


def write(path: str, data: np.ndarray, sample_rate: int, bits: int = 16) -> None:
    """Write ``[frames, channels]`` or ``[frames]`` float32 audio as WAV."""
    data = np.asarray(data, dtype=np.float32)
    if data.ndim == 1:
        data = data[:, None]
    _write_wav(path, np.ascontiguousarray(data), sample_rate, bits)


def resample(audio: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase windowed-sinc resample along axis 0 (scipy's
    ``resample_poly``, as the JAX package); float32 out."""
    if orig_sr == target_sr:
        return audio
    from scipy.signal import resample_poly
    g = gcd(orig_sr, target_sr)
    return resample_poly(audio, target_sr // g, orig_sr // g, axis=0).astype(np.float32)
