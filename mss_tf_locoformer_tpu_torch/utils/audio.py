"""WAV load/save on the host with numpy (the RIFF reader/writer the JAX
package's ``data/audio_io.py`` falls back to), resampling with scipy.
FLAC input goes through ``data/audio_io.py``'s native decoder."""

from __future__ import annotations

from math import gcd
from typing import Optional, Tuple

import numpy as np

__all__ = ["load_audio", "save_audio"]


def _header(path: str):
    with open(path, "rb") as f:
        riff = f.read(12)
        if len(riff) < 12 or riff[:4] != b"RIFF" or riff[8:12] != b"WAVE":
            raise ValueError(f"Not a RIFF/WAVE file: {path}")
        fmt = None
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            tag, size = hdr[:4], int.from_bytes(hdr[4:8], "little")
            if tag == b"fmt ":
                raw = f.read(size + (size & 1))
                code = int.from_bytes(raw[0:2], "little")
                if code == 0xFFFE and size >= 40:  # WAVE_FORMAT_EXTENSIBLE
                    code = int.from_bytes(raw[24:26], "little")
                fmt = dict(format=code,
                           channels=int.from_bytes(raw[2:4], "little"),
                           sample_rate=int.from_bytes(raw[4:8], "little"),
                           bits=int.from_bytes(raw[14:16], "little"))
            elif tag == b"data":
                if fmt is None:
                    raise ValueError(f"data chunk before fmt in {path}")
                return fmt, f.tell(), size
            else:
                f.seek(size + (size & 1), 1)
    raise ValueError(f"No data chunk in {path}")


def _decode(raw: bytes, fmt) -> np.ndarray:
    """Interleaved samples of a WAV data chunk as flat float32."""
    bits, code = fmt["bits"], fmt["format"]
    buf = np.frombuffer(raw, dtype=np.uint8)
    if code == 3 and bits == 32:
        return buf.view("<f4").astype(np.float32)
    if code == 3 and bits == 64:
        return buf.view("<f8").astype(np.float32)
    if bits == 16:
        return buf.view("<i2").astype(np.float32) / 32768.0
    if bits == 24:
        b = buf.reshape(-1, 3).astype(np.uint32)
        v = (b[:, 0] << 8) | (b[:, 1] << 16) | (b[:, 2] << 24)
        return (v.view(np.int32) >> 8).astype(np.float32) / 8388608.0
    if bits == 32:
        return (buf.view("<i4").astype(np.float64) / 2147483648.0).astype(np.float32)
    raise ValueError(f"Unsupported WAV: bits={bits} format={code}")


def _read_wav(path: str) -> Tuple[np.ndarray, int]:
    """``[frames, channels]`` float32 and the sample rate."""
    fmt, offset, size = _header(path)
    ch = fmt["channels"]
    frame_bytes = fmt["bits"] // 8 * ch
    with open(path, "rb") as f:
        f.seek(offset)
        raw = f.read(size // frame_bytes * frame_bytes)
    n = len(raw) // frame_bytes
    return _decode(raw[:n * frame_bytes], fmt).reshape(n, ch), fmt["sample_rate"]


def _write_wav(path: str, data: np.ndarray, sample_rate: int, bits: int) -> None:
    ch = data.shape[1]
    if bits == 32:
        payload, code = data.astype("<f4").tobytes(), 3
    elif bits == 16:
        payload = np.round(np.clip(data, -1, 1) * 32767.0).astype("<i2").tobytes()
        code = 1
    else:
        raise ValueError(f"bits must be 16 or 32, got {bits}")
    nb = bits // 8
    hdr = (b"RIFF" + (36 + len(payload)).to_bytes(4, "little") + b"WAVEfmt "
           + (16).to_bytes(4, "little") + code.to_bytes(2, "little")
           + ch.to_bytes(2, "little") + sample_rate.to_bytes(4, "little")
           + (sample_rate * ch * nb).to_bytes(4, "little")
           + (ch * nb).to_bytes(2, "little") + bits.to_bytes(2, "little")
           + b"data" + len(payload).to_bytes(4, "little"))
    with open(path, "wb") as f:
        f.write(hdr + payload)


def load_audio(path: str, sample_rate: Optional[int] = None,
               mono: bool = False) -> Tuple[np.ndarray, int]:
    """``[C, T]`` float32 and its rate; optional polyphase resample and mono mean."""
    if path.lower().endswith(".flac"):
        from ..data.audio_io import read
        data, sr = read(path)
    else:
        data, sr = _read_wav(path)
    audio = data.T
    if sample_rate is not None and sr != sample_rate:
        from scipy.signal import resample_poly
        g = gcd(sr, sample_rate)
        audio = resample_poly(audio, sample_rate // g, sr // g, axis=1)
        sr = sample_rate
    if mono and audio.shape[0] > 1:
        audio = audio.mean(axis=0, keepdims=True)
    return np.ascontiguousarray(audio, dtype=np.float32), sr


def save_audio(path: str, audio: np.ndarray, sample_rate: int,
               normalize: bool = True, bits: int = 16) -> None:
    """Write ``[C, T]`` or ``[T]`` audio as WAV; optional peak normalisation to 0.95."""
    audio = np.asarray(audio, dtype=np.float32)
    if audio.ndim == 1:
        audio = audio[None]
    if normalize:
        peak = np.max(np.abs(audio))
        if peak > 0:
            audio = audio / peak * 0.95
    _write_wav(path, np.ascontiguousarray(audio.T), sample_rate, bits)
