"""Segment reads of WAV and FLAC files (the JAX package's
``data/audio_io.py``): ``info``, ``read(path, start, frames)`` with zero
padding past the end, ``write`` (WAV), ``resample``.  WAV is parsed with
numpy (the RIFF reader of the port's ``utils/audio.py``).  FLAC goes through
the repository's own C++ decoder (``native/audio_io.cpp`` and
``native/flac_decoder.cpp``, the sources the JAX package loads over
ctypes), which the port builds with ``g++`` into ``build/native/`` at first
use (again when a source is newer than the library; under a file lock, so
concurrent processes build once).  A failed build raises: no reader skips
FLAC."""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import tempfile
import threading
from dataclasses import dataclass
from math import gcd
from typing import Optional, Tuple

import numpy as np

from ..utils.audio import _decode, _header, _write_wav

__all__ = ["AudioInfo", "info", "read", "write", "resample", "is_flac", "flac_library"]

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NATIVE_DIR = os.path.join(_ROOT, "native")
BUILD_DIR = os.path.join(_ROOT, "build", "native")
_SOURCES = ("audio_io.cpp", "flac_decoder.cpp")
_LIB: list = []
_LOCK = threading.Lock()


@dataclass(frozen=True)
class AudioInfo:
    frames: int
    sample_rate: int
    channels: int
    bits: int
    fmt: int  # 1 = PCM, 3 = IEEE float


def is_flac(path: str) -> bool:
    return str(path).lower().endswith(".flac")


def _build_flac() -> str:
    srcs = [os.path.join(NATIVE_DIR, f) for f in _SOURCES]
    lib = os.path.join(BUILD_DIR, "libaudio_io.so")

    def fresh():
        return (os.path.exists(lib)
                and os.path.getmtime(lib) >= max(map(os.path.getmtime, srcs)))

    if fresh():
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".libaudio_io.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not fresh():
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                proc = subprocess.run(["g++", "-O3", "-std=c++17", "-shared", "-fPIC",
                                       "-o", tmp, *srcs], capture_output=True, text=True,
                                      timeout=240)
                if proc.returncode != 0:
                    raise RuntimeError(f"g++ failed for {srcs}:\n{proc.stdout}{proc.stderr}")
                os.replace(tmp, lib)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
    return lib


def flac_library() -> ctypes.CDLL:
    """The native FLAC decoder (built at first use; raises when ``g++`` or
    the sources are missing or the build fails)."""
    with _LOCK:
        if not _LIB:
            try:
                path = _build_flac()
            except (OSError, subprocess.SubprocessError) as e:
                raise RuntimeError(f"FLAC needs the native decoder built from {NATIVE_DIR} "
                                   f"with g++: {e}") from e
            lib = ctypes.CDLL(path)
            lib.flac_info.restype = ctypes.c_int
            lib.flac_info.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
                                      ctypes.POINTER(ctypes.c_int32),
                                      ctypes.POINTER(ctypes.c_int32),
                                      ctypes.POINTER(ctypes.c_int32)]
            lib.flac_read.restype = ctypes.c_int64
            lib.flac_read.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
                                      ctypes.POINTER(ctypes.c_float)]
            _LIB.append(lib)
        return _LIB[0]


def _flac_info(path: str) -> AudioInfo:
    frames, sr, ch, bits = (ctypes.c_int64(), ctypes.c_int32(), ctypes.c_int32(),
                            ctypes.c_int32())
    rc = flac_library().flac_info(str(path).encode(), ctypes.byref(frames), ctypes.byref(sr),
                                  ctypes.byref(ch), ctypes.byref(bits))
    if rc != 0:
        raise ValueError(f"flac_info failed ({rc}) for {path}")
    return AudioInfo(frames.value, sr.value, ch.value, bits.value, 1)


def _flac_read(path: str, start: int, frames: Optional[int]) -> Tuple[np.ndarray, int]:
    meta = _flac_info(path)
    if frames is None:
        frames = max(0, meta.frames - start)
    out = np.zeros((frames, meta.channels), dtype=np.float32)
    rc = flac_library().flac_read(str(path).encode(), start, frames,
                                  out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if rc < 0:
        raise ValueError(f"flac_read failed ({rc}) for {path}")
    return out, meta.sample_rate


def info(path: str) -> AudioInfo:
    if is_flac(path):
        return _flac_info(path)
    fmt, _, size = _header(path)
    frame_bytes = fmt["bits"] // 8 * fmt["channels"]
    return AudioInfo(size // frame_bytes, fmt["sample_rate"], fmt["channels"],
                     fmt["bits"], fmt["format"])


def read(path: str, start: int = 0,
         frames: Optional[int] = None) -> Tuple[np.ndarray, int]:
    """``([frames, channels] float32, sample_rate)`` from ``start``; frames
    past the end of the file are zeros."""
    if is_flac(path):
        return _flac_read(path, start, frames)
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
