"""STFT and iSTFT kernel wrappers (``csrc/stft.cu``) and their plain
PyTorch versions.

The kernels are FFTs in shared memory (``csrc/fft.cuh``), fp32, for a
power-of-two ``n_fft`` from 128 to 4096 (every config's: 128, 256, 1024,
2048, 4096).  A real frame of ``n_fft`` samples is packed as ``n_fft // 2``
complex values, transformed by one complex Stockham FFT (:func:`fft_stages`)
and split into its ``n_fft // 2 + 1`` bins; twiddles, split factors and the
Hann window come from one table built in float64 and rounded to fp32
(:func:`fft_tables`), cached per device.

**STFT.** Replaces the JAX package's Pallas ``ops/pallas/stft_kernel.py::
stft_pallas``.  The kernel reads the signal as it is (reflect padding is
computed from the index) and writes the complex ``[B, F, N]`` spectrum.

**iSTFT.** Replaces the JAX package's Pallas ``_windowed_frames`` behind
``istft_pallas``: one kernel computes the windowed frames ``irfft(spec[...,
:, n]) * w`` (:func:`windowed_frames`), a second the overlap-add, the
division by the squared window's envelope and the crop
(:func:`frames_to_audio`), which ``istft_pallas`` leaves to XLA.
:func:`istft_fused` has ``torch.istft``'s contract.  Like ``istft_pallas``,
it is an API of its own: the models call the plain ``ops/stft.py::istft``,
as the JAX models call their jnp ``istft``.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises (another ``n_fft`` included).  On the card the kernels sit
in autograd Functions whose backward is the adjoint of the plain version,
as the JAX ``custom_vjp``s differentiate through their plain transforms.
Launch counts: ``stft_fused.launches``; ``istft_fused.launches`` (every
frames launch, :func:`windowed_frames`' included); ``frames_to_audio.
launches`` (every overlap-add launch).
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import stft as plain
from . import check, load, ptr, stream_handle

__all__ = ["stft_fused", "reference_stft", "FusedSTFT", "istft_fused",
           "reference_istft", "windowed_frames", "reference_windowed_frames",
           "frames_to_audio", "reference_frames_to_audio", "FusedISTFT",
           "fft_stages", "fft_tables_np", "fft_tables", "N_FFT_MIN", "N_FFT_MAX"]

N_FFT_MIN, N_FFT_MAX = 128, 4096   # the kernels' template range (csrc/stft.cu)


def fft_stages(n_fft: int) -> List[Tuple[int, int]]:
    """``(radix, p)`` of each stage of ``csrc/fft.cuh::forward``'s complex
    FFT of ``M = n_fft // 2`` points: a radix-2 or radix-4 stage first when
    log2 M is not a multiple of 3, then radix-8 stages; ``p`` is the size of
    the sub-transforms done before the stage."""
    m = n_fft // 2
    first = 2 ** ((m.bit_length() - 1) % 3)
    stages, p = ([(first, 1)], first) if first > 1 else ([], 1)
    while p < m:
        stages.append((8, p))
        p *= 8
    return stages


@functools.lru_cache(maxsize=8)
def fft_tables_np(n_fft: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The kernels' tables, built in float64 and rounded: ``(twiddle, split,
    window)``.  ``twiddle`` (complex64, ``M = n_fft // 2``) holds each
    radix-8 stage after ``p > 1`` points in turn, ``W_{8p}^{rk}`` at ``(r -
    1) p + k`` of its part (``csrc/fft.cuh``), zeros after the last;
    ``split`` is ``W_N^k = exp(-2 pi i k / n_fft)`` for ``k < M``; ``window``
    the periodic Hann window (fp32, ``n_fft``)."""
    m = n_fft // 2
    twiddle = np.zeros(m, np.complex64)
    at = 0
    for radix, p in fft_stages(n_fft):
        if p > 1:
            rk = np.arange(1, radix)[:, None] * np.arange(p)
            twiddle[at:at + (radix - 1) * p] = np.exp(-2j * np.pi * rk / (radix * p)).ravel()
            at += (radix - 1) * p
    split = np.exp(-2j * np.pi * np.arange(m) / n_fft).astype(np.complex64)
    window = (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n_fft) / n_fft)).astype(np.float32)
    return twiddle, split, window


@functools.lru_cache(maxsize=16)
def fft_tables(n_fft: int, device: torch.device) -> torch.Tensor:
    """:func:`fft_tables_np` as the one fp32 buffer the kernels read:
    ``[twiddle re/im (n_fft)][split re/im (n_fft)][window (n_fft)]``."""
    twiddle, split, window = fft_tables_np(n_fft)
    flat = np.concatenate([twiddle.view(np.float32), split.view(np.float32), window])
    return torch.from_numpy(flat).to(device)


def _check_n_fft(n_fft: int, what: str) -> None:
    if not (N_FFT_MIN <= n_fft <= N_FFT_MAX and n_fft & (n_fft - 1) == 0):
        raise ValueError(f"{what}: the FFT kernels take a power-of-two n_fft from "
                         f"{N_FFT_MIN} to {N_FFT_MAX}, got {n_fft}")


_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {"stft_forward": [_P] * 3 + [_I] * 5 + [_P],
             "istft_frames": [_P] * 3 + [_I] * 3 + [ctypes.c_longlong] * 3 + [_P],
             "istft_overlap_add": [_P] * 3 + [_I] * 5 + [_P]}


@functools.lru_cache(maxsize=None)
def _fn(name: str):
    """The C entry point ``name`` of ``csrc/stft.cu`` (built at first use)."""
    fn = getattr(load("stft"), name)
    fn.restype = ctypes.c_int
    fn.argtypes = _ARGTYPES[name]
    return fn


# ------------------------------------------------------------------ STFT


def reference_stft(audio: torch.Tensor, n_fft: int, hop_length: int) -> torch.Tensor:
    """Plain version: ``torch.stft`` defaults, ``[..., T]`` -> complex ``[..., F, N]``."""
    return plain.stft(audio, n_fft, hop_length)


def _launch(audio: torch.Tensor, n_fft: int, hop_length: int) -> torch.Tensor:
    lead, t = audio.shape[:-1], audio.shape[-1]
    x = audio.reshape(-1, t).contiguous()
    n_frames = 1 + t // hop_length   # of the signal reflect-padded by n_fft // 2
    n_bins = n_fft // 2 + 1
    out = torch.empty(x.shape[0], n_bins, n_frames, 2, dtype=torch.float32,
                      device=audio.device)
    check(_fn("stft_forward")(ptr(x), ptr(fft_tables(n_fft, audio.device)), ptr(out),
                              x.shape[0], t, n_fft, hop_length, n_frames,
                              stream_handle(audio.device)),
          f"stft at n_fft {n_fft}, hop {hop_length} (a block's signal span must fit "
          f"the card's shared memory)")
    stft_fused.launches += 1
    return torch.view_as_complex(out).reshape(lead + (n_bins, n_frames))


class FusedSTFT(torch.autograd.Function):
    """The STFT kernel forward; backward = the adjoint of the plain version."""

    @staticmethod
    def forward(ctx, audio, n_fft, hop_length):
        ctx.args = (n_fft, hop_length)
        ctx.save_for_backward(audio)
        return _launch(audio, n_fft, hop_length)

    @staticmethod
    def backward(ctx, g):
        (audio,) = ctx.saved_tensors
        with torch.enable_grad():
            a = audio.detach().requires_grad_(True)
            (da,) = torch.autograd.grad(reference_stft(a, *ctx.args), a, g)
        return da, None, None


def stft_fused(audio: torch.Tensor, n_fft: int, hop_length: int) -> torch.Tensor:
    """STFT of ``audio [..., T]`` -> complex64 ``[..., F, N]`` (torch.stft
    semantics: periodic Hann, reflect centre pad, onesided, un-normalised)."""
    if audio.device.type == "cpu":
        return reference_stft(audio, n_fft, hop_length)
    if audio.device.type != "cuda":
        raise ValueError(f"stft_fused: unsupported device {audio.device}")
    if audio.dtype != torch.float32:
        raise TypeError(f"stft_fused: fp32 audio expected, got {audio.dtype}")
    _check_n_fft(n_fft, "stft_fused")
    if hop_length < 1:
        raise ValueError(f"stft_fused: hop_length {hop_length} must be positive")
    if audio.shape[-1] <= n_fft // 2:
        raise ValueError(f"stft_fused: {audio.shape[-1]} samples is too short for "
                         f"reflect padding of {n_fft // 2}")
    return FusedSTFT.apply(audio, n_fft, hop_length)


stft_fused.launches = 0


# ----------------------------------------------------------------- iSTFT


def reference_istft(spec: torch.Tensor, n_fft: int, hop_length: int,
                    length: Optional[int] = None) -> torch.Tensor:
    """Plain version: ``torch.istft`` defaults, complex ``[..., F, N]`` -> ``[..., T]``."""
    return plain.istft(spec, n_fft, hop_length, length)


def reference_windowed_frames(spec: torch.Tensor, n_fft: int) -> torch.Tensor:
    """Plain version of the frames kernel: each frame's ``irfft`` times the
    periodic Hann window in fp32, complex ``[..., F, N]`` -> ``[..., N, n_fft]``."""
    x = spec.to(torch.complex64).transpose(-1, -2)
    return torch.fft.irfft(x, n=n_fft, dim=-1) * plain.hann_window(n_fft, spec.device)


def _check_spec(spec: torch.Tensor, n_fft: int, what: str) -> None:
    if spec.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {spec.device}")
    if spec.dtype != torch.complex64:
        raise TypeError(f"{what}: complex64 spectrum expected, got {spec.dtype}")
    _check_n_fft(n_fft, what)
    if spec.shape[-2] != n_fft // 2 + 1:
        raise ValueError(f"{what}: {spec.shape[-2]} bins for n_fft {n_fft} (the kernel "
                         f"takes n_fft // 2 + 1 bins)")


def _launch_frames(spec: torch.Tensor, n_fft: int) -> torch.Tensor:
    """The frames kernel: complex64 ``[..., F, N]`` on the card, read through
    its strides (torch.stft's output is a transposed view) -> ``[..., N, n_fft]``."""
    lead, (n_bins, n_frames) = spec.shape[:-2], spec.shape[-2:]
    x = spec.reshape(-1, n_bins, n_frames)
    frames = torch.empty(x.shape[0], n_frames, n_fft, dtype=torch.float32,
                         device=spec.device)
    check(_fn("istft_frames")(ptr(x), ptr(fft_tables(n_fft, spec.device)), ptr(frames),
                              x.shape[0], n_fft, n_frames, *x.stride(),
                              stream_handle(spec.device)), "istft")
    istft_fused.launches += 1
    return frames.reshape(lead + (n_frames, n_fft))


def windowed_frames(spec: torch.Tensor, n_fft: int) -> torch.Tensor:
    """The windowed frames of complex ``spec [..., F, N]``, ``[..., N,
    n_fft]``: the kernel on the card, the plain version on the CPU."""
    if spec.device.type == "cpu":
        return reference_windowed_frames(spec, n_fft)
    _check_spec(spec, n_fft, "windowed_frames")
    return _launch_frames(spec, n_fft)


def _overlap_add(frames: torch.Tensor, hop_length: int) -> torch.Tensor:
    """``[R, N, n_fft]`` -> ``[R, (N - 1) * hop + n_fft]``."""
    r, n_frames, n_fft = frames.shape
    full = (n_frames - 1) * hop_length + n_fft
    return F.fold(frames.transpose(1, 2), output_size=(1, full), kernel_size=(1, n_fft),
                  stride=(1, hop_length))[:, 0, 0]


def reference_frames_to_audio(frames: torch.Tensor, n_fft: int, hop_length: int,
                              length: Optional[int]) -> torch.Tensor:
    """Plain version of the overlap-add kernel: ``[R, N, n_fft]`` windowed
    frames -> ``[R, T]`` by overlap-add, division by the squared window's
    envelope (where it is above 1e-11) and the centre crop of ``torch.istft``."""
    y = _overlap_add(frames, hop_length)
    w2 = plain.hann_window(n_fft, frames.device).square()
    env = _overlap_add(w2.expand(1, frames.shape[1], n_fft), hop_length)[0]
    y = y / torch.where(env > 1e-11, env, torch.ones_like(env))
    start = n_fft // 2
    if length is None:
        return y[:, start:y.shape[-1] - start]
    y = y[:, start:start + length]
    return F.pad(y, (0, length - y.shape[-1])) if y.shape[-1] < length else y


def _launch_ola(frames: torch.Tensor, hop_length: int,
                length: Optional[int]) -> torch.Tensor:
    r, n_frames, n_fft = frames.shape
    if hop_length < 1:
        raise ValueError(f"istft: hop_length {hop_length} must be positive")
    if length is None:
        length = (n_frames - 1) * hop_length
    out = torch.empty(r, length, dtype=torch.float32, device=frames.device)
    window = fft_tables(n_fft, frames.device)[2 * n_fft:]
    check(_fn("istft_overlap_add")(ptr(frames), ptr(window), ptr(out), r, n_frames, n_fft,
                                   hop_length, length, stream_handle(frames.device)),
          "istft overlap-add")
    frames_to_audio.launches += 1
    return out


def frames_to_audio(frames: torch.Tensor, n_fft: int, hop_length: int,
                    length: Optional[int] = None) -> torch.Tensor:
    """Windowed frames ``[R, N, n_fft]`` -> audio ``[R, T]`` (torch.istft's
    overlap-add, envelope and crop): the kernel on the card, the plain
    version on the CPU."""
    if frames.device.type == "cpu":
        return reference_frames_to_audio(frames, n_fft, hop_length, length)
    if frames.device.type != "cuda":
        raise ValueError(f"frames_to_audio: unsupported device {frames.device}")
    if frames.dtype != torch.float32 or frames.dim() != 3 or frames.shape[-1] != n_fft:
        raise ValueError(f"frames_to_audio: fp32 [R, N, {n_fft}] frames expected, got "
                         f"{frames.dtype} {list(frames.shape)}")
    _check_n_fft(n_fft, "frames_to_audio")
    return _launch_ola(frames.contiguous(), hop_length, length)


frames_to_audio.launches = 0


class FusedISTFT(torch.autograd.Function):
    """The iSTFT kernels forward; backward = the adjoint of the plain version."""

    @staticmethod
    def forward(ctx, spec, n_fft, hop_length, length):
        ctx.args, ctx.shape = (n_fft, hop_length, length), spec.shape
        lead, n_frames = spec.shape[:-2], spec.shape[-1]
        frames = _launch_frames(spec, n_fft).reshape(-1, n_frames, n_fft)
        audio = _launch_ola(frames, hop_length, length)
        return audio.reshape(lead + audio.shape[-1:])

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad():
            s = torch.zeros(ctx.shape, dtype=torch.complex64, device=g.device,
                            requires_grad=True)
            (ds,) = torch.autograd.grad(reference_istft(s, *ctx.args), s, g)
        return ds, None, None, None


def istft_fused(spec: torch.Tensor, n_fft: int, hop_length: int,
                length: Optional[int] = None) -> torch.Tensor:
    """iSTFT of complex ``spec [..., F, N]`` -> ``[..., T]`` (torch.istft
    semantics: periodic Hann, centre crop, onesided, un-normalised;
    ``length`` crops or zero-pads)."""
    if spec.device.type == "cpu":
        return reference_istft(spec, n_fft, hop_length, length)
    _check_spec(spec, n_fft, "istft_fused")
    return FusedISTFT.apply(spec, n_fft, hop_length, length)


istft_fused.launches = 0
