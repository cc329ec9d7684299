"""STFT and iSTFT kernel wrappers (``csrc/stft.cu``) and their plain
PyTorch versions.

**STFT.** Replaces the JAX package's Pallas
``ops/pallas/stft_kernel.py::stft_pallas``.
The CUDA kernel multiplies frames, read in place from the reflect-padded
signal, by the window-folded DFT tables ``W[k, f] = w[k] e^{-2 pi i k f / n}``
(built in float64, cast to fp32, as the JAX kernel's ``_fwd_dft`` builds
them), all in fp32.

Dispatch: a CPU tensor takes :func:`reference_stft` (``torch.stft``); a
CUDA tensor launches the kernel or raises.  On the card the kernel sits in
an autograd Function whose backward is the adjoint of the plain version (as
the JAX ``stft_pallas`` differentiates through its plain transform), so a
gradient through the STFT is never silently dropped.

**iSTFT.** Replaces the JAX package's Pallas ``_windowed_frames`` behind
``istft_pallas``: the CUDA kernel computes the windowed frames
``irfft(spec[..., :, n]) * w`` as one fp32 product with the window-folded
inverse table (:func:`inverse_dft_table`, built as the JAX ``_inv_dft``
builds it), reading the complex spectrum in place; the overlap-add, the
window envelope and the crop are torch ops, as the JAX wrapper leaves them
to XLA.  :func:`istft_fused` has ``torch.istft``'s contract; on the card its
backward is the adjoint of the plain version.  Like ``istft_pallas``, it is
an API of its own: the models call the plain ``ops/stft.py::istft``, as the
JAX models call their jnp ``istft``.  ``istft_fused.launches`` counts every
launch of the kernel, :func:`windowed_frames`' included.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import stft as plain
from . import check, load, ptr, stream_handle

__all__ = ["stft_fused", "reference_stft", "dft_tables", "FusedSTFT",
           "istft_fused", "reference_istft", "windowed_frames",
           "reference_windowed_frames", "inverse_dft_table", "FusedISTFT"]


def reference_stft(audio: torch.Tensor, n_fft: int, hop_length: int) -> torch.Tensor:
    """Plain version: ``torch.stft`` defaults, ``[..., T]`` -> complex ``[..., F, N]``."""
    return plain.stft(audio, n_fft, hop_length)


@functools.lru_cache(maxsize=8)
def _dft_np(n_fft: int):
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n_fft) / n_fft)
    ang = 2.0 * np.pi * np.outer(np.arange(n_fft), np.arange(n_fft // 2 + 1)) / n_fft
    return ((w[:, None] * np.cos(ang)).astype(np.float32),
            (-w[:, None] * np.sin(ang)).astype(np.float32))


@functools.lru_cache(maxsize=8)
def dft_tables(n_fft: int, device: torch.device):
    """Window-folded rDFT tables ``(re, im)``, each ``[n_fft, n_fft//2+1]`` fp32."""
    wre, wim = _dft_np(n_fft)
    return (torch.from_numpy(wre).to(device), torch.from_numpy(wim).to(device))


def _lib():
    lib = load("stft")
    fn = lib.stft_forward
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    return fn


def _launch(audio: torch.Tensor, n_fft: int, hop_length: int) -> torch.Tensor:
    lead, t = audio.shape[:-1], audio.shape[-1]
    pad = n_fft // 2
    x = audio.reshape(-1, t)
    xpad = torch.nn.functional.pad(x[:, None], (pad, pad), mode="reflect")[:, 0]
    xpad = xpad.contiguous()
    n_frames = 1 + (xpad.shape[-1] - n_fft) // hop_length
    n_bins = n_fft // 2 + 1
    wre, wim = dft_tables(n_fft, audio.device)
    out = torch.empty(x.shape[0], n_bins, n_frames, 2, dtype=torch.float32,
                      device=audio.device)
    check(_lib()(ptr(xpad), ptr(wre), ptr(wim), ptr(out), x.shape[0],
                 xpad.shape[-1], n_fft, hop_length, n_frames, n_bins,
                 stream_handle(audio.device)), "stft")
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
    """Plain version of the kernel: each frame's ``irfft`` times the periodic
    Hann window in fp32, complex ``[..., F, N]`` -> ``[..., N, n_fft]``."""
    x = spec.to(torch.complex64).transpose(-1, -2)
    return torch.fft.irfft(x, n=n_fft, dim=-1) * plain.hann_window(n_fft, spec.device)


@functools.lru_cache(maxsize=8)
def _inv_dft_np(n_fft: int) -> np.ndarray:
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n_fft) / n_fft)
    n_bins = n_fft // 2 + 1
    alpha = np.full(n_bins, 2.0)
    alpha[0] = 1.0
    if n_fft % 2 == 0:
        alpha[-1] = 1.0
    ang = 2.0 * np.pi * np.outer(np.arange(n_bins), np.arange(n_fft)) / n_fft
    cre = (alpha[:, None] * np.cos(ang) * w[None, :] / n_fft).astype(np.float32)
    cim = (-alpha[:, None] * np.sin(ang) * w[None, :] / n_fft).astype(np.float32)
    cim[0] = 0.0           # irfft drops the imaginary parts of DC and Nyquist
    if n_fft % 2 == 0:
        cim[-1] = 0.0
    return np.stack([cre, cim], axis=1).reshape(2 * n_bins, n_fft)


@functools.lru_cache(maxsize=8)
def inverse_dft_table(n_fft: int, device: torch.device) -> torch.Tensor:
    """Window-folded inverse rDFT table ``[2F, n_fft]`` fp32, rows ``2f`` and
    ``2f + 1`` the real and imaginary weights of bin f (Hermitian weights 1
    at DC and Nyquist, 2 between; Hann and 1/n_fft folded in), so that a
    frame is ``[re_0, im_0, re_1, ...] @ table``."""
    return torch.from_numpy(_inv_dft_np(n_fft)).to(device)


def _inv_lib():
    fn = load("stft").istft_frames
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    return fn


def _check_spec(spec: torch.Tensor, n_fft: int, what: str) -> None:
    if spec.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {spec.device}")
    if spec.dtype != torch.complex64:
        raise TypeError(f"{what}: complex64 spectrum expected, got {spec.dtype}")
    if n_fft % 4 or spec.shape[-2] != n_fft // 2 + 1:
        raise ValueError(f"{what}: {spec.shape[-2]} bins for n_fft {n_fft} (the kernel "
                         f"takes n_fft // 2 + 1 bins and n_fft a multiple of 4)")


def _launch_frames(spec: torch.Tensor, n_fft: int) -> torch.Tensor:
    """The kernel: complex64 ``[..., F, N]`` on the card -> ``[..., N, n_fft]``."""
    lead, (n_bins, n_frames) = spec.shape[:-2], spec.shape[-2:]
    x = spec.reshape(-1, n_bins, n_frames).contiguous()
    frames = torch.empty(x.shape[0], n_frames, n_fft, dtype=torch.float32,
                         device=spec.device)
    check(_inv_lib()(ptr(torch.view_as_real(x)), ptr(inverse_dft_table(n_fft, spec.device)),
                     ptr(frames), x.shape[0], n_bins, n_frames, n_fft,
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


def _frames_to_audio(frames: torch.Tensor, n_fft: int, hop_length: int,
                     length: Optional[int]) -> torch.Tensor:
    """Overlap-add, division by the squared window's envelope (where it is
    above 1e-11) and the centre crop of ``torch.istft``."""
    y = _overlap_add(frames, hop_length)
    w2 = plain.hann_window(n_fft, frames.device).square()
    env = _overlap_add(w2.expand(1, frames.shape[1], n_fft), hop_length)[0]
    y = y / torch.where(env > 1e-11, env, torch.ones_like(env))
    start = n_fft // 2
    if length is None:
        return y[:, start:y.shape[-1] - start]
    y = y[:, start:start + length]
    return F.pad(y, (0, length - y.shape[-1])) if y.shape[-1] < length else y


class FusedISTFT(torch.autograd.Function):
    """The iSTFT kernel forward; backward = the adjoint of the plain version."""

    @staticmethod
    def forward(ctx, spec, n_fft, hop_length, length):
        ctx.args, ctx.shape = (n_fft, hop_length, length), spec.shape
        lead, n_frames = spec.shape[:-2], spec.shape[-1]
        frames = _launch_frames(spec, n_fft).reshape(-1, n_frames, n_fft)
        audio = _frames_to_audio(frames, n_fft, hop_length, length)
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
