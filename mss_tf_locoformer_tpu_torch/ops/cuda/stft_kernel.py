"""STFT kernel wrapper (``csrc/stft.cu``) and its plain PyTorch version.

Replaces the JAX package's Pallas ``ops/pallas/stft_kernel.py::stft_pallas``.
The CUDA kernel multiplies frames, read in place from the reflect-padded
signal, by the window-folded DFT tables ``W[k, f] = w[k] e^{-2 pi i k f / n}``
(built in float64, cast to fp32, as the JAX kernel's ``_fwd_dft`` builds
them), all in fp32.

Dispatch: a CPU tensor takes :func:`reference_stft` (``torch.stft``); a
CUDA tensor launches the kernel or raises.  On the card the kernel sits in
an autograd Function whose backward is the adjoint of the plain version (as
the JAX ``stft_pallas`` differentiates through its plain transform), so a
gradient through the STFT is never silently dropped.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import stft as plain
from . import check, load, ptr, stream_handle

__all__ = ["stft_fused", "reference_stft", "dft_tables", "FusedSTFT"]


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
