"""MSS losses (the JAX package's ``losses/mss_loss.py``): SI-SDR, SDR, L1,
L2, spectral L1 on log1p magnitudes, multi-resolution STFT, and the combined
per-stem loss dict.  All in fp32 whatever the input dtype.  The reference's
quirk is kept: the spectral loss uses its own STFT (2048/1024 by default,
``LossConfig.spectral_*``) whatever the model's STFT is."""

from __future__ import annotations

from typing import Dict, Mapping, Sequence

import torch

from ..core.config import LossConfig
from ..ops.stft import stft

__all__ = ["si_sdr", "sdr", "si_sdr_loss", "spectral_loss",
           "multi_resolution_stft_loss", "mss_loss"]


def _flatten(x: torch.Tensor) -> torch.Tensor:
    """``[B, C, T] -> [B*C, T]`` in fp32 (channels scored separately)."""
    x = x.to(torch.float32)
    return x.reshape(-1, x.shape[-1]) if x.dim() > 2 else x


def si_sdr(estimate: torch.Tensor, target: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Per-item SI-SDR in dB, ``[B]``."""
    estimate, target = _flatten(estimate), _flatten(target)
    estimate = estimate - estimate.mean(-1, keepdim=True)
    target = target - target.mean(-1, keepdim=True)
    dot = (estimate * target).sum(-1, keepdim=True)
    energy = (target * target).sum(-1, keepdim=True) + eps
    s_target = (dot / energy) * target
    signal = (s_target * s_target).sum(-1) + eps
    noise = (estimate - s_target).square().sum(-1) + eps
    return 10.0 * torch.log10(signal / noise)


def sdr(estimate: torch.Tensor, target: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Per-item plain SDR in dB, ``[B]``."""
    estimate, target = _flatten(estimate), _flatten(target)
    signal = (target * target).sum(-1) + eps
    noise = (estimate - target).square().sum(-1) + eps
    return 10.0 * torch.log10(signal / noise)


def si_sdr_loss(estimate: torch.Tensor, target: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Negative mean SI-SDR."""
    return -si_sdr(estimate, target, eps).mean()


def spectral_loss(estimate: torch.Tensor, target: torch.Tensor, n_fft: int = 2048,
                  hop_length: int = 1024, log_scale: bool = True) -> torch.Tensor:
    """L1 between (log1p-)magnitude spectrograms."""
    est = stft(_flatten(estimate), n_fft, hop_length).abs()
    tgt = stft(_flatten(target), n_fft, hop_length).abs()
    if log_scale:
        est, tgt = torch.log1p(est), torch.log1p(tgt)
    return (est - tgt).abs().mean()


def multi_resolution_stft_loss(estimate: torch.Tensor, target: torch.Tensor,
                               fft_sizes: Sequence[int] = (512, 1024, 2048),
                               hop_sizes: Sequence[int] = (256, 512, 1024)) -> torch.Tensor:
    """Mean spectral loss over several resolutions."""
    total = 0.0
    for n_fft, hop in zip(fft_sizes, hop_sizes):
        total = total + spectral_loss(estimate, target, n_fft, hop)
    return total / len(fft_sizes)


def mss_loss(predictions: Mapping[str, torch.Tensor],
             targets: Mapping[str, torch.Tensor],
             config: LossConfig = LossConfig()) -> Dict[str, torch.Tensor]:
    """Per-stem losses and ``total_loss``; stems without a target are
    skipped."""
    total = 0.0
    out: Dict[str, torch.Tensor] = {}
    for name, pred in predictions.items():
        if name not in targets:
            continue
        tgt = targets[name]
        p32, t32 = pred.to(torch.float32), tgt.to(torch.float32)
        if config.loss_type in ("si_sdr", "combined"):
            v = si_sdr_loss(pred, tgt, config.eps)
            out[f"{name}_si_sdr"] = v
            total = total + config.si_sdr_weight * v
        if config.loss_type in ("l1", "combined"):
            v = (p32 - t32).abs().mean()
            out[f"{name}_l1"] = v
            total = total + config.l1_weight * v
        if config.loss_type == "l2":
            v = (p32 - t32).square().mean()
            out[f"{name}_l2"] = v
            total = total + v
        if config.loss_type == "combined" and config.spectral_weight > 0:
            v = spectral_loss(pred, tgt, config.spectral_n_fft, config.spectral_hop_length)
            out[f"{name}_spectral"] = v
            total = total + config.spectral_weight * v
    out["total_loss"] = total
    return out
