"""Permutation-invariant training (PIT) losses for the speech separators (the
JAX package's ``losses/pit.py``): PIT SI-SNR (wsj0-2mix, WHAMR), the
multi-resolution time-frequency L1 (ESPnet's ``mr_l1_tfd``) and the
fixed-order wrapper (DNS).

The permutation search is a static enumeration (S <= 4 in every recipe, so
at most 24 permutations) over one batched ``[B, S, S]`` pairwise-loss matrix
and a gather: no host loop over the batch.  Permutations come in
``itertools.permutations`` order, and ``argmin`` takes the first of tied
minima, as ``jnp.argmin`` does.  The transforms are the plain ``ops/stft.py``
ones, in fp32 with a gradient (the JAX losses use the jnp transforms; n_fft
768 is not a power of two, so the STFT kernel would not admit it).
"""

from __future__ import annotations

import itertools
from typing import Callable, Sequence, Tuple

import torch

from ..ops.stft import stft
from .mss_loss import si_sdr

__all__ = ["pairwise_si_snr_loss", "pit_loss", "pit_si_snr_loss",
           "mr_l1_tfd_loss", "fixed_order_loss"]

#: loss_fn(est [N, T...], ref [N, T...]) -> [N] per-item loss
PairLossFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _neg_si_snr(est: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    return -si_sdr(est, ref)


def _pairwise_matrix(loss_fn: PairLossFn, estimates: torch.Tensor,
                     targets: torch.Tensor) -> torch.Tensor:
    """``[B, S_est, S_ref]`` per-item losses for every (estimate, reference)
    pair, as one call of ``loss_fn`` on ``B*S*S`` items."""
    b, s = estimates.shape[:2]
    est = estimates[:, :, None].expand(b, s, s, *estimates.shape[2:])
    ref = targets[:, None, :].expand(b, s, s, *targets.shape[2:])
    return loss_fn(est.reshape(b * s * s, *estimates.shape[2:]),
                   ref.reshape(b * s * s, *targets.shape[2:])).reshape(b, s, s)


def pairwise_si_snr_loss(estimates: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """``[B, S, S]`` negative SI-SNR for every (estimate, reference) pair."""
    return _pairwise_matrix(_neg_si_snr, estimates, targets)


def pit_loss(estimates: torch.Tensor, targets: torch.Tensor,
             loss_fn: PairLossFn = _neg_si_snr) -> Tuple[torch.Tensor, torch.Tensor]:
    """PIT loss over ``[B, S, ...]`` estimates and targets: ``(loss, perm)``,
    the batch mean of the best permutation's mean pairwise loss and the
    ``[B]`` int32 index of the winning permutation (into
    ``itertools.permutations(range(S))`` order)."""
    s = estimates.shape[1]
    if targets.shape[1] != s:
        raise ValueError(f"estimates have {s} sources but targets have {targets.shape[1]}")
    mat = _pairwise_matrix(loss_fn, estimates, targets)               # [B, S, S]
    perms = torch.tensor(list(itertools.permutations(range(s))), device=mat.device)
    rows = torch.arange(s, device=mat.device)
    per_perm = mat[:, rows[None, :], perms].mean(-1)                  # [B, P]
    best = per_perm.argmin(-1)
    return per_perm.min(-1).values.mean(), best.to(torch.int32)


def pit_si_snr_loss(estimates: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Scalar PIT SI-SNR loss (the wsj0-2mix / WHAMR / LibriMix criterion)."""
    return pit_loss(estimates, targets, _neg_si_snr)[0]


def mr_l1_tfd_loss(estimate: torch.Tensor, target: torch.Tensor,
                   fft_sizes: Sequence[int] = (256, 512, 768, 1024),
                   hop_factor: float = 0.5, time_domain_weight: float = 0.5,
                   eps: float = 1e-8) -> torch.Tensor:
    """Mean L1 between STFT magnitudes at several resolutions plus a weighted
    time-domain L1 (ESPnet's ``mr_l1_tfd``); a scalar."""
    est, tgt = estimate.to(torch.float32), target.to(torch.float32)
    total = 0.0
    for n_fft in fft_sizes:
        hop = max(1, int(n_fft * hop_factor))
        total = total + (stft(est, n_fft, hop).abs() - stft(tgt, n_fft, hop).abs()).abs().mean()
    return total / len(fft_sizes) + time_domain_weight * (est - tgt).abs().mean()


def fixed_order_loss(estimates: torch.Tensor, targets: torch.Tensor,
                     loss_fn: PairLossFn = _neg_si_snr) -> torch.Tensor:
    """Mean loss over sources in their given order (ESPnet's ``wrapper:
    fixed_order``, the DNS recipe's)."""
    b, s = estimates.shape[:2]
    return loss_fn(estimates.reshape(b * s, *estimates.shape[2:]),
                   targets.reshape(b * s, *targets.shape[2:])).mean()
