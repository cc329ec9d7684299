"""The port's speech losses and STOI on the CPU against the JAX package:
the five PIT losses (pairwise SI-SNR, PIT with its winning permutation and
first-index ties, PIT SI-SNR, ``mr_l1_tfd``, fixed order, and the trainer's
per-item ``mr_l1_tfd`` under both wrappers) with their gradients, and
``compute_stoi`` (numpy on both sides)."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mss_tf_locoformer_tpu.eval.stoi import compute_stoi as jax_stoi
from mss_tf_locoformer_tpu.losses import pit as JP
from mss_tf_locoformer_tpu.train import speech as JS
from mss_tf_locoformer_tpu_torch.eval.stoi import compute_stoi
from mss_tf_locoformer_tpu_torch.losses import pit as P
from mss_tf_locoformer_tpu_torch.train import speech as S

# fp32 losses on both sides, over a few thousand samples: rounding of sums
LOSS_RTOL = 1e-5


def _grad_close(got, want, name):
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * np.abs(want).max(),
                               err_msg=name)


def test_pit_losses_match_jax(rng):
    """Pairwise matrix, PIT loss, winning permutation (targets are permuted,
    noisy estimates, so the winner is known; one item has a tie, which the
    first permutation wins) and the gradients of every loss."""
    b, s, t = 3, 3, 1200
    est = (0.3 * rng.standard_normal((b, s, t))).astype(np.float32)
    order = [(2, 0, 1), (0, 1, 2), (1, 0, 2)]
    tgt = np.stack([est[i, list(order[i])] for i in range(b)])
    tgt = (tgt + 0.05 * rng.standard_normal(tgt.shape)).astype(np.float32)
    est[1, 1], tgt[1, 1] = est[1, 0], tgt[1, 0]      # a tie in item 1
    perms = list(itertools.permutations(range(s)))
    te = torch.from_numpy(est).requires_grad_(True)
    tt = torch.from_numpy(tgt)

    np.testing.assert_allclose(P.pairwise_si_snr_loss(te, tt).detach().numpy(),
                               np.asarray(JP.pairwise_si_snr_loss(est, tgt)),
                               rtol=LOSS_RTOL, atol=1e-5)
    loss, perm = P.pit_loss(te, tt)
    jloss, jperm = JP.pit_loss(est, tgt)
    assert perm.dtype == torch.int32
    assert perm.tolist() == np.asarray(jperm).tolist()
    # estimate j goes to target perms[p][j]; item 1's tie goes to the first
    assert [perms[p] for p in perm.tolist()] == [(1, 2, 0), (0, 1, 2), (1, 0, 2)]
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)

    mr_est, mr_tgt = est[:, 0], tgt[:, 0]                # [B, T]: 1200 > 1024 / 2
    cases = {
        "pit_si_snr": (lambda e: P.pit_si_snr_loss(e, tt), lambda e: JP.pit_si_snr_loss(e, tgt),
                       est),
        "fixed_order": (lambda e: P.fixed_order_loss(e, tt),
                        lambda e: JP.fixed_order_loss(e, tgt), est),
        "mr_l1_tfd": (lambda e: P.mr_l1_tfd_loss(e, torch.from_numpy(mr_tgt)),
                      lambda e: JP.mr_l1_tfd_loss(e, mr_tgt), mr_est),
        "pit_mr_l1": (lambda e: P.pit_loss(e, tt, S._mr_l1_per_item)[0],
                      lambda e: JP.pit_loss(e, tgt, JS._mr_l1_per_item)[0], est),
        "fixed_mr_l1": (lambda e: P.fixed_order_loss(e, tt, S._mr_l1_per_item),
                        lambda e: JP.fixed_order_loss(e, tgt, JS._mr_l1_per_item), est),
    }
    for name, (ours, theirs, x) in cases.items():
        xt = torch.from_numpy(x).requires_grad_(True)
        val = ours(xt)
        (g,) = torch.autograd.grad(val, [xt])
        jval, jg = jax.jit(jax.value_and_grad(theirs))(jnp.asarray(x))
        np.testing.assert_allclose(val.item(), float(jval), rtol=LOSS_RTOL, err_msg=name)
        _grad_close(g.numpy(), np.asarray(jg), name)


def test_stoi_matches_jax(rng):
    """Numpy on both sides, the same resample: equal to float64 rounding,
    at 8 kHz (resampled to 10 kHz) and at 10 kHz, with a silent stretch for
    the 40 dB frame selection."""
    for sr in (8000, 10000):
        clean = rng.standard_normal(3 * sr).astype(np.float32) * 0.1
        clean[sr // 2: sr] = 0.0
        noisy = (clean + 0.05 * rng.standard_normal(clean.shape)).astype(np.float32)
        got = compute_stoi(clean, noisy, sr)
        np.testing.assert_allclose(got, jax_stoi(clean, noisy, sr), rtol=1e-9)
        assert 0.0 < got < 1.0
        assert compute_stoi(clean, clean, sr) == pytest.approx(1.0, abs=1e-6)
    assert np.isnan(compute_stoi(np.zeros(100), np.zeros(100), 10000))
