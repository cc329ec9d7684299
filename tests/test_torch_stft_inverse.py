"""#10, the iSTFT's windowed inverse DFT, on the CPU: the port's plain frames
and iSTFT (the versions the CUDA kernel is held against on the card) against
the JAX package's Pallas ``_windowed_frames`` and ``istft_pallas`` in
interpret mode, as tests/test_stft_pallas.py runs them on the CPU, and the
gradient against ``jax.grad``.  The kernel's own arithmetic (an FFT) is
emulated in tests/test_torch_fft_plan.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mss_tf_locoformer_tpu.ops import stft as JS
from mss_tf_locoformer_tpu.ops.pallas import stft_kernel as JK
from mss_tf_locoformer_tpu_torch.ops.cuda import stft_kernel as SK

CONFIGS = [(512, 128), (1024, 256)]
# Both sides fp32 (the Pallas product at HIGHEST precision, torch's irfft):
# measured <= 6e-7 of max|frame|, and <= 2e-6 absolute on unit-variance
# audio (peak ~3.7); 1e-5 leaves a factor of 5 to 20 and still sees any
# wrong bin, sign or window sample, which are O(1).
TOL = 1e-5


def _spec(rng, n_fft, hop):
    t = 2 * n_fft + 333
    audio = rng.standard_normal((2, t), dtype=np.float32)
    return np.array(JS.stft(jnp.asarray(audio), n_fft, hop)), t


@pytest.mark.parametrize("n_fft,hop", CONFIGS)
def test_windowed_frames_match_pallas(rng, n_fft, hop):
    spec, _ = _spec(rng, n_fft, hop)
    r, f, n = spec.shape
    f_pad, n_pad = -(-f // JK.LANE) * JK.LANE, -(-n // JK.BLK_N) * JK.BLK_N
    re = np.zeros((r, n_pad, f_pad), np.float32)
    im = np.zeros_like(re)
    re[:, :n, :f] = spec.real.transpose(0, 2, 1)
    im[:, :n, :f] = spec.imag.transpose(0, 2, 1)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(JK._windowed_frames(jnp.asarray(re), jnp.asarray(im), n_fft))[:, :n]
    got = SK.windowed_frames(torch.from_numpy(spec), n_fft).numpy()
    assert got.shape == (r, n, n_fft)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=TOL * scale, rtol=0)


@pytest.mark.parametrize("n_fft,hop", CONFIGS)
def test_istft_matches_pallas(rng, n_fft, hop):
    spec, t = _spec(rng, n_fft, hop)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(JK.istft_pallas(jnp.asarray(spec), n_fft, hop, t))
    got = SK.istft_fused(torch.from_numpy(spec), n_fft, hop, t).numpy()
    assert got.shape == want.shape == (2, t)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    # no length: the centre crop of torch.istft
    short = SK.istft_fused(torch.from_numpy(spec), n_fft, hop)
    assert short.shape == (2, (spec.shape[-1] - 1) * hop)
    np.testing.assert_allclose(short.numpy(), got[:, :short.shape[-1]], atol=TOL, rtol=0)


def test_istft_gradient_matches_jax(rng):
    """The gradient of a real loss through #10 against ``jax.grad`` through
    ``istft_pallas`` (interpret mode).  JAX's gradient with respect to a
    complex input is the conjugate of torch's."""
    n_fft, hop = 512, 128
    spec, t = _spec(rng, n_fft, hop)
    g = rng.standard_normal((2, t)).astype(np.float32)

    def loss(s):
        return jnp.sum(JK.istft_pallas(s, n_fft, hop, t) * g)

    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax.grad(loss)(jnp.asarray(spec)))
    s = torch.from_numpy(spec).requires_grad_(True)
    (SK.istft_fused(s, n_fft, hop, t) * torch.from_numpy(g)).sum().backward()
    got = s.grad.numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, np.conj(want), atol=TOL * scale, rtol=0)


def test_istft_refuses_devices_without_a_kernel():
    """Neither wrapper falls back: a tensor that is on neither the CPU nor
    the card raises."""
    spec = torch.zeros(1, 129, 8, dtype=torch.complex64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        SK.istft_fused(spec, 256, 64)
    with pytest.raises(ValueError, match="unsupported device"):
        SK.windowed_frames(spec, 256)
