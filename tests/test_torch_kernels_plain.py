"""The port's kernel modules on the CPU (their plain PyTorch versions) against
the JAX package: the STFT, the fused FFN step and the fused attention step,
each against the JAX Pallas kernel in interpret mode and against its plain
JAX reference, plus RoPE and RMSGroupNorm.  fp32 throughout; inputs from a
numpy seed, handed to both frameworks."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mss_tf_locoformer_tpu.nn.norms import RMSGroupNorm as JaxRMSGroupNorm
from mss_tf_locoformer_tpu.ops import rope as jrope
from mss_tf_locoformer_tpu.ops import stft as jstft
from mss_tf_locoformer_tpu.ops.pallas import attention_block as JAB
from mss_tf_locoformer_tpu.ops.pallas import stft_kernel as JSK
from mss_tf_locoformer_tpu.ops.pallas import swiglu_block as JFB
from mss_tf_locoformer_tpu_torch.nn.norms import RMSGroupNorm
from mss_tf_locoformer_tpu_torch.ops import rope
from mss_tf_locoformer_tpu_torch.ops.cuda import attention_block as AB
from mss_tf_locoformer_tpu_torch.ops.cuda import stft_kernel as SK
from mss_tf_locoformer_tpu_torch.ops.cuda import swiglu_block as FB


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32))


@pytest.mark.parametrize("n_fft,hop", [(256, 64), (512, 128)])
def test_stft_matches_jax(rng, n_fft, hop):
    audio = rng.standard_normal((2, 3 * n_fft + 517)).astype(np.float32)
    got = SK.stft_fused(_t(audio), n_fft, hop).numpy()
    want = np.asarray(jstft.stft(jnp.asarray(audio), n_fft, hop))
    scale = np.abs(want).max()
    # fp32 FFTs in two frameworks: rounding only
    np.testing.assert_allclose(got, want, atol=2e-5 * scale, rtol=1e-4)
    if JSK.supports(n_fft, hop, audio.shape[-1]):
        with pltpu.force_tpu_interpret_mode():
            pallas = np.asarray(JSK.stft_pallas(jnp.asarray(audio), n_fft, hop))
        # interpret mode computes the window-folded DFT products exactly in
        # fp32 (the tolerance of tests/test_stft_pallas.py)
        np.testing.assert_allclose(got, pallas, atol=2e-4 * scale, rtol=1e-4)


def _ffn_args(rng, r, seq, c, inner, k):
    return [rng.standard_normal((r, seq, c)).astype(np.float32),
            (1.0 + 0.1 * rng.standard_normal(c)).astype(np.float32),
            (rng.standard_normal((2 * inner, c, k)) * 0.2).astype(np.float32),
            (rng.standard_normal(2 * inner) * 0.1).astype(np.float32),
            (rng.standard_normal((inner, c, k)) * 0.2).astype(np.float32),
            (rng.standard_normal(c) * 0.1).astype(np.float32)]


@pytest.mark.parametrize("r,seq,c,inner,k,groups", [
    (3, 41, 32, 64, 4, 4),
    (2, 130, 96, 96, 4, 4),     # base width, ragged past one 64-row tile
    (2, 37, 48, 64, 3, 6),
])
def test_ffn_step_matches_jax(rng, r, seq, c, inner, k, groups):
    args = _ffn_args(rng, r, seq, c, inner, k)
    got = FB.fused_norm_ffn_residual(*map(_t, args), k, groups, 1e-5).numpy()
    jargs = [jnp.asarray(a) for a in args]
    want = np.asarray(JFB.reference_norm_ffn_residual(*jargs, k, groups, 1e-5))
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(JFB.fused_norm_ffn_residual(*jargs, k, groups, 1e-5))
    scale = max(np.abs(want).max(), 1.0)
    # fp32 both sides (tests/test_swiglu_block.py's interpret tolerance)
    np.testing.assert_allclose(got, want, atol=1e-4 * scale, rtol=2e-3)
    np.testing.assert_allclose(got, pallas, atol=1e-4 * scale, rtol=2e-3)


def _attn_args(rng, r, seq, c, a):
    return [(0.5 * rng.standard_normal((r, seq, c))).astype(np.float32),
            (1.0 + 0.1 * rng.standard_normal(c)).astype(np.float32),
            (rng.standard_normal((3 * a, c)) / np.sqrt(c)).astype(np.float32),
            (rng.standard_normal((c, a)) / np.sqrt(a)).astype(np.float32)]


@pytest.mark.parametrize("c,a,h,seq,rope_on", [
    (32, 32, 2, 37, True),      # ragged: L below one 64-row tile
    (96, 96, 4, 130, True),     # base dims (head_dim 24), ragged past two tiles
    (64, 96, 3, 50, False),     # attention_dim != emb_dim, NoPE
])
def test_attention_step_matches_jax(rng, c, a, h, seq, rope_on):
    args = _attn_args(rng, 2, seq, c, a)
    got = AB.fused_attention_block(*map(_t, args), h, 4, 1e-5, rope_on).numpy()
    jargs = [jnp.asarray(x) for x in args]
    want = np.asarray(JAB.reference_attention_block(*jargs, h, 4, 1e-5, rope_on))
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(JAB.fused_attention_block(*jargs, h, 4, 1e-5, rope_on))
    scale = max(np.abs(want).max(), 1.0)
    # fp32 both sides (tests/test_attention_block.py's interpret tolerance)
    np.testing.assert_allclose(got, want, atol=2e-4 * scale, rtol=2e-3)
    np.testing.assert_allclose(got, pallas, atol=2e-4 * scale, rtol=2e-3)


@pytest.mark.parametrize("seq,dim", [(37, 24), (130, 16)])
def test_rope_matches_jax(rng, seq, dim):
    x = rng.standard_normal((2, 3, seq, dim)).astype(np.float32)
    got = rope.apply_rope(_t(x)).numpy()
    want = np.asarray(jrope.apply_rope(jnp.asarray(x)))
    # same float64 angle tables cast to fp32; fp32 rotation
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_rms_group_norm_matches_jax(rng):
    x = (3.0 * rng.standard_normal((2, 5, 7, 96))).astype(np.float32)
    gamma = (1.0 + 0.1 * rng.standard_normal(96)).astype(np.float32)
    norm = RMSGroupNorm(4, 96, eps=1e-5)
    with torch.no_grad():
        norm.gamma.copy_(_t(gamma))
        got = norm(_t(x)).numpy()
    want = np.asarray(JaxRMSGroupNorm(4, 96, eps=1e-5).apply(
        {"params": {"gamma": jnp.asarray(gamma)}}, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_ffn_panels_hold_the_torch_weights(rng):
    """The kernel's chunked weight panels are a permutation of the torch
    weights: every conv/deconv tap lands where the kernel reads it."""
    c, inner, k = 32, 64, 4
    conv_w = _t(rng.standard_normal((2 * inner, c, k)))
    conv_b = _t(rng.standard_normal(2 * inner))
    deconv_w = _t(rng.standard_normal((inner, c, k)))
    wc, bc, wd = FB.ffn_panels(conv_w, conv_b, deconv_w, torch.float32)
    ic = FB.IC
    for ch, i, cc, t in [(0, 0, 0, 0), (1, 5, 17, 3), (1, 31, 31, 2)]:
        o = ch * ic + i
        assert wc[ch, t * c + cc, i] == conv_w[o, cc, t]            # value
        assert wc[ch, t * c + cc, ic + i] == conv_w[inner + o, cc, t]  # gate
        assert bc[ch, ic + i] == conv_b[inner + o]
        assert wd[ch, t, i, cc] == deconv_w[o, cc, t]


def test_wrappers_refuse_devices_without_a_kernel():
    """Off the CPU, a wrapper launches its kernel or raises: a meta tensor
    (no device) is refused rather than silently computed another way."""
    x = torch.empty(2, 8, 32, device="meta")
    with pytest.raises(ValueError):
        FB.fused_norm_ffn_residual(x, x[0, 0], x, x, x, x, 4, 4, 1e-5)
    with pytest.raises(ValueError):
        AB.fused_attention_block(x, x[0, 0], x, x, 2, 4, 1e-5)
    with pytest.raises(ValueError):
        SK.stft_fused(torch.empty(2, 4000, device="meta"), 256, 64)
