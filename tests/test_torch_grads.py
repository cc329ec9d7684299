"""Gradients of the port's fused steps on the CPU (their plain versions,
autograd) against ``jax.vjp`` through the JAX package's fused steps in
Pallas interpret mode, which reaches the TPU backward kernels
``swiglu_block._blk_backward`` and ``attention_block._attn_backward_pallas``.
Dropout 0 (the TPU's mask bits cannot be matched), fp32, ragged lengths,
base widths.  Tolerances: those of tests/test_swiglu_block.py (_GATOL,
_GRTOL) and tests/test_attention_block.py in interpret mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mss_tf_locoformer_tpu.ops.pallas import attention_block as JAB
from mss_tf_locoformer_tpu.ops.pallas import swiglu_block as JFB
from mss_tf_locoformer_tpu_torch.ops.cuda import attention_block as AB
from mss_tf_locoformer_tpu_torch.ops.cuda import swiglu_block as FB


def _torch_grads(fn, args, g):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in args]
    out = fn(*ts)
    return torch.autograd.grad(out, ts, torch.from_numpy(g))


def _jax_grads(fn, args, g):
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(fn, *[jnp.asarray(a) for a in args])
        return vjp(jnp.asarray(g))


@pytest.mark.parametrize("r,seq,c,inner,k", [(2, 37, 96, 384, 4), (2, 130, 96, 384, 4)])
def test_ffn_step_grads_match_jax(rng, r, seq, c, inner, k):
    f32 = lambda a: np.asarray(a, np.float32)
    b = (c * k) ** -0.5
    args = [f32(rng.standard_normal((r, seq, c))), f32(1 + 0.1 * rng.standard_normal(c)),
            f32(rng.uniform(-b, b, (2 * inner, c, k))), f32(rng.uniform(-b, b, 2 * inner)),
            f32(rng.uniform(-b, b, (inner, c, k))), f32(rng.uniform(-b, b, c))]
    g = f32(rng.standard_normal((r, seq, c)))
    got = _torch_grads(lambda *a: FB.fused_norm_ffn_residual(*a, k, 4, 1e-5), args, g)
    want = _jax_grads(lambda *a: JFB.fused_norm_ffn_residual(*a, k, 4, 1e-5), args, g)
    names = ("dx", "dgamma", "dconv_w", "dconv_b", "ddeconv_w", "ddeconv_b")
    for name, a, w in zip(names, got, want):
        w = np.asarray(w)
        scale = max(np.abs(w).max(), 1.0)
        # interpret mode computes fp32 exactly (tests/test_swiglu_block.py)
        np.testing.assert_allclose(a.numpy(), w, atol=5e-4 * scale, rtol=5e-3, err_msg=name)


@pytest.mark.parametrize("r,seq,c,a,h,rope", [(2, 37, 96, 96, 4, True),
                                              (2, 130, 96, 96, 4, True)])
def test_attention_step_grads_match_jax(rng, r, seq, c, a, h, rope):
    f32 = lambda v: np.asarray(v, np.float32)
    args = [f32(0.5 * rng.standard_normal((r, seq, c))), f32(1 + 0.1 * rng.standard_normal(c)),
            f32(rng.standard_normal((3 * a, c)) / np.sqrt(c)),
            f32(rng.standard_normal((c, a)) / np.sqrt(a))]
    g = f32(rng.standard_normal((r, seq, c)))
    got = _torch_grads(lambda *p: AB.fused_attention_block(*p, h, 4, 1e-5, rope), args, g)
    want = _jax_grads(lambda *p: JAB.fused_attention_block(*p, h, 4, 1e-5, rope), args, g)
    for name, x, w in zip(("dx", "dgamma", "dw_qkv", "dw_out"), got, want):
        w = np.asarray(w)
        scale = max(np.abs(w).max(), 1.0)
        # tests/test_attention_block.py's interpret-mode tolerance
        np.testing.assert_allclose(x.numpy(), w, atol=5e-5 * scale, rtol=5e-4, err_msg=name)
