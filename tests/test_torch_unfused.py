"""The port's unfused route on the CPU against the JAX package: the plain
versions of the flash-attention kernel (#6) and the FFN-core kernel (#8)
against the JAX Pallas kernels in interpret mode, the step gates computed
from the H100 layouts, blocks and a model of the xlarge structure (and a
LayerNorm block) taking that route, the chunked plain attention, and the
xlarge config ``chip_smoke.py`` builds.  fp32 throughout; inputs from a
numpy seed, handed to both frameworks."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util
from jax.experimental.pallas import tpu as pltpu

import chip_smoke
from mss_tf_locoformer_tpu.convert.torch_ckpt import convert_state_dict
from mss_tf_locoformer_tpu.core.config import ModelConfig as JaxModelConfig
from mss_tf_locoformer_tpu.core.config import load_config
from mss_tf_locoformer_tpu.models.mss_tflocoformer import TFLocoformerMSS as JaxMSS
from mss_tf_locoformer_tpu.nn.blocks import LocoformerBlock as JaxBlock
from mss_tf_locoformer_tpu.ops.pallas import flash_attention as JFA
from mss_tf_locoformer_tpu.ops.pallas import swiglu_ffn as JFFN
from mss_tf_locoformer_tpu_torch.convert.torch_ckpt import jax_params_to_state_dict
from mss_tf_locoformer_tpu_torch.core.config import ModelConfig, load_model_config
from mss_tf_locoformer_tpu_torch.models import build_model
from mss_tf_locoformer_tpu_torch.nn.blocks import LocoformerBlock
from mss_tf_locoformer_tpu_torch.ops import attention as plain_attention
from mss_tf_locoformer_tpu_torch.ops.cuda import SMEM_OPTIN
from mss_tf_locoformer_tpu_torch.ops.cuda import attention_block as AB
from mss_tf_locoformer_tpu_torch.ops.cuda import flash_attention as FA
from mss_tf_locoformer_tpu_torch.ops.cuda import swiglu_block as FB
from mss_tf_locoformer_tpu_torch.ops.cuda import swiglu_ffn as SF
from torch_routes import spy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEMS = ("vocals", "drums", "bass", "other")


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32))


# ------------------------------------------------------- (a) flash attention

@pytest.mark.parametrize("d,seq,rope", [(12, 65, True), (16, 130, False), (24, 65, True)])
def test_flash_attention_matches_jax(rng, d, seq, rope):
    q, k, v = ((0.7 * rng.standard_normal((1, 2, seq, d))).astype(np.float32)
               for _ in range(3))
    got = FA.flash_attention(_t(q), _t(k), _t(v), rope).numpy()
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(JFA.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                              jnp.asarray(v), rope))
    # fp32 both sides; softmax shifted differently (exact max here, the TPU
    # kernel's bounded shift there): rounding only
    np.testing.assert_allclose(got, want, atol=2e-5 * np.abs(want).max(), rtol=0)


# ------------------------------------------------------------ (b) FFN core

@pytest.mark.parametrize("r,seq,c,inner,k", [(2, 37, 48, 64, 4), (2, 11, 256, 64, 4),
                                             (3, 11, 48, 32, 3)])
def test_ffn_core_matches_jax(rng, r, seq, c, inner, k):
    lin = seq + 2 * (k - 1)
    x = np.zeros((r, lin, c), np.float32)           # pre-padded rows
    x[:, k - 1:k - 1 + seq] = rng.standard_normal((r, seq, c))
    b = (c * k) ** -0.5
    w = [rng.uniform(-b, b, s).astype(np.float32)
         for s in ((2 * inner, c, k), (2 * inner,), (inner, c, k), (c,))]
    got = SF.swiglu_conv_deconv(_t(x), *map(_t, w), k).numpy()
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(JFFN.swiglu_conv_deconv(jnp.asarray(x), *map(jnp.asarray, w), k))
    assert got.shape == want.shape == (r, lin, c)
    # fp32 both sides (tests/test_swiglu_fused.py's interpret tolerance)
    np.testing.assert_allclose(got, want, atol=1e-4 * max(np.abs(want).max(), 1.0),
                               rtol=2e-3)


def test_core_panels_pad_the_inner_channels(rng):
    """The FFN core's 64-channel chunks: every tap lands where the kernel
    reads it, and the inner channels past I are zero (h = 0 there)."""
    c, inner, k, ic = 32, 40, 4, SF.IC
    conv_w, conv_b, deconv_w = (_t(rng.standard_normal(s))
                                for s in ((2 * inner, c, k), (2 * inner,), (inner, c, k)))
    wc, bc, wd = FB.ffn_panels(conv_w, conv_b, deconv_w, torch.float32, ic=ic)
    assert wc.shape == (1, k * c, 2 * ic) and bc.shape == (1, 2 * ic)
    assert wd.shape == (1, k, ic, c)
    for i, cc, t in [(0, 0, 0), (39, 31, 3), (17, 5, 2)]:
        assert wc[0, t * c + cc, i] == conv_w[i, cc, t]                 # value
        assert wc[0, t * c + cc, ic + i] == conv_w[inner + i, cc, t]    # gate
        assert bc[0, ic + i] == conv_b[inner + i]
        assert wd[0, t, i, cc] == deconv_w[i, cc, t]
    assert not (wc[..., inner:ic].any() or wc[..., ic + inner:].any()
                or bc[:, inner:ic].any() or wd[:, :, inner:].any())


# ------------------------------------------------------------------ (c) gates

def test_gates_pin_the_layout_bytes():
    """The bytes the gates compute are those of the .cu layouts (the FFN
    step's Lay<C>::bytes(4) at C 256, its Hopper forward's FLay at C 96 and
    128; the attention step's QKV launch, qkv_bytes), which
    tests/test_torch_cuda_kernels.py holds against the compiled kernels'
    own count."""
    assert SMEM_OPTIN == 232448
    assert [FB.step_bytes(c, 4) for c in (256, 96, 128)] == [283904, 225400, 217176]
    assert [AB.launch_bytes(c, c, h)["qkv"] for c, h in ((256, 16), (96, 4), (128, 8))] \
        == [168960, 33280, 52224]
    assert SF.core_bytes(256) == 220280 <= SMEM_OPTIN


@pytest.mark.parametrize("training", [False, True], ids=["eval", "training"])
@pytest.mark.parametrize("name,admitted", [("musdb18_xlarge", False), ("musdb18_small", False),
                                           ("musdb18", True), ("musdb18_medium", True)])
def test_gates_refuse_xlarge_and_small_admit_base_and_medium(name, admitted, training):
    cfg = load_model_config(os.path.join(REPO, "configs", f"{name}.yaml"))
    c, a, h, k = cfg.emb_dim, cfg.attention_dim, cfg.n_heads, cfg.conv1d_kernel
    dims = cfg.ffn_hidden_dim
    for inner in dims if isinstance(dims, (tuple, list)) else (dims,):
        assert FB.supports_step(c, inner, k, training) is admitted
        # the unfused route's kernel takes every shipped width
        assert SF.supports_shape(c, inner, k)
    assert AB.supports_block(c, a, h, training) is admitted
    assert FA.supports_shape(a // h)


def test_blocks_take_the_route_the_gates_give():
    kw = dict(norm_type="rmsgroupnorm", use_rope=True, ffn_type=("swiglu_conv1d",) * 2,
              conv1d_kernel=4, conv1d_shift=1, eps=1e-5, flash_attention=True,
              fused_ffn=True)
    xl = LocoformerBlock(emb_dim=256, num_groups=8, n_heads=16, attention_dim=256,
                         ffn_hidden_dim=(1024, 1024), **kw)
    base = LocoformerBlock(emb_dim=96, num_groups=4, n_heads=4, attention_dim=96,
                           ffn_hidden_dim=(384, 384), **kw)
    for mode in (False, True):
        assert xl.train(mode).fused_steps() == ([False, False], False)
        assert base.train(mode).fused_steps() == ([True, True], True)
    assert xl.attn.flash and all(f.fused for f in xl.ffn)


# ----------------------------------------------- (d) blocks, (e) the model

def _perturb_norms(rng, params):
    """Norm scales and shifts moved off 1 and 0, so that each is exercised."""
    flat = traverse_util.flatten_dict(params)
    for key, val in flat.items():
        if "norm" in "/".join(key[:-1]) and key[-1] in ("gamma", "weight", "bias"):
            flat[key] = val + 0.1 * rng.standard_normal(val.shape).astype(np.float32)
    return traverse_util.unflatten_dict(flat)


@pytest.mark.parametrize("norm_type,groups", [("rmsgroupnorm", 8), ("layernorm", 1)])
def test_unfused_block_matches_jax(rng, monkeypatch, norm_type, groups):
    kw = dict(emb_dim=256, norm_type=norm_type, num_groups=groups, n_heads=16,
              flash_attention=True, attention_dim=256, use_rope=True,
              ffn_type=("swiglu_conv1d", "swiglu_conv1d"), ffn_hidden_dim=(64, 32),
              conv1d_kernel=4, conv1d_shift=1, fused_ffn=True, eps=1e-5)
    x = rng.standard_normal((1, 1, 17, 256)).astype(np.float32)
    jblock = JaxBlock(**kw)
    params = _perturb_norms(rng, jax.device_get(jax.jit(jblock.init)(jax.random.PRNGKey(0), x)))
    block = LocoformerBlock(**kw).eval()
    block.load_state_dict(jax_params_to_state_dict(params), strict=True)
    calls = spy(monkeypatch)
    with torch.inference_mode():
        got = block(_t(x)).numpy()
    assert calls == {"fused_norm_ffn_residual": 0, "fused_attention_block": 0,
                     "flash_attention": 1, "swiglu_conv_deconv": 2}
    want = np.asarray(jax.jit(jblock.apply)(params, x))
    # fp32 both sides (tests/test_parity_model.py's tolerances)
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=1e-3)


def test_xlarge_structure_model_matches_jax(rng, monkeypatch):
    """The xlarge config's structure (emb 256, 16 heads, 8 groups) at one
    layer, inner 64 and n_fft 256: every step on the unfused route."""
    kw = dict(n_fft=256, hop_length=64, n_layers=1, emb_dim=256, num_groups=8, n_heads=16,
              attention_dim=256, ffn_type=("swiglu_conv1d", "swiglu_conv1d"),
              ffn_hidden_dim=(64, 64), conv1d_kernel=4, conv1d_shift=1,
              fused_stft=True, fused_ffn=True, flash_attention=True)
    jmodel = JaxMSS(JaxModelConfig(**kw))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), np.zeros((1, 2048), np.float32))
    sd = jax_params_to_state_dict(_perturb_norms(rng, jax.device_get(params)))
    model = build_model(ModelConfig(**kw)).eval()
    model.load_state_dict(sd, strict=True)
    jparams = convert_state_dict({k: v.numpy() for k, v in sd.items()})
    x = (0.5 * rng.standard_normal((1, 4096))).astype(np.float32)
    calls = spy(monkeypatch)
    with torch.inference_mode():
        got = model(_t(x))
    assert calls == {"fused_norm_ffn_residual": 0, "fused_attention_block": 0,
                     "flash_attention": 2, "swiglu_conv_deconv": 4}
    want = jax.jit(jmodel.apply)(jparams, x)
    for name in STEMS:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   atol=5e-4, rtol=1e-3, err_msg=name)


# ------------------------------------------------- (f) chunked attention

@pytest.mark.parametrize("drop", [0.0, 0.3])
def test_chunked_attention_equals_one_piece(rng, monkeypatch, drop):
    q, k, v = (_t(rng.standard_normal((3, 2, 33, 8))) for _ in range(3))
    rows = torch.tensor([4, 9, 2])
    whole = plain_attention.dot_product_attention(q, k, v, drop, 17, rows)
    groups = []
    real = plain_attention._attention
    monkeypatch.setattr(plain_attention, "_attention",
                        lambda *a: groups.append(a[0].shape[0]) or real(*a))
    monkeypatch.setattr(plain_attention, "MAX_SCORE_BYTES", 4 * 33 * 33 * 4)
    chunked = plain_attention.dot_product_attention(q, k, v, drop, 17, rows)
    assert groups == [4, 2]        # 6 rows (3 x 2 heads) in groups of 4
    torch.testing.assert_close(chunked, whole, atol=1e-6, rtol=1e-6)


# ------------------------------------------------------ (g) the xlarge config

def test_chip_smoke_builds_the_xlarge_config():
    path = os.path.join(REPO, "configs", "musdb18_xlarge.yaml")
    ours = chip_smoke.xlarge_model_config()
    assert ours == load_model_config(path)
    assert dataclasses.asdict(ours) == dataclasses.asdict(load_config(path).model)


def test_unfused_wrappers_refuse_devices_without_a_kernel():
    x = torch.empty(2, 2, 8, 16, device="meta")
    with pytest.raises(ValueError):
        FA.flash_attention(x, x, x)
    w = torch.empty(1, device="meta")
    with pytest.raises(ValueError):
        SF.swiglu_conv_deconv(torch.empty(2, 14, 32, device="meta"), w, w, w, w, 4)
