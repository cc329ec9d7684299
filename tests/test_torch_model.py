"""The port's whole model and separation engine on the CPU against the JAX
package: weights made by the JAX model's ``init``, carried across by
``jax_params_to_state_dict`` and loaded with ``strict=True``; stems compared
in fp32 (tolerances of tests/test_parity_model.py)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from mss_tf_locoformer_tpu.convert.torch_ckpt import convert_state_dict
from mss_tf_locoformer_tpu.core.config import ModelConfig as JaxModelConfig
from mss_tf_locoformer_tpu.infer.overlap_add import SeparationEngine as JaxEngine
from mss_tf_locoformer_tpu.models.mss_tflocoformer import TFLocoformerMSS as JaxMSS
from mss_tf_locoformer_tpu_torch.convert.torch_ckpt import jax_params_to_state_dict
from mss_tf_locoformer_tpu_torch.core.config import ModelConfig
from mss_tf_locoformer_tpu_torch.infer.overlap_add import SeparationEngine
from mss_tf_locoformer_tpu_torch.models import build_model
from torch_routes import spy

STEMS = ("vocals", "drums", "bass", "other")
# emb 32 and inner widths of whole 32-channel chunks: widths the fused steps'
# gates admit (ops/cuda/swiglu_block.py::supports_step, attention_block.py::
# supports_block), so that the kernel path is the fused steps of the base
# config's route
_TINY = dict(n_fft=256, hop_length=64, n_layers=2, emb_dim=32, num_groups=4,
             n_heads=2, attention_dim=32,
             ffn_type=("swiglu_conv1d", "swiglu_conv1d"),
             ffn_hidden_dim=(64, 32), conv1d_kernel=4, conv1d_shift=1)


def _pair(rng, tf_order="ft", fused=True):
    """(port model, JAX model, JAX params) sharing JAX-initialised weights,
    norm scales perturbed so that every gamma is exercised."""
    kw = dict(_TINY, tf_order=tf_order, fused_stft=fused, fused_ffn=fused,
              flash_attention=fused)
    jmodel = JaxMSS(JaxModelConfig(**kw))
    params = jmodel.init(jax.random.PRNGKey(0), np.zeros((1, 2048), np.float32))
    sd = jax_params_to_state_dict(jax.device_get(params))
    for key in sd:
        if key.endswith("gamma"):
            sd[key] = sd[key] + torch.from_numpy(
                0.1 * rng.standard_normal(sd[key].shape).astype(np.float32))
    model = build_model(ModelConfig(**kw))
    model.load_state_dict(sd, strict=True)
    jparams = convert_state_dict({k: v.numpy() for k, v in sd.items()})
    return model.eval(), jmodel, jparams


@pytest.mark.parametrize("fused", [True, False], ids=["kernel_path", "unfused"])
@pytest.mark.parametrize("tf_order", ["ft", "tf"])
def test_model_matches_jax(rng, monkeypatch, tf_order, fused):
    model, jmodel, jparams = _pair(rng, tf_order, fused)
    x = (0.5 * rng.standard_normal((2, 4000))).astype(np.float32)
    calls = spy(monkeypatch)
    with torch.inference_mode():
        got = model(torch.from_numpy(x))
    # 2 layers x 2 paths: 2 FFN steps and 1 attention step each, all fused on
    # the kernel path; none of the kernels with the flags off
    steps = 8 if fused else 0
    assert calls == {"fused_norm_ffn_residual": steps, "fused_attention_block": steps // 2,
                     "swiglu_conv_deconv": 0, "flash_attention": 0}
    want = jmodel.apply(jparams, x)
    for name in STEMS:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   atol=5e-4, rtol=1e-3, err_msg=name)


def test_state_dict_schema_matches_jax_export(rng):
    """Every key of the JAX export is a port parameter and vice versa."""
    model, _, _ = _pair(rng)
    jmodel = JaxMSS(JaxModelConfig(**_TINY))
    params = jmodel.init(jax.random.PRNGKey(1), np.zeros((1, 2048), np.float32))
    sd = jax_params_to_state_dict(jax.device_get(params))
    assert set(sd) == set(model.state_dict())
    for key, value in model.state_dict().items():
        assert tuple(sd[key].shape) == tuple(value.shape), key


def test_separation_engine_matches_jax(rng):
    model, jmodel, jparams = _pair(rng)
    chunk, overlap, batch = 2048, 512, 2
    audio = (0.3 * rng.standard_normal(5000)).astype(np.float32)  # 3 chunks
    got = SeparationEngine(model, chunk, overlap, batch, device="cpu")(audio)
    want = JaxEngine(jmodel.apply, chunk, overlap, batch, params=jparams)(audio)
    assert set(got) == set(STEMS)
    for name in STEMS:
        assert got[name].shape == (5000,)
        np.testing.assert_allclose(got[name], want[name], atol=5e-4, rtol=1e-3,
                                   err_msg=name)


def test_spectral_output_matches_jax(rng):
    model, jmodel, jparams = _pair(rng)
    x = (0.5 * rng.standard_normal((1, 3000))).astype(np.float32)
    with torch.inference_mode():
        got = model(torch.from_numpy(x), return_time_domain=False)
    want = jmodel.apply(jparams, x, return_time_domain=False)
    for name in STEMS:
        assert got[name].shape == want[name].shape
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   atol=5e-4, rtol=1e-3, err_msg=name)


def test_bf16_blocks_stay_close_to_fp32(rng):
    """The bf16 policy keeps the fp32 islands: stems stay within bf16
    rounding of the fp32 model on the same weights."""
    from mss_tf_locoformer_tpu_torch.core.precision import BF16
    cfg = ModelConfig(**dict(_TINY, fused_ffn=True, flash_attention=True,
                             fused_stft=True))
    gen_sd = build_model(cfg, generator=torch.Generator().manual_seed(3)).state_dict()
    fp32 = build_model(cfg)
    bf16 = build_model(dataclasses.replace(cfg), precision=BF16)
    fp32.load_state_dict(gen_sd)
    bf16.load_state_dict(gen_sd)
    x = torch.from_numpy((0.5 * rng.standard_normal((1, 3000))).astype(np.float32))
    with torch.inference_mode():
        a, b = fp32(x), bf16(x)
    for name in STEMS:
        assert b[name].dtype == torch.float32
        rel = ((a[name] - b[name]).norm() / a[name].norm()).item()
        assert rel < 5e-2, (name, rel)
