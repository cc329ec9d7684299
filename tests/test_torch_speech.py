"""The port's speech separator on the CPU against the JAX package: the
``TFLocoformerSeparator`` (num_spk 1 and 2, k 4 and 8, RoPE and no
positional encoding) from seeded weights in the JAX parameter tree carried
across by ``jax_params_to_state_dict`` and loaded with ``strict=True``, the
ESPnet adapter, the ``SpeechSeparator`` pipeline end to end at n_fft 128 /
hop 64, the key schema (ESPnet's ``separator.`` prefix) and the speech
configs.  fp32 on both sides; emb 32, 2 heads, I 64: widths the fused steps'
gates admit, so the blocks take the route the published configs take on the
card (their plain versions here)."""

import dataclasses
import functools
import glob
import json
import os

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from mss_tf_locoformer_tpu.core import config as JC
from mss_tf_locoformer_tpu.models.espnet_compat import ESPnetSeparatorAdapter as JaxAdapter
from mss_tf_locoformer_tpu.models.espnet_compat import SpeechSeparator as JaxPipeline
from mss_tf_locoformer_tpu.models.tflocoformer import TFLocoformerSeparator as JaxSeparator
from mss_tf_locoformer_tpu_torch.convert.torch_ckpt import jax_params_to_state_dict
from mss_tf_locoformer_tpu_torch.core import config as C
from mss_tf_locoformer_tpu_torch.infer.separate import load_speech_separator
from mss_tf_locoformer_tpu_torch.models import TFLocoformerSeparator
from mss_tf_locoformer_tpu_torch.models.espnet_compat import (ESPnetSeparatorAdapter,
                                                              SpeechSeparator)
from torch_routes import spy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# fp32 on both sides: the stems' tolerances of tests/test_torch_model.py
ATOL, RTOL = 5e-4, 1e-3
N_FFT, HOP = 128, 64
FRAMES = 40                       # one spectrogram length for every JAX call
_TINY = dict(n_layers=1, emb_dim=32, num_groups=4, n_heads=2, attention_dim=32,
             ffn_type=("swiglu_conv1d", "swiglu_conv1d"), ffn_hidden_dim=(64, 64),
             flash_attention=True, fused_ffn=True)
# (num_spk, conv1d_kernel, pos_enc): each value of each axis at least once
CASES = [(2, 4, "rope"), (1, 8, "rope"), (2, 8, "nope"), (1, 4, "nope")]


def _fill(rng):
    """Seeded values for a JAX parameter tree: norm scales 1 + 0.1 N(0, 1),
    shifts and biases 0.1 N(0, 1), weights N(0, 1 / fan_in)."""
    def fill(path, leaf):
        z = rng.standard_normal(leaf.shape).astype(np.float32)
        if leaf.ndim == 1:
            return np.float32(path[-1].key != "bias") + 0.1 * z
        return z / np.float32(np.sqrt(np.prod(leaf.shape[:-1])))
    return fill


@functools.lru_cache(maxsize=None)
def _pair(num_spk, k, pos_enc):
    """(port separator, JAX separator, JAX params) on the same weights: the
    JAX tree's shapes from ``jax.eval_shape(init)`` (an op-by-op init costs
    as many compiles as the forward), filled with seeded values."""
    kw = dict(_TINY, num_spk=num_spk, conv1d_kernel=k, pos_enc=pos_enc)
    jmod = JaxSeparator(**JC.SeparatorConfig(**kw).module_kwargs())
    spec = np.zeros((2, FRAMES, N_FFT // 2 + 1), np.complex64)
    params = jax.tree_util.tree_map_with_path(
        _fill(np.random.default_rng(num_spk * 100 + k)),
        jax.eval_shape(jmod.init, jax.random.PRNGKey(0), spec))
    model = TFLocoformerSeparator(C.SeparatorConfig(**kw))
    model.load_state_dict(jax_params_to_state_dict(params), strict=True)
    return model.eval(), jmod, params


def _spec(rng, b=2, frames=FRAMES):
    f = N_FFT // 2 + 1
    return (0.3 * (rng.standard_normal((b, frames, f))
                   + 1j * rng.standard_normal((b, frames, f)))).astype(np.complex64)


@pytest.mark.parametrize("num_spk,k,pos_enc", CASES)
def test_separator_matches_jax(rng, monkeypatch, num_spk, k, pos_enc):
    """Complex ``[B, S, T, F]`` of the port against the JAX separator on the
    fused-step route; ``[B, 1, T, F]`` input gives the same."""
    model, jmod, params = _pair(num_spk, k, pos_enc)
    spec = _spec(rng)
    calls = spy(monkeypatch)
    with torch.no_grad():
        got = model(torch.from_numpy(spec))
        again = model(torch.from_numpy(spec[:, None]))
    # 1 layer x 2 paths x 2 calls: two FFN steps and one attention step each
    assert calls == {"fused_norm_ffn_residual": 8, "fused_attention_block": 4,
                     "swiglu_conv_deconv": 0, "flash_attention": 0}
    want = np.asarray(jmod.apply(params, spec))
    assert got.shape == want.shape == (2, num_spk, FRAMES, N_FFT // 2 + 1)
    assert got.dtype == torch.complex64
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(again, got, atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError, match="monaural"):
        model(torch.zeros(1, 2, FRAMES, N_FFT // 2 + 1, dtype=torch.complex64))


def test_adapter_and_pipeline_match_jax(rng):
    """The ESPnet 3-tuple and ``SpeechSeparator`` (std normalisation, STFT,
    separator, iSTFT at the input's length, scale restored) against the JAX
    ones, at n_fft 128 / hop 64 on a length whose frame count is FRAMES."""
    model, jmod, params = _pair(2, 4, "rope")
    spec = _spec(rng)
    masked, ilens, others = ESPnetSeparatorAdapter(model)(torch.from_numpy(spec),
                                                          torch.tensor([FRAMES] * 2))
    jmasked, _, jothers = JaxAdapter(jmod, params)(spec)
    assert len(masked) == 2 and others == jothers == {} and ilens.tolist() == [FRAMES] * 2
    for a, b in zip(masked, jmasked):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, rtol=RTOL)

    t = (FRAMES - 1) * HOP                     # 1 + T / hop frames: FRAMES
    audio = (0.2 * rng.standard_normal((2, t))).astype(np.float32)
    audio[1] *= 3.0                            # per-item scales differ
    got = SpeechSeparator(model, N_FFT, HOP)(audio)
    want = JaxPipeline(jmod, params, N_FFT, HOP)(audio)
    assert got.shape == want.shape == (2, 2, t)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    one = SpeechSeparator(model, N_FFT, HOP)(audio[0])
    np.testing.assert_allclose(one, got[:1], atol=1e-6, rtol=1e-5)


def test_key_schema_and_espnet_checkpoint(tmp_path):
    """The port's keys are the reference separator's (``conv.0``, ``conv.1``,
    ``blocks.0``, ``deconv``); an ESPnet-prefixed ``.pth`` loads through
    ``load_speech_separator`` with ``strict=True``, fp32 blocks by default
    (as the JAX loader),
    on the device asked for; an orbax directory is refused."""
    model, _, _ = _pair(2, 4, "rope")
    keys = set(model.state_dict())
    assert {"conv.0.weight", "conv.1.weight", "conv.1.bias", "deconv.weight",
            "deconv.bias"} <= keys
    assert any(k.startswith("blocks.0.freq_path.ffn.1.") for k in keys)
    torch.save({f"separator.{k}": v for k, v in model.state_dict().items()}
               | {"encoder.stft.window": torch.ones(3)}, tmp_path / "espnet.pth")
    cfg = C.SpeechConfig(separator=model.config)
    loaded = load_speech_separator(str(tmp_path / "espnet.pth"), cfg, device="cpu")
    assert not loaded.training and loaded.precision.compute_dtype == torch.float32
    for k, v in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
    with pytest.raises(NotImplementedError, match="orbax"):
        load_speech_separator(str(tmp_path), cfg, device="cpu")


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(REPO, "configs", "speech_*.yaml"))),
                         ids=os.path.basename)
def test_speech_configs_match_jax(path, tmp_path):
    """Every speech YAML field for field as the JAX loader reads it, the same
    from JSON (no PyYAML needed) and from ``chip_smoke.speech_config`` (the
    configs built in code for the card), and a separator of it takes the
    fused steps in eval and in training."""
    cfg = C.load_speech_config(path)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(JC.load_speech_config(path))
    name = os.path.basename(path)[len("speech_"):-len(".yaml")]
    assert chip_smoke.speech_config(name) == cfg
    import yaml
    with open(path) as f:
        raw = yaml.safe_load(f)
    (tmp_path / "c.json").write_text(json.dumps(raw))
    assert C.load_speech_config(str(tmp_path / "c.json")) == cfg
    sep = TFLocoformerSeparator(dataclasses.replace(cfg.separator, n_layers=1))
    for training in (False, True):
        sep.train(training)
        for path_ in (sep.blocks[0].freq_path, sep.blocks[0].frame_path):
            assert path_.fused_steps() == ([True, True], True)


def test_speech_config_rejects_unknown_keys():
    with pytest.raises(ValueError, match=r"Valid: \['dataset'"):
        C.speech_config_from_dict({"separatorr": {}})
    with pytest.raises(ValueError, match="n_layer.*Valid keys"):
        C.speech_config_from_dict({"separator": {"n_layer": 2}})
    with pytest.raises(ValueError, match="criterion"):
        C.speech_config_from_dict({"loss": {"criterion": "l2"}})
    raw = {"training": {"warmup_steps": 7, "early_stopping": {"patience": 3}}}
    got, want = C.speech_config_from_dict(raw), JC.speech_config_from_dict(raw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.training.scheduler.warmup_steps == 7
    assert not got.training.early_stopping.enabled
