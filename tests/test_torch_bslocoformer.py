"""The port's BS-Locoformer on the CPU against the JAX package: the band
table, the separator and the audio -> stems model (mono and stereo, masking
on and off) from seeded weights in the JAX parameter tree carried across by
``jax_params_to_state_dict`` and loaded with ``strict=True``, the key
schema, the stereo engine, ``separate_audio`` and the configs.  fp32; sizes
of tests/test_bslocoformer_e2e.py (n_fft 256: 10 bands of unequal widths, so
a transposed band, channel or stem layout cannot pass unseen)."""

import dataclasses
import functools
import json
import os
import re

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from mss_tf_locoformer_tpu.convert.torch_ckpt import params_to_state_dict
from mss_tf_locoformer_tpu.core.config import BSModelConfig as JaxBSConfig
from mss_tf_locoformer_tpu.core.config import load_config as jax_load_config
from mss_tf_locoformer_tpu.infer.overlap_add import SeparationEngine as JaxEngine
from mss_tf_locoformer_tpu.models.bslocoformer import compute_bands as jax_compute_bands
from mss_tf_locoformer_tpu.models.bslocoformer_mss import BSLocoformerMSS as JaxBSMSS
from mss_tf_locoformer_tpu_torch.convert.torch_ckpt import (jax_params_to_state_dict,
                                                            load_torch_checkpoint)
from mss_tf_locoformer_tpu_torch.core.config import (BSModelConfig, load_config,
                                                     load_model_config)
from mss_tf_locoformer_tpu_torch.infer.overlap_add import SeparationEngine
from mss_tf_locoformer_tpu_torch.infer.separate import load_model, separate_audio
from mss_tf_locoformer_tpu_torch.models import build_model
from mss_tf_locoformer_tpu_torch.models.bslocoformer import compute_bands
from mss_tf_locoformer_tpu_torch.models.bslocoformer_mss import BSLocoformerMSS
from mss_tf_locoformer_tpu_torch.utils.audio import load_audio, save_audio
from torch_routes import spy

STEMS = ("vocals", "drums", "bass", "other")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BS_YAML = os.path.join(REPO, "configs", "musdb18_bslocoformer.yaml")
# emb 32 and inner 64: widths the fused steps' gates admit, so the blocks
# take the route the full config takes on the card (fused FFN and attention
# steps; their plain versions here)
_TINY = dict(name="bslocoformer", n_fft=256, hop_length=128, stft_size=256,
             sample_rate=44100, n_sources=4, n_layers=1, emb_dim=32, num_groups=4,
             n_heads=2, attention_dim=32, ffn_type="swiglu_conv1d", ffn_hidden_dim=64,
             flash_attention=True, fused_ffn=True)
# fp32 on both sides; the stems of tests/test_torch_model.py's tolerances
ATOL, RTOL = 5e-4, 1e-3
# one input length for every JAX call (init, model, engine chunks): the JAX
# model runs op by op, and each new shape costs compiles
N = 3000


@pytest.mark.parametrize("stft_size,sample_rate", [(2048, 44100), (4096, 44100),
                                                   (2048, 48000), (256, 44100)])
def test_compute_bands_matches_jax(stft_size, sample_rate):
    bands = compute_bands(stft_size, sample_rate)
    assert bands == jax_compute_bands(stft_size, sample_rate)
    assert sum(bands) == stft_size // 2 + 1
    if (stft_size, sample_rate) == (2048, 44100):
        assert bands == [2] * 24 + [4] * 12 + [12] * 8 + [24] * 8 + [48] * 8 + [128, 129]


@functools.lru_cache(maxsize=None)
def _pair(stereo, masking):
    """(port model, JAX model, JAX params) on the same weights: seeded
    values in the JAX model's parameter tree (its shapes from
    ``jax.eval_shape`` of ``init``: initialising op by op costs as many
    compiles as the forward), carried across by ``jax_params_to_state_dict``.
    Norm scales are 1 + 0.1 N(0, 1), shifts and biases 0.1 N(0, 1), weights
    N(0, 1 / fan_in), so that every parameter is exercised.  Built once per
    layout and shared."""
    rng = np.random.default_rng(int(stereo) * 2 + int(masking))
    kw = dict(_TINY, stereo=stereo, masking=masking)
    jmodel = JaxBSMSS(JaxBSConfig(**kw))
    example = np.zeros((2, 2, N) if stereo else (2, N), np.float32)

    def fill(path, leaf):
        z = rng.standard_normal(leaf.shape).astype(np.float32)
        if leaf.ndim == 1:
            return np.float32(path[-1].key != "bias") + 0.1 * z
        return z / np.float32(np.sqrt(np.prod(leaf.shape[:-1])))

    params = jax.tree_util.tree_map_with_path(
        fill, jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), example))
    model = build_model(BSModelConfig(**kw))
    model.load_state_dict(jax_params_to_state_dict(params), strict=True)
    return model.eval(), jmodel, params


@pytest.mark.parametrize("masking", [True, False], ids=["masking", "mapping"])
@pytest.mark.parametrize("stereo", [False, True], ids=["mono", "stereo"])
def test_bs_model_matches_jax(rng, monkeypatch, stereo, masking):
    """Stems and spectrograms (the separator's output) of the port against
    the JAX model, on the fused-step route."""
    model, jmodel, jparams = _pair(stereo, masking)
    x = (0.3 * rng.standard_normal((2, 2, N) if stereo else (2, N))).astype(np.float32)
    calls = spy(monkeypatch)
    with torch.inference_mode():
        got = model(torch.from_numpy(x))
        got_spec = model(torch.from_numpy(x), return_time_domain=False)
    # 1 layer x 2 paths: one FFN step and one attention step each
    assert calls == {"fused_norm_ffn_residual": 4, "fused_attention_block": 4,
                     "swiglu_conv_deconv": 0, "flash_attention": 0}
    want = jmodel.apply(jparams, x)
    want_spec = jmodel.apply(jparams, x, return_time_domain=False)
    for name in STEMS:
        assert got[name].shape == x.shape
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   atol=ATOL, rtol=RTOL, err_msg=name)
        np.testing.assert_allclose(got_spec[name].numpy(), np.asarray(want_spec[name]),
                                   atol=ATOL, rtol=RTOL, err_msg=name)


def test_key_schema_and_strict_roundtrip(tmp_path):
    """The port's keys are the JAX export's minus its ``separator.`` level
    (the reference separator's schema); a state_dict the port writes loads
    back with ``strict=True``, as a raw file and ESPnet-prefixed."""
    model, _, jparams = _pair(True, True)
    keys = set(params_to_state_dict(jparams["params"]["separator"]))
    assert keys == set(model.state_dict())
    assert any(k.startswith("band_split_module.band_split_module.9.1.") for k in keys)
    assert any(k.startswith("band_split_module.bandwise_decoding_module.0.4.") for k in keys)
    torch.save(model.state_dict(), tmp_path / "raw.pth")
    torch.save({f"separator.{k}": v for k, v in model.state_dict().items()},
               tmp_path / "espnet.pth")
    for name in ("raw.pth", "espnet.pth"):
        again = build_model(model.config)
        again.load_state_dict(load_torch_checkpoint(str(tmp_path / name)), strict=True)
        for k, v in model.state_dict().items():
            assert torch.equal(again.state_dict()[k], v), (name, k)


def test_stereo_engine_matches_jax(rng):
    model, jmodel, jparams = _pair(True, True)
    chunk, overlap, batch = N, N // 4, 2
    audio = (0.3 * rng.standard_normal((2, 7000))).astype(np.float32)  # 3 chunks
    got = SeparationEngine(model, chunk, overlap, batch, device="cpu")(audio)
    want = JaxEngine(jmodel.apply, chunk, overlap, batch, params=jparams)(audio)
    assert set(got) == set(STEMS)
    for name in STEMS:
        assert got[name].shape == (2, 7000)
        np.testing.assert_allclose(got[name], want[name], atol=ATOL, rtol=RTOL,
                                   err_msg=name)


def test_separate_audio_writes_stereo_stems(tmp_path, rng):
    """A stereo model's stems are written as they come (true stereo); a mono
    file is duplicated into both channels of the model's input."""
    cfg = BSModelConfig(**dict(_TINY, stereo=True))
    model = build_model(cfg, generator=torch.Generator().manual_seed(1)).eval()
    ckpt, cfg_path = tmp_path / "bs.pth", tmp_path / "bs.json"
    torch.save(model.state_dict(), ckpt)
    cfg_path.write_text(json.dumps({"model": dataclasses.asdict(cfg)}))
    model, loaded = load_model(str(ckpt), str(cfg_path), device="cpu")
    assert isinstance(model, BSLocoformerMSS) and loaded == cfg
    sr, n = 8000, 9000
    wav = tmp_path / "mix.wav"
    save_audio(str(wav), (0.3 * rng.standard_normal((2, n))).astype(np.float32), sr)
    stems = separate_audio(str(wav), str(tmp_path / "out"), model, sample_rate=sr,
                           chunk_seconds=0.5, overlap_seconds=0.125, device="cpu")
    for name in STEMS:
        assert stems[name].shape == (2, n)
        audio, rate = load_audio(str(tmp_path / "out" / f"mix_{name}.wav"))
        assert rate == sr and audio.shape == (2, n) and np.isfinite(audio).all()
        assert not np.array_equal(audio[0], audio[1])
    mono = tmp_path / "mono.wav"
    save_audio(str(mono), (0.3 * rng.standard_normal((1, n))).astype(np.float32), sr)
    stems = separate_audio(str(mono), str(tmp_path / "out"), model, sample_rate=sr,
                           chunk_seconds=0.5, overlap_seconds=0.125, save_stems=False,
                           device="cpu")
    assert all(v.shape == (2, n) for v in stems.values())


def test_bs_config_matches_yaml_and_jax(tmp_path):
    """``chip_smoke.bs_model_config()`` is the YAML's model section; the port
    reads the YAML as the JAX package does; its model has 62 bands, takes
    the fused steps in every block, in eval and in training, and
    ``load_model`` loads a checkpoint of it with the YAML."""
    cfg = load_model_config(BS_YAML)
    assert isinstance(cfg, BSModelConfig)
    assert chip_smoke.bs_model_config() == cfg
    assert dataclasses.asdict(load_config(BS_YAML)) == dataclasses.asdict(
        jax_load_config(BS_YAML))
    model = build_model(cfg, generator=torch.Generator().manual_seed(3))
    assert isinstance(model, BSLocoformerMSS) and len(model.bands) == 62
    for training in (False, True):
        model.train(training)
        for blk in model.blocks:
            for path in (blk.freq_path, blk.frame_path):
                assert path.fused_steps() == ([True], True)
    torch.save(model.state_dict(), tmp_path / "bs.pth")
    loaded, loaded_cfg = load_model(str(tmp_path / "bs.pth"), BS_YAML, device="cpu")
    assert loaded_cfg == cfg and not loaded.training
    key = "band_split_module.bandwise_decoding_module.61.4.weight"
    assert torch.equal(loaded.state_dict()[key], model.state_dict()[key])

