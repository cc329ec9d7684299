"""The port's speech training slice on the CPU against the JAX package:
``SpeechMixtureDataset`` (crops and the resample path), and one accumulated,
clipped AdamW step against the JAX ``make_speech_step`` for PIT SI-SNR and
for fixed-order ``mr_l1_tfd``.  fp32, dropout 0; emb 32, 2 heads, I 64."""

import jax
import numpy as np
import pytest
import torch

from mss_tf_locoformer_tpu.convert.torch_ckpt import convert_state_dict
from mss_tf_locoformer_tpu.core import config as JC
from mss_tf_locoformer_tpu.data import audio_io as jaudio
from mss_tf_locoformer_tpu.data.speech import SpeechMixtureDataset as JaxSpeechDataset
from mss_tf_locoformer_tpu.models.tflocoformer import TFLocoformerSeparator as JaxSeparator
from mss_tf_locoformer_tpu.train import speech as JS
from mss_tf_locoformer_tpu.train import state as JSt
from mss_tf_locoformer_tpu_torch.convert.torch_ckpt import jax_params_to_state_dict
from mss_tf_locoformer_tpu_torch.core import config as C
from mss_tf_locoformer_tpu_torch.data.speech import SpeechMixtureDataset
from mss_tf_locoformer_tpu_torch.models import TFLocoformerSeparator
from mss_tf_locoformer_tpu_torch.train import speech as S
from mss_tf_locoformer_tpu_torch.train.state import make_optimizer
from torch_routes import spy

_SEP = dict(n_layers=1, emb_dim=32, num_groups=4, n_heads=2, attention_dim=32,
            ffn_type=("swiglu_conv1d", "swiglu_conv1d"), ffn_hidden_dim=(64, 64),
            conv1d_kernel=4, flash_attention=True, fused_ffn=True)


@pytest.fixture
def corpus(tmp_path, rng):
    """``mix/ s1/ s2/`` at 8 kHz (3 utterances of 0.5-0.8 s) and one at
    16 kHz, which the dataset resamples."""
    for d in ("mix", "s1", "s2"):
        (tmp_path / d).mkdir()
    for utt, sr, n in (("a.wav", 8000, 4000), ("b.wav", 8000, 6400),
                       ("c.wav", 16000, 10000), ("d.wav", 8000, 5000)):
        s1, s2 = (0.1 * rng.standard_normal(n).astype(np.float32) for _ in range(2))
        for d, x in (("s1", s1), ("s2", s2), ("mix", s1 + s2)):
            jaudio.write(str(tmp_path / d / utt), x[:, None], sr, bits=16)
    return tmp_path


def test_speech_dataset_matches_jax(corpus):
    for kw in (dict(segment_length=3000, random_crop=True, seed=4),
               dict(segment_length=7000, random_crop=False),
               dict(segment_length=None)):
        ours = SpeechMixtureDataset(str(corpus), num_spk=2, sample_rate=8000, **kw)
        theirs = JaxSpeechDataset(str(corpus), num_spk=2, sample_rate=8000, **kw)
        assert ours.utts == theirs.utts == ["a.wav", "b.wav", "c.wav", "d.wav"]
        for _ in range(2):
            for i in range(len(ours)):
                a, b = ours[i], theirs[i]
                assert a["name"] == b["name"]
                assert a["sources"].shape[:2] == (2, 1) and a["mixture"].shape[0] == 1
                for k in ("mixture", "sources"):
                    np.testing.assert_array_equal(a[k], b[k], err_msg=f"{kw} {i} {k}")
    assert SpeechMixtureDataset(str(corpus), sample_rate=8000)[2]["mixture"].shape == (1, 5000)
    with pytest.raises(ValueError, match="spk_dirs"):
        SpeechMixtureDataset(str(corpus), num_spk=2, spk_dirs=["s1"])
    (corpus / "s2" / "d.wav").unlink()
    with pytest.raises(FileNotFoundError, match="missing speaker files"):
        SpeechMixtureDataset(str(corpus))


@pytest.mark.parametrize("criterion,wrapper,num_spk", [("si_snr", "pit", 2),
                                                       ("mr_l1_tfd", "fixed_order", 1)])
def test_one_speech_step_matches_jax(rng, monkeypatch, criterion, wrapper, num_spk):
    """Batch 4 in 2 micro-batches, clipping that bites: loss, pre-clip
    grad_norm, parameters and AdamW moments after one step."""
    raw = {"separator": dict(_SEP, num_spk=num_spk), "stft": {"n_fft": 128, "hop_length": 64},
           "loss": {"criterion": criterion, "wrapper": wrapper},
           "training": {"batch_size": 4, "gradient_accumulation_steps": 2,
                        "gradient_clip": 0.05, "use_amp": False,
                        "optimizer": {"lr": 1e-3, "weight_decay": 0.01}}}
    cfg_t, cfg_j = C.speech_config_from_dict(raw), JC.speech_config_from_dict(raw)
    t = 2000
    src = (0.2 * rng.standard_normal((4, num_spk, t))).astype(np.float32)
    mix = src.sum(1) + (0.02 * rng.standard_normal((4, t))).astype(np.float32)
    jmod = JaxSeparator(**cfg_j.separator.module_kwargs())
    spec = np.zeros((1, 1 + t // 64, 65), np.complex64)
    fill_rng = np.random.default_rng(7)

    def fill(path, leaf):
        z = fill_rng.standard_normal(leaf.shape).astype(np.float32)
        if leaf.ndim == 1:
            return np.float32(path[-1].key != "bias") + 0.1 * z
        return z / np.float32(np.sqrt(np.prod(leaf.shape[:-1])))

    params = jax.tree_util.tree_map_with_path(
        fill, jax.eval_shape(jmod.init, jax.random.PRNGKey(0), spec))
    sd = jax_params_to_state_dict(params)
    model = TFLocoformerSeparator(cfg_t.separator)
    model.load_state_dict(sd, strict=True)
    opt = make_optimizer(model.parameters(), cfg_t.training)

    tx = JSt.make_optimizer(cfg_j.training)
    state = JSt.init_state(convert_state_dict({k: v.numpy() for k, v in sd.items()}), tx)
    step, _ = JS.make_speech_step(jmod, cfg_j, tx)
    state, ld_j = step(state, mix, src, 1e-3, jax.random.PRNGKey(1))

    calls = spy(monkeypatch)
    ld_t = S.speech_train_step(model, opt, torch.from_numpy(mix), torch.from_numpy(src),
                               1e-3, torch.Generator().manual_seed(0), cfg_t)
    # 2 micro-batches x 2 paths: 2 FFN steps and 1 attention step each, fused
    assert calls == {"fused_norm_ffn_residual": 8, "fused_attention_block": 4,
                     "swiglu_conv_deconv": 0, "flash_attention": 0}
    assert set(ld_t) == set(ld_j) == {"total_loss", "grad_norm"}
    for k in ld_j:
        np.testing.assert_allclose(float(ld_t[k]), float(ld_j[k]), rtol=2e-4, err_msg=k)
    assert float(ld_j["grad_norm"]) > 2 * cfg_t.training.gradient_clip

    new_j = jax_params_to_state_dict(jax.device_get(state.params))
    adam = state.opt_state[1].inner_state[0]
    mu, nu = jax_params_to_state_dict(adam.mu), jax_params_to_state_dict(adam.nu)
    # a constant real part in every bin is an impulse at each frame's first
    # sample, where the periodic Hann window is 0: the gradient of the
    # decoder bias's real parts is rounding noise (first moments ~1e-12
    # against ~1e-8 for its imaginary parts), so each moment's floor is
    # 1e-6 of its largest value in the model
    m_floor, v_floor = (1e-6 * max(np.abs(t.numpy()).max() for t in d.values())
                        for d in (mu, nu))
    for name, p in model.named_parameters():
        st = opt.state[p]
        m, v = mu[name].numpy(), nu[name].numpy()
        np.testing.assert_allclose(st["exp_avg"].numpy(), m, rtol=1e-3,
                                   atol=max(1e-4 * np.abs(m).max(), m_floor), err_msg=name)
        np.testing.assert_allclose(st["exp_avg_sq"].numpy(), v, rtol=2e-3,
                                   atol=max(1e-4 * np.abs(v).max(), v_floor), err_msg=name)
        np.testing.assert_allclose(p.detach().numpy(), new_j[name].numpy(), atol=1e-4,
                                   err_msg=name)
