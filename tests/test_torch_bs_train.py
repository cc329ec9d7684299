"""BS-Locoformer training in the port on the CPU: one accumulated, clipped
AdamW step of a tiny stereo BS-Locoformer against the JAX ``make_train_step``
(weights carried across from a seeded JAX parameter tree), the trainer's
stereo batch preparation against the JAX ``_stereo``, and the trainer end to
end on stereo batches (an epoch, then ``--resume``).  fp32, dropout 0 in the
step; n_fft 256 (10 bands of unequal widths), emb 32, 2 heads, I 64: widths
the fused steps' gates admit in training."""

import json

import jax
import numpy as np
import pytest
import torch

from mss_tf_locoformer_tpu.convert.torch_ckpt import convert_state_dict
from mss_tf_locoformer_tpu.core import config as JC
from mss_tf_locoformer_tpu.data import audio_io as jaudio
from mss_tf_locoformer_tpu.models.bslocoformer_mss import BSLocoformerMSS as JaxBSMSS
from mss_tf_locoformer_tpu.train import loop as JL
from mss_tf_locoformer_tpu.train import state as JSt
from mss_tf_locoformer_tpu.train.step import make_train_step
from mss_tf_locoformer_tpu_torch.cli import train as train_cli
from mss_tf_locoformer_tpu_torch.convert.torch_ckpt import jax_params_to_state_dict
from mss_tf_locoformer_tpu_torch.core import config as C
from mss_tf_locoformer_tpu_torch.models import build_model
from mss_tf_locoformer_tpu_torch.models.bslocoformer_mss import BSLocoformerMSS
from mss_tf_locoformer_tpu_torch.train import loop as L
from mss_tf_locoformer_tpu_torch.train.state import make_optimizer
from mss_tf_locoformer_tpu_torch.train.step import train_step
from torch_routes import spy

STEMS = ("vocals", "drums", "bass", "other")
SR = 8000
_TINY = dict(name="bslocoformer", n_fft=256, hop_length=128, stft_size=256,
             sample_rate=44100, n_sources=4, n_layers=1, emb_dim=32, num_groups=4,
             n_heads=2, attention_dim=32, ffn_type="swiglu_conv1d", ffn_hidden_dim=64,
             flash_attention=True, fused_ffn=True, stereo=True, masking=True)


def test_stereo_batches_match_jax():
    """``[B, T]`` and ``[B, 1, T]`` are duplicated into ``[B, 2, T]``, stereo
    kept, more channels refused, as in the JAX trainer."""
    x = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    for a in (x[:, 0], x[:, :1], x[:, :2]):
        np.testing.assert_array_equal(L._stereo(a), JL._stereo(a))
        assert L._stereo(a).shape == (2, 2, 4)
    with pytest.raises(ValueError, match="<=2 channels"):
        L._stereo(x)


def test_one_bs_train_step_matches_jax(rng, monkeypatch):
    """Stereo batch 4 in 2 micro-batches, combined loss, clipping that
    bites: loss dict, pre-clip grad_norm, parameters and AdamW moments."""
    raw = {"model": _TINY, "loss": {"loss_type": "combined"},
           "training": {"batch_size": 4, "gradient_accumulation_steps": 2,
                        "gradient_clip": 0.05, "use_amp": False,
                        "optimizer": {"lr": 1e-3, "weight_decay": 0.01}}}
    cfg_t, cfg_j = C.config_from_dict(raw), JC.config_from_dict(raw)
    n = 3000
    tgts = {s: (0.2 * rng.standard_normal((4, 2, n))).astype(np.float32) for s in STEMS}
    mix = sum(tgts.values())
    jmodel = JaxBSMSS(cfg_j.model)
    fill_rng = np.random.default_rng(11)

    def fill(path, leaf):
        z = fill_rng.standard_normal(leaf.shape).astype(np.float32)
        if leaf.ndim == 1:
            return np.float32(path[-1].key != "bias") + 0.1 * z
        return z / np.float32(np.sqrt(np.prod(leaf.shape[:-1])))

    params = jax.tree_util.tree_map_with_path(
        fill, jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), mix[:2]))
    sd = jax_params_to_state_dict(params)
    model = build_model(cfg_t.model)
    model.load_state_dict(sd, strict=True)
    opt = make_optimizer(model.parameters(), cfg_t.training)

    tx = JSt.make_optimizer(cfg_j.training)
    # the JAX tree nests the separator's weights under "separator"
    state = JSt.init_state({"params": {"separator": convert_state_dict(
        {k: v.numpy() for k, v in sd.items()})["params"]}}, tx)
    state, ld_j = make_train_step(jmodel, cfg_j, tx)(state, mix, tgts, 1e-3,
                                                      jax.random.PRNGKey(1))
    calls = spy(monkeypatch)
    ld_t = train_step(model, opt, torch.from_numpy(mix),
                      {k: torch.from_numpy(v) for k, v in tgts.items()}, 1e-3,
                      torch.Generator().manual_seed(0), cfg_t.loss, accum=2,
                      gradient_clip=cfg_t.training.gradient_clip)
    # 2 micro-batches x 2 paths: one FFN step and one attention step each
    assert calls == {"fused_norm_ffn_residual": 4, "fused_attention_block": 4,
                     "swiglu_conv_deconv": 0, "flash_attention": 0}
    assert set(ld_t) == set(ld_j)
    for k in ld_j:
        np.testing.assert_allclose(float(ld_t[k]), float(ld_j[k]), rtol=2e-4, err_msg=k)
    assert float(ld_j["grad_norm"]) > 2 * cfg_t.training.gradient_clip

    new_j = jax_params_to_state_dict(jax.device_get(state.params))
    adam = state.opt_state[1].inner_state[0]
    mu, nu = jax_params_to_state_dict(adam.mu), jax_params_to_state_dict(adam.nu)
    for name, p in model.named_parameters():
        st = opt.state[p]
        m, v = mu[name].numpy(), nu[name].numpy()
        np.testing.assert_allclose(st["exp_avg"].numpy(), m, rtol=1e-3,
                                   atol=1e-4 * np.abs(m).max(), err_msg=name)
        np.testing.assert_allclose(st["exp_avg_sq"].numpy(), v, rtol=2e-3,
                                   atol=1e-4 * np.abs(v).max(), err_msg=name)
        np.testing.assert_allclose(p.detach().numpy(), new_j[name].numpy(), atol=1e-4,
                                   err_msg=name)


@pytest.fixture
def musdb_root(tmp_path, rng):
    """Tracks of 1 s (train) and 0.7 s (test), stereo 16-bit WAV."""
    for subset, tracks, n in (("train", 4, SR), ("test", 1, 7 * SR // 10)):
        for t in range(tracks):
            d = tmp_path / "musdb" / subset / f"track{t}"
            d.mkdir(parents=True)
            stems = {s: (0.1 * rng.standard_normal((n, 2))).astype(np.float32) for s in STEMS}
            for s, x in stems.items():
                jaudio.write(str(d / f"{s}.wav"), x, SR, bits=16)
            jaudio.write(str(d / "mixture.wav"), sum(stems.values()), SR, bits=16)
    return tmp_path / "musdb"


def test_bs_trainer_fits_stereo_and_resumes(musdb_root, tmp_path, monkeypatch):
    """The training CLI on a BS-Locoformer config: stereo ``[B, 2, T]``
    batches in training and validation, dropout 0.1, one epoch of 2 steps,
    then ``--resume`` for a second."""
    raw = {"dataset": {"root_dir": str(musdb_root), "sample_rate": SR,
                       "segment_length": SR // 2, "sources": list(STEMS)},
           "model": dict(_TINY, dropout=0.1),
           "training": {"batch_size": 2, "num_epochs": 1, "num_workers": 2,
                        "use_amp": False, "save_interval": 1, "log_interval": 1,
                        "val_batch_size": 2},
           "seed": 0}
    cfg_path = tmp_path / "bs.json"
    cfg_path.write_text(json.dumps(raw))
    args = ["--config", str(cfg_path), "--device", "cpu", "--output_dir", str(tmp_path / "exp")]
    shapes = []
    forward = BSLocoformerMSS.forward

    def record(self, mixture, *a, **kw):
        shapes.append(tuple(mixture.shape))
        return forward(self, mixture, *a, **kw)

    monkeypatch.setattr(BSLocoformerMSS, "forward", record)
    calls = spy(monkeypatch)
    trainer = train_cli.main(args)
    assert isinstance(trainer.model, BSLocoformerMSS)
    # 2 training batches, then the test track's 0.7 s in 2 chunks of 0.5 s
    assert shapes == [(2, 2, SR // 2)] * 3
    assert calls["fused_norm_ffn_residual"] == calls["fused_attention_block"] == 6
    assert trainer.step == 2 and trainer.ckpt.epochs() == [0]
    first = {k: v.clone() for k, v in trainer.model.state_dict().items()}

    raw["training"]["num_epochs"] = 2
    cfg_path.write_text(json.dumps(raw))
    resumed = train_cli.main(args + ["--resume", "latest"])
    assert resumed.start_epoch == 1 and resumed.step == 4
    assert any(not torch.equal(first[k], v) for k, v in resumed.model.state_dict().items())
    for p in resumed.model.parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all()
    meta = torch.load(resumed.ckpt.path(1), weights_only=True)["metadata"]
    assert np.isfinite(meta["val_loss"])
