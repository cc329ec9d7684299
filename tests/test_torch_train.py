"""The port's training slice on the CPU against the JAX package: configs,
data, losses, one accumulated and clipped AdamW step, the LR schedule and
early stopping; and the port's trainer end to end (fit, resume, checkpoint
into the separation CLI) on a synthetic MUSDB tree.  fp32, dropout 0."""

import dataclasses
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mss_tf_locoformer_tpu.convert.torch_ckpt import convert_state_dict
from mss_tf_locoformer_tpu.core import config as JC
from mss_tf_locoformer_tpu.data import audio_io as jaudio
from mss_tf_locoformer_tpu.data.loader import DataLoader as JaxLoader
from mss_tf_locoformer_tpu.data.musdb import MUSDBDataset as JaxMUSDB
from mss_tf_locoformer_tpu.losses.mss_loss import mss_loss as jax_mss_loss
from mss_tf_locoformer_tpu.models.mss_tflocoformer import TFLocoformerMSS as JaxMSS
from mss_tf_locoformer_tpu.train import schedule as JS
from mss_tf_locoformer_tpu.train import state as JSt
from mss_tf_locoformer_tpu.train.step import make_train_step
from mss_tf_locoformer_tpu_torch.cli import separate as sep_cli
from mss_tf_locoformer_tpu_torch.cli import train as train_cli
from mss_tf_locoformer_tpu_torch.convert.torch_ckpt import jax_params_to_state_dict
from mss_tf_locoformer_tpu_torch.core import config as C
from mss_tf_locoformer_tpu_torch.data.loader import DataLoader
from mss_tf_locoformer_tpu_torch.data.musdb import MUSDBDataset
from mss_tf_locoformer_tpu_torch.losses.mss_loss import mss_loss
from mss_tf_locoformer_tpu_torch.models import build_model
from mss_tf_locoformer_tpu_torch.train import schedule as S
from mss_tf_locoformer_tpu_torch.train.state import LRController, make_optimizer
from mss_tf_locoformer_tpu_torch.train.step import eval_step, train_step
from torch_routes import spy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEMS = ("vocals", "drums", "bass", "other")
SR = 8000
# widths the fused steps' gates admit in training (emb 32, whole 32-channel
# inner chunks), so that the kernel path is the fused steps
_TINY = dict(n_fft=256, hop_length=64, n_layers=1, emb_dim=32, num_groups=4,
             n_heads=2, attention_dim=32, ffn_type=("swiglu_conv1d", "swiglu_conv1d"),
             ffn_hidden_dim=(32, 32), conv1d_kernel=4, conv1d_shift=1)


@pytest.mark.parametrize("path", sorted(p for p in glob.glob(os.path.join(REPO, "configs", "musdb18*.yaml"))
                                        if "bslocoformer" not in p), ids=os.path.basename)
def test_load_config_matches_jax(path):
    assert dataclasses.asdict(C.load_config(path)) == dataclasses.asdict(JC.load_config(path))


def test_config_rejects_unknown_keys_and_wide_meshes(tmp_path, monkeypatch):
    with pytest.raises(ValueError, match="lrr"):
        C.config_from_dict({"training": {"optimizer": {"lrr": 1.0}}})
    path = tmp_path / "c.json"
    path.write_text(json.dumps({"mesh": {"dp": 2}, "training": {"use_amp": False}}))
    # a grid wider than the ranks raises (one process here; nothing clamped)
    with pytest.raises(ValueError, match="mesh 2x1 != 1 processes"):
        train_cli.main(["--config", str(path), "--device", "cpu",
                        "--output_dir", str(tmp_path / "o")])
    # --distributed needs torchrun's environment or a coordinator
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(RuntimeError, match="torchrun environment"):
        train_cli.main(["--config", str(path), "--device", "cpu", "--distributed"])
    assert train_cli.parse_args(["--config", str(path)]).device == "cuda"  # the default


@pytest.mark.parametrize("loss_type", ["combined", "si_sdr", "l1", "l2"])
def test_mss_loss_and_grad_match_jax(rng, loss_type):
    cfg_t, cfg_j = C.LossConfig(loss_type=loss_type), JC.LossConfig(loss_type=loss_type)
    preds = {s: (0.3 * rng.standard_normal((2, 5000))).astype(np.float32) for s in STEMS}
    tgts = {s: (0.3 * rng.standard_normal((2, 5000))).astype(np.float32) for s in STEMS}
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in preds.items()}
    got = mss_loss(tp, {k: torch.from_numpy(v) for k, v in tgts.items()}, cfg_t)
    want = jax_mss_loss(preds, tgts, cfg_j)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    gt = torch.autograd.grad(got["total_loss"], list(tp.values()))
    gj = jax.grad(lambda p: jax_mss_loss(p, tgts, cfg_j)["total_loss"])(
        {k: jnp.asarray(v) for k, v in preds.items()})
    for (k, a) in zip(tp, gt):
        w = np.asarray(gj[k])
        np.testing.assert_allclose(a.numpy(), w, rtol=1e-5, atol=1e-5 * np.abs(w).max(), err_msg=k)


def _training_cfg(**kw):
    return dict(batch_size=4, gradient_accumulation_steps=2, gradient_clip=0.05,
                optimizer=dict(lr=1e-3, weight_decay=0.01), **kw)


def test_one_train_step_matches_jax(rng, monkeypatch):
    """Accumulation 2, clipping that bites: loss dict, pre-clip grad_norm,
    parameters and AdamW moments after one step.  The port clips with
    optax's rule (no epsilon on the norm), so both sides scale the same."""
    raw = {"model": dict(_TINY, fused_ffn=True, flash_attention=True, fused_stft=True),
           "training": _training_cfg(use_amp=False), "loss": {"loss_type": "combined"}}
    cfg_t, cfg_j = C.config_from_dict(raw), JC.config_from_dict(raw)
    jmodel = JaxMSS(cfg_j.model)
    mix = (0.3 * rng.standard_normal((4, 3000))).astype(np.float32)
    tgts = {s: (0.3 * rng.standard_normal((4, 3000))).astype(np.float32) for s in STEMS}
    params = jmodel.init(jax.random.PRNGKey(0), mix[:1])
    sd = jax_params_to_state_dict(jax.device_get(params))
    model = build_model(cfg_t.model)
    model.load_state_dict(sd, strict=True)
    opt = make_optimizer(model.parameters(), cfg_t.training)

    tx = JSt.make_optimizer(cfg_j.training)
    state = JSt.init_state(convert_state_dict({k: v.numpy() for k, v in sd.items()}), tx)
    state, ld_j = make_train_step(jmodel, cfg_j, tx)(state, mix, tgts, 1e-3, jax.random.PRNGKey(1))

    calls = spy(monkeypatch)
    ld_t = train_step(model, opt, torch.from_numpy(mix),
                      {k: torch.from_numpy(v) for k, v in tgts.items()}, 1e-3,
                      torch.Generator().manual_seed(0), cfg_t.loss, accum=2,
                      gradient_clip=cfg_t.training.gradient_clip)
    # 2 micro-batches x 2 paths: 2 FFN steps and 1 attention step each, fused
    assert calls == {"fused_norm_ffn_residual": 8, "fused_attention_block": 4,
                     "swiglu_conv_deconv": 0, "flash_attention": 0}
    assert set(ld_t) == set(ld_j)
    for k in ld_j:
        np.testing.assert_allclose(float(ld_t[k]), float(ld_j[k]), rtol=2e-4, err_msg=k)
    assert float(ld_j["grad_norm"]) > 2 * cfg_t.training.gradient_clip  # clipping bites

    new_j = jax_params_to_state_dict(jax.device_get(state.params))
    adam = state.opt_state[1].inner_state[0]
    mu, nu = jax_params_to_state_dict(adam.mu), jax_params_to_state_dict(adam.nu)
    assert int(adam.count) == 1
    for name, p in model.named_parameters():
        st = opt.state[p]
        assert float(st["step"]) == 1
        m, v = mu[name].numpy(), nu[name].numpy()
        np.testing.assert_allclose(st["exp_avg"].numpy(), m, rtol=1e-3,
                                   atol=1e-4 * np.abs(m).max(), err_msg=name)
        np.testing.assert_allclose(st["exp_avg_sq"].numpy(), v, rtol=2e-3,
                                   atol=1e-4 * np.abs(v).max(), err_msg=name)
        # the first AdamW step moves each weight by ~lr * sign(g); the two
        # sides agree to a tenth of lr
        np.testing.assert_allclose(p.detach().numpy(), new_j[name].numpy(), atol=1e-4,
                                   err_msg=name)


def test_eval_step_weights_per_sample(rng):
    model = build_model(C.ModelConfig(**_TINY))
    mix = torch.from_numpy((0.3 * rng.standard_normal((2, 2000))).astype(np.float32))
    tg = {s: 0.25 * mix for s in STEMS}
    cfg = C.LossConfig(loss_type="si_sdr")
    l0 = float(eval_step(model, mix[:1], {k: v[:1] for k, v in tg.items()}, cfg)["total_loss"])
    l1 = float(eval_step(model, mix[1:], {k: v[1:] for k, v in tg.items()}, cfg)["total_loss"])
    got = float(eval_step(model, mix, tg, cfg, weights=torch.tensor([1.0, 0.25]))["total_loss"])
    np.testing.assert_allclose(got, (l0 + 0.25 * l1) / 1.25, rtol=1e-5)


def test_schedule_and_early_stop_match_jax():
    raw = {"optimizer": {"lr": 1e-3}, "early_stopping": {"patience": 3},
           "scheduler": {"factor": 0.5, "patience": 1, "cooldown": 1, "min_lr": 2e-4,
                         "warmup_steps": 10, "warmup_start_lr": 1e-5}}
    ct, cj = C._training(raw), JC.config_from_dict({"training": raw}).training
    lt, lj = LRController(ct), JSt.LRController(cj)
    et, ej = S.EarlyStopping(ct.early_stopping), JS.EarlyStopping(cj.early_stopping)
    for step in (0, 3, 9, 10, 50):
        assert lt.lr_at(step) == pytest.approx(lj.lr_at(step), rel=1e-12)
    for v in (1.0, 0.9, 0.95, 0.97, 0.99, 0.8, 0.85, 0.86, 0.87, 0.88, 0.9):
        assert lt.on_validation(v) == lj.on_validation(v)
        assert et.step(v) == ej.step(v)
        assert lt.lr_at(100) == pytest.approx(lj.lr_at(100), rel=1e-12)
    assert lt.state_dict() == lj.state_dict()


@pytest.fixture
def musdb_root(tmp_path, rng):
    """Tracks of 2 s (train) and 1.3 s (test), stereo 16-bit WAV."""
    for subset, tracks, n in (("train", 4, 2 * SR), ("test", 1, 13 * SR // 10)):
        for t in range(tracks):
            d = tmp_path / "musdb" / subset / f"track{t}"
            d.mkdir(parents=True)
            stems = {s: (0.1 * rng.standard_normal((n, 2))).astype(np.float32) for s in STEMS}
            stems["vocals"][: SR // 4] = 0.0   # a silent stretch for the loudness filter
            for s, x in stems.items():
                jaudio.write(str(d / f"{s}.wav"), x, SR, bits=16)
            jaudio.write(str(d / "mixture.wav"), sum(stems.values()), SR, bits=16)
    return tmp_path / "musdb"


def test_dataset_and_loader_match_jax(musdb_root):
    kw = dict(sample_rate=SR, segment_length=SR // 2, sources=list(STEMS), seed=3,
              verbose=False)
    ours = MUSDBDataset(str(musdb_root), "train", **kw)
    theirs = JaxMUSDB(str(musdb_root), "train", metadata_cache=False, **kw)
    for _ in range(4):
        a, b = ours[0], theirs[0]
        assert set(a) == set(b)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    full = MUSDBDataset(str(musdb_root), "test", sample_rate=SR, segment_length=None,
                        sources=list(STEMS), verbose=False)[0]
    assert full["mixture"].shape == (2, 13 * SR // 10)
    la = DataLoader(list(range(11)), batch_size=4, shuffle=True, seed=5, drop_last=True,
                    collate=lambda b: b)
    lb = JaxLoader(list(range(11)), batch_size=4, shuffle=True, seed=5, drop_last=True,
                   collate=lambda b: b)
    for _ in range(2):
        assert list(la) == list(lb)
    threaded = DataLoader(list(range(11)), batch_size=3, shuffle=True, seed=5,
                          num_workers=3, collate=lambda b: b)
    serial = DataLoader(list(range(11)), batch_size=3, shuffle=True, seed=5, collate=lambda b: b)
    assert list(threaded) == list(serial)
    # augmentation: one seed gives the JAX dataset's arrays, the MP3
    # simulation (mixture alone) and the noise included (the noise only
    # survives without rebuild_mixture, in both datasets)
    for aug, rebuild in (({"mp3_prob": 1.0}, True),
                         ({"mp3_prob": 0.0, "noise_prob": 1.0}, False), (True, True)):
        ours = MUSDBDataset(str(musdb_root), "train", augmentation=aug,
                            rebuild_mixture=rebuild, **kw)
        theirs = JaxMUSDB(str(musdb_root), "train", metadata_cache=False, augmentation=aug,
                          rebuild_mixture=rebuild, **kw)
        for _ in range(2):
            a, b = ours[0], theirs[0]
            assert set(a) == set(b)
            for k in b:
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{aug} {k}")
        if aug is not True:   # the mixture is no longer the sum of the stems
            assert not np.allclose(a["mixture"], sum(a[k] for k in STEMS), atol=1e-4)


def test_trainer_fits_resumes_and_checkpoint_separates(musdb_root, tmp_path, rng,
                                                       monkeypatch):
    out = tmp_path / "exp"
    raw = {"dataset": {"root_dir": str(musdb_root), "sample_rate": SR,
                       "segment_length": SR // 2, "sources": list(STEMS)},
           "model": dict(_TINY, dropout=0.1, fused_ffn=True, flash_attention=True,
                         fused_stft=True),
           "training": dict(_training_cfg(use_amp=False, num_workers=2, num_epochs=2,
                                          save_interval=1, log_interval=1,
                                          val_batch_size=2)),
           "seed": 0}
    cfg_path = tmp_path / "tiny.json"
    cfg_path.write_text(json.dumps(raw))
    args = ["--config", str(cfg_path), "--device", "cpu", "--output_dir", str(out)]
    calls = spy(monkeypatch)
    trainer = train_cli.main(args)
    assert calls["fused_norm_ffn_residual"] > 0 and calls["fused_attention_block"] > 0
    assert calls["swiglu_conv_deconv"] == calls["flash_attention"] == 0
    assert trainer.step == 2 and trainer.ckpt.epochs() == [0, 1]
    first = {k: v.clone() for k, v in trainer.model.state_dict().items()}

    raw["training"]["num_epochs"] = 3
    cfg_path.write_text(json.dumps(raw))
    resumed = train_cli.main(args + ["--resume", "latest"])
    assert resumed.start_epoch == 2 and resumed.step == 3
    assert resumed.ckpt.epochs() == [0, 1, 2]
    assert any(not torch.equal(first[k], v) for k, v in resumed.model.state_dict().items())
    for p in resumed.model.parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all()

    wav = tmp_path / "mix.wav"
    jaudio.write(str(wav), (0.2 * rng.standard_normal((SR, 2))).astype(np.float32), SR)
    sep_cli.main(["--input", str(wav), "--output_dir", str(tmp_path / "stems"),
                  "--checkpoint", resumed.ckpt.path(2), "--config", str(cfg_path),
                  "--device", "cpu", "--sample_rate", str(SR), "--chunk_seconds", "0.5",
                  "--overlap_seconds", "0.125"])
    assert len(os.listdir(tmp_path / "stems")) == 4
