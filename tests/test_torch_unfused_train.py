"""Training through the port's unfused route on the CPU against the JAX
package: the plain versions of the flash-attention backward (#7) and the
FFN-core backward (#9) against the JAX Pallas backward kernels in
interpret mode, the row-grouped plain attention with dropout, per-block
remat, one AdamW step of an unfused-route model with gradient checkpointing
on both sides, and the trainer with the xlarge config's training section
(gradient checkpointing, augmentation) on a tiny tree.  fp32; inputs from a
numpy seed, handed to both frameworks."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mss_tf_locoformer_tpu.convert.torch_ckpt import convert_state_dict
from mss_tf_locoformer_tpu.core import config as JC
from mss_tf_locoformer_tpu.data import audio_io as jaudio
from mss_tf_locoformer_tpu.models.mss_tflocoformer import TFLocoformerMSS as JaxMSS
from mss_tf_locoformer_tpu.ops.pallas import flash_attention as JFA
from mss_tf_locoformer_tpu.ops.pallas import swiglu_ffn as JFFN
from mss_tf_locoformer_tpu.train import state as JSt
from mss_tf_locoformer_tpu.train.step import make_train_step
from mss_tf_locoformer_tpu_torch.cli import train as train_cli
from mss_tf_locoformer_tpu_torch.convert.torch_ckpt import jax_params_to_state_dict
from mss_tf_locoformer_tpu_torch.core import config as C
from mss_tf_locoformer_tpu_torch.losses.mss_loss import mss_loss
from mss_tf_locoformer_tpu_torch.models import build_model
from mss_tf_locoformer_tpu_torch.ops import attention as plain_attention
from mss_tf_locoformer_tpu_torch.ops.cuda import attention_block as AB
from mss_tf_locoformer_tpu_torch.ops.cuda import flash_attention as FA
from mss_tf_locoformer_tpu_torch.ops.cuda import swiglu_ffn as SF
from mss_tf_locoformer_tpu_torch.train.loop import training_model_config
from mss_tf_locoformer_tpu_torch.train.state import make_optimizer
from mss_tf_locoformer_tpu_torch.train.step import train_step
from torch_routes import spy

STEMS = ("vocals", "drums", "bass", "other")
SR = 8000
# emb 16: a width the fused steps' gates refuse, so every step takes the
# unfused route (flash attention and the FFN core) as xlarge and small do
_UNFUSED = dict(n_fft=256, hop_length=64, n_layers=2, emb_dim=16, num_groups=4,
                n_heads=2, attention_dim=16, ffn_type=("swiglu_conv1d", "swiglu_conv1d"),
                ffn_hidden_dim=(32, 32), conv1d_kernel=4, conv1d_shift=1,
                fused_ffn=True, flash_attention=True, fused_stft=True)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny shapes: one intra-op thread.  Next to other test workers the
    default pool oversubscribes the cores and the many small int64 ops of
    the plain dropout masks slow down ~20-fold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a, grad=False):
    return torch.from_numpy(np.asarray(a, dtype=np.float32)).requires_grad_(grad)


def _torch_grads(fn, args, g):
    ts = [_t(a, True) for a in args]
    return torch.autograd.grad(fn(*ts), ts, _t(g))


# ------------------------------------------------- #7 and #9 against JAX

@pytest.mark.parametrize("seq,d,rope", [(17, 12, True), (33, 16, False), (33, 12, False),
                                        (17, 16, True)])
def test_flash_attention_backward_matches_jax(rng, seq, d, rope):
    q, k, v, g = ((0.7 * rng.standard_normal((1, 2, seq, d))).astype(np.float32)
                  for _ in range(4))
    got = _torch_grads(lambda *a: FA.flash_attention(*a, rope), [q, k, v], g)
    with pltpu.force_tpu_interpret_mode():
        want = JFA._flash_backward_pallas(*(jnp.asarray(a) for a in (q, k, v, g)),
                                          rope, 10000.0)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        w = np.asarray(w)
        # fp32 both sides (tests/test_torch_grads.py's attention tolerance)
        np.testing.assert_allclose(a.numpy(), w, atol=5e-5 * np.abs(w).max(), rtol=5e-4,
                                   err_msg=name)


@pytest.mark.parametrize("c", [16, 32])
def test_swiglu_ffn_backward_matches_jax(rng, c):
    r, lin, inner, k = 3, 11, 64, 4
    b = (c * k) ** -0.5
    x = np.zeros((r, lin, c), np.float32)
    x[:, k - 1:lin - k + 1] = rng.standard_normal((r, lin - 2 * (k - 1), c))
    args = [x, rng.uniform(-b, b, (2 * inner, c, k)), rng.uniform(-b, b, 2 * inner),
            rng.uniform(-b, b, (inner, c, k)), rng.uniform(-b, b, c)]
    args = [np.asarray(a, np.float32) for a in args]
    g = rng.standard_normal((r, lin, c)).astype(np.float32)
    got = _torch_grads(lambda *a: SF.swiglu_conv_deconv(*a, k), args, g)
    with pltpu.force_tpu_interpret_mode():
        want = JFFN._backward_pallas(*(jnp.asarray(a) for a in args), k, jnp.asarray(g))
    names = ("dx", "dconv_w", "dconv_b", "ddeconv_w", "ddeconv_b")
    for name, a, w in zip(names, got, want):
        w = np.asarray(w)
        # tests/test_torch_grads.py's FFN tolerance
        np.testing.assert_allclose(a.numpy(), w, atol=5e-4 * np.abs(w).max(), rtol=5e-3,
                                   err_msg=name)


# ---------------------------------------- grouped attention with dropout

def test_grouped_attention_with_dropout_equals_one_piece(rng, monkeypatch):
    """Masks built per row group (under checkpoint when a gradient is asked
    for) give exactly the one-piece computation with the whole mask."""
    r, h, seq, d, p, seed = 3, 2, 21, 8, 0.3, 11
    rows = torch.tensor([5, 0, 7])
    q, k, v, g = (rng.standard_normal((r, h, seq, d)).astype(np.float32) for _ in range(4))
    keep = AB.probability_mask(seed, rows, h, seq, p)
    want_out = plain_attention._attention(*(_t(a) for a in (q, k, v)), keep, p)
    want = _torch_grads(lambda *a: plain_attention._attention(*a, keep, p), [q, k, v], g)
    monkeypatch.setattr(plain_attention, "MAX_SCORE_BYTES", 4 * seq * seq * 4)  # groups of 4
    got_out = plain_attention.dot_product_attention(*(_t(a) for a in (q, k, v)), p, seed, rows)
    got = _torch_grads(lambda *a: plain_attention.dot_product_attention(*a, p, seed, rows),
                       [q, k, v], g)
    assert torch.equal(got_out, want_out)
    for a, w in zip(got, want):
        assert torch.equal(a, w)


# ------------------------------------------------------------------ remat

@pytest.mark.parametrize("fused_ffn", [True, False])
def test_remat_blocks_gives_the_same_gradients(rng, fused_ffn):
    """Per-block remat at dropout 0.1: the same gradients, exactly, and the
    generator left where the run without remat leaves it; without the
    FFN-core kernels remat also recomputes each FFN (``remat_ffn``)."""
    mix = _t(0.3 * rng.standard_normal((1, 600)))
    tg = {s: 0.25 * mix for s in STEMS}
    grads, states = [], []
    small = dict(_UNFUSED, n_fft=64, hop_length=16, fused_ffn=fused_ffn)  # small masks
    for remat in (False, True):
        model = build_model(C.ModelConfig(**small, dropout=0.1, remat_blocks=remat),
                            generator=torch.Generator().manual_seed(0)).train()
        gen = torch.Generator().manual_seed(4)
        loss = mss_loss(model(mix, generator=gen), tg,
                        C.LossConfig(loss_type="si_sdr"))["total_loss"]
        loss.backward()
        grads.append({n: p.grad for n, p in model.named_parameters()})
        states.append(gen.get_state())
    assert torch.equal(states[0], states[1])
    for name, g in grads[0].items():
        assert g is not None and torch.equal(grads[1][name], g), name


# ------------------------------------ one AdamW step against the JAX step

def test_unfused_train_step_with_checkpointing_matches_jax(rng, monkeypatch):
    raw = {"model": dict(_UNFUSED),
           "training": dict(batch_size=2, gradient_accumulation_steps=1, gradient_clip=5.0,
                            gradient_checkpointing=True, use_amp=False,
                            optimizer=dict(lr=1e-3, weight_decay=0.01)),
           "loss": {"loss_type": "combined"}}
    cfg_t, cfg_j = C.config_from_dict(raw), JC.config_from_dict(raw)
    model_cfg = training_model_config(cfg_t)
    assert model_cfg.remat_blocks
    jmodel = JaxMSS(dataclasses.replace(cfg_j.model, remat_blocks=True))
    mix = (0.3 * rng.standard_normal((2, 3000))).astype(np.float32)
    tgts = {s: (0.3 * rng.standard_normal((2, 3000))).astype(np.float32) for s in STEMS}
    params = jmodel.init(jax.random.PRNGKey(0), mix[:1])
    sd = jax_params_to_state_dict(jax.device_get(params))
    model = build_model(model_cfg)
    model.load_state_dict(sd, strict=True)
    opt = make_optimizer(model.parameters(), cfg_t.training)
    tx = JSt.make_optimizer(cfg_j.training)
    state = JSt.init_state(convert_state_dict({k: v.numpy() for k, v in sd.items()}), tx)
    state, ld_j = make_train_step(jmodel, cfg_j, tx)(state, mix, tgts, 1e-3,
                                                     jax.random.PRNGKey(1))
    calls = spy(monkeypatch)
    ld_t = train_step(model, opt, _t(mix), {k: _t(v) for k, v in tgts.items()}, 1e-3,
                      torch.Generator().manual_seed(0), cfg_t.loss, accum=1,
                      gradient_clip=5.0)
    # 2 layers x 2 paths, forward and the remat's recompute: 1 attention core
    # and 2 FFN cores each, none of the fused steps
    assert calls == {"fused_norm_ffn_residual": 0, "fused_attention_block": 0,
                     "flash_attention": 8, "swiglu_conv_deconv": 16}
    for k in ld_j:
        np.testing.assert_allclose(float(ld_t[k]), float(ld_j[k]), rtol=1e-3, err_msg=k)
    new_j = jax_params_to_state_dict(jax.device_get(state.params))
    adam = state.opt_state[1].inner_state[0]
    mu, nu = jax_params_to_state_dict(adam.mu), jax_params_to_state_dict(adam.nu)
    for name, p in model.named_parameters():
        st = opt.state[p]
        m, v = mu[name].numpy(), nu[name].numpy()
        # the moments carry the gradients: fp32 both sides
        np.testing.assert_allclose(st["exp_avg"].numpy(), m, atol=5e-4 * np.abs(m).max(),
                                   rtol=1e-3, err_msg=name)
        np.testing.assert_allclose(st["exp_avg_sq"].numpy(), v, atol=5e-4 * np.abs(v).max(),
                                   rtol=1e-3, err_msg=name)
        # AdamW's first step moves a weight by lr * g / |g|: where g is at
        # rounding level its sign is noise on either side, so the weights
        # are compared where |g| is above a thousandth of the tensor's most
        sure = np.abs(m) > 1e-3 * np.abs(m).max()
        np.testing.assert_allclose(p.detach().numpy()[sure], new_j[name].numpy()[sure],
                                   atol=5e-4, rtol=1e-3, err_msg=name)


# --------------------------- the xlarge config's training section, tiny

def test_trainer_fits_with_checkpointing_and_augmentation(tmp_path, rng, monkeypatch):
    for subset, tracks in (("train", 4), ("test", 1)):
        for t in range(tracks):
            d = tmp_path / "musdb" / subset / f"track{t}"
            d.mkdir(parents=True)
            stems = {s: (0.1 * rng.standard_normal((SR, 2))).astype(np.float32) for s in STEMS}
            for s, x in stems.items():
                jaudio.write(str(d / f"{s}.wav"), x, SR, bits=16)
            jaudio.write(str(d / "mixture.wav"), sum(stems.values()), SR, bits=16)
    raw = {"dataset": {"root_dir": str(tmp_path / "musdb"), "sample_rate": SR,
                       "segment_length": SR // 8, "sources": list(STEMS),
                       "augmentation": True},
           "model": dict(_UNFUSED, n_fft=64, hop_length=16, n_layers=1, dropout=0.1),
           "loss": {"loss_type": "si_sdr"},   # 1000 samples: no 2048-point spectral loss
           "training": dict(batch_size=4, gradient_accumulation_steps=2, num_epochs=1,
                            gradient_checkpointing=True, use_amp=False, num_workers=2,
                            log_interval=1, val_batch_size=2,
                            optimizer=dict(lr=1e-3, weight_decay=0.01),
                            scheduler=dict(warmup_steps=4)),
           "seed": 0}
    path = tmp_path / "xl.json"
    path.write_text(json.dumps(raw))
    calls = spy(monkeypatch)
    trainer = train_cli.main(["--config", str(path), "--device", "cpu",
                              "--output_dir", str(tmp_path / "exp")])
    assert trainer.model.config.remat_blocks and trainer.step == 1
    assert calls["swiglu_conv_deconv"] > 0 and calls["flash_attention"] > 0  # validation
    assert calls["fused_norm_ffn_residual"] == calls["fused_attention_block"] == 0
    for p in trainer.model.parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all()
