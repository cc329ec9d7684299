"""The port's parallel runs over gloo, 2 and 4 CPU ranks in subprocesses
(``tests/torch_parallel_worker.py``), held against the JAX package and the
single-process port in this process:

* the TP attention and FFN steps at mp 2 and 4 (forward and gradients,
  the shards' weight gradients gathered whole) against the JAX plain
  references in partial-sum mode (atol 2e-4 x max|ref|, rtol 2e-3, the
  tolerance of ``tests/test_tp_fused.py``; fp32 rows, so the all-reduce
  adds in fp32 here);
* one accumulated, clipped AdamW step at mesh ``1 x 2`` (mp) and ``2 x 1``
  (dp) against the single-process port step (itself held against
  ``make_train_step`` by tests/test_torch_train.py): loss and grad_norm
  within 1e-5 relative, the updated parameters within 1e-5 relative L2;
* the trainer at ``mp 2``: fit, resume, and a checkpoint of the reference
  schema that loads ``strict=True`` into a one-device model; the 2-rank
  evaluation CLI's merged ``results.json`` against the JAX CLI's on one
  device (fp32 both, 1e-3 dB); chunk-parallel separation over dp;
* at mesh ``2 x 2``: the outer dropout sites' masks equal on the mp ranks
  and different on the dp ranks.

Every rank has a hard timeout and ``init_process_group`` one of 45 s: a hang
fails the test.  No test here starts ``tests/multihost_worker.py`` or the
JAX ``shard_map`` TP path.
"""

import functools
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mss_tf_locoformer_tpu.cli import evaluate as jax_eval_cli
from mss_tf_locoformer_tpu.core.precision import FP32 as JFP32
from mss_tf_locoformer_tpu.data import audio_io as jaudio
from mss_tf_locoformer_tpu.infer import separate as jax_separate
from mss_tf_locoformer_tpu.ops.pallas import attention_block as JAB
from mss_tf_locoformer_tpu.ops.pallas import swiglu_block as JFB
from mss_tf_locoformer_tpu_torch.core import config as C
from mss_tf_locoformer_tpu_torch.models import build_model
from mss_tf_locoformer_tpu_torch.train.state import make_optimizer
from mss_tf_locoformer_tpu_torch.train.step import train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_parallel_worker.py")
ATOL, RTOL = 2e-4, 2e-3
STEP_RTOL = 1e-5
SR = 8000
STEMS = ("vocals", "drums", "bass", "other")
TINY = dict(n_fft=256, hop_length=64, n_layers=1, emb_dim=32, num_groups=4, n_heads=2,
            attention_dim=32, ffn_type=["swiglu_conv1d", "swiglu_conv1d"],
            ffn_hidden_dim=[64, 64], conv1d_kernel=4, conv1d_shift=1, fused_ffn=True,
            flash_attention=True, fused_stft=True)
TRAINING = dict(batch_size=4, gradient_accumulation_steps=2, gradient_clip=0.05,
                optimizer=dict(lr=1e-3, weight_decay=0.01), use_amp=False)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(mode, world, d):
    """Start ``world`` ranks of the worker; returns a function that waits
    for them (each under its own timeout) and loads rank 0's output."""
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=REPO)
    logs = [open(os.path.join(d, f"{mode}_{r}.log"), "w+") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, WORKER, mode, str(r), str(world), str(port), d],
                              env=env, cwd=REPO, stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(world)]

    def wait(timeout=150):
        failed = []
        for r, p in enumerate(procs):
            try:
                rc = p.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                rc = "timeout"
            if rc != 0:
                logs[r].seek(0)
                failed.append(f"rank {r}: {rc}\n{logs[r].read()[-3000:]}")
        for f in logs:
            f.close()
        if failed:
            pytest.fail("\n".join(failed))
        return torch.load(os.path.join(d, f"{mode}_out.pt"), weights_only=False)
    return wait


def _close(got, want, name=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, atol=ATOL * np.abs(want).max(),
                               rtol=RTOL, err_msg=name)


def _jax_vjp(fn, args, g):
    out, grads = jax.jit(lambda g, *a: (fn(*a), jax.vjp(fn, *a)[1](g)))(
        jnp.asarray(g), *[jnp.asarray(a) for a in args])
    return np.asarray(out), [np.asarray(v) for v in grads]


def _step_files(d, rng):
    """``cfg.json``, ``model.pth`` and ``batch.npz`` of the AdamW step;
    returns the single-process port step's loss dict and parameters."""
    raw = {"model": TINY, "training": TRAINING, "loss": {"loss_type": "combined"}}
    with open(os.path.join(d, "cfg.json"), "w") as f:
        json.dump(raw, f)
    cfg = C.config_from_dict(raw)
    model = build_model(cfg.model, generator=torch.Generator().manual_seed(2))
    torch.save(model.state_dict(), os.path.join(d, "model.pth"))
    batch = {"mixture": (0.3 * rng.standard_normal((4, 3000))).astype(np.float32),
             **{s: (0.3 * rng.standard_normal((4, 3000))).astype(np.float32) for s in STEMS}}
    np.savez(os.path.join(d, "batch.npz"), **batch)
    opt = make_optimizer(model.parameters(), cfg.training)
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    mix = t.pop("mixture")
    ld = train_step(model, opt, mix, t, 1e-3, torch.Generator().manual_seed(0), cfg.loss,
                    cfg.training.gradient_accumulation_steps, cfg.training.gradient_clip)
    return {k: float(v) for k, v in ld.items()}, model.state_dict()


def _check_step(got, want):
    (ld, params), (ld_ref, params_ref) = got, want
    assert ld.keys() == ld_ref.keys()
    for k in ld_ref:
        assert ld[k] == pytest.approx(ld_ref[k], rel=STEP_RTOL), k
    assert ld_ref["grad_norm"] > 2 * TRAINING["gradient_clip"]   # the clip bites
    # the parameters as one vector, relative L2: AdamW's first step divides
    # each gradient by its own magnitude (plus eps 1e-8), so an element whose
    # gradient is near eps turns the other summation order of a parallel run
    # into a visible share of lr (the decoder bias's, whose gradient nearly
    # vanishes under the scale-invariant losses); one element moved by lr
    # alone is ~8e-5 of this norm, so a wrong update anywhere still fails
    assert params.keys() == params_ref.keys()
    diff = torch.cat([(params[k] - v).reshape(-1) for k, v in params_ref.items()])
    ref = torch.cat([v.reshape(-1) for v in params_ref.values()])
    assert float(diff.norm() / ref.norm()) <= STEP_RTOL


@pytest.mark.parametrize("world", [2, 4])
def test_tp_steps_match_jax(tmp_path, rng, world):
    """The TP steps over ``world`` mp ranks (heads 4 of 8, inner 64) against
    the JAX plain references with ``residual=False`` (a zero deconv bias:
    the TP caller adds its own), forward and every gradient; at mp 2 also
    one AdamW step of a tiny model against the single-process port step."""
    d = str(tmp_path)
    f32 = lambda a: np.asarray(a, np.float32)
    c, a, h, inner, k = 32, 32, 4, 64, 4
    b = (c * k) ** -0.5
    t = {"heads": np.int64(h)}
    for name in ("attn", "ffn"):
        t[f"{name}_x"] = f32(0.5 * rng.standard_normal((2, 37, c)))
        t[f"{name}_gamma"] = f32(1 + 0.1 * rng.standard_normal(c))
        t[f"{name}_g"] = f32(rng.standard_normal((2, 37, c)))
    t["attn_attn.qkv.weight"] = f32(rng.standard_normal((3 * a, c)) / np.sqrt(c))
    t["attn_attn.aggregate_heads.0.weight"] = f32(rng.standard_normal((c, a)) / np.sqrt(a))
    t["ffn_ffn.0.conv1d.weight"] = f32(rng.uniform(-b, b, (2 * inner, c, k)))
    t["ffn_ffn.0.conv1d.bias"] = f32(rng.uniform(-b, b, 2 * inner))
    t["ffn_ffn.0.deconv1d.weight"] = f32(rng.uniform(-b, b, (inner, c, k)))
    np.savez(os.path.join(d, "in.npz"), **t)
    step_ref = _step_files(d, rng) if world == 2 else None
    wait = _spawn("tp", world, d)

    zero = jnp.zeros(c, jnp.float32)
    cases = {
        "attn": (lambda x, gm, wq, wo: JAB.reference_attention_block(
            x, gm, wq, wo, h, 4, 1e-5, True, residual=False),
            ("attn.qkv.weight", "attn.aggregate_heads.0.weight")),
        "ffn": (lambda x, gm, cw, cb, dw: JFB.reference_norm_ffn_residual(
            x, gm, cw, cb, dw, zero, k, 4, 1e-5, residual=False),
            ("ffn.0.conv1d.weight", "ffn.0.conv1d.bias", "ffn.0.deconv1d.weight"))}
    want = {name: _jax_vjp(fn, [t[f"{name}_x"], t[f"{name}_gamma"],
                                *[t[f"{name}_{kk}"] for kk in keys]], t[f"{name}_g"])
            for name, (fn, keys) in cases.items()}
    got = wait()
    for name, (_, keys) in cases.items():
        out, grads = want[name]
        _close(got[f"{name}_out"], out, f"{name} out")
        for label, w in zip(["dx", "dgamma"] + [f"d{kk}" for kk in keys], grads):
            _close(got[f"{name}_{label}"], w, f"{name} {label}")
    if step_ref is not None:
        _check_step(got["step"], step_ref)


@pytest.fixture
def musdb_root(tmp_path, rng):
    """4 train tracks of 1.5 s and 2 test tracks of 1.3 s, stereo WAV."""
    for subset, tracks, n in (("train", 4, 3 * SR // 2), ("test", 2, 13 * SR // 10)):
        for tr in range(tracks):
            d = tmp_path / "musdb" / subset / f"track{tr}"
            d.mkdir(parents=True)
            stems = {s: (0.1 * rng.standard_normal((n, 2))).astype(np.float32) for s in STEMS}
            for s, x in stems.items():
                jaudio.write(str(d / f"{s}.wav"), x, SR, bits=16)
            jaudio.write(str(d / "mixture.wav"), sum(stems.values()), SR, bits=16)
    return tmp_path / "musdb"


def test_dp_step_trainer_at_mp2_evaluation_and_engine(tmp_path, rng, musdb_root,
                                                      monkeypatch):
    """Two ranks: the AdamW step at dp 2 against the single-process step;
    the trainer at mesh 1 x 2 (fit, resume, the checkpoint into a one-device
    model); the evaluation CLI's merged ``results.json`` against the JAX
    CLI's; chunk-parallel separation against one rank's."""
    d = str(tmp_path)
    step_ref = _step_files(d, rng)
    raw = {"dataset": {"root_dir": str(musdb_root), "sample_rate": SR,
                       "segment_length": SR // 2, "sources": list(STEMS)},
           "model": TINY,
           "training": dict(TRAINING, num_workers=0, num_epochs=1, save_interval=1,
                            log_interval=1, val_batch_size=2),
           "mesh": {"dp": 1, "mp": 2}, "seed": 0}
    for name, epochs in (("train.json", 1), ("train_more.json", 2)):
        raw["training"]["num_epochs"] = epochs
        with open(os.path.join(d, name), "w") as f:
            json.dump(raw, f)
    wait = _spawn("dp", 2, d)

    monkeypatch.setattr(jax_separate, "load_model",
                        functools.partial(jax_separate.load_model, precision=JFP32))
    jax_eval_cli.main(["--config", os.path.join(d, "train.json"), "--checkpoint",
                       os.path.join(d, "model.pth"), "--output_dir", os.path.join(d, "jax_eval"),
                       "--chunk_seconds", "0.5", "--overlap_seconds", "0.125"])
    got = wait(timeout=200)

    _check_step(got["step"], step_ref)
    fit = got["fit"]
    assert fit["steps"] == (1, 2) and fit["start"] == 1 and fit["epochs"] == [0, 1]
    assert fit["dp"] == 1 and fit["verbose"] == (True, True)
    blob = torch.load(os.path.join(d, "exp", "checkpoints", "checkpoint_epoch0001.pth"),
                      weights_only=True)
    model = build_model(C.config_from_dict(raw).model)
    model.load_state_dict(blob["model_state_dict"], strict=True)
    first = torch.load(os.path.join(d, "exp", "checkpoints", "checkpoint_epoch0000.pth"),
                       weights_only=True)
    # the whole moments of the split parameters, one per parameter
    state = blob["optimizer_state_dict"]["state"]
    names = [n for n, _ in model.named_parameters()]
    assert len(state) == len(names)
    for i, n in enumerate(names):
        assert state[i]["exp_avg"].shape == model.state_dict()[n].shape, n
    assert any(not torch.equal(first["model_state_dict"][k], v)
               for k, v in blob["model_state_dict"].items())

    with open(os.path.join(d, "eval", "results.json")) as f:
        ours = json.load(f)
    with open(os.path.join(d, "jax_eval", "results.json")) as f:
        theirs = json.load(f)
    assert list(ours["per_track"]) == ["track0", "track1"]
    assert sorted(theirs["per_track"]) == ["track0", "track1"]
    for track in theirs["per_track"]:
        for stem, vals in theirs["per_track"][track].items():
            for m, v in vals.items():
                assert ours["per_track"][track][stem][m] == pytest.approx(v, abs=1e-3), \
                    (track, stem, m)
    for stem, vals in theirs["summary"].items():
        for m, v in vals.items():
            assert ours["summary"][stem][m] == pytest.approx(v, abs=1e-3), (stem, m)
    assert got["engine"] < 1e-5


def test_outer_masks_same_across_mp_and_differ_across_dp(tmp_path, rng):
    """Mesh 2 x 2 at dropout 0.1, the same input on every rank: the outer
    FFN and post-projection keep masks (and so the block's outputs) are the
    same on the two mp ranks of a replica and differ between replicas; the
    in-kernel sites' seeds differ on all four shards."""
    d = str(tmp_path)
    with open(os.path.join(d, "cfg.json"), "w") as f:
        json.dump({"model": TINY}, f)
    np.savez(os.path.join(d, "batch.npz"),
             x=(0.5 * rng.standard_normal((1, 3, 20, 32))).astype(np.float32))
    got = _spawn("seeds", 4, d)(timeout=120)
    for name in ("outputs", "ffn_keep", "attn_keep"):
        p = got[name]
        assert torch.equal(p[0], p[1]) and torch.equal(p[2], p[3]), name
        assert not torch.equal(p[0], p[2]), name
    for name in ("ffn_keep", "attn_keep"):
        assert 0.85 < float(got[name][0].mean()) < 0.95, name
    assert not torch.equal(got["outputs"][0], got["undropped"])
    assert len(set(got["seeds"])) == 4
