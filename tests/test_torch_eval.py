"""The port's evaluation on the CPU: ``eval/metrics.py`` and
``eval/bss_eval.py`` against the JAX package's on seeded numpy, and the
evaluation CLI (``--device cpu``) on a one-track synthetic MUSDB tree for
each model family: ``results.json``'s structure, and its values against the
port's metrics on the same stems."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from mss_tf_locoformer_tpu.eval import bss_eval as JB
from mss_tf_locoformer_tpu.eval import metrics as JM
from mss_tf_locoformer_tpu_torch.cli import evaluate as cli
from mss_tf_locoformer_tpu_torch.core.config import BSModelConfig, ModelConfig
from mss_tf_locoformer_tpu_torch.data.audio_io import write
from mss_tf_locoformer_tpu_torch.data.musdb import MUSDBDataset
from mss_tf_locoformer_tpu_torch.eval import bss_eval as B
from mss_tf_locoformer_tpu_torch.eval import metrics as M
from mss_tf_locoformer_tpu_torch.infer.separate import load_model, make_engine, model_input
from mss_tf_locoformer_tpu_torch.models import build_model

STEMS = ("vocals", "drums", "bass", "other")
SR = 8000
METRICS = {"si_sdr", "sdr", "sar", "sir", "bss_sdr", "bss_sir", "bss_sar"}
FLEN = 32   # BSS Eval filter taps: short signals, small systems
# the same numpy code on both sides, float64: equal up to summation order
TOL = 1e-9


def _estimates(rng, t=2000):
    refs = rng.standard_normal((4, t))
    est = refs + 0.3 * rng.standard_normal((4, t)) + 0.2 * refs[::-1]
    return est, refs


@pytest.mark.parametrize("name", ["compute_si_sdr", "compute_sdr", "compute_sar",
                                  "compute_sir"])
def test_metrics_match_jax(rng, name):
    est, refs = _estimates(rng)
    for e, r in zip(est, refs):
        assert getattr(M, name)(e, r) == pytest.approx(getattr(JM, name)(e, r), abs=TOL)


def test_evaluate_source_separation_matches_jax(rng):
    est, refs = _estimates(rng)
    preds, targets = dict(zip(STEMS, est)), dict(zip(STEMS[:3], refs))
    got = M.evaluate_source_separation(preds, targets)
    want = JM.evaluate_source_separation(preds, targets)
    assert set(got) == set(want) == {"vocals", "drums", "bass", "average"}
    for stem in want:
        assert got[stem] == pytest.approx(want[stem], abs=TOL)
        assert got[stem]["sar"] == got[stem]["sir"] == got[stem]["si_sdr"]


def test_bss_eval_matches_jax(rng):
    est, refs = _estimates(rng)
    got, want = B.bss_eval_sources(est, refs, FLEN), JB.bss_eval_sources(est, refs, FLEN)
    for m in ("sdr", "sir", "sar"):
        np.testing.assert_allclose(got[m], want[m], atol=TOL, rtol=0)
    stereo = {s: e.reshape(2, -1) for s, e in zip(STEMS, est)}
    targets = {s: r.reshape(2, -1) for s, r in zip(STEMS, refs)}
    got, want = B.bss_eval_stems(stereo, targets, filter_len=FLEN), \
        JB.bss_eval_stems(stereo, targets, filter_len=FLEN)
    for stem in want:
        assert got[stem] == pytest.approx(want[stem], abs=TOL)


_FAMILIES = {
    "tflocoformer": ModelConfig(n_fft=256, hop_length=64, n_layers=1, emb_dim=32,
                                num_groups=4, n_heads=2, attention_dim=32,
                                ffn_type=("swiglu_conv1d", "swiglu_conv1d"),
                                ffn_hidden_dim=(32, 32), flash_attention=True,
                                fused_ffn=True, fused_stft=True),
    "bslocoformer": BSModelConfig(n_fft=256, hop_length=128, stft_size=256, n_layers=1,
                                  emb_dim=32, num_groups=4, n_heads=2, attention_dim=32,
                                  ffn_type="swiglu_conv1d", ffn_hidden_dim=64,
                                  flash_attention=True, fused_ffn=True, stereo=True)}


def _tree(root, rng, n=SR):
    d = root / "test" / "song0"
    d.mkdir(parents=True)
    stems = {s: (0.1 * rng.standard_normal((n, 2))).astype(np.float32) for s in STEMS}
    for s, x in stems.items():
        write(str(d / f"{s}.wav"), x, SR)
    write(str(d / "mixture.wav"), sum(stems.values()), SR)


@pytest.mark.parametrize("family", sorted(_FAMILIES))
def test_evaluate_cli(tmp_path, rng, family):
    """results.json holds every stem, ``average`` and ``summary`` with every
    metric, and its values are the port's metrics of the port's stems:
    stereo stems for the stereo model, mono ones otherwise."""
    cfg = _FAMILIES[family]
    _tree(tmp_path / "musdb", rng)
    ckpt, cfg_path = tmp_path / "m.pth", tmp_path / "c.json"
    torch.save(build_model(cfg, generator=torch.Generator().manual_seed(0)).state_dict(), ckpt)
    cfg_path.write_text(json.dumps({
        "dataset": {"root_dir": str(tmp_path / "musdb"), "sample_rate": SR,
                    "sources": list(STEMS)},
        "model": dataclasses.asdict(cfg)}))
    out = tmp_path / "eval"
    returned = cli.main(["--config", str(cfg_path), "--checkpoint", str(ckpt),
                         "--output_dir", str(out), "--device", "cpu", "--bss_eval",
                         "--bss_filter_len", str(FLEN), "--chunk_seconds", "0.5",
                         "--overlap_seconds", "0.125", "--save_audio"])
    results = json.loads((out / "results.json").read_text())
    assert results == json.loads(json.dumps(returned))
    assert set(results) == {"per_track", "summary"}
    assert set(results["per_track"]) == {"song0"}
    for table in (results["per_track"]["song0"], results["summary"]):
        assert set(table) == set(STEMS) | {"average"}
        for vals in table.values():
            assert set(vals) == METRICS and all(np.isfinite(list(vals.values())))

    model, _ = load_model(str(ckpt), str(cfg_path), device="cpu")
    sample = MUSDBDataset(str(tmp_path / "musdb"), subset="test", sample_rate=SR,
                          sources=list(STEMS), return_metadata=True, verbose=False)[0]
    assert sample["track_name"] == "song0"
    stems = make_engine(model, 0.5, 0.125, SR, 2, "cpu")(model_input(model, sample["mixture"]))
    targets = {s: model_input(model, sample[s]) for s in STEMS}
    assert stems["vocals"].shape == ((2, SR) if cfg.name.startswith("bs") else (SR,))
    want = M.evaluate_source_separation(stems, targets)
    for stem, vals in B.bss_eval_stems(stems, targets, filter_len=FLEN).items():
        want[stem].update({f"bss_{m}": v for m, v in vals.items()})
    for stem in want:
        assert results["per_track"]["song0"][stem] == pytest.approx(want[stem], abs=1e-6)
        assert results["summary"][stem] == pytest.approx(want[stem], abs=1e-6)
    assert (out / "song0" / "vocals.wav").exists()


def test_evaluate_cli_refuses_distributed_runs(monkeypatch):
    """Distributed evaluation runs (tests/test_torch_parallel_runs.py); what
    it refuses is a run it cannot start: rank flags without --distributed or
    a coordinator, and --distributed without torchrun's environment."""
    args = ["--config", "c.json", "--checkpoint", "m.pth"]
    assert cli.parse_args(args).device == "cuda"   # the default
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(RuntimeError, match="torchrun environment"):
        cli.main(args + ["--distributed"])
    with pytest.raises(SystemExit):
        cli.main(args + ["--num_processes", "2"])
