"""The port's speech CLIs on the CPU (``--device cpu``): training on a tiny
``mix/ s1/ s2/`` corpus, ``--resume``, separation of a directory of WAVs of
different lengths, and the evaluation CLI's ``results.json`` against the
JAX CLI's on the same ``.pth`` and corpus.  emb 32, 2 heads, I 64; fp32
training (``use_amp: false``)."""

import functools
import json
import os

import numpy as np
import pytest
import torch

from mss_tf_locoformer_tpu.cli import evaluate_speech as jax_eval_cli
from mss_tf_locoformer_tpu.data import audio_io as jaudio
from mss_tf_locoformer_tpu_torch.cli import evaluate_speech as eval_cli
from mss_tf_locoformer_tpu_torch.cli import separate_speech as sep_cli
from mss_tf_locoformer_tpu_torch.cli import train_speech as train_cli
from mss_tf_locoformer_tpu_torch.core.precision import FP32
from mss_tf_locoformer_tpu_torch.infer import separate as infer
from mss_tf_locoformer_tpu_torch.utils.audio import load_audio
from torch_routes import spy

SR = 8000
_SEP = dict(num_spk=2, n_layers=1, emb_dim=32, num_groups=4, n_heads=2, attention_dim=32,
            ffn_type=["swiglu_conv1d", "swiglu_conv1d"], ffn_hidden_dim=[64, 64],
            conv1d_kernel=4, flash_attention=True, fused_ffn=True)


@pytest.fixture
def corpus(tmp_path, rng):
    """``tr/`` (4 utterances of 0.6 s) and ``cv/`` (2 of 0.5 s), 8 kHz."""
    for sub, n_utts, n in (("tr", 4, 4800), ("cv", 2, 4000)):
        for d in ("mix", "s1", "s2"):
            (tmp_path / sub / d).mkdir(parents=True)
        for u in range(n_utts):
            s1, s2 = (0.1 * rng.standard_normal(n).astype(np.float32) for _ in range(2))
            for d, x in (("s1", s1), ("s2", s2), ("mix", s1 + s2)):
                jaudio.write(str(tmp_path / sub / d / f"u{u}.wav"), x[:, None], SR, bits=16)
    return tmp_path


def _config(corpus, path, epochs):
    raw = {"task": "speech_separation",
           "dataset": {"root_dir": str(corpus / "tr"), "valid_dir": str(corpus / "cv"),
                       "num_spk": 2, "sample_rate": SR, "segment_length": 3200},
           "separator": _SEP, "stft": {"n_fft": 128, "hop_length": 64},
           "loss": {"criterion": "si_snr", "wrapper": "pit"},
           "training": {"batch_size": 2, "num_epochs": epochs, "num_workers": 2,
                        "use_amp": False, "save_interval": 1, "log_interval": 1,
                        "optimizer": {"lr": 1e-3}},
           "seed": 3}
    path.write_text(json.dumps(raw))
    return str(path)


def test_speech_clis_train_resume_separate(corpus, tmp_path, rng, monkeypatch):
    cfg = tmp_path / "speech.json"
    out = tmp_path / "exp"
    args = ["--config", _config(corpus, cfg, 1), "--device", "cpu", "--output_dir", str(out)]
    assert train_cli.parse_args(["--config", str(cfg)]).device == "cuda"   # the default
    calls = spy(monkeypatch)
    trainer = train_cli.main(args)
    # 2 steps of 2 x 0.4 s (2 paths: 2 FFN steps and 1 attention step each),
    # then 2 validation utterances
    assert calls == {"fused_norm_ffn_residual": 16, "fused_attention_block": 8,
                     "swiglu_conv_deconv": 0, "flash_attention": 0}
    assert trainer.step == 2 and trainer.ckpt.epochs() == [0]
    first = {k: v.clone() for k, v in trainer.model.state_dict().items()}

    resumed = train_cli.main(["--config", _config(corpus, cfg, 2)] + args[2:]
                             + ["--resume", "latest"])
    assert resumed.start_epoch == 1 and resumed.step == 4
    assert resumed.ckpt.epochs() == [0, 1]
    assert any(not torch.equal(first[k], v) for k, v in resumed.model.state_dict().items())
    for p in resumed.model.parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all()
    meta = torch.load(resumed.ckpt.path(1), weights_only=True)["metadata"]
    assert np.isfinite(meta["val_loss"]) and np.isfinite(meta["train_loss"])

    wavs = tmp_path / "mixes"
    wavs.mkdir()
    lengths = {"short": 2300, "long": 9100}    # not multiples of the 1 s bucket
    for name, n in lengths.items():
        jaudio.write(str(wavs / f"{name}.wav"),
                     (0.2 * rng.standard_normal((n, 1))).astype(np.float32), SR)
    est = sep_cli.main(["--config", str(cfg), "--checkpoint", resumed.ckpt.path(1),
                        "--input", str(wavs), "--output_dir", str(tmp_path / "sep"),
                        "--device", "cpu"])
    assert len(est) == 2
    for name, n in lengths.items():
        for s in (1, 2):
            audio, rate = load_audio(str(tmp_path / "sep" / f"{name}_spk{s}.wav"))
            assert rate == SR and audio.shape == (1, n) and np.isfinite(audio).all()
    assert sep_cli.parse_args(["--config", "c", "--checkpoint", "m", "--input", "x"]
                              ).device == "cuda"


def test_evaluate_speech_matches_jax_cli(corpus, tmp_path, monkeypatch):
    """``results.json`` of the port's CLI against the JAX CLI's on one random
    ``.pth`` and the ``cv/`` corpus: the same utterances, and SI-SNR, SDR and
    STOI per utterance and in the mean.  The port's loader is held at fp32
    here, as the JAX CLI runs its separator (its default is bf16 blocks);
    fp32 on both sides, so 1e-3 dB and 1e-4 in STOI."""
    from mss_tf_locoformer_tpu_torch.core.config import load_speech_config
    from mss_tf_locoformer_tpu_torch.models import TFLocoformerSeparator
    cfg = _config(corpus, tmp_path / "speech.json", 1)
    model = TFLocoformerSeparator(load_speech_config(cfg).separator,
                                  generator=torch.Generator().manual_seed(5))
    ckpt = str(tmp_path / "model.pth")
    torch.save({"model_state_dict": model.state_dict()}, ckpt)
    monkeypatch.setattr(infer, "load_speech_separator",
                        functools.partial(infer.load_speech_separator, precision=FP32))
    argv = ["--config", cfg, "--checkpoint", ckpt]
    got = eval_cli.main(argv + ["--output_dir", str(tmp_path / "ours"), "--device", "cpu"])
    jax_eval_cli.main(argv + ["--output_dir", str(tmp_path / "jax")])
    with open(tmp_path / "ours" / "results.json") as f:
        ours = json.load(f)
    with open(tmp_path / "jax" / "results.json") as f:
        theirs = json.load(f)
    assert ours == json.loads(json.dumps(got))
    assert set(ours) == {"mean", "per_utterance"}
    assert sorted(ours["per_utterance"]) == sorted(theirs["per_utterance"]) == ["u0.wav",
                                                                              "u1.wav"]
    for where, a, b in [(u, ours["per_utterance"][u], theirs["per_utterance"][u])
                        for u in theirs["per_utterance"]] + [("mean", ours["mean"],
                                                             theirs["mean"])]:
        assert set(a) == set(b) == {"si_snr", "sdr", "stoi"}
        for k in ("si_snr", "sdr"):
            assert a[k] == pytest.approx(b[k], abs=1e-3), (where, k)
        assert a["stoi"] == pytest.approx(b["stoi"], abs=1e-4), where
