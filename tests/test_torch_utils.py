"""The port's ``utils/flops.py`` and ``utils/profiling.py`` on the CPU: the
analytic FLOP counts against the JAX module's for every shipped config, the
card's peak from its name, a ``torch.profiler`` window writing a trace,
``step_time_stats`` against the JAX function, and ``profile_steps`` in the
MSS and the speech trainer on ``--device cpu``."""

import dataclasses
import glob
import json
import os
import types

import numpy as np
import pytest
import torch

from mss_tf_locoformer_tpu.core import config as JC
from mss_tf_locoformer_tpu.data import audio_io as jaudio
from mss_tf_locoformer_tpu.utils import flops as JF
from mss_tf_locoformer_tpu.utils import profiling as JP
from mss_tf_locoformer_tpu_torch.core import config as C
from mss_tf_locoformer_tpu_torch.utils import flops as F
from mss_tf_locoformer_tpu_torch.utils import profiling as P

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEMS = ("vocals", "drums", "bass", "other")


def _model_cfgs(path):
    """(port, JAX) model configs of a config file; a speech config as the
    fields the count reads (separator, STFT, one source per speaker)."""
    if os.path.basename(path).startswith("speech"):
        cfgs = []
        for load in (C.load_speech_config, JC.load_speech_config):
            s = load(path)
            fields = {f.name: getattr(s.separator, f.name)
                      for f in dataclasses.fields(s.separator)}
            ffn = fields["ffn_hidden_dim"]
            fields.update(n_fft=s.stft.n_fft, hop_length=s.stft.hop_length,
                          n_sources=s.separator.num_spk,
                          ffn_hidden_dim=tuple(ffn) if isinstance(ffn, list) else ffn)
            cfgs.append(types.SimpleNamespace(**fields))
        return cfgs
    return C.load_model_config(path), JC.load_config(path).model


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml"))),
                         ids=os.path.basename)
def test_flops_match_jax(path):
    ours, theirs = _model_cfgs(path)
    for batch, samples in ((1, 44100), (2, 3 * 44100 + 17)):
        want = JF.tflocoformer_forward_flops(theirs, batch, samples)
        assert want > 0
        assert F.tflocoformer_forward_flops(ours, batch, samples) == want
        assert F.train_step_flops(ours, batch, samples) == \
            JF.train_step_flops(theirs, batch, samples)
    assert F.n_stft_frames(44100, 512) == JF.n_stft_frames(44100, 512)


def test_device_peak_flops(monkeypatch):
    """NVIDIA's dense bf16 peak by part; None on the CPU, without a card or
    for an unknown card."""
    assert F.device_peak_flops("cpu") is None
    if not torch.cuda.is_available():
        assert F.device_peak_flops() is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for name, peak in (("NVIDIA H100 80GB HBM3", 989.4e12), ("NVIDIA H100 PCIe", 756.5e12),
                       ("NVIDIA H100 NVL", 835.5e12), ("NVIDIA A100-SXM4-80GB", None)):
        monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None, n=name: n)
        assert F.device_peak_flops() == peak
        assert F.device_peak_flops(0) == peak
        assert F.device_peak_flops(name) == peak
    assert F.device_peak_flops("cpu") is None


def _trace_events(path):
    with open(path) as f:
        return json.load(f)["traceEvents"]


def test_step_profiler_window_and_stats(tmp_path):
    """Steps 2 and 3 of 5 traced: the window opens at step_start(2), closes
    after step_end(3), and writes one trace holding the ranges of those
    steps only; the times and their summary as the JAX profiler keeps them."""
    prof = P.StepProfiler(str(tmp_path), n_steps=2, start_step=2)
    x = torch.randn(64, 64)
    for step in range(5):
        prof.step_start(step)
        with torch.profiler.record_function(f"work_{step}"):
            (x @ x).sum().item()
        prof.step_end(step)
    prof.close()
    files = glob.glob(str(tmp_path / "plugins" / "profile" / "*" / "*.pt.trace.json"))
    assert files == [prof.trace_path]
    names = {e.get("name") for e in _trace_events(prof.trace_path)}
    assert {"work_2", "work_3"} <= names and not names & {"work_0", "work_1", "work_4"}
    assert len(prof.times) == 5
    assert prof.stats() == P.step_time_stats(prof.times)
    for times in ([], [0.5], [3.0, 1.0, 2.0, 5.0, 4.0], list(np.linspace(0.1, 1.0, 23))):
        assert P.step_time_stats(times) == JP.step_time_stats(times)
    idle = P.StepProfiler(str(tmp_path / "idle"))   # n_steps 0: never traces
    idle.step_start(7)
    idle.step_end(7)
    idle.close()
    assert idle.trace_path is None and not os.path.exists(tmp_path / "idle" / "plugins")


SR = 8000
_TINY = dict(n_fft=256, hop_length=64, n_layers=1, emb_dim=32, num_groups=4, n_heads=2,
             attention_dim=32, ffn_type=["swiglu_conv1d", "swiglu_conv1d"],
             ffn_hidden_dim=[32, 32], fused_ffn=True, flash_attention=True, fused_stft=True)


def test_mss_trainer_profile_steps(tmp_path, rng):
    """``profile_steps: 1`` from step 1 in the MSS trainer on the CPU: one
    trace of the second step under ``logs/plugins/profile``."""
    from mss_tf_locoformer_tpu_torch.cli import train as train_cli
    for subset, tracks, n in (("train", 4, SR), ("test", 1, SR // 2)):
        for t in range(tracks):
            d = tmp_path / "musdb" / subset / f"t{t}"
            d.mkdir(parents=True)
            stems = {s: (0.1 * rng.standard_normal((n, 2))).astype(np.float32) for s in STEMS}
            for s, x in stems.items():
                jaudio.write(str(d / f"{s}.wav"), x, SR)
            jaudio.write(str(d / "mixture.wav"), sum(stems.values()), SR)
    raw = {"dataset": {"root_dir": str(tmp_path / "musdb"), "sample_rate": SR,
                       "segment_length": SR // 4, "sources": list(STEMS)},
           "model": _TINY,
           "training": {"batch_size": 2, "num_epochs": 1, "num_workers": 0, "use_amp": False,
                        "profile_steps": 1, "profile_start_step": 1, "log_interval": 1,
                        "optimizer": {"lr": 1e-3}},
           "seed": 0}
    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps(raw))
    out = tmp_path / "exp"
    trainer = train_cli.main(["--config", str(cfg), "--device", "cpu",
                              "--output_dir", str(out)])
    assert trainer.step == 2
    files = glob.glob(str(out / "logs" / "plugins" / "profile" / "*" / "*.pt.trace.json"))
    assert files == [trainer.profiler.trace_path] and _trace_events(files[0])
    assert trainer.profiler.stats()["steps"] == 2.0


def test_speech_trainer_profile_steps(tmp_path, rng):
    """``profile_steps: 2`` in the speech trainer on the CPU: the trace of
    steps 0 and 1, and the step-time statistics of the epoch."""
    from mss_tf_locoformer_tpu_torch.cli import train_speech as train_cli
    for sub, n_utts, n in (("tr", 4, 4800), ("cv", 1, 4000)):
        for d in ("mix", "s1", "s2"):
            (tmp_path / sub / d).mkdir(parents=True)
        for u in range(n_utts):
            s1, s2 = (0.1 * rng.standard_normal(n).astype(np.float32) for _ in range(2))
            for d, x in (("s1", s1), ("s2", s2), ("mix", s1 + s2)):
                jaudio.write(str(tmp_path / sub / d / f"u{u}.wav"), x[:, None], SR)
    sep = {k: v for k, v in _TINY.items() if k not in ("n_fft", "hop_length", "fused_stft")}
    raw = {"task": "speech_separation",
           "dataset": {"root_dir": str(tmp_path / "tr"), "valid_dir": str(tmp_path / "cv"),
                       "num_spk": 2, "sample_rate": SR, "segment_length": 3200},
           "separator": dict(sep, num_spk=2), "stft": {"n_fft": 128, "hop_length": 64},
           "loss": {"criterion": "si_snr", "wrapper": "pit"},
           "training": {"batch_size": 2, "num_epochs": 1, "num_workers": 0, "use_amp": False,
                        "profile_steps": 2, "profile_start_step": 0, "log_interval": 1,
                        "optimizer": {"lr": 1e-3}},
           "seed": 3}
    cfg = tmp_path / "speech.json"
    cfg.write_text(json.dumps(raw))
    out = tmp_path / "exp"
    trainer = train_cli.main(["--config", str(cfg), "--device", "cpu",
                              "--output_dir", str(out)])
    assert trainer.step == 2
    files = glob.glob(str(out / "logs" / "plugins" / "profile" / "*" / "*.pt.trace.json"))
    assert files == [trainer.profiler.trace_path] and _trace_events(files[0])
    assert trainer.profiler.stats()["steps"] == 2.0
