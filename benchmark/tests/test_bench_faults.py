"""A run's comparison sees a broken program: the runners run here on the CPU
at a tiny size (past the harness's look for a card), once sound and once
with each fault a cell can have planted in the port underneath, and
``correct`` has to come out true and then false.

    python -m pytest benchmark/tests/test_bench_faults.py -q
"""

import os
import sys
import time

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from benchmark import faults, harness  # noqa: E402
from benchmark.runners import separate, train  # noqa: E402

MODEL = dict(name="tflocoformer_mss", n_fft=128, hop_length=64, n_sources=4, n_layers=1,
             emb_dim=8, norm_type="rmsgroupnorm", num_groups=2, tf_order="ft", n_heads=2,
             flash_attention=True, fused_ffn=True, fused_stft=True, attention_dim=8,
             pos_enc="rope", ffn_type=["swiglu_conv1d", "swiglu_conv1d"],
             ffn_hidden_dim=[16, 16], conv1d_kernel=4, conv1d_shift=1, dropout=0.0, eps=1e-5)
CONFIG = {"reference": "tflocoformer_mss", "model": MODEL, "loss": {},
          "training": {"gradient_clip": 5.0, "optimizer": {"type": "adamw", "lr": 5e-4}}}
SERVE = harness.Cell(
    "tiny-separate", 1, CONFIG,
    dict(runner="separate", precision="fp32", sample_rate=8000, chunk_seconds=0.5,
         overlap_seconds=0.125, chunks_per_song=[4, 6], batch_size=2, songs=3,
         warmup_batches=1, checked_batches=2, checked_songs=1, traced_batches=2),
    {"stem_rel_l2": 1e-4, "engine_rel_l2": 1e-5}, {}, {})
TRAIN = harness.Cell(
    "tiny-train", 1, CONFIG,
    dict(runner="train", use_amp=False, batch_size=4, accumulation=2, segment_samples=2000,
         sample_rate=8000, pool=4, checked_steps=3, lookahead=2, traced_steps=2),
    {"loss_gap": 1e-4, "grad_gap": 1e-4, "change_gap": 1e-3}, {}, {})


def _correct(cell, runner):
    outcome = runner.run(cell, 2 ** 31 + 4242, 1.0, False, time.perf_counter(), "cpu")
    return harness.result_line(cell, outcome, False, {})["correct"]


def test_sound_separation_is_correct():
    assert _correct(SERVE, separate)


@pytest.mark.parametrize("fault", sorted(faults.SEPARATION))
def test_broken_separation_is_not_correct(monkeypatch, fault):
    faults.SEPARATION[fault](monkeypatch.setattr)
    assert not _correct(SERVE, separate)


def test_sound_training_is_correct():
    assert _correct(TRAIN, train)


@pytest.mark.parametrize("fault", sorted(faults.TRAINING))
def test_broken_training_is_not_correct(monkeypatch, fault):
    faults.TRAINING[fault](monkeypatch.setattr)
    assert not _correct(TRAIN, train)
