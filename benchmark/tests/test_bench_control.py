"""On the card: each cell's control (the reference one precision down, in
the program's place) comes out not correct under the cell's limits, on
three seeds, and the program comes out correct, at the cells' published
widths with fewer and shorter inputs than a run's, so that a test run holds
them.  The cells' own sizes are read by ``benchmark/readings.py``.

    python -m pytest benchmark/tests/test_bench_control.py -q -m cuda
"""

import dataclasses
import os
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402

CELLS = ("base-separate", "xlarge-separate", "base-train", "base-train-fp32")
SMALLER = {"separate": dict(chunks_per_song=[2], songs=2, batch_size=2, warmup_batches=1,
                            checked_batches=1),
           "train": dict(pool=3)}
SEEDS = (2 ** 31 + 301, 2 ** 31 + 302, 2 ** 31 + 303)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the controls are read on the chip")


def _small(name):
    cell = harness.load_cell(name)
    return dataclasses.replace(cell, traffic=dict(cell.traffic, **SMALLER[cell.traffic["runner"]]))


def _correct(cell, seed, control, kw):
    runner = harness.runner_module(cell)
    outcome = runner.run(cell, seed, 1.0, False, time.perf_counter(), "cuda", control, **kw)
    return harness.result_line(cell, outcome, False, {})


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_and_program_passes(card, name):
    cell = _small(name)
    kw = {"cache": {}} if cell.traffic["runner"] == "train" else {}
    line = _correct(cell, SEEDS[0], None, kw)
    assert line["correct"], line["checks"]
    for seed in SEEDS:
        line = _correct(cell, seed, harness.control_of(cell), kw)
        assert not line["correct"], (seed, line["checks"])
