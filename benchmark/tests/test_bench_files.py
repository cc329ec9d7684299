"""The benchmark's files: every cell, configuration and metric of
``BENCHMARK.json`` loads by name, the frozen FLOP count, what the harness
may import, and a run on a machine without a card.

    python -m pytest benchmark/tests -q
"""

import ast
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402
from benchmark.yardstick import flops, work  # noqa: E402

with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    BENCH = json.load(_f)
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _sources(sub=""):
    top = os.path.join(ROOT, "benchmark", sub)
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imports(path):
    """Top-level names of every module ``path`` imports (absolute imports)."""
    tree = ast.parse(open(path).read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("cell", CELLS)
def test_cell_loads_by_name(cell):
    c = harness.load_cell(cell)
    assert c.chips == 1
    assert set(c.limits) and all(v > 0 for v in c.limits.values())
    assert "setup_s" in c.end_to_end and len(c.end_to_end) >= 2 and c.per_layer
    harness.runner_module(c)
    ref = harness.reference_module(c)
    from mss_tf_locoformer_tpu_torch.core.config import model_config_from_dict
    model_config_from_dict(c.config["model"])
    from mss_tf_locoformer_tpu_torch.models import build_model
    port = build_model(model_config_from_dict(c.config["model"])).state_dict()
    specs = {n: tuple(s) for n, s, _ in ref.param_specs(c.config["model"])}
    assert specs == {n: tuple(t.shape) for n, t in port.items()}


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_loads_and_reads_nothing_when_absent(metric):
    read = harness.metric_reader(metric)

    class Empty:
        kind = "none"
    assert read(Empty()) is None


def test_benchmark_json_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"] and 1 <= BENCH["run_seconds"] <= 51
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("benchmark/") and os.path.exists(os.path.join(ROOT, c["file"]))
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and len(w["why"]) <= 200
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert os.path.exists(os.path.join(ROOT, "benchmark", "traffic", w["traffic"] + ".json"))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert all(0.01 <= m["bound"] <= 0.25 for m in BENCH["end_to_end"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["source"] in ("device_trace", "program_span",
                                                     "program_counter", "host_clock")
        assert os.path.exists(os.path.join(ROOT, "benchmark", "metrics", m["name"] + ".py"))


def _config(name):
    with open(os.path.join(ROOT, "benchmark", "configs", name + ".json")) as f:
        return json.load(f)


def test_frozen_flops_base_forward():
    m = _config("tflocoformer-musdb-base")["model"]
    assert flops.forward_flops(m, 2, 352800) / 1e12 == pytest.approx(24.61, abs=5e-3)
    ops = work.forward_ops(m, 2, 352800, 2)
    assert sum(f for _, f, _ in ops) == pytest.approx(flops.forward_flops(m, 2, 352800))


@pytest.mark.parametrize("name,batch,samples", [
    ("tflocoformer-musdb-base", 2, 352800), ("tflocoformer-musdb-xlarge", 2, 352800),
    ("tflocoformer-musdb-base", 1, 132300)])
def test_frozen_flops_agree_with_the_port(name, batch, samples):
    from mss_tf_locoformer_tpu_torch.core.config import model_config_from_dict
    from mss_tf_locoformer_tpu_torch.utils import flops as port
    m = _config(name)["model"]
    cfg = model_config_from_dict(m)
    assert flops.forward_flops(m, batch, samples) == pytest.approx(
        port.tflocoformer_forward_flops(cfg, batch, samples), rel=1e-12)
    assert flops.train_step_flops(m, batch, samples) == pytest.approx(
        port.train_step_flops(cfg, batch, samples), rel=1e-12)


def test_nothing_imports_jax():
    for path in _sources():
        bad = _imports(path) & set(harness.FORBIDDEN)
        assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("sub", ["reference", "yardstick"])
def test_reference_and_yardstick_import_nothing_of_the_port(sub):
    for path in _sources(sub):
        assert "mss_tf_locoformer_tpu_torch" not in _imports(path), path


def _no_card_run(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELLS[0],
                           "--seed", "2147483999", "--seconds", "1", "--trace", "0"],
                          cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_a_run_without_a_card_fails():
    proc = _no_card_run(ROOT)
    assert proc.returncode != 0
    assert not any(line.startswith("{") for line in proc.stdout.splitlines())


def test_a_run_without_the_port_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _no_card_run(tmp_path)
    assert proc.returncode != 0
    assert not any(line.startswith("{") for line in proc.stdout.splitlines())
