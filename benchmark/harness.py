"""What every cell shares: finding a cell's files by name, the checks on the
card and on what the process loaded, the control's rounding, the reading of
per-layer metrics and the result line.

A cell is one entry of ``BENCHMARK.json``'s ``workloads``.  Its files:

  * the configuration named by ``config``, at the ``file`` its entry in
    ``configs`` gives, whose ``reference`` key names the plain reference in
    ``benchmark/reference/``;
  * ``benchmark/traffic/<traffic>.json``, whose ``runner`` key names the
    module of ``benchmark/runners/`` that runs it;
  * ``benchmark/limits/<cell>.json``: each number compared and its limit;
  * ``benchmark/metrics/<metric>.py`` for each per-layer metric of the cell.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "mss_tf_locoformer_tpu")
CONTROLS = {"bf16": "fp8", "fp32": "tf32"}   # the next precision down


class NoCard(RuntimeError):
    """The cell asks for more cards than the machine shows."""


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: Dict[str, str]            # name -> unit
    per_layer: Dict[str, str]             # name -> unit


@dataclass
class Outcome:
    """What a runner hands back.  ``ctx`` is what the per-layer readers
    read; ``checks`` maps each number the run can compare to its value
    (the cell's limits file says which are compared); ``detail``
    holds what the run prints on standard error before the checks (the
    seconds of its phases, the worst leaves)."""

    e2e: Dict[str, float]
    checks: Dict[str, float]
    attempted: int
    memory_peak: int
    ctx: object = None
    trace: Optional[object] = None
    detail: dict = field(default_factory=dict)


def _applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load_cell(name: str, root: str = ROOT) -> Cell:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(work)})")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(HERE, "traffic", w["traffic"] + ".json")) as f:
        traffic = json.load(f)
    with open(os.path.join(HERE, "limits", name + ".json")) as f:
        limits = json.load(f)
    return Cell(name, w["chips"], config, traffic, limits,
                {m["name"]: m["unit"] for m in bench["end_to_end"] if _applies(m, name)},
                {m["name"]: m["unit"] for m in bench["per_layer"] if _applies(m, name)})


def reference_module(cell: Cell):
    return importlib.import_module(f"benchmark.reference.{cell.config['reference']}")


def runner_module(cell: Cell):
    return importlib.import_module(f"benchmark.runners.{cell.traffic['runner']}")


def metric_reader(name: str):
    """``read(ctx)`` of ``benchmark/metrics/<name>.py``."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def check_card(chips: int) -> None:
    import torch
    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is false: this benchmark runs on a CUDA card")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"the cell asks for {chips} cards, the machine shows "
                     f"{torch.cuda.device_count()}")


def forbidden_modules() -> List[str]:
    """Modules of JAX or of the JAX package in ``sys.modules``, compared by
    whole top-level names."""
    return sorted({n.split(".")[0] for n in sys.modules} & set(FORBIDDEN))


def rounding(control: Optional[str]):
    """The control's rounding where the configuration rounds to its compute
    dtype: ``fp8`` rounds to float8 e4m3 with a per-tensor scale, forward
    and backward; otherwise the identity (``tf32`` is a backend switch)."""
    import torch

    def _fp8(t):
        amax = t.detach().abs().amax().float().clamp_min(1e-30)
        scale = 448.0 / amax
        return (t * scale).to(torch.float8_e4m3fn).to(t.dtype) / scale

    class _Fp8(torch.autograd.Function):
        @staticmethod
        def forward(ctx, t):
            return _fp8(t)

        @staticmethod
        def backward(ctx, g):
            return _fp8(g)

    if control == "fp8":
        return _Fp8.apply
    return lambda t: t


def control_of(cell: Cell) -> str:
    """The control's precision: the one below the cell's."""
    prec = cell.traffic.get("precision") or ("bf16" if cell.traffic.get("use_amp") else "fp32")
    return CONTROLS[prec]


def set_tf32(on: bool) -> None:
    import torch
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def rel_l2(got, ref) -> float:
    import numpy as np
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


def still_leaves(grad: Dict[str, float]) -> set:
    """Leaves whose reference gradient is under a thousandth of the median
    leaf's: Adam moves them by round-off alone."""
    import numpy as np
    med = float(np.median(list(grad.values())))
    return {k for k, g in grad.items() if g < 1e-3 * med}


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], skip=frozenset()) -> Dict[str, float]:
    """Each leaf's gap between two norms, over the reference's norm of that
    leaf or of the median leaf, whichever is larger; ``skip`` leaves out."""
    import numpy as np
    med = float(np.median([r for k, r in ref.items() if k not in skip]))
    return {k: abs(prog.get(k, 0.0) - r) / max(r, med) for k, r in ref.items() if k not in skip}


def per_layer_metrics(cell: Cell, ctx) -> Dict[str, dict]:
    out = {}
    for name, unit in cell.per_layer.items():
        value = metric_reader(name)(ctx)
        if value is not None:
            out[name] = {"value": value, "unit": unit}
    return out


def end_to_end(cell: Cell, e2e: Dict[str, float]) -> Dict[str, dict]:
    """The cell's end-to-end metrics from the runner's readings: a metric
    ``<quantity>.<qualifier>`` (one cell's own bound) reads ``<quantity>``."""
    out = {}
    for name, unit in cell.end_to_end.items():
        key = name if name in e2e else name.split(".")[0]
        if key in e2e:
            out[name] = {"value": e2e[key], "unit": unit}
    return out


def result_line(cell: Cell, outcome: Outcome, trace: bool, device_info: dict) -> dict:
    """The result's line; a number the limits file names that the run did
    not read (``None``) makes the run not correct."""
    checks = {k: {"value": outcome.checks.get(k), "limit": v} for k, v in cell.limits.items()}
    correct = bool(checks) and all(
        c["value"] is not None and math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values())
    metrics = per_layer_metrics(cell, outcome.ctx) if trace else end_to_end(cell, outcome.e2e)
    line = {"correct": correct, "attempted": outcome.attempted, "failed": 0,
            "metrics": metrics, "device": dict(device_info)}
    if trace and outcome.trace is not None:
        line["device"]["busy_s"] = outcome.trace.busy_s
        line["device"]["window_s"] = outcome.trace.window_s
        line["breakdown"] = {"device_ops": outcome.trace.device_ops,
                             "idle_gaps": outcome.trace.idle_gaps}
    line["checks"] = checks
    return line
