"""The traced part of a ``--trace 1`` run: ``torch.profiler`` over a few
batches or steps, reduced to what the per-layer metrics and the
``breakdown`` read.

Device time is the union of the trace's kernel, copy and memset intervals
inside the traced window (overlapping work counted once); the window is the
host span ``bench.traced`` around the traced work, which ends in a
synchronise.  Each idle gap of the device is named by the innermost
``bench.*`` host span open when it began.
"""

from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass
from typing import Callable, Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


@dataclass
class TraceSummary:
    busy_s: float                 # union of device intervals in the window
    window_s: float
    kernel_s: float               # summed kernel time in the window
    device_ops: List[list]        # [[name, seconds]], the most time first
    idle_gaps: List[list]         # [[host span, seconds]], the longest first


def _short(name: str) -> str:
    name = name.replace("void ", "").replace("(anonymous namespace)::", "")
    return name[:120]


def reduce(events: List[dict], span_names: Dict[str, str]) -> TraceSummary:
    """Reduce chrome-trace events; ``span_names`` maps a ``bench.*`` host
    span to the name its idle gaps get."""
    win = [e for e in events if e.get("name") == "bench.traced" and e.get("ph") == "X"
           and e.get("cat") == "user_annotation"]
    if not win:
        raise RuntimeError("the trace holds no bench.traced span")
    w0, w1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    dev = sorted((max(e["ts"], w0), min(e["ts"] + e["dur"], w1), e)
                 for e in events
                 if e.get("cat") in DEVICE_CATS and e.get("ph") == "X"
                 and e["ts"] < w1 and e["ts"] + e["dur"] > w0)
    kernel_us: Dict[str, float] = {}
    for a, b, e in dev:
        if e["cat"] == "kernel":
            kernel_us[_short(e["name"])] = kernel_us.get(_short(e["name"]), 0.0) + (b - a)
    merged: List[List[float]] = []
    for a, b, _ in dev:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged)
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e.get("cat") == "user_annotation" and e.get("name") in span_names)
    gaps: List[Tuple[float, float]] = []
    edge = w0
    for a, b in merged + [[w1, w1]]:
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)

    def name_of(t: float) -> str:
        inner = None
        for s0, s1, name in spans:
            if s0 <= t < s1 and (inner is None or s0 >= inner[0]):
                inner = (s0, name)
        return span_names[inner[1]] if inner else "outside the benchmark's spans"

    idle = sorted(((name_of(a), (b - a) * 1e-6) for a, b in gaps), key=lambda g: -g[1])
    ops = sorted(kernel_us.items(), key=lambda kv: -kv[1])
    return TraceSummary(busy_s=busy * 1e-6, window_s=(w1 - w0) * 1e-6,
                        kernel_s=sum(kernel_us.values()) * 1e-6,
                        device_ops=[[n, us * 1e-6] for n, us in ops[:TOP]],
                        idle_gaps=[[n, s] for n, s in idle[:TOP]])


def traced(fn: Callable[[], None], span_names: Dict[str, str]) -> TraceSummary:
    """Run ``fn`` under ``torch.profiler`` and reduce its trace; the trace
    file lives in the temporary directory only while it is read."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("bench.traced"):
            fn()
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return reduce(events, span_names)
