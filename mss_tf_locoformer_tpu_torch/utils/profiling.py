"""Profiling hooks (the JAX package's ``utils/profiling.py``): a
``torch.profiler`` trace window over chosen training steps, and host-side
step-time statistics.

The trace records CPU activity and, where a card is present, CUDA activity,
and is written as a Chrome trace (viewable in Perfetto or TensorBoard's
profile plugin) under ``<log_dir>/plugins/profile/<time>/<host>.pt.trace.json``,
the directory the JAX package's ``jax.profiler`` traces go to.
"""

from __future__ import annotations

import os
import socket
import time
from typing import Dict, Optional

import torch

__all__ = ["StepProfiler", "step_time_stats"]


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


class StepProfiler:
    """Captures a ``torch.profiler`` trace for steps ``[start_step, start_step
    + n_steps)`` and records per-step wall times.

    Call :meth:`step_start` / :meth:`step_end` around each optimizer step;
    ``step_end`` must run after the host has synchronised on the step's
    results (the trainer reads the scalar loss, which waits for the card).
    ``trace_path`` is the written trace's file once the window has closed.
    """

    def __init__(self, log_dir: str, n_steps: int = 0, start_step: int = 5):
        self.log_dir = log_dir
        self.n_steps = n_steps
        self.start_step = start_step
        self._prof: Optional[torch.profiler.profile] = None
        self._done = n_steps <= 0
        self._t0: Optional[float] = None
        self.times: list = []
        self.trace_path: Optional[str] = None

    def step_start(self, step: int) -> None:
        if not self._done and self._prof is None and step >= self.start_step:
            self._prof = torch.profiler.profile(activities=_activities())
            self._prof.__enter__()
        self._t0 = time.perf_counter()

    def step_end(self, step: int) -> None:
        if self._t0 is not None:
            self.times.append(time.perf_counter() - self._t0)
        if self._prof is not None and step >= self.start_step + self.n_steps - 1:
            self._stop()

    def _stop(self) -> None:
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        out = os.path.join(self.log_dir, "plugins", "profile",
                           time.strftime("%Y_%m_%d_%H_%M_%S"))
        os.makedirs(out, exist_ok=True)
        self.trace_path = os.path.join(out, f"{socket.gethostname()}.pt.trace.json")
        prof.export_chrome_trace(self.trace_path)
        self._done = True

    def close(self) -> None:
        if self._prof is not None:
            self._stop()

    def stats(self) -> Dict[str, float]:
        return step_time_stats(self.times)


def step_time_stats(times) -> Dict[str, float]:
    """Robust step-time summary (skips the first, warm-up step)."""
    if not times:
        return {}
    steady = sorted(times[1:] or times)
    n = len(steady)
    return {
        "steps": float(len(times)),
        "mean_s": sum(steady) / n,
        "p50_s": steady[n // 2],
        "p90_s": steady[min(n - 1, int(0.9 * n))],
        "max_s": steady[-1],
    }
