"""Trainer plumbing (the JAX package's ``train/engine.py``): the epoch loop
over device-prefetched batches, the step profiler's window and optional
TensorBoard scalars.  The only
per-step host sync is the scalar loss read for logging."""

from __future__ import annotations

import time
from typing import Callable, Dict, Iterable, Tuple

from ..data.loader import prefetch_to_device
from ..utils.common import AverageMeter, format_time

__all__ = ["make_writer", "Scalars", "run_train_epoch"]


def make_writer(log_dir: str):
    """A tensorboardX writer, or None when tensorboardX is not installed."""
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        return None
    return SummaryWriter(log_dir)


class Scalars:
    """Scalar logger over an optional writer."""

    def __init__(self, writer):
        self.writer = writer

    def __call__(self, tag: str, value: float, step: int):
        if self.writer is not None:
            self.writer.add_scalar(tag, value, step)

    def close(self):
        if self.writer is not None:
            self.writer.close()


def run_train_epoch(step_fn: Callable, host_batches: Iterable[Dict], *, device,
                    prefetch: int, lr_ctl, step: int, epoch: int,
                    log_interval: int, log: Callable[[str], None],
                    scalars: Scalars, profiler=None) -> Tuple[int, float]:
    """One epoch: ``step_fn(batch, lr) -> loss dict`` on each batch (its
    arrays already on ``device``), each step inside ``profiler``'s
    ``step_start`` / ``step_end`` (``utils/profiling.py::StepProfiler``),
    the end after the loss's host sync.  Returns ``(step, mean loss)``."""
    meter = AverageMeter()
    t0 = time.time()
    for i, batch in enumerate(prefetch_to_device(host_batches, device, prefetch)):
        lr = lr_ctl.lr_at(step)
        if profiler is not None:
            profiler.step_start(step)
        ld = step_fn(batch, lr)
        loss = float(ld["total_loss"])  # host sync
        if profiler is not None:
            profiler.step_end(step)
        step += 1
        meter.update(loss, batch["mixture"].shape[0])
        if i % log_interval == 0:
            scalars("train/loss_step", loss, step)
            scalars("train/lr", lr, step)
            scalars("train/grad_norm", float(ld["grad_norm"]), step)
            log(f"  epoch {epoch} step {step} loss {loss:.4f} lr {lr:.2e} "
                f"grad_norm {float(ld['grad_norm']):.3f} ({format_time(time.time() - t0)})")
    return step, meter.avg
