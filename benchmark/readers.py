"""What the per-layer metrics read, shared by their reader files in
``metrics/``: each serving cell reports its own end-to-end rate and each
training precision its own step time, so each quantity has a metric per
end-to-end metric, read alike."""

import torch

from benchmark.yardstick import peaks, work


def _serving(ctx) -> bool:
    return getattr(ctx, "kind", None) == "separate"


def engine_host_ms(ctx):
    """Host milliseconds per engine batch inside ``SeparationEngine.__call__``
    outside the model call (chunking, pinned copy in, copy out, float64
    overlap-add), over the window: the window less the model calls, which
    end in a synchronise, over the batches."""
    if not _serving(ctx) or not ctx.n_batches:
        return None
    return ctx.host_ms


def forward_ms(ctx):
    """Device milliseconds of one engine-batch forward, by CUDA events
    around each model call in the window, averaged."""
    if not _serving(ctx):
        return None
    return ctx.forward_ms


def mfu(ctx):
    """Share of the card's dense bf16 peak: the frozen FLOP count of every
    engine batch finished in the window, over the window's seconds."""
    if not _serving(ctx) or ctx.device != "cuda" or not ctx.n_batches:
        return None
    card = peaks.peaks(torch.cuda.get_device_name(0))
    if card is None:
        return None
    return 100.0 * ctx.n_batches * ctx.forward_flops() / ctx.window_s / card[0]


def kernel_roofline(ctx):
    """The traced batches' least device time, op by op
    (``yardstick/work.py``: the larger of FLOP at the dense bf16 peak and
    bytes at the memory rate), over the summed device time of every kernel
    the profiler saw in the traced span."""
    if not _serving(ctx) or ctx.trace is None or not ctx.traced_batches:
        return None
    card = peaks.peaks(torch.cuda.get_device_name(0))
    if card is None or not ctx.trace.kernel_s:
        return None
    ops = work.forward_ops(ctx.m, ctx.bs, ctx.chunk, 2 if ctx.precision == "bf16" else 4)
    return 100.0 * ctx.traced_batches * work.least_seconds(ops, *card) / ctx.trace.kernel_s


def device_idle(ctx):
    """Share of the traced span in which no kernel, copy or memset ran on
    the device (the union of the profiler's device intervals), in a fresh
    traced process."""
    if not _serving(ctx) or ctx.trace is None or not ctx.trace.window_s:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)


def _training(ctx) -> bool:
    return getattr(ctx, "kind", None) == "train"


def train_forward_ms(ctx):
    """Device milliseconds of the model forwards of one optimizer step (its
    micro-batches summed), by CUDA events from forward hooks on the model,
    over the window's steps."""
    if not _training(ctx):
        return None
    return ctx.forward_ms


def train_backward_ms(ctx):
    """Device milliseconds of the rest of an optimizer step (losses,
    backward, accumulation, clipping, AdamW): the step's CUDA-event span
    less its forwards, over the window's steps."""
    if not _training(ctx) or ctx.step_ms is None:
        return None
    return ctx.step_ms - ctx.forward_ms


def train_mfu(ctx):
    """Share of the card's dense bf16 peak: the frozen FLOP count (3 x the
    forward) of every optimizer step in the window, over the window's
    seconds."""
    if not _training(ctx) or ctx.device != "cuda" or not ctx.n_steps:
        return None
    card = peaks.peaks(torch.cuda.get_device_name(0))
    if card is None:
        return None
    return 100.0 * ctx.n_steps * ctx.step_flops() / ctx.window_s / card[0]


def train_kernel_roofline(ctx):
    """The traced optimizer steps' least device time, op by op
    (``yardstick/work.py``: forward and backward of each micro-batch, the
    larger of FLOP at the dense bf16 peak and bytes at the memory rate),
    over the summed device time of every kernel the profiler saw in the
    traced span (losses, clipping and AdamW included)."""
    if not _training(ctx) or ctx.trace is None or not ctx.traced_steps:
        return None
    card = peaks.peaks(torch.cuda.get_device_name(0))
    if card is None or not ctx.trace.kernel_s:
        return None
    row = 2 if ctx.precision == "bf16" else 4
    micro = ctx.batch // ctx.accum
    ops = (work.forward_ops(ctx.m, micro, ctx.samples, row)
           + work.backward_ops(ctx.m, micro, ctx.samples, row))
    least = ctx.traced_steps * ctx.accum * work.least_seconds(ops, *card)
    return 100.0 * least / ctx.trace.kernel_s


def train_device_idle(ctx):
    """Share of the traced span in which no kernel, copy or memset ran on
    the device, in a fresh traced process."""
    if not _training(ctx) or ctx.trace is None or not ctx.trace.window_s:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
