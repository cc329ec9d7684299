"""Optimizer steps through the port's ``train/step.py::train_step``, as its
trainer takes them: the configuration's model (``training_model_config``)
at ``use_amp``'s precision, ``make_optimizer`` (AdamW), dropout seeds from
a CPU ``torch.Generator``, ``accumulation`` micro-batches a step, clipping
at ``gradient_clip``, the learning rate fixed at the optimizer's.

Traffic keys: ``use_amp``, ``batch_size``, ``accumulation``,
``segment_samples``, ``sample_rate``, ``pool`` (distinct batches made on
the device in set-up, cycled), ``checked_steps`` (the first steps, taken in
set-up through the window's own call on distinct batches, that the
reference follows), ``check_loss`` (optional: loss weights that replace
the configuration's in those steps), ``lookahead`` (steps dispatched ahead
of the device), ``traced_steps`` (steps the profiler sees after the
window).

``train_step_s`` is the window over the steps it completed: the window
starts after set-up and ends at a synchronise after the last step
dispatched before its end.  ``train_peak_gib``: the allocator's peak over
the window, after a reset at its start.

``correct``: the reference takes the same first steps from the same
weights, batches and dropout seeds.  The numbers: each step's loss
(``loss_gap``: the worst step's relative gap), and by the worst leaf
(``harness.leaf_gaps``) the norm of each leaf's first gradient as AdamW
got it, worked out from its first moment after one step (``grad_gap``),
and of each leaf's change over the checked steps (``change_gap``).  A cell
compares those its limits file names (``PERF.md`` says why).
"""

from __future__ import annotations

import gc
import time

from .. import harness, signals, trace as T
from ..yardstick import flops


def _batches(tr, seed: int, device):
    out = []
    for i in range(tr["pool"]):
        st = signals.stems(tr["batch_size"], tr["segment_samples"], tr["sample_rate"],
                           (seed * 1000 + 500 + i) % 2 ** 62, device)
        out.append((sum(st.values()), st))
    return out


class _Program:
    """The port's training step on one model and optimizer."""

    def __init__(self, cell, weights, gen_seed: int, device: str):
        import torch
        from mss_tf_locoformer_tpu_torch.core.config import config_from_dict
        from mss_tf_locoformer_tpu_torch.core.precision import precision_from_amp
        from mss_tf_locoformer_tpu_torch.models import build_model
        from mss_tf_locoformer_tpu_torch.train.loop import training_model_config
        from mss_tf_locoformer_tpu_torch.train.state import make_optimizer
        from mss_tf_locoformer_tpu_torch.train.step import train_step
        tr, cfg = cell.traffic, cell.config
        training = dict(cfg["training"], use_amp=tr["use_amp"],
                        gradient_accumulation_steps=tr["accumulation"])
        self.config = config_from_dict({"model": cfg["model"], "training": training,
                                        "loss": cfg.get("loss", {})})
        t = self.config.training
        with torch.device(device):
            self.model = build_model(training_model_config(self.config),
                                     precision_from_amp(t.use_amp, t.amp_dtype),
                                     torch.Generator(device=device).manual_seed(0))
        self.model.load_state_dict(weights, strict=True)
        self.model.train()
        self.optimizer = make_optimizer(self.model.parameters(), t)
        self.generator = torch.Generator().manual_seed(gen_seed)
        self.lr = t.optimizer.lr
        self._step = train_step
        self.check_loss = config_from_dict({"loss": check_loss(cfg, tr)}).loss

    def __call__(self, mixture, targets, loss=None):
        t = self.config.training
        return self._step(self.model, self.optimizer, mixture, targets, self.lr, self.generator,
                          loss or self.config.loss, t.gradient_accumulation_steps,
                          t.gradient_clip)

    def first_gradient(self):
        """Each leaf's gradient AdamW got in its first step (on the host),
        worked out from its first moment."""
        import torch
        beta1 = self.optimizer.param_groups[0]["betas"][0]
        out = {}
        for name, p in self.model.named_parameters():
            st = self.optimizer.state.get(p, {})
            g = st["exp_avg"] / (1 - beta1) if "exp_avg" in st else torch.zeros_like(p)
            out[name] = g.detach().float().cpu()
        return out

    def parameters(self):
        return dict(self.model.named_parameters())


def check_loss(cfg, tr) -> dict:
    """The loss of the checked steps: the configuration's, with the
    traffic's ``check_loss`` weights in place of its own."""
    return dict(cfg.get("loss", {}), **tr.get("check_loss", {}))


def _leaf_norms(grads):
    import torch
    return {k: float(torch.linalg.vector_norm(g)) for k, g in grads.items()}


def _flips(prog, ref, leaves):
    """Per leaf: its size, the share of elements whose first gradient has
    the other sign in the program than in the reference, and the median
    over those elements of the reference's magnitude over the leaf's RMS."""
    import torch
    out = []
    for k in leaves:
        p, r = prog[k].flatten(), ref[k].flatten().float().cpu()
        flip = torch.sign(p) != torch.sign(r)
        rms = r.pow(2).mean().sqrt().clamp_min(1e-30)
        mag = float((r[flip].abs() / rms).median()) if bool(flip.any()) else None
        out.append([k, r.numel(), float(flip.float().mean()), mag])
    return out


def _norms(params, start):
    import torch
    return {k: float(torch.linalg.vector_norm(params[k].detach() - start[k])) for k in start}


def _reference(R, ref_cfg, weights, gen_seed, batches, checked, lr):
    """The reference's losses, first gradient norms and change norms over
    the first ``checked`` steps."""
    import torch
    harness.set_tf32(False)
    ref = R.TrainReference(ref_cfg, weights, gen_seed)
    losses = []
    for i in range(checked):
        terms, grads = ref.step(*batches[i % len(batches)], lr)
        losses.append(terms)
        if i == 0:
            grad1 = {k: g.cpu() for k, g in grads.items()}
    return losses, grad1, _norms(ref.params, weights)


def _worst(gaps, prog, ref, n=3):
    top = sorted(gaps, key=lambda k: -gaps[k])[:n]
    return [[k, prog.get(k, 0.0), ref[k], gaps[k]] for k in top]


def run(cell, seed: int, seconds: float, trace: bool, t0: float, device: str = "cuda",
        control=None, cache=None) -> harness.Outcome:
    """One run of a training cell; ``control`` puts the reference at that
    precision in the program's place; ``cache`` (a dict) keeps the
    reference's readings by seed across runs in one process."""
    import torch
    tr, cfg = cell.traffic, cell.config
    m = cfg["model"]
    R = harness.reference_module(cell)
    cuda = device == "cuda"
    marks = {"start": time.perf_counter() - t0}
    if cuda:
        from mss_tf_locoformer_tpu_torch.ops import cuda as kernels
        kernels.build_all()
    marks["kernels"] = time.perf_counter() - t0
    harness.set_tf32(False)
    weights = R.make_weights(m, seed, device)
    batches = _batches(tr, seed, device)
    marks["inputs"] = time.perf_counter() - t0
    gen_seed = (seed * 7 + 3) % 2 ** 62
    training = dict(cfg["training"], gradient_accumulation_steps=tr["accumulation"])
    ref_cfg = dict(cfg, training=training, loss=check_loss(cfg, tr))
    lr = cfg["training"]["optimizer"]["lr"]
    checked = tr["checked_steps"]

    # set-up: the first steps, through the window's own call
    if control is None:
        prog = _Program(cell, weights, gen_seed, device)
        losses = []
        for i in range(checked):
            losses.append(prog(*batches[i % len(batches)], prog.check_loss))
            if i == 0:
                grad1 = prog.first_gradient()
        change = _norms(prog.parameters(), weights)
        losses = [{k: float(v) for k, v in terms.items()} for terms in losses]
    else:
        harness.set_tf32(control == "tf32")
        ctrl = R.TrainReference(ref_cfg, weights, gen_seed, harness.rounding(control))
        losses = []
        for i in range(checked):
            terms, grads = ctrl.step(*batches[i % len(batches)], lr)
            losses.append(terms)
            if i == 0:
                grad1 = {k: g.float().cpu() for k, g in grads.items()}
        change = _norms(ctrl.params, weights)
        del ctrl
        harness.set_tf32(False)

    n_steps, window, peak, fwd_ms, step_ms, summary, t_trace = 0, 0.0, 0, None, None, None, 0.0
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    setup_s = None
    if control is None:
        hooks = _Hooks(prog.model, trace and cuda)
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        start = time.perf_counter()
        setup_s = start - t0
        ends = []
        while time.perf_counter() < start + seconds:
            hooks.begin_step()
            prog(*batches[(checked + n_steps) % len(batches)])
            hooks.end_step()
            if cuda:
                ev = torch.cuda.Event()
                ev.record()
                ends.append(ev)
                if len(ends) > tr["lookahead"]:
                    ends[-1 - tr["lookahead"]].synchronize()
            n_steps += 1
        if cuda:
            torch.cuda.synchronize()
        window = time.perf_counter() - start
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        fwd_ms, step_ms = hooks.per_step()
        hooks.remove()
        t_trace = time.perf_counter()
        if trace and cuda:
            def tail():
                for j in range(tr["traced_steps"]):
                    with torch.profiler.record_function("bench.step"):
                        prog(*batches[(checked + n_steps + j) % len(batches)])
            hooks = _Hooks(prog.model, False, spans=True)
            summary = T.traced(tail, {"bench.forward": "train step: model forward",
                                      "bench.step": "train step: loss, backward, clip, AdamW"})
            hooks.remove()
        t_trace = time.perf_counter() - t_trace
        del prog, hooks
    memory_peak = max(setup_peak, peak)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # the reference's steps, once the program's state is freed
    t_ref = time.perf_counter()
    key = (cell.name, seed)
    if cache is not None and key in cache:
        ref_losses, ref_grad1, ref_change = cache[key]
    else:
        ref_losses, ref_grad1, ref_change = _reference(R, ref_cfg, weights, gen_seed, batches,
                                                       checked, lr)
        if cache is not None:
            cache[key] = (ref_losses, ref_grad1, ref_change)
    t_done = time.perf_counter()
    grad1_t, ref_grad1_t = grad1, ref_grad1
    grad1, ref_grad1 = _leaf_norms(grad1_t), _leaf_norms(ref_grad1_t)
    skip = harness.still_leaves(ref_grad1)
    grad_gaps = harness.leaf_gaps(grad1, ref_grad1, skip)
    change_gaps = harness.leaf_gaps(change, ref_change, skip)
    gaps = [abs(a["total_loss"] - b["total_loss"]) / abs(b["total_loss"])
            for a, b in zip(losses, ref_losses)]
    checks = {"loss_gap": max(gaps), "grad_gap": max(grad_gaps.values()),
              "change_gap": max(change_gaps.values())}
    detail = {"setup_marks": marks,
              "seconds": {"setup": setup_s, "window": window, "trace": t_trace,
                          "reference": t_done - t_ref},
              "losses": [[t["total_loss"] for t in losses], [t["total_loss"] for t in ref_losses]],
              "left_out": sorted(skip),
              "worst_grad": _worst(grad_gaps, grad1, ref_grad1),
              "worst_change": _worst(change_gaps, change, ref_change),
              "flips": _flips(grad1_t, ref_grad1_t,
                              sorted(change_gaps, key=lambda k: -change_gaps[k])[:3]
                              + sorted(grad_gaps, key=lambda k: -grad_gaps[k])[:1]),
              "flips_all": float(sum(float((g.sign() != ref_grad1_t[k].float().sign()).sum())
                                     for k, g in grad1_t.items())
                                 / sum(g.numel() for g in grad1_t.values())),
              "leaves": {k: [grad1.get(k, 0.0), ref_grad1[k], change.get(k, 0.0), ref_change[k]]
                         for k in ref_grad1}}
    gib = 2 ** 30
    ctx = _Ctx(m=m, batch=tr["batch_size"], samples=tr["segment_samples"], n_steps=n_steps,
               window_s=window, forward_ms=fwd_ms, step_ms=step_ms, trace=summary,
               traced_steps=tr["traced_steps"], accum=tr["accumulation"],
               precision="bf16" if tr["use_amp"] else "fp32", device=device)
    e2e = {}
    if n_steps:
        e2e = {"train_step_s": window / n_steps, "train_peak_gib": peak / gib, "setup_s": setup_s}
    return harness.Outcome(e2e=e2e, checks=checks, attempted=n_steps,
                           memory_peak=memory_peak, ctx=ctx, trace=summary, detail=detail)


class _Hooks:
    """Forward hooks on the model: CUDA events around each forward (with
    ``events``) and the ``bench.forward`` profiler span (with ``spans``)."""

    def __init__(self, model, events: bool, spans: bool = False):
        import torch
        self.events, self.spans = events, spans
        self.steps = []            # [(start, end, [(fwd start, fwd end)])]
        self._open = None
        self._range = None
        self.handles = []
        if events or spans:
            self.handles = [model.register_forward_pre_hook(self._pre),
                            model.register_forward_hook(self._post)]
        self._torch = torch

    def _event(self):
        ev = self._torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def _pre(self, module, args):
        if self.spans:
            self._range = self._torch.profiler.record_function("bench.forward")
            self._range.__enter__()
        if self.events:
            self._open = self._event()

    def _post(self, module, args, out):
        if self.events:
            self.steps[-1][2].append((self._open, self._event()))
        if self.spans:
            self._range.__exit__(None, None, None)

    def begin_step(self):
        if self.events:
            self.steps.append([self._event(), None, []])

    def end_step(self):
        if self.events:
            self.steps[-1][1] = self._event()

    def per_step(self):
        """Mean device ms of a step's forwards, and of the whole step."""
        if not self.steps:
            return None, None
        fwd = [sum(a.elapsed_time(b) for a, b in s[2]) for s in self.steps]
        whole = [s[0].elapsed_time(s[1]) for s in self.steps]
        return sum(fwd) / len(fwd), sum(whole) / len(whole)

    def remove(self):
        for h in self.handles:
            h.remove()


class _Ctx:
    """What the training cells' per-layer readers read."""

    kind = "train"

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def step_flops(self) -> float:
        return flops.train_step_flops(self.m, self.batch, self.samples)
