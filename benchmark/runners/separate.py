"""Songs separated back to back through the port's chunked overlap-add
engine (``infer/separate.py::make_engine``, ``SeparationEngine.__call__`` on
``model_input(model, audio)``), as its separation CLI runs them, without
WAV I/O.

Traffic keys: ``precision`` (bf16 | fp32), ``sample_rate``,
``chunk_seconds``, ``overlap_seconds``, ``batch_size`` (chunks per engine
batch), ``chunks_per_song`` (the songs' chunk counts, cycled), ``songs``
(the pool made in set-up), ``warmup_batches``, ``checked_batches`` (engine
batches of the window compared with the reference, drawn from the seed),
``checked_songs`` (0 or 1: whether a song finished in the window, drawn
from the seed, has its overlap-add checked), ``traced_batches`` (batches
the profiler sees after the window).

A song of n chunks is between ``chunk + (n - 2) hop`` and ``chunk + (n - 1)
hop`` samples long, its length within that range and its content drawn
from the seed; the pool's chunk counts are the same for every seed, in an
order the seed draws, so that every seed asks for the same work.

The window starts after set-up and runs songs from the pool in turn.  The
engine's model call is wrapped: once the window has closed the next call
raises, which cuts the song in flight at its next batch.  ``separate_rtf``
is the new audio (a hop per chunk) of the batches finished in the window
over the time from the window's start to the end of the last one.

``correct``, after the window: the model, by ``stem_rel_l2``, the worst
stem's relative L2 error of each checked batch's chunks against the
reference's, which cuts the chunks again from the song; the engine, by
``engine_rel_l2``, the worst stem's relative L2 error of the stems the
engine returned for the checked song against the reference's overlap-add
of the model outputs the engine was handed for it.  A cell compares the
numbers its limits file names.
"""

from __future__ import annotations

import gc
import math
import random
import time

import numpy as np

from .. import harness, signals, trace as T
from ..yardstick import flops


class WindowClosed(Exception):
    pass


class Apply:
    """The ``apply_fn`` the engine calls: the model, timed, with a sample
    of its outputs kept."""

    def __init__(self, model, device, keep: int, seed: int, events: bool, songs: bool):
        self.model, self.device = model, device
        self.keep, self.rng = keep, random.Random(seed)
        self.events, self.songs = events, songs
        self.deadline = None       # while recording: the window's end
        self.budget = None         # calls left before the next one raises
        self.batches = []          # (song occurrence, batch in song, valid chunks, t_in, t_out)
        self.kept = []             # (occurrence, batch, valid, {stem: tensor})
        self.song_out = []         # with ``songs``: the song's (valid, {stem: tensor}) so far
        self.forward = []          # (start event, end event)
        self.song = None

    def begin(self, occurrence: int, n_chunks: int, batch_size: int):
        self.song = (occurrence, n_chunks, batch_size, [0])
        self.song_out = []

    def _sync(self):
        if self.device == "cuda":
            import torch
            torch.cuda.synchronize()

    def __call__(self, x):
        import torch
        if self.deadline is not None and time.perf_counter() >= self.deadline:
            raise WindowClosed
        if self.budget is not None:
            if self.budget <= 0:
                raise WindowClosed
            self.budget -= 1
        occ, n_chunks, bs, count = self.song
        b = count[0]
        count[0] += 1
        valid = min(bs, n_chunks - b * bs)
        t_in = time.perf_counter()
        with torch.profiler.record_function("bench.model_call"):
            if self.events:
                ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                ev[0].record()
            out = self.model(x)
            if self.events:
                ev[1].record()
                self.forward.append(ev)
            self._sync()
        t_out = time.perf_counter()
        if self.deadline is not None:
            i = len(self.batches)
            self.batches.append((occ, b, valid, t_in, t_out))
            entry = (occ, b, valid, out)
            if i < self.keep:
                self.kept.append(entry)
            else:
                j = self.rng.randrange(i + 1)
                if j < self.keep:
                    self.kept[j] = entry
            if self.songs:
                self.song_out.append((valid, out))
        return out


def n_chunks(t: int, chunk: int, hop: int) -> int:
    return 1 + math.ceil((t - chunk) / hop)


def chunk_starts(t: int, chunk: int, hop: int) -> np.ndarray:
    return np.arange(n_chunks(t, chunk, hop)) * hop


def window_fn(chunk: int, overlap: int) -> np.ndarray:
    """The flat-top crossfade: linear ramps of ``overlap`` samples."""
    w = np.ones(chunk, np.float64)
    if overlap:
        ramp = (np.arange(overlap) + 1.0) / (overlap + 1.0)
        w[:overlap], w[-overlap:] = ramp, ramp[::-1]
    return w


def overlap_add(outputs, n_samples: int, chunk: int, hop: int) -> dict:
    """The song's stems from its chunks' outputs ``[(valid, {stem: [B,
    W]})]`` in order: the crossfaded sum over the normalised envelope, in
    float64."""
    starts = chunk_starts(n_samples, chunk, hop)
    total = starts[-1] + chunk
    win = window_fn(chunk, chunk - hop)
    env = np.zeros(total)
    for s in starts:
        env[s:s + chunk] += win
    acc, j = {}, 0
    for valid, out in outputs:
        for k, v in out.items():
            a = acc.setdefault(k, np.zeros(total))
            for i in range(valid):
                a[starts[j + i]:starts[j + i] + chunk] += v[i] * win
        j += valid
    if j != len(starts):
        raise ValueError(f"{j} chunk outputs for a song of {len(starts)} chunks")
    return {k: (a / env)[:n_samples] for k, a in acc.items()}


def run(cell, seed: int, seconds: float, trace: bool, t0: float, device: str = "cuda",
        control=None) -> harness.Outcome:
    """One run of a serving cell; ``control`` puts the reference at that
    precision in the program's place."""
    import torch
    from mss_tf_locoformer_tpu_torch.core.config import model_config_from_dict
    from mss_tf_locoformer_tpu_torch.core.precision import precision_from_name
    from mss_tf_locoformer_tpu_torch.infer.separate import make_engine, model_input
    from mss_tf_locoformer_tpu_torch.models import build_model

    tr, m = cell.traffic, cell.config["model"]
    R = harness.reference_module(cell)
    sr = tr["sample_rate"]
    chunk = int(tr["chunk_seconds"] * sr)
    overlap = int(tr["overlap_seconds"] * sr)
    hop = chunk - overlap
    bs = tr["batch_size"]
    cuda = device == "cuda"
    marks = {"start": time.perf_counter() - t0}
    if cuda:
        from mss_tf_locoformer_tpu_torch.ops import cuda as kernels
        kernels.build_all()
    marks["kernels"] = time.perf_counter() - t0

    # set-up: weights, model, the pool of songs, warm-up
    harness.set_tf32(False)
    weights = R.make_weights(m, seed, device)
    rng = random.Random(seed)
    counts = [tr["chunks_per_song"][i % len(tr["chunks_per_song"])] for i in range(tr["songs"])]
    rng.shuffle(counts)
    lengths = [chunk + (n - 1) * hop - rng.randrange(hop) for n in counts]
    pool = [signals.song(t, sr, (seed * 1000 + i) % 2 ** 62, device).cpu().numpy()
            for i, t in enumerate(lengths)]
    marks["inputs"] = time.perf_counter() - t0
    if control is None:
        with torch.device(device):
            model = build_model(model_config_from_dict(m), precision_from_name(tr["precision"]),
                                torch.Generator(device=device).manual_seed(0))
        model.load_state_dict(weights, strict=True)
        model.eval()
        mono = lambda audio: model_input(model, audio)
    else:
        harness.set_tf32(control == "tf32")
        ref = R.Reference(m, weights, harness.rounding(control))
        model = lambda x: ref(x)
        mono = lambda audio: audio.mean(axis=0)
    checked_songs = tr.get("checked_songs", 0)
    apply = Apply(model, device, tr["checked_batches"], seed, trace and cuda, checked_songs > 0)
    engine = make_engine(apply, tr["chunk_seconds"], tr["overlap_seconds"], sr, bs, device)
    warm = np.zeros(chunk + (tr["warmup_batches"] * bs - 1) * hop, np.float32)
    apply.begin(-1, n_chunks(len(warm), chunk, hop), bs)
    engine(warm)
    apply.forward.clear()

    # the window
    song_rng = random.Random(seed + 1)
    checked_song, finished = None, 0     # (occurrence, model outputs, engine's stems)
    start = time.perf_counter()
    setup_s = start - t0
    apply.deadline = start + seconds
    occ = 0
    while True:
        audio = pool[occ % len(pool)]
        apply.begin(occ, n_chunks(audio.shape[-1], chunk, hop), bs)
        try:
            stems = engine(mono(audio))
        except WindowClosed:
            break
        finished += 1
        if checked_songs and song_rng.randrange(finished) == 0:
            checked_song = (occ, apply.song_out, stems)
        occ += 1
    apply.deadline = None
    t_last = apply.batches[-1][4]
    window = t_last - start
    audio_s = sum(b[2] for b in apply.batches) * hop / sr
    in_model = sum(b[4] - b[3] for b in apply.batches)
    n_batches = len(apply.batches)
    forward_ms = None
    if apply.forward:
        forward_ms = sum(a.elapsed_time(b) for a, b in apply.forward) / len(apply.forward)

    summary, traced = None, 0
    t_trace = time.perf_counter()
    if trace and cuda:
        apply.budget = tr["traced_batches"]
        summary = T.traced(lambda: _tail(engine, apply, pool[occ % len(pool)], chunk, hop, bs, mono),
                           {"bench.model_call": "model call: host dispatch and wait",
                            "bench.song": "engine host work: chunking, copies, overlap-add"})
        traced = tr["traced_batches"] - apply.budget
    t_trace = time.perf_counter() - t_trace
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0

    # the comparison, once the program's state is freed
    host = lambda out, v: {k: t[:v].float().cpu().numpy() for k, t in out.items()}
    kept = [(o, b, v, host(out, v)) for o, b, v, out in apply.kept]
    checks = {}
    if checked_song is not None:
        o, outs, stems = checked_song
        rebuilt = overlap_add([(v, host(out, v)) for v, out in outs],
                              pool[o % len(pool)].shape[-1], chunk, hop)
        checks["engine_rel_l2"] = max(harness.rel_l2(stems[k], rebuilt[k]) for k in rebuilt)
    del model, engine, apply, checked_song
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    harness.set_tf32(False)
    reference = R.Reference(m, weights)
    batch_gap = 0.0
    with torch.no_grad():
        for o, b, valid, out in kept:
            song = pool[o % len(pool)].mean(axis=0)
            t = song.shape[-1]
            starts = chunk_starts(t, chunk, hop)[b * bs:b * bs + valid]
            padded = np.pad(song, (0, max(0, starts[-1] + chunk - t)))
            x = torch.from_numpy(np.stack([padded[s:s + chunk] for s in starts])).to(device)
            ref = reference(x)
            for k, v in out.items():
                batch_gap = max(batch_gap, harness.rel_l2(v, ref[k].cpu().numpy()))
    if kept:
        checks["stem_rel_l2"] = batch_gap
    detail = {"setup_marks": marks,
              "seconds": {"setup": setup_s, "window": window, "trace": t_trace,
                          "reference": time.perf_counter() - t_ref},
              "checked": [[o, b, v] for o, b, v, _ in kept], "songs_finished": finished}
    ctx = _Ctx(m=m, bs=bs, chunk=chunk, n_batches=n_batches, window_s=window,
               host_ms=1e3 * (window - in_model) / max(1, n_batches), forward_ms=forward_ms,
               trace=summary, traced_batches=traced, precision=tr["precision"],
               device=device)
    return harness.Outcome(
        e2e={"separate_rtf": audio_s / window, "setup_s": setup_s}, checks=checks,
        attempted=n_batches, memory_peak=memory_peak, ctx=ctx, trace=summary, detail=detail)


def _tail(engine, apply, audio, chunk, hop, bs, mono):
    """The song after the window's last, until ``apply``'s budget runs out."""
    import torch
    apply.begin(-2, n_chunks(audio.shape[-1], chunk, hop), bs)
    with torch.profiler.record_function("bench.song"):
        try:
            engine(mono(audio))
        except WindowClosed:
            pass


class _Ctx:
    """What the serving cells' per-layer readers read."""

    kind = "separate"

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def forward_flops(self) -> float:
        return flops.forward_flops(self.m, self.bs, self.chunk)
