"""Chunked overlap-add separation (the JAX package's ``infer/overlap_add.py``).

Mono ``[T]`` or multichannel ``[C, T]`` audio (the stereo BS-Locoformer)
is cut along its last axis into fixed-size chunks, batched to a static batch
size (the last batch padded with zero chunks), and recombined by a triangular crossfade whose envelope is
normalised, so interior and edge samples are both exact.  The overlap-add
runs in float64 on the host.

The loop is synchronous: each batch is copied to the device (from pinned
memory, without blocking, when the device is CUDA), separated under
``torch.inference_mode``, and copied back before the next batch starts.  A
bounded queue of batches in flight is a later item (ROADMAP.md).

Chunk-parallel separation (the JAX engine's ``sharding``,
``infer/overlap_add.py:47-48``): with a ``mesh`` (``parallel/mesh.py``)
every rank of a dp group separates the same audio, each the batches of its
dp index (every dp-th), overlap-adds them into a zero buffer, and one
all-reduce over the dp group sums the buffers; an ``mp > 1`` model serves
through its tensor-parallel steps, its mp peers on the same batches.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..parallel import mesh as M
from ..parallel.multihost import comm_device

__all__ = ["SeparationEngine", "triangular_window"]


def triangular_window(length: int, overlap: int) -> np.ndarray:
    """Flat-top window with linear ramps of ``overlap`` samples on each side."""
    w = np.ones(length, dtype=np.float32)
    if overlap > 0:
        ramp = (np.arange(overlap, dtype=np.float32) + 1.0) / (overlap + 1.0)
        w[:overlap] = ramp
        w[-overlap:] = ramp[::-1]
    return w


class SeparationEngine:
    """Batched chunked-OLA separation around a spectral-mapping model.

    Args:
        apply_fn: ``(mixture [B, (C,) W] on device) -> {stem: [B, (C,) W]}``.
        chunk_samples: chunk length W.
        overlap: overlap samples between consecutive chunks (default W/4).
        batch_size: chunks per forward.
        device: where ``apply_fn`` runs: the card unless the caller asks
            for the CPU; never guessed from what is available.
        mesh: optional ``parallel.mesh.Mesh`` to split the chunk batches
            over its dp ranks (every rank of its dp group calls the engine
            on the same audio).
    """

    def __init__(self, apply_fn: Callable, chunk_samples: int,
                 overlap: Optional[int] = None, batch_size: int = 4,
                 device="cuda", mesh=None):
        self.chunk = int(chunk_samples)
        self.overlap = int(overlap) if overlap is not None else self.chunk // 4
        if not 0 <= self.overlap < self.chunk:
            raise ValueError(f"overlap {self.overlap} must be in [0, {self.chunk})")
        self.hop = self.chunk - self.overlap
        self.batch_size = int(batch_size)
        self.device = torch.device(device)
        self._apply = apply_fn
        self._window = triangular_window(self.chunk, self.overlap)
        self.mesh = mesh

    def __call__(self, audio: np.ndarray) -> Dict[str, np.ndarray]:
        """``audio [T]`` (mono) or ``[C, T]`` (stereo models) -> dict of stems
        of the same layout; chunks and the overlap-add run over the last axis."""
        audio = np.asarray(audio, dtype=np.float32)
        if audio.ndim not in (1, 2):
            raise ValueError(f"expected [T] or [C, T] audio, got {audio.shape}")
        t = audio.shape[-1]
        lead = audio.shape[:-1]

        def pad_tail(x, n):
            return np.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, n)])

        if t <= self.chunk:
            out = self._forward(pad_tail(audio, self.chunk - t)[None])
            return {k: v[0, ..., :t] for k, v in out.items()}

        n_chunks = 1 + math.ceil((t - self.chunk) / self.hop)
        total = (n_chunks - 1) * self.hop + self.chunk
        padded = pad_tail(audio, total - t)
        starts = np.arange(n_chunks) * self.hop
        chunks = np.stack([padded[..., s:s + self.chunk] for s in starts])  # [N, (C,) W]
        n_batches = -(-n_chunks // self.batch_size)
        pad_chunks = n_batches * self.batch_size - n_chunks
        if pad_chunks:
            chunks = np.concatenate(
                [chunks, np.zeros((pad_chunks, *lead, self.chunk), np.float32)])

        dp = self.mesh.dp if self.mesh is not None else 1
        mine = range(self.mesh.dp_index if dp > 1 else 0, n_batches, dp)
        window = self._window
        acc: Dict[str, np.ndarray] = {}
        for b in mine:
            out = self._forward(chunks[b * self.batch_size:(b + 1) * self.batch_size])
            for k, v in out.items():
                a = acc.setdefault(k, np.zeros((*lead, total), dtype=np.float64))
                for j in range(min(self.batch_size, n_chunks - b * self.batch_size)):
                    s = starts[b * self.batch_size + j]
                    a[..., s:s + self.chunk] += v[j] * window
        if dp > 1:
            if not acc:   # no batch of this rank's: the stems' names from batch 0
                acc = {k: np.zeros((*lead, total), dtype=np.float64)
                       for k in self._forward(chunks[:self.batch_size])}
            keys = sorted(acc)
            buf = torch.from_numpy(np.stack([acc[k] for k in keys])).to(comm_device(self.device))
            M.all_reduce(buf, self.mesh.dp_group)
            acc = dict(zip(keys, buf.cpu().numpy()))

        envelope = np.zeros(total, dtype=np.float64)
        for s in starts:
            envelope[s:s + self.chunk] += window
        return {k: (a / np.maximum(envelope, 1e-8)).astype(np.float32)[..., :t]
                for k, a in acc.items()}

    def _forward(self, block: np.ndarray) -> Dict[str, np.ndarray]:
        x = torch.from_numpy(np.ascontiguousarray(block, dtype=np.float32))
        if self.device.type == "cuda":
            x = x.pin_memory().to(self.device, non_blocking=True)
        else:
            x = x.to(self.device)
        with torch.inference_mode(), M.activate_mesh(self.mesh):
            out = self._apply(x)
            return {k: v.to(torch.float32).cpu().numpy() for k, v in out.items()}
