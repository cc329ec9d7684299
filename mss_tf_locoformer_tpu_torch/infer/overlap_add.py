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
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import numpy as np
import torch

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
    """

    def __init__(self, apply_fn: Callable, chunk_samples: int,
                 overlap: Optional[int] = None, batch_size: int = 4,
                 device="cuda"):
        self.chunk = int(chunk_samples)
        self.overlap = int(overlap) if overlap is not None else self.chunk // 4
        if not 0 <= self.overlap < self.chunk:
            raise ValueError(f"overlap {self.overlap} must be in [0, {self.chunk})")
        self.hop = self.chunk - self.overlap
        self.batch_size = int(batch_size)
        self.device = torch.device(device)
        self._apply = apply_fn
        self._window = triangular_window(self.chunk, self.overlap)

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

        stem_chunks: Dict[str, list] = {}
        for b in range(n_batches):
            out = self._forward(chunks[b * self.batch_size:(b + 1) * self.batch_size])
            for k, v in out.items():
                stem_chunks.setdefault(k, []).append(v)

        window = self._window
        envelope = np.zeros(total, dtype=np.float64)
        for s in starts:
            envelope[s:s + self.chunk] += window
        results: Dict[str, np.ndarray] = {}
        for k, blocks in stem_chunks.items():
            flat = np.concatenate(blocks)[:n_chunks]                     # [N, (C,) W]
            acc = np.zeros((*flat.shape[1:-1], total), dtype=np.float64)
            for i, s in enumerate(starts):
                acc[..., s:s + self.chunk] += flat[i] * window
            results[k] = (acc / np.maximum(envelope, 1e-8)).astype(np.float32)[..., :t]
        return results

    def _forward(self, block: np.ndarray) -> Dict[str, np.ndarray]:
        x = torch.from_numpy(np.ascontiguousarray(block, dtype=np.float32))
        if self.device.type == "cuda":
            x = x.pin_memory().to(self.device, non_blocking=True)
        else:
            x = x.to(self.device)
        with torch.inference_mode():
            out = self._apply(x)
            return {k: v.to(torch.float32).cpu().numpy() for k, v in out.items()}
