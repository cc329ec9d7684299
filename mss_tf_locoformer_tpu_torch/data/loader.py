"""Host-side loading (the JAX package's ``data/loader.py``): a threaded
``DataLoader`` with the same batches -- order shuffled by
``numpy.random.default_rng(seed + epoch)``, ``drop_last``, a bounded number
of batches in flight -- and ``prefetch_to_device``, which keeps batches
copied ahead on the card from pinned host buffers (``non_blocking`` copies
on a side stream, so the copy of batch i+1 overlaps the step on batch i).
``shard=(rank, world)`` takes an equal-count round-robin share of the
indices after a shuffle that every rank draws alike, so the shards are
disjoint and every rank runs the same number of batches (the JAX loader's
``shard``).
"""

from __future__ import annotations

import collections
import contextlib
import queue
import threading
from typing import Any, Callable, Dict, Iterator, Optional, Sequence

import numpy as np
import torch

from .musdb import collate_fn

__all__ = ["DataLoader", "prefetch_to_device"]


class DataLoader:
    """Iterates ``dataset`` by index and collates into batches; with
    ``num_workers > 0``, worker threads load batches ahead, at most
    ``num_workers * prefetch_factor`` of them."""

    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False,
                 num_workers: int = 0, collate: Callable = collate_fn,
                 prefetch_factor: int = 2, drop_last: bool = False,
                 seed: int = 0, shard: Optional[Sequence[int]] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(0, num_workers)
        self.collate = collate
        self.prefetch_factor = max(1, prefetch_factor)
        self.drop_last = drop_last
        self._epoch = 0
        self._seed = seed
        self.shard = tuple(shard) if shard else None
        if self.shard and not 0 <= self.shard[0] < self.shard[1]:
            raise ValueError(f"bad shard {shard}")

    def _local_count(self) -> int:
        n = len(self.dataset)
        return n // self.shard[1] if self.shard else n

    def __len__(self) -> int:
        n = self._local_count()
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _index_batches(self):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.default_rng(self._seed + self._epoch).shuffle(order)
        if self.shard:
            rank, world = self.shard
            order = order[rank::world][:n // world]
            n = order.shape[0]
        batches = [order[i:i + self.batch_size] for i in range(0, n, self.batch_size)]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        return batches

    def _load(self, idxs):
        return self.collate([self.dataset[int(i)] for i in idxs])

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        self._epoch += 1
        batches = self._index_batches()
        if self.num_workers == 0:
            for idxs in batches:
                yield self._load(idxs)
            return
        yield from self._threaded(batches)

    def _threaded(self, batches):
        """Workers take batch indices from a queue and put finished batches
        into slots; the consumer yields them in order.  A semaphore bounds
        the batches loaded but not yet consumed."""
        todo: "queue.Queue" = queue.Queue()
        for item in enumerate(batches):
            todo.put(item)
        done: Dict[int, Any] = {}
        cond = threading.Condition()
        slots = threading.Semaphore(self.num_workers * self.prefetch_factor)
        stop = threading.Event()

        def worker():
            while not stop.is_set():
                if not slots.acquire(timeout=0.1):
                    continue
                try:
                    bi, idxs = todo.get_nowait()
                except queue.Empty:
                    slots.release()
                    return
                try:
                    batch = self._load(idxs)
                except Exception as exc:  # raised again on the consumer's side
                    batch = exc
                with cond:
                    done[bi] = batch
                    cond.notify_all()

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()
        try:
            for bi in range(len(batches)):
                with cond:
                    while bi not in done:
                        if not any(t.is_alive() for t in threads):
                            raise RuntimeError("DataLoader workers exited early")
                        cond.wait(timeout=0.1)
                    batch = done.pop(bi)
                slots.release()
                if isinstance(batch, Exception):
                    raise batch
                yield batch
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=5.0)


def _to_device(batch, device, stream):
    out = {}
    with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
        for k, v in batch.items():
            if isinstance(v, np.ndarray):
                t = torch.from_numpy(v)
                if stream is not None:
                    t = t.pin_memory()
                out[k] = t.to(device, non_blocking=stream is not None)
            else:
                out[k] = v
    return out


def prefetch_to_device(batches, device, size: int = 2):
    """Yield the dicts of ``batches`` with their arrays on ``device``,
    keeping ``size`` batches copied ahead.  On a CUDA device the copies go
    from pinned host memory on a side stream; the consumer's stream waits
    for a batch's copy before the batch is handed out."""
    device = torch.device(device)
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None
    buf = collections.deque()
    it = iter(batches)

    def put():
        try:
            batch = next(it)
        except StopIteration:
            return
        moved = _to_device(batch, device, stream)
        event = None
        if stream is not None:
            event = torch.cuda.Event()
            event.record(stream)
        buf.append((moved, event))

    for _ in range(max(1, size)):
        put()
    while buf:
        moved, event = buf.popleft()
        if event is not None:
            torch.cuda.current_stream(device).wait_event(event)
            for v in moved.values():
                if isinstance(v, torch.Tensor):
                    v.record_stream(torch.cuda.current_stream(device))
        put()
        yield moved
