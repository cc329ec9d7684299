"""Multi-process runs on ``torch.distributed`` (the JAX package's
``parallel/multihost.py``): one process per GPU.

The JAX package runs one process per host over a global device mesh; the
port runs one process per card, started by ``torchrun`` (which sets
``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``
and ``LOCAL_WORLD_SIZE``) or by the JAX CLI's explicit flags
(``--coordinator_address host:port --num_processes N --process_id I``).

* :func:`initialize` starts the process group (idempotent) and returns this
  rank's device.  The backend is NCCL for CUDA ranks that each have a card
  of their own, gloo for CPU ranks and for ranks that share one card
  (NCCL refuses two ranks on one GPU).  Over gloo, all-reduce and broadcast
  take CUDA tensors; every other collective of the port (gathers of
  checkpoints and metrics) goes through host tensors (:func:`comm_device`).
* :func:`process_count`, :func:`process_index`, :func:`is_coordinator`.
* :func:`local_batch_size` and :func:`shard_indices`: the JAX functions'
  equal shares (tails dropped: unequal counts would desynchronise the
  per-step collectives).
* :func:`broadcast_from_coordinator` (a picklable object) and
  :func:`replicate` (rank 0's parameters and buffers into every rank's
  module, in place).

With no process group everything is the single-process path: one process,
rank 0, nothing communicated.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

__all__ = ["initialize", "process_count", "process_index", "is_coordinator",
           "local_batch_size", "shard_indices", "broadcast_from_coordinator",
           "replicate", "comm_device", "barrier", "rank_device"]


def rank_device(device, local_rank: int, local_world: int) -> Tuple[torch.device, str]:
    """``(device, backend)`` of a rank: ``cuda`` without an index gives each
    rank of a host the card of its local rank when there are cards enough,
    and NCCL; ranks that share a card (an explicit ``cuda:N``, or more
    ranks than cards) take gloo, and so do CPU ranks."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev, "gloo"
    n = torch.cuda.device_count()
    if local_world == 1:
        return (dev if dev.index is not None else torch.device("cuda", 0)), "nccl"
    if dev.index is None and local_world <= n:
        return torch.device("cuda", local_rank), "nccl"
    return torch.device("cuda", dev.index if dev.index is not None else local_rank % n), "gloo"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device="cuda",
               timeout: float = 1800.0) -> torch.device:
    """Start the process group (nothing if one is up) and return this rank's
    device.  Explicit arguments (the JAX CLI's flags, all on one host unless
    ``LOCAL_RANK``/``LOCAL_WORLD_SIZE`` say otherwise), or else the
    ``torchrun`` environment.  ``timeout`` (seconds) bounds every
    collective, the rendezvous included."""
    env = os.environ
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("--coordinator_address needs --num_processes and --process_id")
        world, rank = int(num_processes), int(process_id)
        init_method = f"tcp://{coordinator_address}"
    else:
        if "WORLD_SIZE" not in env or "RANK" not in env:
            raise RuntimeError("--distributed without --coordinator_address needs the "
                               "torchrun environment (WORLD_SIZE, RANK, MASTER_ADDR, "
                               "MASTER_PORT)")
        world, rank = int(env["WORLD_SIZE"]), int(env["RANK"])
        init_method = "env://"
    local_rank = int(env.get("LOCAL_RANK", rank))
    local_world = int(env.get("LOCAL_WORLD_SIZE", world))
    dev, backend = rank_device(device, local_rank, local_world)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device}: CUDA is not available")
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method, world_size=world,
                                rank=rank, timeout=datetime.timedelta(seconds=timeout))
    return dev


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_coordinator() -> bool:
    return process_index() == 0


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def comm_device(device) -> torch.device:
    """Where tensors of the port's gathers live: the rank's card under NCCL,
    the host under gloo."""
    dev = torch.device(device)
    if dist.is_initialized() and dist.get_backend() == "nccl" and dev.type == "cuda":
        return dev
    return torch.device("cpu")


def local_batch_size(global_batch: int, n: Optional[int] = None) -> int:
    """Per-rank share of a global batch over ``n`` ranks (default every
    rank; the trainer passes the mesh's dp): it must divide evenly."""
    n = process_count() if n is None else n
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by {n} processes")
    return global_batch // n


def shard_indices(n: int, rank: Optional[int] = None,
                  world: Optional[int] = None) -> Tuple[int, int, int]:
    """Equal-count round-robin shard of ``range(n)``: ``(rank, rank + world *
    (n // world), world)``, the tail ``n % world`` items dropped."""
    rank = process_index() if rank is None else rank
    world = process_count() if world is None else world
    count = n // world
    return rank, rank + world * count, world


def broadcast_from_coordinator(obj):
    """Rank 0's ``obj`` (picklable) on every rank; the object itself with
    one process."""
    if process_count() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


@torch.no_grad()
def replicate(module: torch.nn.Module) -> torch.nn.Module:
    """Rank 0's parameters and buffers into every rank's ``module`` (in
    place, on the module's device)."""
    if process_count() > 1:
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=0)
    return module
