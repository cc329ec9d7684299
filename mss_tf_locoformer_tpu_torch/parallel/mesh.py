"""The ``dp x mp`` grid of ranks (the JAX package's ``parallel/mesh.py``).

The JAX package lays its devices out as a ``Mesh`` with ``dp`` (data
parallel: batch rows, OLA chunks) and ``mp`` (model parallel: heads and
inner channels) axes.  The port lays its ranks out the same way: rank
``dp_index * mp + mp_index`` (the JAX ``devices.reshape(dp, mp)``), with a
process group per axis: the ``mp`` group of a rank holds the ranks of its
row (the shards of one replica), the ``dp`` group those of its column (the
replicas of one shard).

:func:`activate_mesh` is the scope that the tensor-parallel dispatch of
``nn/attention.py`` and ``nn/ffn.py`` and the train step read
(:func:`active_mesh`), as the JAX ``activate_mesh`` sets the Pallas gate
(``ops/pallas/__init__.py:46-88``); outside it, or with a one-rank mesh,
everything is the single-process path.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.distributed as dist

from . import multihost as MH

__all__ = ["Mesh", "make_mesh", "local_mesh", "activate_mesh", "active_mesh",
           "tp_mesh", "shard_batch", "all_reduce"]


@dataclass(frozen=True)
class Mesh:
    dp: int
    mp: int
    dp_index: int = 0
    mp_index: int = 0
    dp_group: Any = None   # this rank's column: the replicas of its shard
    mp_group: Any = None   # this rank's row: the shards of its replica

    @property
    def shard_index(self) -> int:
        """The linear index ``dp_index * mp + mp_index`` (this rank's rank)."""
        return self.dp_index * self.mp + self.mp_index


def make_mesh(dp: int = -1, mp: int = 1) -> Mesh:
    """The grid over every rank (``dp`` -1: the ranks over ``mp``); a grid
    that does not cover the world raises.  Every rank must call it (the
    groups are made collectively)."""
    world, rank = MH.process_count(), MH.process_index()
    mp = max(1, mp)
    if dp <= 0:
        dp = world // mp
    if dp * mp != world:
        raise ValueError(f"mesh {dp}x{mp} != {world} processes")
    dp_index, mp_index = divmod(rank, mp)
    if world == 1:
        return Mesh(1, 1)
    dp_group = mp_group = None
    for i in range(dp):   # rows: the mp groups
        g = dist.new_group([i * mp + j for j in range(mp)])
        if i == dp_index:
            mp_group = g
    for j in range(mp):   # columns: the dp groups
        g = dist.new_group([i * mp + j for i in range(dp)])
        if j == mp_index:
            dp_group = g
    return Mesh(dp, mp, dp_index, mp_index, dp_group, mp_group)


def local_mesh() -> Mesh:
    """Every rank on the dp axis (one process: the trivial 1 x 1 mesh)."""
    return make_mesh()


_ACTIVE: Optional[Mesh] = None


@contextlib.contextmanager
def activate_mesh(mesh: Optional[Mesh]):
    """Make ``mesh`` the one the dispatch reads in this scope (None: the
    single-process path); the previous one comes back on exit."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, mesh
    try:
        yield mesh
    finally:
        _ACTIVE = prev


def active_mesh() -> Optional[Mesh]:
    """The active mesh, or None when it is absent or one rank."""
    return _ACTIVE if _ACTIVE is not None and _ACTIVE.dp * _ACTIVE.mp > 1 else None


def tp_mesh() -> Optional[Mesh]:
    """The active mesh when it splits the model (``mp > 1``), else None."""
    m = active_mesh()
    return m if m is not None and m.mp > 1 else None


def shard_batch(mesh: Mesh, tree):
    """The rows of a global batch (a tensor, an array or a dict of them,
    leading axis) that belong to this rank's ``dp_index``; mp peers get the
    same rows."""
    if isinstance(tree, dict):
        return {k: shard_batch(mesh, v) for k, v in tree.items()}
    n = tree.shape[0]
    if n % mesh.dp:
        raise ValueError(f"batch of {n} rows does not divide over dp={mesh.dp}")
    per = n // mesh.dp
    return tree[mesh.dp_index * per:(mesh.dp_index + 1) * per]


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` in place over ``group`` (nothing without a group)."""
    if group is not None:
        dist.all_reduce(t, group=group)
    return t
