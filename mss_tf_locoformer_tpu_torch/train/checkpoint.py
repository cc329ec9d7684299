"""Checkpoints as ``.pth`` files (the JAX package's ``train/checkpoint.py``
keeps orbax directories; reading those is a later item, ROADMAP.md).

``checkpoint_epoch{NNNN}.pth`` holds ``model_state_dict`` (the reference's
key schema, which ``infer/separate.py::load_model`` and the separation CLI
load with ``strict=True``), ``optimizer_state_dict`` and ``metadata``
(epoch, step, losses, LR-controller and early-stop state).  The newest
``keep_last`` are kept; with ``save_best`` the best epoch is copied to
``best_model.pth``.  Files are written to a temporary name and renamed, so
a file is whole or absent.

In a parallel run every rank calls :meth:`CheckpointManager.save`: with a
model split over mp (``parallel/sharding.py``) the weights and the AdamW
moments of split parameters are gathered over the mp group first, and rank
0 writes the whole reference schema, which loads ``strict=True`` into a
one-device model; :meth:`CheckpointManager.restore` cuts them to this
rank's shards again.
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..parallel import multihost as MH
from ..parallel.sharding import (gather_optimizer_state, gather_over_mp, shard_optimizer_state,
                                 shard_state_dict)

__all__ = ["CheckpointManager"]

_NAME = re.compile(r"checkpoint_epoch(\d+)\.pth$")


class CheckpointManager:
    def __init__(self, directory: str, keep_last: int = 10, save_best: bool = True):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.keep_last = max(1, keep_last)
        self.save_best = save_best

    def path(self, epoch: int) -> str:
        return os.path.join(self.directory, f"checkpoint_epoch{epoch:04d}.pth")

    @property
    def best_path(self) -> str:
        return os.path.join(self.directory, "best_model.pth")

    def epochs(self) -> List[int]:
        return sorted(int(m.group(1)) for f in os.listdir(self.directory)
                      if (m := _NAME.match(f)))

    def latest_epoch(self) -> Optional[int]:
        e = self.epochs()
        return e[-1] if e else None

    def save(self, epoch: int, model: torch.nn.Module,
             optimizer: Optional[torch.optim.Optimizer], metadata: Dict[str, Any],
             is_best: bool = False, mesh=None, device="cpu") -> str:
        """Write an epoch (rank 0; every rank of a parallel run calls it)."""
        split = mesh is not None and mesh.mp > 1
        blob = {"model_state_dict": gather_over_mp(model.state_dict(), mesh, device),
                "epoch": epoch, "metadata": metadata}
        if optimizer is not None:
            blob["optimizer_state_dict"] = (
                gather_optimizer_state(optimizer, model, mesh, device) if split
                else optimizer.state_dict())
        path = self.path(epoch)
        if not MH.is_coordinator():
            return path
        tmp = path + ".tmp"
        torch.save(blob, tmp)
        os.replace(tmp, path)
        if is_best and self.save_best:
            shutil.copyfile(path, self.best_path + ".tmp")
            os.replace(self.best_path + ".tmp", self.best_path)
        for old in self.epochs()[:-self.keep_last]:
            os.remove(self.path(old))
        return path

    def restore(self, model: torch.nn.Module,
                optimizer: Optional[torch.optim.Optimizer] = None,
                epoch: Optional[int] = None, mesh=None) -> Tuple[Dict[str, Any], int]:
        """Load an epoch (default: the newest) into ``model`` and
        ``optimizer`` (cut to this rank's shards under an mp split); returns
        ``(metadata, epoch)``."""
        epoch = self.latest_epoch() if epoch is None else epoch
        if epoch is None:
            raise FileNotFoundError(f"No checkpoint in {self.directory}")
        blob = torch.load(self.path(epoch), map_location="cpu", weights_only=True)
        sd = blob["model_state_dict"]
        if mesh is not None and mesh.mp > 1:
            sd = shard_state_dict(sd, mesh.mp_index, mesh.mp)
        model.load_state_dict(sd, strict=True)
        if optimizer is not None and "optimizer_state_dict" in blob:
            optimizer.load_state_dict(
                shard_optimizer_state(blob["optimizer_state_dict"], model, mesh))
        return blob["metadata"], epoch
