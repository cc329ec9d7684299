"""End-to-end trainer (the JAX package's ``train/loop.py``).

Kept from the JAX trainer: the channel layout of mixture and targets fixed
once (``_prep``): the channel mean for a mono model, both channels
``[B, 2, T]`` for a stereo BS-Locoformer (mono tracks duplicated); random
training chunks through the threaded loader with device prefetch; AdamW
with warmup x ReduceLROnPlateau on the validation loss; fixed-length chunked
validation (every test track cut into segments, the last zero-padded and
weighted by its valid fraction, scored in groups of ``val_batch_size``); a
checkpoint every ``save_interval`` epochs and on a new best; early
stopping; ``--resume`` from the newest checkpoint.  The speech trainer
(``train/speech.py``) is a subclass with its own model, data, step and
validation.

The device is the caller's (``device`` is required; nothing moves to the
CPU on its own).  Dropout seeds come from a ``torch.Generator`` seeded with
``seed + 1`` (the JAX trainer's ``PRNGKey(seed + 1)``); initial weights from
one seeded with ``seed``.  Importing ``core.precision`` turns TF32 off, so
the fp32 encoder and decoder convolutions run in full fp32 on the card.
``gradient_checkpointing`` turns on the model's per-block remat
(``remat_blocks``), as the JAX trainer maps it.

Parallel runs (one process per GPU under ``torch.distributed``,
``parallel/``): ``config.mesh`` lays the ranks out as ``dp x mp``
(``dp`` -1: the ranks over ``mp``; a grid that does not cover them, or a
batch that does not divide over dp, raises).  Rank 0's initial weights are
broadcast to every rank, then each rank keeps its mp shard.  The training
loader takes this rank's dp share of the indices (mp peers load the same
rows; chunk and augmentation draws seeded ``seed + 7919 * dp_index``, as
the JAX trainer seeds by process index), each step averages the gradients
over dp (``train/step.py``), validation scores every dp-th track and sums
its meters over dp, only rank 0 logs, and checkpoints keep the reference
schema (``train/checkpoint.py``).  ``profile_steps`` traces the steps
``[profile_start_step, profile_start_step + profile_steps)`` with
``torch.profiler`` (``utils/profiling.py``; the coordinator only) and logs
the step-time statistics.  Orbax checkpoints are not read (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..core.config import Config
from ..core.precision import precision_from_amp
from ..data.loader import DataLoader
from ..data.musdb import MUSDBDataset
from ..models import build_model
from ..parallel import mesh as M
from ..parallel import multihost as MH
from ..parallel.sharding import shard_module, validate_tp
from ..utils.common import AverageMeter, count_parameters, format_time, set_seed
from ..utils.profiling import StepProfiler
from .checkpoint import CheckpointManager
from .engine import Scalars, make_writer, run_train_epoch
from .schedule import EarlyStopping
from .state import LRController, make_optimizer
from .step import eval_step, train_step

__all__ = ["Trainer", "training_model_config"]


def training_model_config(config: Config):
    """The model section a training run builds: ``gradient_checkpointing``
    turns on ``remat_blocks`` (the JAX trainer's mapping)."""
    if config.training.gradient_checkpointing and not config.model.remat_blocks:
        return dataclasses.replace(config.model, remat_blocks=True)
    return config.model


def _mono(x: np.ndarray) -> np.ndarray:
    """[B, C, T] -> [B, T] channel mean."""
    return x.mean(axis=1) if x.ndim == 3 else x


def _stereo(x: np.ndarray) -> np.ndarray:
    """[B, (C,) T] -> [B, 2, T], the stereo BS-Locoformer's input; mono tracks
    are duplicated."""
    if x.ndim == 2:
        x = x[:, None]
    if x.shape[1] == 1:
        x = np.repeat(x, 2, axis=1)
    if x.shape[1] != 2:
        raise ValueError(f"stereo model expects <=2 channels, got {x.shape}")
    return x


class Trainer:
    def __init__(self, config: Config, device, output_dir: Optional[str] = None,
                 resume: Optional[str] = None, verbose: bool = True):
        self.config = config
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {device}: CUDA is not available")
        self.mesh = M.make_mesh(*config.mesh.axis_sizes(MH.process_count()))
        if config.training.batch_size % self.mesh.dp:
            raise ValueError(f"batch_size {config.training.batch_size} does not divide "
                             f"over dp={self.mesh.dp}")
        self.verbose = verbose and MH.is_coordinator()
        set_seed(config.seed)
        self.output_dir = output_dir or config.paths.output_dir
        self.log_dir = os.path.join(self.output_dir, "logs")
        os.makedirs(self.log_dir, exist_ok=True)

        tcfg = config.training
        self.precision = precision_from_amp(tcfg.use_amp, tcfg.amp_dtype)
        self.model = MH.replicate(self._build_model().to(self.device))
        # a stereo BS-Locoformer keeps both channels; every other model
        # takes the channel mean
        self._prep = _stereo if getattr(self.model.config, "stereo", False) else _mono
        n_params = count_parameters(self.model)
        validate_tp(self.model.config, self.mesh.mp)
        shard_module(self.model, self.mesh)
        self.optimizer = make_optimizer(self.model.parameters(), tcfg)
        self.lr_ctl = LRController(tcfg)
        self.early_stop = EarlyStopping(tcfg.early_stopping)
        self.ckpt = CheckpointManager(os.path.join(self.output_dir, "checkpoints"),
                                      keep_last=tcfg.keep_last, save_best=tcfg.save_best)
        self.scalars = Scalars(make_writer(self.log_dir) if MH.is_coordinator() else None)
        # a torch.profiler trace of steps [profile_start_step, + profile_steps),
        # from the coordinator only
        self.profiler = StepProfiler(
            self.log_dir, n_steps=tcfg.profile_steps if MH.is_coordinator() else 0,
            start_step=tcfg.profile_start_step)
        self.generator = torch.Generator().manual_seed(config.seed + 1)
        self.step = 0
        self.start_epoch = 0
        self.best_val_loss = float("inf")
        self._resume = resume
        backend = dist.get_backend() if dist.is_initialized() else "no process group"
        self._log(f"Device: {self.device}  {MH.process_count()} ranks over {backend}, "
                  f"mesh dp={self.mesh.dp} mp={self.mesh.mp}  "
                  f"precision={self.precision.compute_dtype}  parameters {n_params / 1e6:.2f} M")

    def _log(self, msg: str):
        if self.verbose:
            print(msg, flush=True)

    def _build_model(self) -> torch.nn.Module:
        return build_model(training_model_config(self.config), self.precision,
                           torch.Generator().manual_seed(self.config.seed))

    def _loaders(self):
        """``(train loader, validation loader or None)`` from the config's
        dataset."""
        tcfg = self.config.training
        train_ds, val_ds = self._datasets()
        dp = self.mesh.dp
        train = DataLoader(train_ds, batch_size=MH.local_batch_size(tcfg.batch_size, dp),
                           shuffle=True, num_workers=tcfg.num_workers,
                           prefetch_factor=tcfg.prefetch_factor, seed=self.config.seed,
                           drop_last=dp > 1,
                           shard=(self.mesh.dp_index, dp) if dp > 1 else None)
        val = None if val_ds is None else DataLoader(
            val_ds, batch_size=1, shuffle=False, num_workers=min(2, tcfg.num_workers))
        return train, val

    def _datasets(self):
        d = self.config.dataset
        common = dict(sample_rate=d.sample_rate, sources=list(d.sources),
                      min_loudness=d.min_loudness, rebuild_mixture=d.rebuild_mixture,
                      metadata_cache=d.cache_dir or True, verbose=self.verbose)
        train = MUSDBDataset(d.root_dir, "train", segment_length=d.segment_length,
                             augmentation=d.augmentation, random_chunks=d.random_chunks,
                             max_chunk_attempts=d.max_chunk_attempts,
                             precompute_chunks=d.precompute_chunks,
                             seed=self._data_seed(), **common)
        val = MUSDBDataset(d.root_dir, "test", segment_length=None, **common)
        return train, val

    def _data_seed(self) -> int:
        """The training data's seed: draws decorrelated across dp ranks."""
        return self.config.seed + 7919 * self.mesh.dp_index

    def _val_shard(self, loader):
        """The validation batches of this rank's dp index (every dp-th one;
        mp peers score the same ones)."""
        for i, batch in enumerate(loader):
            if i % self.mesh.dp == self.mesh.dp_index:
                yield batch

    def _merge(self, meter: AverageMeter) -> float:
        """The meter's weighted mean over the dp ranks' shards."""
        if self.mesh.dp == 1:
            return meter.avg
        t = torch.tensor([meter.sum, meter.count], dtype=torch.float64,
                         device=MH.comm_device(self.device))
        M.all_reduce(t, self.mesh.dp_group)
        return float(t[0] / max(float(t[1]), 1e-12))

    def _host_batches(self, loader):
        sources = self.config.dataset.sources
        for batch in loader:
            yield {"mixture": self._prep(np.asarray(batch["mixture"])),
                   **{k: self._prep(np.asarray(batch[k])) for k in sources if k in batch}}

    def _train_step(self, batch: Dict[str, torch.Tensor], lr: float):
        b = dict(batch)
        mixture = b.pop("mixture")
        tcfg = self.config.training
        return train_step(self.model, self.optimizer, mixture, b, lr, self.generator,
                          self.config.loss, tcfg.gradient_accumulation_steps,
                          tcfg.gradient_clip)

    def validate(self, loader) -> float:
        with M.activate_mesh(self.mesh):
            return self._validate(loader)

    def _validate(self, loader) -> float:
        """Weighted mean validation loss over fixed-length chunks."""
        tcfg, d = self.config.training, self.config.dataset
        seg = tcfg.val_segment_length or d.segment_length or 10 * d.sample_rate
        group = max(1, tcfg.val_batch_size)
        meter = AverageMeter()
        mix, tgt, wts = [], [], []

        def flush():
            if not mix:
                return
            to = lambda xs: torch.from_numpy(np.stack(xs)).to(self.device)
            ld = eval_step(self.model, to(mix),
                           {k: to([t[k] for t in tgt]) for k in tgt[0]},
                           self.config.loss,
                           weights=torch.tensor(wts, device=self.device))
            meter.update(float(ld["total_loss"]), sum(wts))
            mix.clear()
            tgt.clear()
            wts.clear()

        def pad(x):
            return np.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, seg - x.shape[-1])])

        for batch in self._val_shard(loader):
            mixture = self._prep(np.asarray(batch["mixture"]))
            targets = {k: self._prep(np.asarray(batch[k])) for k in d.sources if k in batch}
            n_chunks = max(1, -(-mixture.shape[-1] // seg))
            for b in range(mixture.shape[0]):
                for c in range(n_chunks):
                    sl = slice(c * seg, (c + 1) * seg)
                    m = mixture[b][..., sl]
                    mix.append(pad(m))
                    tgt.append({k: pad(v[b][..., sl]) for k, v in targets.items()})
                    wts.append(m.shape[-1] / seg)
                    if len(mix) == group:
                        flush()
        flush()
        return self._merge(meter)

    def fit(self, train_loader=None, val_loader=None) -> int:
        """Train to ``num_epochs`` (or an early stop); returns the step count."""
        with M.activate_mesh(self.mesh):
            return self._fit(train_loader, val_loader)

    def _fit(self, train_loader=None, val_loader=None) -> int:
        tcfg = self.config.training
        if train_loader is None:
            train_loader, val_loader = self._loaders()
        if self._resume:
            meta, epoch = self._restore()
            self.start_epoch = epoch + 1
            self.step = meta["step"]
            self.best_val_loss = meta.get("best_val_loss", float("inf"))
            self.lr_ctl.load_state_dict(meta["lr_controller"])
            self.early_stop.load_state_dict(meta["early_stop"])
            self._log(f"Resumed from epoch {epoch} (step {self.step})")

        for epoch in range(self.start_epoch, tcfg.num_epochs):
            t0 = time.time()
            self.step, train_loss = run_train_epoch(
                self._train_step, self._host_batches(train_loader), device=self.device,
                prefetch=tcfg.prefetch_factor, lr_ctl=self.lr_ctl, step=self.step,
                epoch=epoch, log_interval=tcfg.log_interval, log=self._log,
                scalars=self.scalars, profiler=self.profiler)
            self.scalars("train/loss_epoch", train_loss, epoch)
            msg = f"epoch {epoch}: train {train_loss:.4f} ({format_time(time.time() - t0)})"
            val_loss = None
            if val_loader is not None and (epoch + 1) % tcfg.val_interval == 0:
                val_loss = self.validate(val_loader)
                self.scalars("val/loss", val_loss, epoch)
                self.lr_ctl.on_validation(val_loss)
                msg += f" val {val_loss:.4f}"
            self._log(msg)
            is_best = val_loss is not None and val_loss < self.best_val_loss
            if is_best:
                self.best_val_loss = val_loss
            if (epoch + 1) % tcfg.save_interval == 0 or is_best:
                self.ckpt.save(epoch, self.model,
                               self.optimizer if tcfg.save_optimizer else None, {
                                   "epoch": epoch, "step": self.step,
                                   "train_loss": train_loss, "val_loss": val_loss,
                                   "best_val_loss": self.best_val_loss,
                                   "lr_controller": self.lr_ctl.state_dict(),
                                   "early_stop": self.early_stop.state_dict()},
                               is_best=is_best, mesh=self.mesh, device=self.device)
            if val_loss is not None and self.early_stop.step(val_loss):
                self._log(f"Early stopping at epoch {epoch}")
                break
        self.profiler.close()
        stats = self.profiler.stats()
        if stats:
            self._log("step time: " + "  ".join(f"{k}={v:.4g}" for k, v in stats.items()))
        if self.profiler.trace_path:
            self._log(f"profile trace: {self.profiler.trace_path}")
        self.scalars.close()
        return self.step

    def _restore(self):
        """``--resume``: a checkpoint directory (its newest epoch), or any
        other value for this trainer's own newest checkpoint."""
        mgr = self.ckpt
        if os.path.isdir(str(self._resume)):
            mgr = CheckpointManager(self._resume, self.ckpt.keep_last, self.ckpt.save_best)
        return mgr.restore(self.model, self.optimizer, mesh=self.mesh)
