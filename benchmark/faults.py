"""Faults planted in the port underneath a run, to see the comparison that
decides ``correct`` fail: each ``plant(patch)`` calls ``patch(owner, name,
value)`` (pytest's ``monkeypatch.setattr``, or ``patched``'s patcher) to
break the timed path where it computes.

Separation: ``stale`` (each model call returns the previous call's stems,
its state unchanged), ``half_batch`` (the model computes half of the
chunks and repeats them), ``swapped`` (two stems exchanged where they are
produced), ``flat_window`` (the engine crossfades with a flat window: its
overlaps become plain means).  Training: ``unchanged`` (AdamW's step leaves the parameters
and its state as they were), ``half_loss`` (the loss is the mean over half
of each micro-batch), ``swapped``.  One chip, so no exchange between chips
can be left out.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch


def _model_cls():
    from mss_tf_locoformer_tpu_torch.models.mss_tflocoformer import TFLocoformerMSS
    return TFLocoformerMSS


def stale(patch):
    cls, last = _model_cls(), {}
    orig = cls.forward

    def forward(self, x, *a, **k):
        fresh = orig(self, x, *a, **k)
        out = last.get("out") or fresh
        last["out"] = {n: v.detach().clone() for n, v in fresh.items()}
        return out
    patch(cls, "forward", forward)


def half_batch(patch):
    cls = _model_cls()
    orig = cls.forward

    def forward(self, x, *a, **k):
        h = max(1, x.shape[0] // 2)
        out = orig(self, x[:h], *a, **k)
        return {n: torch.cat([v] * 2)[:x.shape[0]] for n, v in out.items()}
    patch(cls, "forward", forward)


def swapped(patch):
    cls = _model_cls()
    orig = cls.forward

    def forward(self, x, *a, **k):
        out = dict(orig(self, x, *a, **k))
        out["vocals"], out["drums"] = out["drums"], out["vocals"]
        return out
    patch(cls, "forward", forward)


def flat_window(patch):
    from mss_tf_locoformer_tpu_torch.infer import overlap_add
    patch(overlap_add, "triangular_window", lambda length, overlap: np.ones(length, np.float32))


def unchanged(patch):
    patch(torch.optim.AdamW, "step", lambda self, closure=None: None)


def half_loss(patch):
    from mss_tf_locoformer_tpu_torch.train import step as S
    orig = S.mss_loss

    def loss(pred, tgt, cfg):
        h = max(1, next(iter(tgt.values())).shape[0] // 2)
        return orig({k: v[:h] for k, v in pred.items()}, {k: v[:h] for k, v in tgt.items()}, cfg)
    patch(S, "mss_loss", loss)


SEPARATION = {"stale": stale, "half_batch": half_batch, "swapped": swapped,
              "flat_window": flat_window}
TRAINING = {"unchanged": unchanged, "half_loss": half_loss, "swapped": swapped}


@contextlib.contextmanager
def patched(plant):
    """Plant a fault for the ``with`` body, and take it out after."""
    saved = []

    def patch(owner, name, value):
        saved.append((owner, name, owner.__dict__[name]))
        setattr(owner, name, value)
    plant(patch)
    try:
        yield
    finally:
        for owner, name, value in reversed(saved):
            setattr(owner, name, value)
