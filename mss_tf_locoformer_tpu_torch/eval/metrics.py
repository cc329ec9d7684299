"""Separation metrics on the host with numpy (the JAX package's
``eval/metrics.py``, copied: importing it would import JAX).

SI-SDR, SDR, SAR and SIR per stem and their mean over stems (``average``).
As in the reference and the JAX package, SAR and SIR are projection-residual
ratios against the single target, so both equal SI-SDR; the true BSS Eval
decomposition is ``eval/bss_eval.py``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np

__all__ = ["compute_si_sdr", "compute_sdr", "compute_sar", "compute_sir",
           "evaluate_source_separation", "print_metrics"]


def _flat(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float64).reshape(-1)


def compute_si_sdr(estimate, target, eps: float = 1e-8) -> float:
    e, t = _flat(estimate), _flat(target)
    e = e - e.mean()
    t = t - t.mean()
    scale = np.dot(e, t) / (np.dot(t, t) + eps)
    s_target = scale * t
    noise = e - s_target
    return float(10.0 * np.log10((np.dot(s_target, s_target) + eps)
                                 / (np.dot(noise, noise) + eps)))


def compute_sdr(estimate, target, eps: float = 1e-8) -> float:
    e, t = _flat(estimate), _flat(target)
    noise = e - t
    return float(10.0 * np.log10((np.dot(t, t) + eps) / (np.dot(noise, noise) + eps)))


def compute_sar(estimate, target, eps: float = 1e-8) -> float:
    """The reference's SAR: the single-target projection ratio, = SI-SDR."""
    return compute_si_sdr(estimate, target, eps)


def compute_sir(estimate, target, eps: float = 1e-8) -> float:
    """The reference's SIR: the single-target projection ratio, = SI-SDR."""
    return compute_si_sdr(estimate, target, eps)


_METRIC_FNS = {"si_sdr": compute_si_sdr, "sdr": compute_sdr,
               "sar": compute_sar, "sir": compute_sir}


def evaluate_source_separation(
    predictions: Mapping[str, np.ndarray],
    targets: Mapping[str, np.ndarray],
    metrics=("si_sdr", "sdr", "sar", "sir"),
) -> Dict[str, Dict[str, float]]:
    """Per-stem metric dicts for the stems that have a target, and their
    mean as ``average``."""
    out: Dict[str, Dict[str, float]] = {}
    for name, pred in predictions.items():
        if name not in targets:
            continue
        out[name] = {m: _METRIC_FNS[m](pred, targets[name]) for m in metrics}
    if out:
        out["average"] = {m: float(np.mean([v[m] for k, v in out.items()
                                            if k != "average"]))
                          for m in metrics}
    return out


def print_metrics(results: Mapping[str, Mapping[str, float]]) -> None:
    metrics = None
    for stem, vals in results.items():
        if metrics is None:
            metrics = list(vals)
            header = "stem".ljust(10) + "".join(m.rjust(10) for m in metrics)
            print(header)
            print("-" * len(header))
        print(stem.ljust(10) + "".join(f"{vals[m]:10.2f}" for m in metrics))
