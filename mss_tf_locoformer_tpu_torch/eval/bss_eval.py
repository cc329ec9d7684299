"""BSS Eval v3 source-separation metrics on the host with numpy (the JAX
package's ``eval/bss_eval.py``, copied: importing it would import JAX).

Each estimate is decomposed against time-invariant ``filter_len``-tap
filtered versions of all references (Vincent et al., IEEE TASLP 2006):

    s_target = P_{ref_j} e        (projection onto lags of the true source)
    e_interf = P_{all refs} e - s_target
    e_artif  = e - P_{all refs} e

    SDR = 10 log10 |s_target|^2 / |e_interf + e_artif|^2
    SIR = 10 log10 |s_target|^2 / |e_interf|^2
    SAR = 10 log10 |s_target + e_interf|^2 / |e_artif|^2

The projections solve one block-Toeplitz least-squares system per estimate,
built from FFT cross-correlations; energies are taken over the full filtered
support ``t + filter_len - 1`` (the mir_eval convention).  Stems keep their
fixed order (no permutation search).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np

__all__ = ["bss_eval_sources", "bss_eval_stems"]


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def _correlations(refs: np.ndarray, est: np.ndarray, flen: int
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """G [S*L, S*L] Gram of lagged references; D [S*L] ref-estimate corr."""
    s, t = refs.shape
    n_fft = _next_pow2(t + flen - 1)
    rf = np.fft.rfft(refs, n_fft, axis=1)           # [S, F]
    ef = np.fft.rfft(est, n_fft)

    g = np.zeros((s * flen, s * flen))
    idx = np.arange(flen)
    lag = idx[:, None] - idx[None, :]
    for i in range(s):
        for j in range(i, s):
            # r_ij[tau] = sum_t refs_i[t] refs_j[t + tau]
            r = np.fft.irfft(np.conj(rf[i]) * rf[j], n_fft)
            # block[a, b] = corr(shift_a(s_i), shift_b(s_j)) = r_ij[a - b]
            block = r[lag % n_fft]
            g[i * flen:(i + 1) * flen, j * flen:(j + 1) * flen] = block
            if j > i:
                g[j * flen:(j + 1) * flen, i * flen:(i + 1) * flen] = block.T

    d = np.zeros(s * flen)
    for i in range(s):
        c = np.fft.irfft(np.conj(rf[i]) * ef, n_fft)
        d[i * flen:(i + 1) * flen] = c[:flen]
    return g, d


def _project(refs: np.ndarray, coefs: np.ndarray, flen: int, t_out: int
             ) -> np.ndarray:
    """Apply per-source FIR filters (coefs [S, L]) and sum."""
    s, t = refs.shape
    n_fft = _next_pow2(t + flen - 1)
    rf = np.fft.rfft(refs, n_fft, axis=1)
    cf = np.fft.rfft(coefs, n_fft, axis=1)
    y = np.fft.irfft((rf * cf).sum(axis=0), n_fft)
    return y[:t_out]


def bss_eval_sources(estimates: np.ndarray, references: np.ndarray,
                     filter_len: int = 512, eps: float = 1e-12
                     ) -> Dict[str, np.ndarray]:
    """estimates/references ``[S, T]`` (fixed stem order) -> per-source
    arrays ``{"sdr", "sir", "sar"}``."""
    est = np.asarray(estimates, np.float64)
    ref = np.asarray(references, np.float64)
    if est.shape != ref.shape or est.ndim != 2:
        raise ValueError(f"estimates {est.shape} and references {ref.shape} must "
                         f"both be [S, T]")
    s, t = ref.shape
    flen = int(filter_len)

    sdr = np.zeros(s)
    sir = np.zeros(s)
    sar = np.zeros(s)
    t_full = t + flen - 1
    for i in range(s):
        g, d = _correlations(ref, est[i], flen)
        # regularised solves: a silent stem makes G singular
        reg = eps * np.trace(g) / max(g.shape[0], 1) + eps
        coefs_all = np.linalg.solve(g + reg * np.eye(g.shape[0]), d).reshape(s, flen)
        p_all = _project(ref, coefs_all, flen, t_full)

        gi = g[i * flen:(i + 1) * flen, i * flen:(i + 1) * flen]
        di = d[i * flen:(i + 1) * flen]
        regi = eps * np.trace(gi) / flen + eps
        coef_i = np.linalg.solve(gi + regi * np.eye(flen), di)
        s_target = _project(ref[i:i + 1], coef_i[None], flen, t_full)

        est_full = np.concatenate([est[i], np.zeros(flen - 1)])
        e_interf = p_all - s_target
        e_artif = est_full - p_all

        def db(num, den):
            return 10.0 * np.log10((num + eps) / (den + eps))

        sdr[i] = db(np.sum(s_target ** 2), np.sum((e_interf + e_artif) ** 2))
        sir[i] = db(np.sum(s_target ** 2), np.sum(e_interf ** 2))
        sar[i] = db(np.sum((s_target + e_interf) ** 2), np.sum(e_artif ** 2))
    return {"sdr": sdr, "sir": sir, "sar": sar}


def bss_eval_stems(predictions: Mapping[str, np.ndarray],
                   targets: Mapping[str, np.ndarray],
                   stems: Optional[Sequence[str]] = None,
                   filter_len: int = 512) -> Dict[str, Dict[str, float]]:
    """Stem dicts in, ``evaluate_source_separation``'s layout out (per-stem
    dicts and ``average``); multichannel stems are flattened."""
    names = [k for k in (stems or predictions) if k in targets]
    est = np.stack([np.asarray(predictions[k], np.float64).reshape(-1) for k in names])
    ref = np.stack([np.asarray(targets[k], np.float64).reshape(-1) for k in names])
    r = bss_eval_sources(est, ref, filter_len)
    out = {name: {"sdr": float(r["sdr"][i]), "sir": float(r["sir"][i]),
                  "sar": float(r["sar"][i])}
           for i, name in enumerate(names)}
    out["average"] = {m: float(np.mean([out[n][m] for n in names]))
                      for m in ("sdr", "sir", "sar")}
    return out
