"""Analytic FLOP count of TF-Locoformer MSS, for ``mfu.*``.

A frozen copy of the port's ``utils/flops.py`` (``tflocoformer_forward_flops``,
``train_step_flops``), reading a configuration file's ``model`` section:
every multiply-add of the architecture counted as 2 FLOP (QKV and
out-projections, scores and the value product, the conv-SwiGLU-deconv FFNs,
the encoder and decoder convolutions) plus 2.5 N log2 N per real FFT frame;
elementwise work is left out.  A training step counts 3 x the forward.
"""

from __future__ import annotations

import math


def n_frames(samples: int, hop: int) -> int:
    """Frames of a centred STFT."""
    return 1 + samples // hop


def rfft_flops(n_fft: int) -> float:
    return 2.5 * n_fft * math.log2(n_fft)


def _inner(m):
    hidden = m["ffn_hidden_dim"]
    return tuple(hidden) if isinstance(hidden, (list, tuple)) else (hidden,)


def block_flops(m, rows: int, seq: int) -> float:
    """One Locoformer block on ``[rows, seq, C]``: macaron FFNs and MHSA."""
    d, a, k = m["emb_dim"], m["attention_dim"], m["conv1d_kernel"]
    tokens = rows * seq
    ffn = sum(2.0 * tokens * 3 * i * d * k for i in _inner(m))
    proj = 2.0 * tokens * 4 * a * d
    attn = 2.0 * (2.0 * rows * seq * seq * a)
    return ffn + proj + attn


def forward_flops(m, batch: int, samples: int) -> float:
    """STFT, encoder, ``n_layers`` x (frequency + time path), decoder,
    ``n_sources`` iSTFTs, on ``[batch, samples]``."""
    n = n_frames(samples, m["hop_length"])
    f = m["n_fft"] // 2 + 1
    d, s = m["emb_dim"], m["n_sources"]
    total = batch * n * rfft_flops(m["n_fft"]) * (1 + s)
    total += 2.0 * batch * n * f * 9 * 2 * d
    total += 2.0 * batch * n * f * 9 * d * (2 * s)
    total += m["n_layers"] * (block_flops(m, batch * n, f) + block_flops(m, batch * f, n))
    return total


def train_step_flops(m, batch: int, samples: int) -> float:
    """Forward and backward (2 x forward) of one optimizer step."""
    return 3.0 * forward_flops(m, batch, samples)
