"""Least device time of a TF-Locoformer MSS forward or training step, op by
op, for ``kernel_roofline.*``.

Each model op's work is reckoned from the cell's shapes, not from the
launches that implement it, so that it reads the same whatever kernels do
the op: its FLOP (``flops.py``'s conventions) at the card's dense bf16 peak,
or its bytes at the card's memory rate, whichever takes longer.  An op's
bytes are its inputs read once and its outputs written once, at the dtypes
its module boundary carries: fp32 audio and spectra, block rows in the
compute dtype, fp32 weights.  An op's backward is 2 x its FLOP and reads its
input and the output's gradient and writes the input's gradient.  The ops:
STFT, encoder, per layer and path the two FFN steps and the attention step,
decoder, the iSTFTs.
"""

from __future__ import annotations

from typing import List, Tuple

from .flops import n_frames, rfft_flops, _inner


def forward_ops(m, batch: int, samples: int, row_bytes: int) -> List[Tuple[str, float, float]]:
    """``(op, FLOP, bytes)`` of one forward on ``[batch, samples]``."""
    n = n_frames(samples, m["hop_length"])
    f = m["n_fft"] // 2 + 1
    c, s, k, a = m["emb_dim"], m["n_sources"], m["conv1d_kernel"], m["attention_dim"]
    tokens = batch * n * f
    rows_io = 2 * tokens * c * row_bytes
    ops = [("stft", batch * n * rfft_flops(m["n_fft"]), batch * samples * 4 + tokens * 8),
           ("encoder", 2.0 * tokens * 9 * 2 * c, tokens * 8 + tokens * c * row_bytes + 4 * c * 20)]
    for _ in range(m["n_layers"]):
        for rows, seq in ((batch * n, f), (batch * f, n)):
            for inner in _inner(m):
                ops.append(("ffn_step", 2.0 * tokens * 3 * inner * c * k,
                            rows_io + 4 * (3 * inner * c * k + 3 * inner + c)))
            ops.append(("attention_step",
                        2.0 * tokens * 4 * a * c + 4.0 * rows * seq * seq * a,
                        rows_io + 4 * (4 * a * c + c)))
    ops.append(("decoder", 2.0 * tokens * 9 * c * 2 * s,
                tokens * c * row_bytes + tokens * 2 * s * 4 + 4 * (c * 2 * s * 9 + 2 * s)))
    ops.append(("istft", batch * s * n * rfft_flops(m["n_fft"]),
                s * tokens * 8 + batch * s * samples * 4))
    return ops


def backward_ops(m, batch: int, samples: int, row_bytes: int) -> List[Tuple[str, float, float]]:
    """``(op, FLOP, bytes)`` of one backward on ``[batch, samples]``: 2 x
    each forward op's FLOP; its input and the output's gradient read, the
    input's gradient written (the forward's bytes plus its input again)."""
    n = n_frames(samples, m["hop_length"])
    tokens = batch * n * (m["n_fft"] // 2 + 1)
    inputs = {"stft": batch * samples * 4, "encoder": tokens * 8,
              "istft": m["n_sources"] * tokens * 8}
    rows_in = tokens * m["emb_dim"] * row_bytes
    return [(name + "_backward", 2.0 * flop, nbytes + inputs.get(name, rows_in))
            for name, flop, nbytes in forward_ops(m, batch, samples, row_bytes)]


def least_seconds(ops, peak_flops: float, bytes_per_s: float) -> float:
    """The sum over ``ops`` of max(FLOP / peak, bytes / rate)."""
    return sum(max(flop / peak_flops, nbytes / bytes_per_s) for _, flop, nbytes in ops)
