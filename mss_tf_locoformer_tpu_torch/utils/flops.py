"""Analytic FLOP accounting for MFU (the JAX package's ``utils/flops.py``).

MFU is the achieved FLOP/s over the card's peak dense bf16 FLOP/s.  The
count is analytic, from the model config, with the JAX module's
conventions: every matmul / conv MAC of the architecture (attention scores
and AV, QKV and out projections, the conv-SwiGLU-deconv FFNs, the encoder
and decoder convs) plus the rFFT transforms; elementwise work (norms,
gates, dropout, rotary) is left out.  The backward is 2x the forward (grad
with respect to inputs and weights); the optimizer update is negligible.

:func:`device_peak_flops` knows NVIDIA's published dense bf16 peaks of the
H100 parts (data sheet figures without sparsity, at the part's full power
limit) and returns None on the CPU or an unknown card.  The JAX module's
table holds TPU peaks only; a number from it is no peak of this port's
card.
"""

from __future__ import annotations

import math
from typing import Optional

__all__ = ["tflocoformer_forward_flops", "train_step_flops",
           "device_peak_flops", "n_stft_frames"]


def n_stft_frames(samples: int, hop: int) -> int:
    """torch.stft center=True frame count (``ops/stft.py`` parity)."""
    return 1 + samples // hop


def _rfft_flops(n_fft: int) -> float:
    """~2.5 N log2 N real-FFT FLOPs (half the 5 N log2 N complex-FFT count)."""
    return 2.5 * n_fft * math.log2(n_fft)


def _locoformer_block_flops(rows: int, seq: int, cfg) -> float:
    """One LocoformerBlock on [rows, seq, emb]: macaron FFNs + MHSA."""
    d = cfg.emb_dim
    a = cfg.attention_dim
    k = cfg.conv1d_kernel
    tokens = rows * seq

    hidden = cfg.ffn_hidden_dim
    if not isinstance(hidden, tuple):
        hidden = (hidden,)
    ffn = 0.0
    for i_dim in hidden:
        # Conv1d(d -> 2*i, k) + ConvTranspose1d(i -> d, k): 3*i*d*k MACs/token
        ffn += 2.0 * tokens * 3 * i_dim * d * k

    # QKV (d -> 3a) + out proj (a -> d): 4*a*d MACs/token
    proj = 2.0 * tokens * 4 * a * d
    # scores QK^T + attn@V: 2 * rows * seq^2 * a MACs
    attn = 2.0 * (2.0 * rows * seq * seq * a)
    return ffn + proj + attn


def tflocoformer_forward_flops(cfg, batch: int, samples: int) -> float:
    """Analytic forward FLOPs of ``TFLocoformerMSS``: STFT, encoder Conv2d,
    n_layers x (freq-path + time-path LocoformerBlock), decoder
    ConvTranspose2d, n_sources x iSTFT."""
    n = n_stft_frames(samples, cfg.hop_length)
    f = cfg.n_fft // 2 + 1
    d = cfg.emb_dim

    total = 0.0
    # STFT: one rFFT per frame, + iSTFT per stem (irFFT per frame)
    total += batch * n * _rfft_flops(cfg.n_fft)
    total += batch * cfg.n_sources * n * _rfft_flops(cfg.n_fft)
    # encoder Conv2d(2 -> d, 3x3) and decoder ConvTranspose2d(d -> 2*S, 3x3)
    total += 2.0 * batch * n * f * 9 * 2 * d
    total += 2.0 * batch * n * f * 9 * d * (2 * cfg.n_sources)
    # dual-path blocks: freq path rows=B*N seq=F; time path rows=B*F seq=N
    per_layer = (_locoformer_block_flops(batch * n, f, cfg) +
                 _locoformer_block_flops(batch * f, n, cfg))
    total += cfg.n_layers * per_layer
    return total


def train_step_flops(cfg, batch: int, samples: int) -> float:
    """fwd + bwd (2x fwd) for one optimizer step at [batch, samples]."""
    return 3.0 * tflocoformer_forward_flops(cfg, batch, samples)


# Dense bf16 FLOP/s of the H100 parts (NVIDIA's data sheets give twice
# these, with sparsity), matched on torch.cuda.get_device_name in order
_PEAK_BF16 = (
    ("h100 pcie", 756.5e12),
    ("h100 nvl", 835.5e12),
    ("h100", 989.4e12),       # SXM5: "NVIDIA H100 80GB HBM3"
)


def device_peak_flops(device=None) -> Optional[float]:
    """Peak dense bf16 FLOP/s of the card ``device`` (a CUDA device, index
    or name; the current card by default), from its name; None on the CPU,
    without a card, or for a card not in the table."""
    import torch
    if isinstance(device, str) and not device.startswith(("cuda", "cpu")):
        name = device
    else:
        dev = torch.device("cuda", device) if isinstance(device, int) else \
            torch.device("cuda" if device is None else device)
        if dev.type != "cuda" or not torch.cuda.is_available():
            return None
        name = torch.cuda.get_device_name(dev)
    name = name.lower()
    for key, peak in _PEAK_BF16:
        if key in name:
            return peak
    return None
