"""BS-Locoformer: band-split TF-Locoformer (the JAX package's
``models/bslocoformer.py``).

BS-Roformer banding (:data:`BAND_SPLIT`): ``(0, 1k): 2, (1k, 2k): 4,
(2k, 4k): 12, (4k, 8k): 24, (8k, 16k): 48`` bins per band, the rest split in
2 (in 4 at 48 kHz); at n_fft 2048 and 44.1 kHz that is 62 bands.  Each band
has its own encoder, GroupNorm(1) -> 1x1 Conv1d from ``band * coef`` channels
to ``emb_dim``; the shared TF-Locoformer blocks (``nn/blocks.py``, unchanged)
then run over (time x band) instead of (time x bin); each band's decoder,
GN -> 1x1 -> Tanh -> 1x1 -> 1x1 -> GLU, gives ``band * num_spk * coef``
channels.  ``coef`` is 2 (real, imaginary) or 4 with ``stereo``.

Channel orders are the reference's: the encoder flattens each band
band-major, ``(bin, coef)``, with ``coef`` the real parts then the imaginary
parts over the channels; the decoder's channels are ``(2, num_spk, [M],
band)``, complex-major.  With ``masking`` the output is a complex mask times
the mixture's spectrogram, else the spectrogram itself.

The state_dict is the reference separator's: ``band_split_module.
band_split_module.{b}.{0,1}.*`` (encoders), ``band_split_module.
bandwise_decoding_module.{b}.{0,1,3,4}.*`` (decoders) and ``blocks.{i}.*``.
The 1x1 convolutions are ``nn.Conv1d`` (weight ``[out, in, 1]``) applied to
channels-last rows as a product with ``weight[..., 0]``.

The bands run one after another in Python, each encoder and decoder as a
few small launches (their GroupNorm statistics reduce over a whole chunk per
sample); PERF.md has their share of a forward on the card.
"""

from __future__ import annotations

import math
from itertools import accumulate
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..core.config import BSModelConfig
from ..core.precision import FP32, Precision
from ..nn.blocks import TFLocoformerBlock
from ..nn.norms import GroupNorm
from .tflocoformer import reset_parameters

__all__ = ["BAND_SPLIT", "compute_bands", "BandEncoder", "BandDecoder",
           "BandSplitModule", "BSLocoformerSeparator"]

# the banding of BS-Roformer (https://arxiv.org/abs/2309.02612)
BAND_SPLIT = {(0, 1000): 2, (1000, 2000): 4, (2000, 4000): 12,
              (4000, 8000): 24, (8000, 16000): 48}


def compute_bands(stft_size: int, sample_rate: int) -> List[int]:
    """Bins per band for an ``stft_size``-point transform at ``sample_rate``."""
    num_freq_bins = stft_size // 2 + 1
    bands: List[int] = []
    freq_each_bin = sample_rate // 2 / num_freq_bins
    for (start, end), num_bins in BAND_SPLIT.items():
        num_band = math.ceil((end - start) / (num_bins * freq_each_bin))
        bands.extend([num_bins] * num_band)
    rest = num_freq_bins - sum(bands)
    if sample_rate == 48000:
        bands.extend([rest // 4, rest // 4, rest // 4, rest // 4 + rest % 4])
    else:
        bands.extend([math.floor(rest / 2), math.ceil(rest / 2)])
    if sum(bands) != num_freq_bins:
        raise ValueError(f"bands {bands} do not cover {num_freq_bins} bins")
    return bands


def _pointwise(conv: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    """A 1x1 ``nn.Conv1d`` on channels-last ``x [..., in]``."""
    return F.linear(x, conv.weight[..., 0], conv.bias)


class BandEncoder(nn.Sequential):
    """GroupNorm(1) -> 1x1 Conv1d of one band: ``[B, T, band*coef] -> [B, T, emb]``."""

    def __init__(self, in_channels: int, emb_dim: int):
        super().__init__(GroupNorm(1, in_channels), nn.Conv1d(in_channels, emb_dim, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _pointwise(self[1], self[0](x))


class BandDecoder(nn.Sequential):
    """GN -> 1x1 -> Tanh -> 1x1 -> 1x1 -> GLU of one band:
    ``[B, T, emb] -> [B, T, out_channels]`` (GLU keeps the first half)."""

    def __init__(self, emb_dim: int, out_channels: int):
        e = emb_dim
        super().__init__(GroupNorm(1, e), nn.Conv1d(e, 4 * e, 1), nn.Tanh(),
                         nn.Conv1d(4 * e, 4 * e, 1), nn.Conv1d(4 * e, 2 * out_channels, 1),
                         nn.GLU(dim=-1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self[2](_pointwise(self[1], self[0](x)))
        return self[5](_pointwise(self[4], _pointwise(self[3], x)))


class BandSplitModule(nn.Module):
    """The reference's attribute names: ``band_split_module`` holds the
    encoders, ``bandwise_decoding_module`` the decoders."""

    def __init__(self, bands: List[int], emb_dim: int, num_spk: int, coef: int):
        super().__init__()
        self.band_split_module = nn.ModuleList(
            BandEncoder(nb * coef, emb_dim) for nb in bands)
        self.bandwise_decoding_module = nn.ModuleList(
            BandDecoder(emb_dim, nb * num_spk * coef) for nb in bands)


class BSLocoformerSeparator(nn.Module):
    """Complex ``spec [B, M, T, F]`` (``[B, T, F]`` mono) -> complex
    ``[B, S, (M,) T, F]``.  fp32 band encoders and decoders; the blocks in
    the precision's compute dtype.  ``train()`` and the ``generator`` passed
    to ``forward`` decide dropout as in ``TFLocoformerMSS``; as in the JAX
    separator, nothing is rematerialised."""

    def __init__(self, config: BSModelConfig, precision: Precision = FP32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = config
        self.config, self.precision = cfg, precision
        self.bands = compute_bands(cfg.stft_size, cfg.sample_rate)
        self.coef = 4 if cfg.stereo else 2
        self.band_split_module = BandSplitModule(self.bands, cfg.emb_dim, cfg.n_sources,
                                                 self.coef)
        self.blocks = nn.ModuleList(
            TFLocoformerBlock(
                tf_order=cfg.tf_order, emb_dim=cfg.emb_dim, norm_type=cfg.norm_type,
                num_groups=cfg.num_groups, n_heads=cfg.n_heads,
                flash_attention=cfg.flash_attention, attention_dim=cfg.attention_dim,
                use_rope=cfg.pos_enc == "rope", ffn_type=cfg.ffn_type,
                ffn_hidden_dim=cfg.ffn_hidden_dim, conv1d_kernel=cfg.conv1d_kernel,
                conv1d_shift=cfg.conv1d_shift, fused_ffn=cfg.fused_ffn, eps=cfg.eps,
                dropout=cfg.dropout)
            for _ in range(cfg.n_layers))
        reset_parameters(self, generator or torch.Generator().manual_seed(0))

    def forward(self, spec: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        cfg = self.config
        if spec.dim() == 3:
            if cfg.stereo:
                raise ValueError(f"stereo BS-Locoformer expects [B, 2, T, F], got "
                                 f"{tuple(spec.shape)}")
            spec = spec[:, None]
        b, m, n_frames, n_freqs = spec.shape
        if m * 2 != self.coef or sum(self.bands) != n_freqs:
            raise ValueError(f"spectrogram {tuple(spec.shape)} does not fit "
                             f"{len(self.bands)} bands of {sum(self.bands)} bins, "
                             f"coef {self.coef}")
        edges = list(accumulate([0] + self.bands))
        x = spec.movedim(1, -1)                                   # [B, T, F, M]
        x = torch.cat([x.real, x.imag], dim=-1)                   # [B, T, F, coef]
        bsm = self.band_split_module
        h = torch.stack([enc(x[:, :, lo:hi].reshape(b, n_frames, -1))
                         for enc, lo, hi in zip(bsm.band_split_module, edges, edges[1:])],
                        dim=2)                                    # [B, T, bands, C]
        h = self.precision.cast_compute(h)
        for blk in self.blocks:
            h = blk(h, generator)
        h = h.to(torch.float32)
        split = (2, cfg.n_sources, 2) if cfg.stereo else (2, cfg.n_sources)
        y = torch.cat([dec(h[:, :, i]).unflatten(-1, split + (nb,))
                       for i, (dec, nb) in enumerate(zip(bsm.bandwise_decoding_module,
                                                         self.bands))],
                      dim=-1)                                     # [B, T, 2, S, (M,) F]
        out = torch.complex(y[:, :, 0], y[:, :, 1])               # [B, T, S, (M,) F]
        out = out.movedim(1, -2)                                  # [B, S, (M,) T, F]
        if cfg.masking:
            out = out * (spec[:, None] if cfg.stereo else spec[:, :1])
        return out
