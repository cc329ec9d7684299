"""TF-Locoformer for music source separation, audio -> 4 stems (the JAX
package's ``models/mss_tflocoformer.py::TFLocoformerMSS``).

  * STFT (n_fft, hop) -> ``[B, 2, T, F]`` real/imag planes; with
    ``fused_stft`` the STFT kernel (``ops/cuda/stft_kernel.py``) computes it.
  * fp32 encoder: Conv2d(2 -> emb, 3x3, pad 1) + GroupNorm(1).  In NCHW
    ``[B, 2, T, F]`` the kernel's first spatial tap runs over frames and the
    second over bins, the mapping of the JAX layout ``[B, T, F, C]``.
  * Cast to the compute dtype; ``n_layers`` TF-Locoformer blocks on
    channels-last ``[B, T, F, C]``.
  * fp32 decoder: ConvTranspose2d(emb -> 2*S, 3x3, pad 1); channel ``2s``
    is stem s's real part and ``2s+1`` its imaginary part.
  * ``torch.istft`` with ``length`` back to ``[B, T_samples]`` per stem.

Direct spectral mapping; stem order ``vocals, drums, bass, other``.
``train()``/``eval()`` decide dropout: in training mode the config's rate
applies at the four reference sites (two per FFN step, two per attention
step), with one seed per step drawn from the ``generator`` the caller passes
to ``forward`` -- the model keeps no random state of its own.

``remat_blocks`` (training only, the JAX model's per-block ``nn.remat``):
each ``TFLocoformerBlock`` runs under ``torch.utils.checkpoint`` with the
seeds it drew before running, so the backward recomputes the block's
activations, with the same dropout masks, instead of keeping them.
``remat_ffn`` (None: follow ``remat_blocks``) recomputes each torch-
convolution FFN inside a block likewise.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.config import SOURCE_NAMES, ModelConfig
from ..core.precision import FP32, Precision
from ..nn.blocks import TFLocoformerBlock
from ..ops.cuda.stft_kernel import stft_fused
from ..ops.stft import istft, stft

__all__ = ["TFLocoformerMSS", "reset_parameters"]

_TORCH_LAYERS = (nn.Conv1d, nn.Conv2d, nn.ConvTranspose1d, nn.ConvTranspose2d,
                 nn.Linear)


def reset_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """torch's default initialisation drawn from ``generator``: every conv and
    linear weight and bias ~ U(+-1/sqrt(fan_in)), ``fan_in =
    weight.size(1) * kernel area`` (as ``nn.Conv*``/``nn.Linear`` compute
    it); norm scales 1, norm shifts 0."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, _TORCH_LAYERS):
                w = m.weight
                bound = (w.shape[1] * w[0, 0].numel()) ** -0.5
                for p in (w, m.bias):
                    if p is not None:
                        u = torch.rand(p.shape, generator=generator,
                                       dtype=torch.float32)
                        p.copy_((u * 2 - 1) * bound)


class TFLocoformerMSS(nn.Module):
    def __init__(self, config: ModelConfig, precision: Precision = FP32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = config
        self.config, self.precision = cfg, precision
        self.conv = nn.Sequential(
            nn.Conv2d(2, cfg.emb_dim, (3, 3), padding=(1, 1)),
            nn.GroupNorm(1, cfg.emb_dim, eps=cfg.eps))
        block = dict(
            emb_dim=cfg.emb_dim, norm_type=cfg.norm_type,
            num_groups=cfg.num_groups, n_heads=cfg.n_heads,
            flash_attention=cfg.flash_attention,
            attention_dim=cfg.attention_dim, use_rope=cfg.pos_enc == "rope",
            ffn_type=cfg.ffn_type, ffn_hidden_dim=cfg.ffn_hidden_dim,
            conv1d_kernel=cfg.conv1d_kernel, conv1d_shift=cfg.conv1d_shift,
            fused_ffn=cfg.fused_ffn, eps=cfg.eps, dropout=cfg.dropout,
            remat_ffn=cfg.remat_blocks if cfg.remat_ffn is None else cfg.remat_ffn)
        self.blocks = nn.ModuleList(
            TFLocoformerBlock(tf_order=cfg.tf_order, **block)
            for _ in range(cfg.n_layers))
        self.deconv = nn.ConvTranspose2d(cfg.emb_dim, cfg.n_sources * 2, (3, 3),
                                         padding=(1, 1))
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        reset_parameters(self, generator)

    def forward(self, mixture: torch.Tensor, return_time_domain: bool = True,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """``mixture [B, T_samples]`` -> stems ``[B, T_samples]`` each (or
        complex ``[B, F, N]`` spectrograms with ``return_time_domain=False``).
        ``generator`` (a CPU ``torch.Generator``) supplies the dropout seeds
        in training mode."""
        cfg = self.config
        b, length = mixture.shape
        transform = stft_fused if cfg.fused_stft else stft
        spec = transform(mixture.to(torch.float32), cfg.n_fft, cfg.hop_length)
        x = torch.view_as_real(spec).permute(0, 3, 2, 1)          # [B, 2, T, F]
        x = self.conv(x)                                            # fp32 island
        x = x.permute(0, 2, 3, 1).contiguous()                      # [B, T, F, C]
        x = self.precision.cast_compute(x)
        remat = self.training and cfg.remat_blocks and torch.is_grad_enabled()
        for blk in self.blocks:
            seeds = blk.draw_seeds(generator)
            if remat:
                x = checkpoint(blk, x, None, seeds, use_reentrant=False)
            else:
                x = blk(x, seeds=seeds)
        x = self.deconv(x.to(torch.float32).permute(0, 3, 1, 2))    # fp32 island
        n_frames, n_freqs = x.shape[-2], x.shape[-1]
        x = x.reshape(b, cfg.n_sources, 2, n_frames, n_freqs)
        spec_out = torch.complex(x[:, :, 0], x[:, :, 1]).transpose(-1, -2)  # [B, S, F, N]
        names = SOURCE_NAMES[:cfg.n_sources]
        if not return_time_domain:
            return {name: spec_out[:, i] for i, name in enumerate(names)}
        audio = istft(spec_out, cfg.n_fft, cfg.hop_length, length=length)
        return {name: audio[:, i] for i, name in enumerate(names)}
