"""TF-Locoformer separator, spectrogram in and out (the JAX package's
``models/tflocoformer.py::TFLocoformerSeparator``), and the encoder, block
stack and decoder it shares with the audio -> stems model
(``models/mss_tflocoformer.py``, a subclass).

The caller owns the STFT: input is a complex spectrogram ``[B, T, F]`` (or
``[B, 1, T, F]``; mono only), output is complex ``[B, num_spk, T, F]``.

  * fp32 encoder: Conv2d(2 -> emb, 3x3, pad 1) + GroupNorm(1) on
    ``[B, 2, T, F]`` real/imaginary planes (the JAX layout ``[B, T, F, 2]``);
  * cast to the compute dtype; ``n_layers`` TF-Locoformer blocks
    (``nn/blocks.py``) on channels-last ``[B, T, F, C]``;
  * fp32 decoder: ConvTranspose2d(emb -> 2*S, 3x3, pad 1); channel ``2s`` is
    output s's real part and ``2s+1`` its imaginary part.

The state_dict is the reference separator's: ``conv.0`` (Conv2d), ``conv.1``
(GroupNorm), ``blocks.{i}.*`` and ``deconv``.  ``train()``/``eval()`` decide
dropout, whose seeds come from the ``generator`` passed to ``forward``.

Precision: fp32 blocks by default, as the JAX separator's.  The speech
entry points serve and evaluate fp32 blocks (``infer/separate.py::
load_speech_separator``, as the JAX loader) and train at the trainer's
``use_amp`` (bf16 blocks with fp32 islands, or fp32).  On the card the fused
steps take either dtype (fp32 rows through ``ops/cuda/step_fp32.py``); on
the CPU every precision runs the steps' plain versions.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.config import SeparatorConfig
from ..core.precision import FP32, Precision
from ..nn.blocks import TFLocoformerBlock

__all__ = ["TFLocoformerSeparator", "reset_parameters"]

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


class TFLocoformerSeparator(nn.Module):
    """``config`` gives the widths (a ``SeparatorConfig``, or the MSS
    model's ``ModelConfig``); ``n_out`` the outputs (default
    ``config.num_spk``); ``remat_blocks`` runs each block under
    ``torch.utils.checkpoint`` in training, ``remat_ffn`` each torch-
    convolution FFN inside a block."""

    def __init__(self, config: SeparatorConfig, precision: Precision = FP32,
                 generator: Optional[torch.Generator] = None, *,
                 n_out: Optional[int] = None, remat_blocks: bool = False,
                 remat_ffn: bool = False):
        super().__init__()
        cfg = config
        self.config, self.precision = cfg, precision
        self.n_out = cfg.num_spk if n_out is None else n_out
        self.remat_blocks = remat_blocks
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
            remat_ffn=remat_ffn)
        self.blocks = nn.ModuleList(
            TFLocoformerBlock(tf_order=cfg.tf_order, **block)
            for _ in range(cfg.n_layers))
        self.deconv = nn.ConvTranspose2d(cfg.emb_dim, self.n_out * 2, (3, 3),
                                         padding=(1, 1))
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        reset_parameters(self, generator)

    @property
    def num_spk(self) -> int:
        return self.n_out

    def separate(self, spec: torch.Tensor,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Complex ``spec [B, T, F]`` -> complex ``[B, n_out, T, F]``."""
        b, n_frames, n_freqs = spec.shape
        x = torch.view_as_real(spec.to(torch.complex64)).permute(0, 3, 1, 2)  # [B, 2, T, F]
        x = self.conv(x)                                            # fp32 island
        x = x.permute(0, 2, 3, 1).contiguous()                      # [B, T, F, C]
        x = self.precision.cast_compute(x)
        remat = self.training and self.remat_blocks and torch.is_grad_enabled()
        for blk in self.blocks:
            seeds = blk.draw_seeds(generator)
            if remat:
                x = checkpoint(blk, x, None, seeds, use_reentrant=False)
            else:
                x = blk(x, seeds=seeds)
        x = self.deconv(x.to(torch.float32).permute(0, 3, 1, 2))    # fp32 island
        x = x.reshape(b, self.n_out, 2, n_frames, n_freqs)
        return torch.complex(x[:, :, 0], x[:, :, 1])

    def forward(self, spec: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Complex ``spec [B, T, F]`` or ``[B, 1, T, F]`` -> complex
        ``[B, num_spk, T, F]``.  ``generator`` (a CPU ``torch.Generator``)
        supplies the dropout seeds in training mode."""
        if spec.dim() == 4:
            if spec.shape[1] != 1:
                raise ValueError(f"Only monaural input is supported, got {tuple(spec.shape)}")
            spec = spec[:, 0]
        if spec.dim() != 3:
            raise ValueError(f"expected a complex spectrogram [B, T, F], got {tuple(spec.shape)}")
        return self.separate(spec, generator)
