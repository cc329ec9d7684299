"""Speech-separation training (the JAX package's ``train/speech.py``).

One step: the plain STFT (``ops/stft.py``, n_fft 128 / hop 64 at 8 kHz by
default) -> ``TFLocoformerSeparator`` (spectrogram -> spectrogram; its
blocks on the fused step kernels on the card) -> the plain iSTFT -> PIT
SI-SNR, or the fixed-order multi-resolution time-frequency L1 (the DNS
criterion).  The transforms stay plain, as in the JAX step: the loss's
n_fft 768 is not a power of two, and the JAX step uses its jnp transforms.

The step is ``train/step.py::update_step``, the MSS trainer's: each
micro-batch loss divided by ``accum``, one clip by global norm, one AdamW
step.  ``SpeechTrainer`` is the MSS trainer (``train/loop.py``) with the
speech model, data and validation: ``LRController`` (warmup x
ReduceLROnPlateau), ``EarlyStopping``, ``CheckpointManager`` and
``run_train_epoch`` are shared, and so are its parallel runs (``config.mesh``
over the ranks of ``torch.distributed``) and its ``profile_steps`` trace
window (``utils/profiling.py``).  Batches are the channel mean:
``[B, C, T]`` -> ``[B, T]`` and ``[B, S, C, T]`` -> ``[B, S, T]``.
Validation runs every utterance whole at batch 1.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..core.config import SpeechConfig
from ..data.speech import SpeechMixtureDataset
from ..losses.pit import fixed_order_loss, pit_loss, pit_si_snr_loss
from ..models.espnet_compat import separate_waveforms
from ..models.tflocoformer import TFLocoformerSeparator
from ..ops.stft import stft
from ..utils.common import AverageMeter
from .loop import Trainer
from .step import update_step

__all__ = ["SpeechTrainer", "speech_train_step", "speech_eval_step"]


def _mr_l1_per_item(est: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Per-item (``[N]``) multi-resolution time-frequency L1 (PIT-compatible)."""
    est, ref = est.to(torch.float32), ref.to(torch.float32)
    fft_sizes = (256, 512, 768, 1024)
    total = 0.0
    for n_fft in fft_sizes:
        hop = n_fft // 2
        total = total + (stft(est, n_fft, hop).abs()
                         - stft(ref, n_fft, hop).abs()).abs().mean(dim=(-2, -1))
    return total / len(fft_sizes) + 0.5 * (est - ref).abs().mean(-1)


def _criterion(cfg: SpeechConfig):
    """``loss(estimates [B, S, T], sources [B, S, T]) -> scalar`` of the
    config's wrapper and criterion."""
    crit, wrap = cfg.loss.criterion, cfg.loss.wrapper
    if wrap == "pit":
        if crit == "si_snr":
            return pit_si_snr_loss
        return lambda est, src: pit_loss(est, src, _mr_l1_per_item)[0]
    if crit == "si_snr":
        return fixed_order_loss
    return lambda est, src: fixed_order_loss(est, src, _mr_l1_per_item)


def speech_train_step(module: TFLocoformerSeparator, optimizer: torch.optim.Optimizer,
                      mixture: torch.Tensor, sources: torch.Tensor, lr: float,
                      generator: torch.Generator, cfg: SpeechConfig) -> Dict[str, torch.Tensor]:
    """One optimizer step on ``mixture [B, T]`` and ``sources [B, S, T]``;
    returns ``{"total_loss", "grad_norm"}``."""
    loss_of, st = _criterion(cfg), cfg.stft
    tcfg = cfg.training
    return update_step(
        module, optimizer,
        lambda mix, src: {"total_loss": loss_of(
            separate_waveforms(module, mix, st.n_fft, st.hop_length, generator), src)},
        mixture, sources, lr, tcfg.gradient_accumulation_steps, tcfg.gradient_clip)


@torch.no_grad()
def speech_eval_step(module: TFLocoformerSeparator, mixture: torch.Tensor,
                     sources: torch.Tensor, cfg: SpeechConfig) -> torch.Tensor:
    """The loss in eval mode (no dropout), a 0-d tensor."""
    module.eval()
    est = separate_waveforms(module, mixture, cfg.stft.n_fft, cfg.stft.hop_length)
    return _criterion(cfg)(est, sources)


class SpeechTrainer(Trainer):
    """Epoch-driven trainer over a ``SpeechMixtureDataset`` corpus on one
    device (``device`` is required)."""

    def __init__(self, config: SpeechConfig, device, output_dir: Optional[str] = None,
                 resume: Optional[str] = None, verbose: bool = True):
        super().__init__(config, device, output_dir, resume, verbose)
        self._log(f"Speech trainer: criterion={config.loss.wrapper}/{config.loss.criterion}")

    def _build_model(self) -> torch.nn.Module:
        return TFLocoformerSeparator(self.config.separator, self.precision,
                                     torch.Generator().manual_seed(self.config.seed))

    def _datasets(self):
        d = self.config.dataset
        common = dict(num_spk=d.num_spk, mix_dir=d.mix_dir, spk_dirs=d.spk_dirs,
                      segment_length=d.segment_length, sample_rate=d.sample_rate)
        train = SpeechMixtureDataset(d.root_dir, random_crop=True, seed=self._data_seed(),
                                     **common)
        val = None
        if d.valid_dir:
            val = SpeechMixtureDataset(d.valid_dir, random_crop=False, **common)
        return train, val

    @staticmethod
    def _mono(batch):
        """``[B, C, T] -> [B, T]``; ``[B, S, C, T] -> [B, S, T]`` (channel mean)."""
        mix = np.asarray(batch["mixture"]).mean(axis=1)
        src = np.asarray(batch["sources"]).mean(axis=2)
        return mix.astype(np.float32), src.astype(np.float32)

    def _host_batches(self, loader):
        for batch in loader:
            mix, src = self._mono(batch)
            yield {"mixture": mix, "sources": src}

    def _train_step(self, batch: Dict[str, torch.Tensor], lr: float):
        return speech_train_step(self.model, self.optimizer, batch["mixture"],
                                 batch["sources"], lr, self.generator, self.config)

    def _validate(self, loader) -> float:
        """Mean eval-mode loss over the validation batches (this rank's dp
        share, the meters summed over dp)."""
        meter = AverageMeter()
        for batch in self._val_shard(loader):
            mix, src = (torch.from_numpy(a).to(self.device) for a in self._mono(batch))
            meter.update(float(speech_eval_step(self.model, mix, src, self.config)),
                         mix.shape[0])
        return self._merge(meter)
