"""Model loading and end-to-end separation (the JAX package's
``infer/separate.py``).

``load_model`` reads a PyTorch ``.pth`` in any of the reference's layouts
(trainer dict, raw state_dict, ESPnet ``separator.``-prefixed) into the
model of an optional config file's ``model:`` section (else the
``ModelConfig`` defaults) with ``strict=True``: ``TFLocoformerMSS``, or
``BSLocoformerMSS`` for a ``bs...`` model name.  ``load_speech_separator``
does the same for the speech family's ``TFLocoformerSeparator`` from a
``SpeechConfig`` (the trainer's checkpoints, or an ESPnet ``.pth`` whose
``separator.`` prefix is stripped).  Orbax checkpoint directories need JAX
to read and are not accepted (ROADMAP.md).  ``load_model`` loads bf16 blocks
with the fp32 islands by default; ``load_speech_separator`` loads fp32
blocks, as the JAX loader builds its separator (the fused steps take fp32
rows on the card through ``ops/cuda/step_fp32.py``).

``separate_audio`` loads a WAV at the model rate and separates it with the
chunked overlap-add engine.  A mono model sees the channel mean and its
stems are written as duplicated stereo; a stereo model (BS-Locoformer with
``stereo``) sees both channels (a mono file duplicated) and its stereo stems
are written as they are.  Stems are peak-normalised ``{input}_{stem}.wav``.

Every entry point runs on the card (``device="cuda"``) unless the caller
asks for the CPU; nothing falls back to the CPU on its own.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..convert.torch_ckpt import load_torch_checkpoint
from ..core.config import ModelConfig, SpeechConfig, load_model_config
from ..core.precision import BF16, FP32, Precision
from ..models import build_model
from ..models.tflocoformer import TFLocoformerSeparator
from ..utils.audio import load_audio, save_audio
from .overlap_add import SeparationEngine

__all__ = ["load_model", "load_speech_separator", "make_engine", "model_input",
           "separate_audio"]


def _state_dict(checkpoint_path: str):
    """A ``.pth`` file's state_dict in the port's keys; orbax directories
    are refused."""
    if os.path.isdir(checkpoint_path):
        raise NotImplementedError(
            f"{checkpoint_path}: orbax checkpoint directories need JAX; "
            f"export a .pth from the JAX package (ROADMAP.md)")
    if not checkpoint_path.endswith((".pth", ".pt", ".ckpt")):
        raise FileNotFoundError(f"Unsupported checkpoint: {checkpoint_path}")
    return load_torch_checkpoint(checkpoint_path)


def load_model(checkpoint_path: str, config_path: Optional[str] = None,
               precision: Precision = BF16,
               device="cuda") -> Tuple[torch.nn.Module, ModelConfig]:
    """``(model on device in eval mode, model config)``.  Inference defaults
    to bf16 blocks with the fp32 islands kept."""
    cfg = load_model_config(config_path) if config_path else ModelConfig()
    state = _state_dict(checkpoint_path)
    model = build_model(cfg, precision=precision)
    model.load_state_dict(state, strict=True)
    return model.to(device).eval(), cfg


def load_speech_separator(checkpoint_path: str, cfg: SpeechConfig,
                          precision: Precision = FP32,
                          device="cuda") -> TFLocoformerSeparator:
    """The ``TFLocoformerSeparator`` of ``cfg.separator`` with a ``.pth``'s
    weights (the trainer's checkpoint, a raw state_dict, or ESPnet's
    ``separator.``-prefixed dict), on ``device`` in eval mode; fp32 blocks
    by default, as the JAX loader (``module_kwargs()`` with the separator's
    fp32 default)."""
    state = _state_dict(checkpoint_path)
    module = TFLocoformerSeparator(cfg.separator, precision)
    module.load_state_dict(state, strict=True)
    return module.to(device).eval()


def make_engine(model: torch.nn.Module, chunk_seconds: float = 8.0,
                overlap_seconds: float = 1.0, sample_rate: int = 44100,
                batch_size: int = 2, device="cuda", mesh=None) -> SeparationEngine:
    """The chunked overlap-add engine around ``model``; with a ``mesh``
    (``parallel/mesh.py``) the chunk batches split over its dp ranks."""
    return SeparationEngine(
        model, chunk_samples=int(chunk_seconds * sample_rate),
        overlap=int(overlap_seconds * sample_rate), batch_size=batch_size,
        device=device, mesh=mesh)


def model_input(model: torch.nn.Module, audio: np.ndarray) -> np.ndarray:
    """``[C, T]`` audio as the model takes it: both channels ``[2, T]`` for a
    stereo model (mono duplicated), else the channel mean ``[T]``."""
    if getattr(model.config, "stereo", False):
        return np.repeat(audio, 2, axis=0) if audio.shape[0] == 1 else audio[:2]
    return audio.mean(axis=0)


def separate_audio(input_path: str, output_dir: str, model: torch.nn.Module,
                   sample_rate: int = 44100, chunk_seconds: float = 8.0,
                   overlap_seconds: float = 1.0, batch_size: int = 2,
                   save_stems: bool = True, device="cuda") -> Dict[str, np.ndarray]:
    audio, _ = load_audio(input_path, sample_rate=sample_rate)
    engine = make_engine(model, chunk_seconds, overlap_seconds, sample_rate,
                         batch_size, device)
    stems = engine(model_input(model, audio))
    if save_stems:
        os.makedirs(output_dir, exist_ok=True)
        base = os.path.splitext(os.path.basename(input_path))[0]
        for name, est in stems.items():
            save_audio(os.path.join(output_dir, f"{base}_{name}.wav"),
                       est if est.ndim == 2 else np.stack([est, est]), sample_rate,
                       normalize=True)
    return stems
