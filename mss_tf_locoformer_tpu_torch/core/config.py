"""Typed configuration (the JAX package's ``core/config.py``, MSS part).

Every section of ``configs/musdb18*.yaml`` is a frozen dataclass with the
fields, defaults and validation of the JAX package, so one file configures
both packages identically; unknown keys raise.  ``mesh`` lays the ranks of
a parallel run out as ``dp x mp`` (``parallel/mesh.py``).  A model section
whose ``name`` starts with ``bs`` is a :class:`BSModelConfig` (the JAX
``build_model`` rule).  The speech task
(``configs/speech_*.yaml``) has its own sections and loader,
:class:`SpeechConfig` and :func:`load_speech_config`.

PyYAML is imported inside the loaders only, and a ``.json`` file of the same
structure needs none: the GPU machine may have no PyYAML.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Mapping, Optional, Tuple, Union

__all__ = ["ModelConfig", "BSModelConfig", "SOURCE_NAMES", "model_config_from_dict",
           "load_model_config", "LossConfig", "DatasetConfig",
           "OptimizerConfig", "SchedulerConfig", "EarlyStoppingConfig",
           "TrainingConfig", "EvaluationConfig", "PathsConfig", "MeshConfig",
           "Config", "config_from_dict", "load_config", "SpeechDatasetConfig",
           "SeparatorConfig", "STFTConfig", "SpeechLossConfig", "SpeechConfig",
           "speech_config_from_dict", "load_speech_config"]

SOURCE_NAMES = ("vocals", "drums", "bass", "other")


def _as_tuple(x):
    if isinstance(x, (list, tuple)):
        return tuple(x)
    return x


@dataclass(frozen=True)
class ModelConfig:
    """TF-Locoformer MSS model hyper-parameters (same surface as the JAX
    package's ``ModelConfig``)."""

    name: str = "tflocoformer_mss"
    # Audio / transform
    n_fft: int = 2048
    hop_length: int = 1024
    # Architecture
    n_sources: int = 4
    n_layers: int = 6
    emb_dim: int = 128
    norm_type: str = "rmsgroupnorm"  # {"layernorm", "rmsgroupnorm"}
    num_groups: int = 4
    tf_order: str = "ft"  # {"ft", "tf"}
    # Attention
    n_heads: int = 4
    flash_attention: bool = False  # fused attention-step kernel
    fused_stft: bool = False  # STFT kernel
    fused_ffn: bool = False   # fused norm+FFN+residual step kernel
    remat_blocks: bool = False  # training only; no effect on inference
    remat_ffn: Optional[bool] = None
    attention_dim: int = 128
    pos_enc: str = "rope"  # {"rope", "nope"}
    # FFN
    ffn_type: Union[str, Tuple[str, ...]] = "swiglu_conv1d"
    ffn_hidden_dim: Union[int, Tuple[int, ...]] = 384
    conv1d_kernel: int = 4
    conv1d_shift: int = 1
    dropout: float = 0.0
    # Misc
    eps: float = 1.0e-5

    def __post_init__(self):
        object.__setattr__(self, "ffn_type", _as_tuple(self.ffn_type))
        object.__setattr__(self, "ffn_hidden_dim", _as_tuple(self.ffn_hidden_dim))
        if self.norm_type not in ("layernorm", "rmsgroupnorm"):
            raise ValueError(f"norm_type must be layernorm|rmsgroupnorm, got {self.norm_type}")
        if self.tf_order not in ("ft", "tf"):
            raise ValueError(f"tf_order must be ft|tf, got {self.tf_order}")
        if self.pos_enc not in ("rope", "nope"):
            raise ValueError(f"pos_enc must be rope|nope, got {self.pos_enc}")
        if self.attention_dim % self.n_heads != 0:
            raise ValueError(f"attention_dim {self.attention_dim} not divisible by n_heads {self.n_heads}")
        if self.emb_dim % self.num_groups != 0 and self.norm_type == "rmsgroupnorm":
            raise ValueError(f"emb_dim {self.emb_dim} not divisible by num_groups {self.num_groups}")
        macaron = isinstance(self.ffn_type, tuple)
        if macaron:
            if len(self.ffn_type) != 2 or not isinstance(self.ffn_hidden_dim, tuple) \
                    or len(self.ffn_hidden_dim) != 2:
                raise ValueError("Macaron style needs 2-element ffn_type and ffn_hidden_dim lists")
        types = self.ffn_type if macaron else (self.ffn_type,)
        for t in types:
            if t not in ("conv1d", "swiglu_conv1d"):
                raise ValueError(f"ffn_type entries must be conv1d|swiglu_conv1d, got {t}")

    @property
    def n_freqs(self) -> int:
        return self.n_fft // 2 + 1


@dataclass(frozen=True)
class BSModelConfig(ModelConfig):
    """BS-Locoformer extras (the JAX package's ``BSModelConfig``): the band
    table's input (``sample_rate``, ``stft_size``), complex masking against
    direct mapping, and joint stereo.  ``ffn_type``/``ffn_hidden_dim`` as
    scalars mean one FFN per path (no macaron)."""

    name: str = "bslocoformer"
    sample_rate: int = 44100
    stft_size: int = 2048
    masking: bool = True
    stereo: bool = False


@dataclass(frozen=True)
class LossConfig:
    loss_type: str = "combined"  # {"si_sdr", "l1", "l2", "combined"}
    si_sdr_weight: float = 1.0
    l1_weight: float = 0.1
    spectral_weight: float = 0.1
    eps: float = 1.0e-8
    # the reference's SpectralLoss is fixed at 2048/1024 whatever the model's STFT
    spectral_n_fft: int = 2048
    spectral_hop_length: int = 1024

    def __post_init__(self):
        if self.loss_type not in ("si_sdr", "l1", "l2", "combined"):
            raise ValueError(f"invalid loss_type {self.loss_type}")


@dataclass(frozen=True)
class DatasetConfig:
    name: str = "musdb18hq"
    root_dir: str = ""
    sample_rate: int = 44100
    segment_length: Optional[int] = 132300
    sources: Tuple[str, ...] = SOURCE_NAMES
    augmentation: bool = False
    random_chunks: bool = True
    min_loudness: float = 1.0e-4
    max_chunk_attempts: int = 8
    rebuild_mixture: bool = True
    cache_dir: Optional[str] = None
    precompute_chunks: bool = False
    chunk_hop: Optional[int] = None

    def __post_init__(self):
        object.__setattr__(self, "sources", tuple(self.sources))


@dataclass(frozen=True)
class OptimizerConfig:
    type: str = "adamw"
    lr: float = 5.0e-4
    weight_decay: float = 0.01
    eps: float = 1.0e-8
    betas: Tuple[float, float] = (0.9, 0.999)
    fused: bool = True  # accepted for YAML compatibility

    def __post_init__(self):
        object.__setattr__(self, "betas", tuple(self.betas))


@dataclass(frozen=True)
class SchedulerConfig:
    type: str = "reducelronplateau"
    mode: str = "min"
    factor: float = 0.5
    patience: int = 8
    min_lr: float = 1.0e-7
    cooldown: int = 0
    warmup_steps: int = 0
    warmup_start_lr: float = 0.0


@dataclass(frozen=True)
class EarlyStoppingConfig:
    enabled: bool = False
    patience: int = 20
    min_delta: float = 0.0


@dataclass(frozen=True)
class TrainingConfig:
    batch_size: int = 1
    num_epochs: int = 300
    gradient_clip: float = 5.0
    num_workers: int = 4
    pin_memory: bool = True
    prefetch_factor: int = 2
    persistent_workers: bool = True   # accepted for YAML compatibility
    gradient_checkpointing: bool = False
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)
    use_amp: bool = True
    amp_dtype: str = "bfloat16"
    gradient_accumulation_steps: int = 1
    save_interval: int = 5
    keep_last: int = 10
    save_best: bool = True
    save_optimizer: bool = True
    val_interval: int = 1
    # validation on fixed-length chunks: None -> segment_length (or 10 s)
    val_segment_length: Optional[int] = None
    val_batch_size: int = 4
    early_stopping: EarlyStoppingConfig = field(default_factory=EarlyStoppingConfig)
    log_interval: int = 50
    profile_steps: int = 0
    profile_start_step: int = 5

    def __post_init__(self):
        if self.amp_dtype not in ("bfloat16", "float16", "float32"):
            raise ValueError(f"amp_dtype must be bfloat16|float16|float32, got {self.amp_dtype}")


@dataclass(frozen=True)
class EvaluationConfig:
    batch_size: int = 1
    save_outputs: bool = False
    metrics: Tuple[str, ...] = ("si_sdr", "sdr", "sar", "sir")

    def __post_init__(self):
        object.__setattr__(self, "metrics", tuple(self.metrics))


@dataclass(frozen=True)
class PathsConfig:
    output_dir: str = "./experiments"
    checkpoint_dir: str = "./experiments/checkpoints"
    log_dir: str = "./experiments/logs"


@dataclass(frozen=True)
class MeshConfig:
    """Device layout: ``dp`` data-parallel (-1: all devices), ``mp`` model
    axis."""

    dp: int = -1
    mp: int = 1

    def axis_sizes(self, n_devices: int) -> Tuple[int, int]:
        mp = max(1, self.mp)
        dp = self.dp if self.dp > 0 else max(1, n_devices // mp)
        return dp, mp


@dataclass(frozen=True)
class Config:
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    training: TrainingConfig = field(default_factory=TrainingConfig)
    evaluation: EvaluationConfig = field(default_factory=EvaluationConfig)
    paths: PathsConfig = field(default_factory=PathsConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    seed: int = 42


def _build(cls, data: Optional[Mapping[str, Any]], ctx: str):
    """A dataclass from a mapping, rejecting unknown keys."""
    data = dict(data or {})
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(data) - names
    if unknown:
        raise ValueError(f"Unknown key(s) {sorted(unknown)} in config section '{ctx}'. "
                         f"Valid keys: {sorted(names)}")
    return cls(**{k: _as_tuple(v) for k, v in data.items()})


_SECTIONS = {"dataset": DatasetConfig, "loss": LossConfig,
             "evaluation": EvaluationConfig, "paths": PathsConfig,
             "mesh": MeshConfig}
# top-level keys of the reference's YAMLs that configure nothing here
_IGNORED_TOP_LEVEL = {"device", "num_gpu", "gpu_id", "performance", "memory"}


def _training(val: Mapping[str, Any]) -> TrainingConfig:
    val = dict(val or {})
    # warmup at the training level (the reference's xlarge config) folds
    # into the scheduler, as the JAX loader does
    sched = dict(val.get("scheduler") or {})
    for wk in ("warmup_steps", "warmup_start_lr"):
        if wk in val:
            sched.setdefault(wk, val.pop(wk))
    if sched:
        val["scheduler"] = sched
    if "optimizer" in val:
        val["optimizer"] = _build(OptimizerConfig, val["optimizer"], "training.optimizer")
    if "scheduler" in val:
        val["scheduler"] = _build(SchedulerConfig, val["scheduler"], "training.scheduler")
    if "early_stopping" in val:
        es = dict(val["early_stopping"])
        es.setdefault("enabled", True)
        val["early_stopping"] = _build(EarlyStoppingConfig, es, "training.early_stopping")
    return _build(TrainingConfig, val, "training")


def config_from_dict(raw: Mapping[str, Any]) -> Config:
    """The whole config from a mapping of sections."""
    kwargs: dict = {}
    for key, val in raw.items():
        if key == "seed":
            kwargs["seed"] = int(val)
        elif key == "model":
            kwargs["model"] = model_config_from_dict(val)
        elif key == "training":
            kwargs["training"] = _training(val)
        elif key in _SECTIONS:
            kwargs[key] = _build(_SECTIONS[key], val, key)
        elif key not in _IGNORED_TOP_LEVEL:
            raise ValueError(f"Unknown top-level config key: {key!r}")
    return Config(**kwargs)


def _read(path: str) -> Mapping[str, Any]:
    with open(path) as f:
        if path.endswith(".json"):
            raw = json.load(f)
        else:
            import yaml  # imported here: the CUDA machine may have no PyYAML
            raw = yaml.safe_load(f) or {}
    if not isinstance(raw, Mapping):
        raise ValueError(f"{path}: top level is not a mapping")
    return raw


def load_config(path: str) -> Config:
    """Every section of a YAML config file (or JSON of the same structure)."""
    return config_from_dict(_read(path))


def model_config_from_dict(data: Optional[Mapping[str, Any]]) -> ModelConfig:
    """Build a ``ModelConfig`` (a ``BSModelConfig`` when ``name`` starts with
    ``bs``) from a mapping, rejecting unknown keys."""
    data = dict(data or {})
    cls = BSModelConfig if str(data.get("name", "")).startswith("bs") else ModelConfig
    return _build(cls, data, "model")


def load_model_config(path: str) -> ModelConfig:
    """Read the ``model:`` section of a YAML config file (or of the same
    structure as JSON, which needs no PyYAML)."""
    return model_config_from_dict(_read(path).get("model"))


# --------------------------------------------------------------------------
# The speech-separation task (the JAX package's ``core/config.py`` speech
# part): the same sections, fields, defaults and validation.


@dataclass(frozen=True)
class SpeechDatasetConfig:
    """wsj0-2mix-style parallel-directory corpus (``data/speech.py``)."""

    root_dir: str = ""
    valid_dir: Optional[str] = None   # separate dev-set root (else no validation)
    num_spk: int = 2
    mix_dir: str = "mix"
    spk_dirs: Optional[Tuple[str, ...]] = None
    sample_rate: int = 8000
    segment_length: Optional[int] = 32000  # 4 s at 8 kHz

    def __post_init__(self):
        if self.spk_dirs is not None:
            object.__setattr__(self, "spk_dirs", tuple(self.spk_dirs))


@dataclass(frozen=True)
class SeparatorConfig:
    """The ``TFLocoformerSeparator`` surface (``models/tflocoformer.py``)."""

    num_spk: int = 2
    n_layers: int = 6
    emb_dim: int = 128
    norm_type: str = "rmsgroupnorm"
    num_groups: int = 4
    tf_order: str = "ft"
    n_heads: int = 4
    flash_attention: bool = False
    fused_ffn: bool = False
    attention_dim: int = 128
    pos_enc: str = "rope"
    ffn_type: Union[str, Tuple[str, ...]] = "swiglu_conv1d"
    ffn_hidden_dim: Union[int, Tuple[int, ...]] = 384
    conv1d_kernel: int = 4
    conv1d_shift: int = 1
    dropout: float = 0.0
    eps: float = 1.0e-5

    def __post_init__(self):
        object.__setattr__(self, "ffn_type", _as_tuple(self.ffn_type))
        object.__setattr__(self, "ffn_hidden_dim", _as_tuple(self.ffn_hidden_dim))


@dataclass(frozen=True)
class STFTConfig:
    """The separator's transform: n_fft 128, hop 64 at 8 kHz by default."""

    n_fft: int = 128
    hop_length: int = 64


@dataclass(frozen=True)
class SpeechLossConfig:
    """PIT SI-SNR (wsj0-2mix, WHAMR) or fixed-order multi-resolution
    time-frequency L1 (DNS)."""

    criterion: str = "si_snr"     # {"si_snr", "mr_l1_tfd"}
    wrapper: str = "pit"          # {"pit", "fixed_order"}

    def __post_init__(self):
        if self.criterion not in ("si_snr", "mr_l1_tfd"):
            raise ValueError(f"criterion must be si_snr|mr_l1_tfd, got {self.criterion}")
        if self.wrapper not in ("pit", "fixed_order"):
            raise ValueError(f"wrapper must be pit|fixed_order, got {self.wrapper}")


@dataclass(frozen=True)
class SpeechConfig:
    task: str = "speech_separation"
    dataset: SpeechDatasetConfig = field(default_factory=SpeechDatasetConfig)
    separator: SeparatorConfig = field(default_factory=SeparatorConfig)
    stft: STFTConfig = field(default_factory=STFTConfig)
    loss: SpeechLossConfig = field(default_factory=SpeechLossConfig)
    training: TrainingConfig = field(default_factory=TrainingConfig)
    paths: PathsConfig = field(default_factory=PathsConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    seed: int = 42


_SPEECH_SECTIONS = {"dataset": SpeechDatasetConfig, "separator": SeparatorConfig,
                    "stft": STFTConfig, "loss": SpeechLossConfig,
                    "paths": PathsConfig, "mesh": MeshConfig}


def speech_config_from_dict(raw: Mapping[str, Any]) -> SpeechConfig:
    """The speech config from a mapping of sections; unknown keys raise with
    the valid ones listed."""
    kwargs: dict = {}
    for key, val in raw.items():
        if key == "seed":
            kwargs["seed"] = int(val)
        elif key == "task":
            kwargs["task"] = str(val)
        elif key == "training":
            # as the JAX speech loader: early stopping keeps its own default
            # of ``enabled`` (the MSS loader turns it on)
            val = dict(val or {})
            es = val.pop("early_stopping", None)
            training = _training(val)
            if es is not None:
                training = dataclasses.replace(training, early_stopping=_build(
                    EarlyStoppingConfig, es, "training.early_stopping"))
            kwargs["training"] = training
        elif key in _SPEECH_SECTIONS:
            kwargs[key] = _build(_SPEECH_SECTIONS[key], val, key)
        else:
            raise ValueError(f"Unknown top-level key '{key}' in speech config. "
                             f"Valid: {sorted(_SPEECH_SECTIONS) + ['training', 'seed', 'task']}")
    return SpeechConfig(**kwargs)


def load_speech_config(path: str) -> SpeechConfig:
    """A speech-task YAML file (``configs/speech_*.yaml``) or JSON of the same
    structure."""
    return speech_config_from_dict(_read(path))
