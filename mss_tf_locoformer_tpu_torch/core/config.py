"""Model configuration (the ``model:`` section of ``configs/*.yaml``).

``ModelConfig`` carries the fields, defaults and validation of the JAX
package's ``core/config.py::ModelConfig`` so that one YAML file configures
both packages identically.  Only the model section is ported: training,
data and evaluation sections belong to later slices.

PyYAML is imported inside :func:`load_model_config` only, so building a
config in code needs nothing beyond the standard library.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Any, Mapping, Optional, Tuple, Union

__all__ = ["ModelConfig", "SOURCE_NAMES", "model_config_from_dict",
           "load_model_config"]

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


def model_config_from_dict(data: Optional[Mapping[str, Any]]) -> ModelConfig:
    """Build a ``ModelConfig`` from a mapping, rejecting unknown keys."""
    data = dict(data or {})
    if str(data.get("name", "")).startswith("bs"):
        raise NotImplementedError(
            "BS-Locoformer configs are not ported yet "
            "(ROADMAP.md, Queue 1: the other model families)")
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    unknown = set(data) - names
    if unknown:
        raise ValueError(f"Unknown key(s) {sorted(unknown)} in config section 'model'. "
                         f"Valid keys: {sorted(names)}")
    return ModelConfig(**{k: _as_tuple(v) for k, v in data.items()})


def load_model_config(path: str) -> ModelConfig:
    """Read the ``model:`` section of a YAML config file (or of the same
    structure as JSON, which needs no PyYAML)."""
    with open(path) as f:
        if path.endswith(".json"):
            raw = json.load(f)
        else:
            import yaml  # imported here: the CUDA machine may have no PyYAML
            raw = yaml.safe_load(f) or {}
    if not isinstance(raw, Mapping):
        raise ValueError(f"{path}: top level is not a mapping")
    return model_config_from_dict(raw.get("model"))
