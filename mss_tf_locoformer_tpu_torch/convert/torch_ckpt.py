"""Weights carried across: JAX parameter trees and reference ``.pth`` files
-> the port's ``state_dict`` (the JAX package's ``convert/torch_ckpt.py``,
TF-Locoformer and BS-Locoformer keys).

The JAX package stores every weight in its torch layout, so the conversion
is a key rename with no transposes.  The JAX ``BSLocoformerMSS`` nests its
weights under ``separator``; the reference separator's schema, which the
port's BS-Locoformer keeps, has no such level, so it is dropped.  A
``conv1d``-type FFN (``ConvDeconv1d``, whose conv has as many outputs as
its deconv inputs; a SwiGLU conv has twice) takes the reference's
``net.0`` / ``net.3`` keys (the JAX ``convert/torch_ckpt.py:64-73``).
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

__all__ = ["jax_params_to_state_dict", "load_torch_checkpoint"]


_ENCODER = {"norm": "0", "conv": "1"}
_DECODER = {"norm": "0", "conv_0": "1", "conv_1": "3", "conv_2": "4"}


def _unrename(path) -> str:
    """flax param path (tuple of names) -> torch state_dict key."""
    if path[0] == "separator":
        path = path[1:]
    m = re.fullmatch(r"band_(encoder|decoder)_(\d+)", path[0])
    if m:   # the reference's band_split_module.{band_split_module,bandwise_decoding_module}
        kind, b = m.groups()
        if kind == "encoder":
            return f"band_split_module.band_split_module.{b}.{_ENCODER[path[1]]}.{path[2]}"
        return (f"band_split_module.bandwise_decoding_module.{b}."
                f"{_DECODER[path[1]]}.{path[2]}")
    out = []
    for p in path:
        m = re.fullmatch(r"blocks_(\d+)", p)
        if m:
            out.append(f"blocks.{m.group(1)}")
            continue
        m = re.fullmatch(r"(ffn|ffn_norm)_(\d+)", p)
        if m:
            out.append(f"{m.group(1)}.{m.group(2)}")
            continue
        out.append(p)
    key = ".".join(out)
    key = key.replace("conv_norm", "conv.1")
    if key.startswith("conv.") and not key.startswith("conv.1"):
        key = "conv.0." + key.split(".", 1)[1]
    return key.replace("aggregate_heads.weight", "aggregate_heads.0.weight")


def jax_params_to_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX ``TFLocoformerMSS`` or ``BSLocoformerMSS`` (or bare BS separator)
    parameter tree (``{'params': ...}`` or the bare tree, numpy-convertible
    leaves) -> the port's ``state_dict`` (fp32)."""
    tree = params.get("params", params)
    flat: Dict[str, torch.Tensor] = {}

    def walk(node, path):
        if isinstance(node, Mapping):
            for k, v in node.items():
                walk(v, path + (k,))
        else:
            arr = np.array(node, dtype=np.float32)
            flat[_unrename(path)] = torch.from_numpy(arr)

    walk(tree, ())
    return _conv1d_ffn_keys(flat)


def _conv1d_ffn_keys(flat: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``ffn.N.{conv1d,deconv1d}.*`` of a ConvDeconv1d FFN ->
    ``ffn.N.net.{0,3}.*``."""
    out = {}
    for key, v in flat.items():
        m = re.fullmatch(r"(.*\bffn\.\d+)\.(conv1d|deconv1d)\.(weight|bias)", key)
        if m:
            conv, deconv = flat[f"{m.group(1)}.conv1d.weight"], flat[f"{m.group(1)}.deconv1d.weight"]
            if conv.shape[0] == deconv.shape[0]:
                key = f"{m.group(1)}.net.{'0' if m.group(2) == 'conv1d' else '3'}.{m.group(3)}"
        out[key] = v
    return out


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """Load a reference ``.pth`` into a CPU state_dict: the wrapped trainer
    layout (``model_state_dict``), a raw state_dict, or an ESPnet flat dict
    (``separator.`` prefixes stripped, other keys dropped)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(ckpt, Mapping):
        raise ValueError(f"{path}: not a state_dict or trainer checkpoint")
    if "model_state_dict" in ckpt:
        ckpt = ckpt["model_state_dict"]
    if any(k.startswith("separator.") for k in ckpt):
        ckpt = {k[len("separator."):]: v for k, v in ckpt.items()
                if k.startswith("separator.")}
    return {k: v.detach().cpu() for k, v in ckpt.items()}
