"""Tensor-parallel (``mp``) split of Locoformer parameters (the JAX
package's ``parallel/sharding.py``, on the port's state_dict keys).

A Megatron-style split of each block's products over the ``mp`` ranks:

* ``attn.qkv.weight [3A, C]``: heads (column-parallel);
* ``attn.aggregate_heads.0.weight [C, A]``: heads (row-parallel: the
  shards' products are partial sums);
* ``ffn.N.conv1d.weight [2I, C, k]`` and ``.bias [2I]``: inner channels;
* ``ffn.N.deconv1d.weight [I, C, k]``: inner channels (row-parallel); its
  bias ``[C]`` stays whole;
* everything else whole (norms, encoder and decoder, band modules).

The JAX rules (``_RULES``) match EXACT key segments, so that ``deconv1d``
never satisfies a ``conv1d`` rule and its ``[C]`` bias stays replicated;
the port keeps that.  The JAX ``PartitionSpec`` shards the stored axis
contiguously and lets SPMD reshard; the port's shards are whole heads and
whole value/gate pairs, as the JAX TP steps view them
(``parallel/tp_fused.py:102-103, :141-142``): ``[3A, C]`` as ``[3, H, D,
C]``, ``[2I, C, k]`` as ``[2, I, C, k]``, so that a shard is the weight of
a model with ``H/mp`` heads and ``I/mp`` inner channels.  The sharded axis
of each key is the JAX spec's (:func:`shard_axis`).

:func:`shard_state_dict` and :func:`gather_state_dict` map a whole
state_dict to its shards and back; :func:`shard_module` swaps a built
model's parameters for this rank's shards; :func:`gather_over_mp` and the
optimizer-state helpers serve checkpoints, which keep the reference's
whole schema.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

__all__ = ["shard_axis", "shard_tensor", "unshard_tensor", "shard_state_dict",
           "gather_state_dict", "validate_tp", "shard_module", "gather_over_mp",
           "gather_optimizer_state", "shard_optimizer_state"]

# (exact key segments that must ALL appear, leaf name, the stored axis that
# is split, the view it is split in: the number of parts before that axis)
_RULES = (
    (("attn", "qkv"), "weight", 0, 3),
    (("attn", "aggregate_heads"), "weight", 1, 1),
    (("conv1d",), "weight", 0, 2),
    (("conv1d",), "bias", 0, 2),
    (("deconv1d",), "weight", 0, 1),
)


def _rule(key: str):
    segs = key.split(".")
    for segments, leaf, axis, parts in _RULES:
        if segs[-1] == leaf and all(s in segs[:-1] for s in segments):
            return axis, parts
    return None


def shard_axis(key: str) -> Optional[int]:
    """The axis of ``key``'s tensor that is split over mp (the JAX
    ``tp_shardings`` spec's), or None for a whole tensor."""
    r = _rule(key)
    return None if r is None else r[0]


def _view(t: torch.Tensor, axis: int, parts: int) -> torch.Tensor:
    """``t`` with its split axis as ``[parts, n / parts]``."""
    shape = list(t.shape)
    return t.reshape(shape[:axis] + [parts, shape[axis] // parts] + shape[axis + 1:])


def shard_tensor(key: str, t: torch.Tensor, mp_index: int, mp: int) -> torch.Tensor:
    """Shard ``mp_index`` of ``mp`` of ``key``'s tensor (a contiguous copy),
    or ``t`` itself when the key stays whole."""
    r = _rule(key)
    if r is None or mp == 1:
        return t
    axis, parts = r
    v = _view(t, axis, parts)
    n = v.shape[axis + 1]
    if n % mp:
        raise ValueError(f"{key}: {n} not divisible by mp={mp}")
    w = n // mp
    s = v.narrow(axis + 1, mp_index * w, w)
    shape = list(t.shape)
    shape[axis] //= mp
    return s.reshape(shape).contiguous()


def unshard_tensor(key: str, shards: Sequence[torch.Tensor]) -> torch.Tensor:
    """The whole tensor from its ``mp`` shards in mp order."""
    r = _rule(key)
    if r is None or len(shards) == 1:
        return shards[0]
    axis, parts = r
    full = torch.cat([_view(s, axis, parts) for s in shards], dim=axis + 1)
    shape = list(shards[0].shape)
    shape[axis] *= len(shards)
    return full.reshape(shape)


def shard_state_dict(sd: Dict[str, torch.Tensor], mp_index: int,
                     mp: int) -> Dict[str, torch.Tensor]:
    return {k: shard_tensor(k, v, mp_index, mp) for k, v in sd.items()}


def gather_state_dict(shards: Sequence[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`shard_state_dict`: the whole state_dict from
    the shards of every mp index, in mp order."""
    return {k: unshard_tensor(k, [s[k] for s in shards]) for k in shards[0]}


def validate_tp(model_cfg, mp: int) -> None:
    """Hard requirements for an even TP split of a Locoformer config."""
    if mp <= 1:
        return
    if model_cfg.attention_dim % (model_cfg.n_heads * mp):
        raise ValueError(
            f"attention_dim {model_cfg.attention_dim} not divisible by "
            f"n_heads*mp = {model_cfg.n_heads}*{mp}")
    if model_cfg.n_heads % mp:
        raise ValueError(f"n_heads {model_cfg.n_heads} not divisible by mp={mp}")
    dims = model_cfg.ffn_hidden_dim
    if not isinstance(dims, (tuple, list)):
        dims = (dims,)
    for d in dims:
        if d % mp:
            raise ValueError(f"ffn_hidden_dim {d} not divisible by mp={mp}")


@torch.no_grad()
def shard_module(model: torch.nn.Module, mesh) -> torch.nn.Module:
    """Swap ``model``'s split parameters for this rank's shards (in place;
    each shard parameter carries ``tp_axis``) and set every block to its
    per-shard widths (``LocoformerBlock.shard``, which raises where a step
    the TP path needs is refused)."""
    if mesh.mp == 1:
        return model
    from ..nn.blocks import LocoformerBlock
    for name, p in list(model.named_parameters()):
        axis = shard_axis(name)
        if axis is None:
            continue
        owner = model.get_submodule(name.rsplit(".", 1)[0])
        shard = torch.nn.Parameter(shard_tensor(name, p.data, mesh.mp_index, mesh.mp),
                                   requires_grad=p.requires_grad)
        shard.tp_axis = axis
        setattr(owner, name.rsplit(".", 1)[1], shard)
    for m in model.modules():
        if isinstance(m, LocoformerBlock):
            m.shard(mesh.mp)
    return model


def _gather_mp(t: torch.Tensor, mesh, device) -> List[torch.Tensor]:
    """Every mp rank's ``t`` (same shape), in mp order, on the host."""
    from .multihost import comm_device
    dev = comm_device(device)
    src = t.detach().to(dev).contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.mp)]
    dist.all_gather(parts, src, group=mesh.mp_group)
    return [p.cpu() for p in parts]


def gather_over_mp(sd: Dict[str, torch.Tensor], mesh, device) -> Dict[str, torch.Tensor]:
    """The whole state_dict on the host from this rank's sharded one
    (collective over the mp group; one rank: ``sd`` on the host)."""
    if mesh is None or mesh.mp == 1:
        return {k: v.detach().cpu() for k, v in sd.items()}
    return {k: (unshard_tensor(k, _gather_mp(v, mesh, device)) if shard_axis(k) is not None
                else v.detach().cpu()) for k, v in sd.items()}


def _param_keys(model: torch.nn.Module) -> List[str]:
    """The state_dict key of each parameter, in ``parameters()`` order (the
    optimizer's indices)."""
    return [n for n, _ in model.named_parameters()]


def gather_optimizer_state(optimizer: torch.optim.Optimizer, model: torch.nn.Module,
                           mesh, device) -> dict:
    """The optimizer's state_dict with the moments of split parameters
    whole (collective over the mp group), on the host."""
    sd = optimizer.state_dict()
    keys = _param_keys(model)
    state = {}
    for i, st in sd["state"].items():
        key = keys[i]
        state[i] = {}
        for name, v in st.items():
            if (torch.is_tensor(v) and v.dim() > 0 and mesh is not None and mesh.mp > 1
                    and shard_axis(key) is not None):
                v = unshard_tensor(key, _gather_mp(v, mesh, device))
            state[i][name] = v.detach().cpu() if torch.is_tensor(v) else v
    return {"state": state, "param_groups": sd["param_groups"]}


def shard_optimizer_state(sd: dict, model: torch.nn.Module, mesh) -> dict:
    """A whole optimizer state_dict (:func:`gather_optimizer_state`) cut to
    this rank's shards."""
    if mesh is None or mesh.mp == 1:
        return sd
    keys = _param_keys(model)
    state = {i: {name: (shard_tensor(keys[i], v, mesh.mp_index, mesh.mp)
                        if torch.is_tensor(v) and v.dim() > 0 else v)
                 for name, v in st.items()}
             for i, st in sd["state"].items()}
    return {"state": state, "param_groups": sd["param_groups"]}
