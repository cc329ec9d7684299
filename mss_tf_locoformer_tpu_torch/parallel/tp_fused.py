"""Tensor-parallel fused block steps (the JAX package's
``parallel/tp_fused.py``).

Each ``mp`` rank runs the whole fused step on its shard of the weights
(``parallel/sharding.py``) in the kernels' partial-sum mode
(``residual=False``), and one all-reduce over the mp group sums the shards:

* attention: heads over mp.  A shard's out-projection contracts only its
  heads, so its output is a partial sum.  The in-kernel probability
  dropout stays in the kernel (it is per head); the post-projection site
  and the residual are the caller's, on the sum (``nn/attention.py``).
* SwiGLU FFN: inner channels over mp.  Conv, gate, the inner dropout site
  and the deconv run on the shard's channels; the deconv bias, the outer
  dropout site and the residual are the caller's, on the sum
  (``nn/ffn.py``).

Two autograd Functions carry the collectives, Megatron's f and g:
:class:`CopyIn` (identity forward, all-reduce of the gradient backward)
on x and the norm's gamma, whose shard gradients are partial sums (the
norm's backward is linear in its upstream, so summing the shards' dx and
dgamma is exact), and :class:`ReduceOut` (all-reduce forward, identity
backward) on the step's output.  The all-reduce runs in the compute dtype,
as the JAX psum does (one bf16 add at mp 2).

Dropout seeds: the in-kernel sites fold the shard's linear index
``dp_index * mp + mp_index`` into the step's seed (:func:`_local_seed`,
bit for bit the JAX fold), so that shards holding different heads,
channels or rows draw different masks; the caller's sites after the
all-reduce act on values every mp rank shares, so their seed folds the dp
index alone (:func:`dp_seed`): the same mask on every mp rank, a different
one on every dp rank.  ``dp_seed`` is also the seed of every site of a
data-parallel run without a model split, and with no mesh it is the seed
itself.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..ops.cuda.attention_block import fused_attention_block
from ..ops.cuda.swiglu_block import fused_norm_ffn_residual

__all__ = ["tp_attention_step", "tp_ffn_step", "CopyIn", "ReduceOut", "dp_seed"]

# The odd word folding the linear shard index into the dropout seed: not
# the golden-ratio word the in-kernel generators stride their indices by,
# so that no shard replays another shard's masks at shifted positions
# (``parallel/tp_fused.py:63-75`` of the JAX package).
_SHARD_SEED_STRIDE = -2048144789  # 0x85EBCA6B as int32 (murmur3 c2)


def _int32(v: int) -> int:
    return (v + 2**31) % 2**32 - 2**31


def _local_seed(seed: Optional[int], mesh) -> Optional[int]:
    """``seed + (dp_index * mp + mp_index) * _SHARD_SEED_STRIDE`` in int32
    arithmetic (the JAX fold); None stays None."""
    if seed is None:
        return None
    return _int32(seed + _int32(mesh.shard_index * _SHARD_SEED_STRIDE))


def dp_seed(seed: Optional[int], mesh) -> Optional[int]:
    """The seed of the sites every mp rank shares: the dp index alone folded
    in; the seed itself without a mesh."""
    if seed is None or mesh is None:
        return seed
    return _int32(seed + _int32(mesh.dp_index * _SHARD_SEED_STRIDE))


class CopyIn(torch.autograd.Function):
    """Identity forward; the gradients summed over ``group`` backward."""

    @staticmethod
    def forward(ctx, group, *ts):
        ctx.group = group
        return tuple(t.view_as(t) for t in ts)

    @staticmethod
    def backward(ctx, *gs):
        out = []
        for g in gs:
            if g is not None:
                g = g.contiguous().clone()
                dist.all_reduce(g, group=ctx.group)
            out.append(g)
        return (None, *out)


class ReduceOut(torch.autograd.Function):
    """The sum over ``group`` forward; identity backward."""

    @staticmethod
    def forward(ctx, group, t):
        if t.is_contiguous():
            ctx.mark_dirty(t)   # summed in place
        else:
            t = t.contiguous()
        dist.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, g):
        return None, g


def tp_attention_step(x, gamma, w_qkv, w_out, n_heads: int, num_groups: int,
                      eps: float, rope: bool, theta: float, drop_rate: float,
                      seed: int, mesh):
    """``OutProj(MHSA(RMSGroupNorm(x)))`` with heads over mp: ``x [R, L, C]``
    (whole on every mp rank), this rank's shards ``w_qkv [3A/mp, C]`` and
    ``w_out [C, A/mp]`` and its ``n_heads`` (``H/mp``) -> the summed
    ``[R, L, C]``, before the post-projection dropout and the residual."""
    x, gamma = CopyIn.apply(mesh.mp_group, x, gamma)
    part = fused_attention_block(x, gamma, w_qkv, w_out, n_heads, num_groups, eps,
                                 rope, theta, drop_rate, _local_seed(seed, mesh),
                                 residual=False)
    return ReduceOut.apply(mesh.mp_group, part)


def tp_ffn_step(x, gamma, conv_w, conv_b, deconv_w, kernel: int, num_groups: int,
                eps: float, drop_rate: float, seed: int, mesh):
    """``Deconv1d(drop_inner(SwiGLU(Conv1d(RMSGroupNorm(x)))))`` with the
    inner channels over mp: ``x [R, L, C]`` and this rank's shards
    (``conv_w [2I/mp, C, k]``, ``conv_b [2I/mp]``, ``deconv_w [I/mp, C, k]``)
    -> the summed ``[R, L, C]``, before the deconv bias, the outer dropout
    and the residual."""
    x, gamma = CopyIn.apply(mesh.mp_group, x, gamma)
    part = fused_norm_ffn_residual(x, gamma, conv_w, conv_b, deconv_w, None, kernel,
                                   num_groups, eps, drop_rate,
                                   _local_seed(seed, mesh), residual=False)
    return ReduceOut.apply(mesh.mp_group, part)
