"""Locoformer blocks: macaron FFN-attention-FFN and the dual-path TF wrapper
(the JAX package's ``nn/blocks.py``).

``LocoformerBlock`` keeps the reference's quirks: the macaron FFN list is
stored *reversed* (``ffn.1`` runs before attention, ``ffn.0`` after) and
there is no 1/2 macaron factor.  Activations are channels-last
``[B, S1, S2, C]``; both sub-steps work along S2 on rows ``B*S1``.

Each step picks its route from the config and its shape, as the JAX
block does (``block_step_applicable``, ``attn_step_applicable``): with
``rmsgroupnorm`` pre-norms, an FFN step with ``fused_ffn`` and stride 1 is
the fused FFN-step kernel, and the attention step with ``flash_attention``
the fused attention-step kernel, when their gates admit the step's widths
in the rows' dtype (``supports_step``, ``supports_block``: the bf16 or the
fp32 kernels' shared-memory layouts on an H100, the backward's too in
training mode).  Otherwise the step runs
as norm + module + residual, and the modules take the flash-attention and
FFN-core kernels under the same flags (``nn/attention.py``,
``nn/ffn.py``); that is the xlarge config's route (C 256) and every
LayerNorm config's.  The route is decided from shapes, the rows' dtype and
``self.training`` before any launch, never from a failure.

Dropout: in training mode (``module.train()``) with a rate above 0, each
step takes one int32 seed from the caller's ``torch.Generator`` (FFN before
attention, attention, FFN after, as the JAX block draws one per call from
``make_rng("dropout")``), and fused and unfused steps apply the same masks
from it.  A block draws all its steps' seeds before it runs
(``draw_seeds``), so that a recompute of the block (per-block remat, the
model's ``remat_blocks``) replays the same masks and leaves the generator
where the first run left it.  The rows of a step are numbered from 0 within
the call.

Tensor parallelism (``parallel/``): :meth:`LocoformerBlock.shard` sets a
block whose parameters hold one of ``mp`` shards to the per-shard widths
(heads ``H/mp``, attention width ``A/mp``, inner ``I/mp``), and the gates
decide its routes at those widths, as the JAX gates do under an mp mesh
(``nn/attention.py:35-50``, ``nn/ffn.py:50-60``).  Only the fused steps
have a TP form (``parallel/tp_fused.py``): a step of a sharded block that
the gates refuse raises; it never routes to another path.

``remat_ffn`` (the JAX block's flag) recomputes each torch-convolution FFN
in the backward instead of keeping its ``2*inner``-wide intermediates; the
FFN-core kernels keep none to begin with, so it changes nothing there.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.cuda.attention_block import supports_block
from ..ops.cuda.swiglu_block import supports_step
from ..ops.dropout import draw_seed

from .attention import MultiHeadSelfAttention
from .ffn import ConvDeconv1d, SwiGLUConvDeconv1d
from .norms import LayerNorm, RMSGroupNorm

__all__ = ["LocoformerBlock", "TFLocoformerBlock"]

_FFN = {"conv1d": ConvDeconv1d, "swiglu_conv1d": SwiGLUConvDeconv1d}


class LocoformerBlock(nn.Module):
    def __init__(self, emb_dim: int, norm_type: str, num_groups: int,
                 n_heads: int, flash_attention: bool, attention_dim: int,
                 use_rope: bool, ffn_type: Union[str, Sequence[str]],
                 ffn_hidden_dim: Union[int, Sequence[int]], conv1d_kernel: int,
                 conv1d_shift: int, fused_ffn: bool, eps: float,
                 dropout: float = 0.0, remat_ffn: bool = False):
        super().__init__()
        macaron = isinstance(ffn_type, (tuple, list))
        types = tuple(ffn_type)[::-1] if macaron else (ffn_type,)
        dims = tuple(ffn_hidden_dim)[::-1] if macaron else (ffn_hidden_dim,)
        if any(t not in _FFN for t in types):
            raise ValueError(f"unknown ffn_type {ffn_type} (expected {sorted(_FFN)})")
        self.num_groups, self.eps, self.dropout = num_groups, eps, dropout
        self.remat_ffn = remat_ffn

        def norm():
            if norm_type == "rmsgroupnorm":
                return RMSGroupNorm(num_groups, emb_dim, eps=eps)
            return LayerNorm(emb_dim, eps=eps)

        self.ffn_norm = nn.ModuleList(norm() for _ in types)
        self.ffn = nn.ModuleList(
            _FFN[t](emb_dim, d, conv1d_kernel, conv1d_shift, fused=fused_ffn)
            for t, d in zip(types, dims))
        self.attn_norm = norm()
        self.attn = MultiHeadSelfAttention(emb_dim, attention_dim, n_heads,
                                           use_rope=use_rope, flash=flash_attention)
        rms = norm_type == "rmsgroupnorm"
        self._widths = (emb_dim, attention_dim, n_heads, dims, conv1d_kernel)
        self._swiglu = [t == "swiglu_conv1d" for t in types]
        self._fusable = (fused_ffn and rms and conv1d_shift == 1, flash_attention and rms)
        self.mp = 1
        self._step_routes = self._routes(1)

    def _routes(self, mp: int):
        """(training?, fp32 rows?) -> route of each FFN step and of the
        attention step, at the widths of one of ``mp`` shards."""
        c, a, h, dims, k = self._widths
        ffn_ok, attn_ok = self._fusable
        out = {}
        for training in (False, True):
            for fp32 in (False, True):
                dt = torch.float32 if fp32 else torch.bfloat16
                out[training, fp32] = (
                    [ffn_ok and swiglu and d % mp == 0
                     and supports_step(c, d // mp, k, training, self.num_groups, dt)
                     for d, swiglu in zip(dims, self._swiglu)],
                    attn_ok and h % mp == 0
                    and supports_block(c, a // mp, h // mp, training, dt))
        return out

    def shard(self, mp: int) -> None:
        """Set this block to hold one of ``mp`` shards of its heads and inner
        channels (its parameters are swapped by ``parallel/sharding.py::
        shard_module``) and take its routes from the gates at those widths."""
        self.mp = self.attn.mp = mp
        self.attn.n_heads //= mp
        for f in self.ffn:
            f.mp = mp
            f.dim_inner //= mp
        self._step_routes = self._routes(mp)

    def fused_steps(self, fp32: bool = False):
        """``([fused FFN step i], fused attention step)`` in the current mode,
        for bf16 rows or (``fp32``) fp32 rows."""
        routes = self._step_routes[self.training, fp32]
        if self.mp > 1 and not (all(routes[0]) and routes[1]):
            c, a, h, dims, k = self._widths
            raise ValueError(
                f"tensor parallelism over mp={self.mp} runs the fused steps only, and their "
                f"gates refuse a shard's widths in "
                f"{'training' if self.training else 'eval'} mode (C {c}, heads {h // self.mp} "
                f"of {a // h}, inner {[d // self.mp for d in dims]}, k {k}; routes {routes})")
        return routes

    def draw_seeds(self, generator: Optional[torch.Generator]) -> Optional[List[int]]:
        """One fresh seed per step in training mode with dropout (FFN before
        attention, attention, FFN after), else None (nothing drawn)."""
        if not (self.training and self.dropout > 0.0):
            return None
        if generator is None:
            raise ValueError("dropout in training mode needs a torch.Generator "
                             "(the model's forward takes generator=...)")
        return [draw_seed(generator) for _ in range(len(self.ffn) + 1)]

    def _drop(self, seed: Optional[int]):
        """``(rate, seed)`` of a step: no dropout without a seed."""
        return (0.0, 0) if seed is None else (self.dropout, seed)

    def _ffn_step(self, x: torch.Tensor, i: int, seed: Optional[int]) -> torch.Tensor:
        rate, seed = self._drop(seed)
        if self.fused_steps(x.dtype == torch.float32)[0][i]:
            return self.ffn[i].fused_step(x, self.ffn_norm[i].gamma,
                                          self.num_groups, self.eps, rate, seed)
        ffn, xn = self.ffn[i], self.ffn_norm[i](x)
        if (self.remat_ffn and self.training and torch.is_grad_enabled()
                and not ffn.fused):   # the FFN-core kernels recompute already
            return x + checkpoint(ffn, xn, rate, seed, use_reentrant=False)
        return x + ffn(xn, rate, seed)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                seeds: Optional[Sequence[int]] = None) -> torch.Tensor:
        """``x [B, S1, S2, C]``; attention and conv along S2.  ``seeds`` (from
        :meth:`draw_seeds`) or else ``generator`` gives the steps' dropout
        seeds."""
        if seeds is None:
            seeds = self.draw_seeds(generator) or [None] * (len(self.ffn) + 1)
        step = iter(seeds)
        if len(self.ffn) == 2:  # pre-attention FFN: the last stored one
            x = self._ffn_step(x, 1, next(step))
        b, s1, s2, c = x.shape
        rows = x.reshape(b * s1, s2, c)
        rate, seed = self._drop(next(step))
        if self.fused_steps(rows.dtype == torch.float32)[1]:
            rows = self.attn.fused_step(rows, self.attn_norm.gamma,
                                        self.num_groups, self.eps, rate, seed)
        else:
            rows = rows + self.attn(self.attn_norm(rows), rate, seed)
        return self._ffn_step(rows.reshape(b, s1, s2, c), 0, next(step))


class TFLocoformerBlock(nn.Module):
    """One LocoformerBlock over frequency (rows B*T, sequence F) and one over
    time (rows B*F, sequence T), in ``tf_order``; ``[B, T, F, C]`` in and out."""

    def __init__(self, tf_order: str = "ft", **kwargs):
        super().__init__()
        self.tf_order = tf_order
        self.freq_path = LocoformerBlock(**kwargs)
        self.frame_path = LocoformerBlock(**kwargs)

    def _paths(self):
        return ((self.freq_path, self.frame_path) if self.tf_order == "ft"
                else (self.frame_path, self.freq_path))

    def draw_seeds(self, generator: Optional[torch.Generator]):
        """Both paths' step seeds, in the order the paths run (None when the
        block draws none)."""
        seeds = [p.draw_seeds(generator) for p in self._paths()]
        return None if seeds[0] is None else seeds

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                seeds=None) -> torch.Tensor:
        """``x [B, T, F, C]``; ``seeds`` (from :meth:`draw_seeds`) or else
        ``generator`` gives the dropout seeds."""
        if seeds is None:
            seeds = self.draw_seeds(generator)
        first, second = seeds if seeds is not None else (None, None)
        if self.tf_order == "ft":
            x = self.freq_path(x, seeds=first)
            x = self.frame_path(x.transpose(1, 2).contiguous(), seeds=second)  # [B, F, T, C]
            return x.transpose(1, 2).contiguous()
        x = self.frame_path(x.transpose(1, 2).contiguous(), seeds=first)
        return self.freq_path(x.transpose(1, 2).contiguous(), seeds=second)
