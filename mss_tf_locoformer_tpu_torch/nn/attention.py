"""Multi-head self-attention with optional RoPE (the JAX package's
``nn/attention.py::MultiHeadSelfAttention``).

Bias-free fused QKV projection, interleaved-pair RoPE on q/k in fp32,
fp32-softmax attention, bias-free output projection.  Parameters are
``qkv.weight [3A, C]`` and ``aggregate_heads.0.weight [C, A]``, the
reference's keys.

``forward`` is the unfused path: the projections are ``torch.matmul``
(as the JAX package leaves them to XLA) and, with ``flash`` (the config's
``flash_attention``), no dropout and a head_dim the kernels take in the
rows' dtype (bf16 or fp32 kernels, keyed as the blocks' routes are), the
core goes to the flash-attention kernels with RoPE fused
(``ops/cuda/flash_attention.py``, forward and backward); otherwise RoPE and
the plain attention run in torch, the probability mask built per row group
from the seed and the rows' ids (``ops/attention.py``).  A dropout request
never reaches the flash kernels, as in the JAX package, whose flash kernel
has no dropout.  ``fused_step`` runs ``x + MHSA(RMSGroupNorm(x))`` through
the fused attention-step kernel (``ops/cuda/attention_block.py``).  Both
take a dropout rate and an int32 seed (drawn per call by the block) for the
reference's two sites, the attention probabilities and the out-projection,
with the kernel's masks.

Under a mesh (``parallel/mesh.py::activate_mesh``) the seed of a data-
parallel rank folds in its dp index (``parallel/tp_fused.py::dp_seed``),
and with ``mp > 1`` ``fused_step`` runs the tensor-parallel step (the JAX
``nn/attention.py:85-112``): the module holds its shard of the heads
(``parallel/sharding.py::shard_module``), ``tp_attention_step`` sums the
shards' partial out-projections, and the post-projection dropout and the
residual act here on the sum.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops import dropout as D
from ..ops.attention import dot_product_attention
from ..ops.cuda import flash_attention as FA
from ..ops.cuda.attention_block import fused_attention_block
from ..ops.rope import apply_rope
from ..parallel.mesh import active_mesh, tp_mesh
from ..parallel.tp_fused import dp_seed, tp_attention_step

__all__ = ["MultiHeadSelfAttention"]


class MultiHeadSelfAttention(nn.Module):
    def __init__(self, emb_dim: int, attention_dim: int, n_heads: int,
                 use_rope: bool = True, flash: bool = False):
        super().__init__()
        self.n_heads, self.use_rope = n_heads, use_rope
        self.mp = 1   # the heads' split (parallel/sharding.py::shard_module)
        # (fp32 rows?) -> whether the core goes to the flash-attention kernels
        self._flash = {fp32: flash and FA.supports_shape(
            attention_dim // n_heads, torch.float32 if fp32 else torch.bfloat16)
            for fp32 in (False, True)}
        self.qkv = nn.Linear(emb_dim, attention_dim * 3, bias=False)
        self.aggregate_heads = nn.Sequential(
            nn.Linear(attention_dim, emb_dim, bias=False))

    @property
    def flash(self) -> bool:
        """Whether bf16 rows' core goes to the flash-attention kernels."""
        return self._flash[False]

    def forward(self, x: torch.Tensor, drop_rate: float = 0.0,
                seed: int = 0) -> torch.Tensor:
        """``x [B, L, C]`` -> ``[B, L, C]``, attention over L, in ``x.dtype``."""
        b, l, _ = x.shape
        dt = x.dtype
        seed = dp_seed(seed, active_mesh())
        qkv = (x @ self.qkv.weight.to(dt).T).reshape(b, l, 3, self.n_heads, -1)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)                  # [B, H, L, D]
        if self._flash[dt == torch.float32] and drop_rate == 0.0:
            out = FA.flash_attention(q, k, v, self.use_rope, 10000.0)
        else:
            if self.use_rope:
                q, k = apply_rope(q), apply_rope(k)
            out = dot_product_attention(q, k, v, drop_rate, seed,
                                        torch.arange(b, device=x.device))
        out = out.transpose(1, 2).reshape(b, l, -1) @ self.aggregate_heads[0].weight.to(dt).T
        if drop_rate > 0.0:
            out = D.apply_mask(out, D.row_mask(seed, D.SITE_ATTN_PROJ, out, 0, drop_rate),
                               drop_rate)
        return out

    def fused_step(self, x: torch.Tensor, gamma: torch.Tensor, num_groups: int,
                   eps: float, drop_rate: float = 0.0, seed: int = 0) -> torch.Tensor:
        """``x + MHSA(RMSGroupNorm(x))`` for rows ``x [B, L, C]`` in one
        kernel step; ``gamma`` is the pre-norm's scale."""
        x = x.contiguous()
        mesh = tp_mesh()
        if mesh is None:
            return fused_attention_block(
                x, gamma, self.qkv.weight, self.aggregate_heads[0].weight, self.n_heads,
                num_groups, eps, self.use_rope, 10000.0, drop_rate,
                dp_seed(seed, active_mesh()))
        if self.mp != mesh.mp:
            raise ValueError(f"the active mesh splits over mp={mesh.mp}, the module's "
                             f"heads over {self.mp} (parallel/sharding.py::shard_module)")
        out = tp_attention_step(x, gamma, self.qkv.weight, self.aggregate_heads[0].weight,
                                self.n_heads, num_groups, eps, self.use_rope, 10000.0,
                                drop_rate, seed, mesh)
        if drop_rate > 0.0:
            out = D.apply_mask(out, D.row_mask(dp_seed(seed, mesh), D.SITE_ATTN_PROJ, out, 0,
                                               drop_rate), drop_rate)
        return x + out
