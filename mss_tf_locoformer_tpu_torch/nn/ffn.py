"""Locoformer feed-forward network: SwiGLU Conv-Deconv (the JAX package's
``nn/ffn.py::SwiGLUConvDeconv1d``).

Conv1d(dim -> 2*inner, k, stride) with the reference's symmetric padding,
SwiGLU gate ``y[:inner] * silu(y[inner:])``, ConvTranspose1d back to dim, crop
to the input length.  Submodules ``conv1d``/``deconv1d`` are the torch layers
whose layouts the JAX package emulates, so reference checkpoints load as
they are.

``forward`` is the unfused path: with ``fused`` (the config's
``fused_ffn``), stride 1 and a shape the kernels take (in training mode the
backward's too), the padded rows go through the FFN-core kernels
(``ops/cuda/swiglu_ffn.py``: forward, and the backward kernel when a
gradient is asked for), as the JAX package's ``swiglu_conv_deconv``;
otherwise through torch's convolutions (any stride).  ``fused_step`` runs ``x + FFN(RMSGroupNorm(x))`` through the
fused FFN-step kernel (``ops/cuda/swiglu_block.py``), stride 1 only.  Both
take a dropout rate and an int32 seed (drawn per call by the block): the
unfused path applies the kernels' masks (``ops/dropout.py``) at the same two
sites, the SwiGLU output and the cropped output.

:class:`ConvDeconv1d` is the ``conv1d`` FFN type (the reference's, the JAX
package's ``nn/ffn.py::ConvDeconv1d``): Conv1d(dim -> inner) -> SiLU ->
dropout -> ConvTranspose1d(inner -> dim) -> crop -> dropout, the same
padding; its layers sit in ``net`` at the reference's indices (``net.0``
the conv, ``net.3`` the deconv).  It has a plain path only, as in the JAX
package (no kernel takes it); ``fused`` is accepted for API parity.

Under a mesh (``parallel/mesh.py::activate_mesh``) the seed of a data-
parallel rank folds in its dp index (``parallel/tp_fused.py::dp_seed``),
and with ``mp > 1`` ``fused_step`` runs the tensor-parallel step (the JAX
``nn/ffn.py:125-150``): the module holds its shard of the inner channels
(``parallel/sharding.py::shard_module``), ``tp_ffn_step`` sums the shards'
partial deconv outputs, and the deconv bias, the outer dropout and the
residual act here on the sum.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import dropout as D
from ..ops.cuda import swiglu_ffn
from ..ops.cuda.swiglu_block import fused_norm_ffn_residual, inner_mask
from ..parallel.mesh import active_mesh, tp_mesh
from ..parallel.tp_fused import dp_seed, tp_ffn_step

__all__ = ["SwiGLUConvDeconv1d", "ConvDeconv1d"]


def _pad_len(s2: int, kernel: int, shift: int) -> int:
    diff_ks = kernel - shift
    return math.ceil((s2 + 2 * diff_ks - kernel) / shift) * shift + kernel


class SwiGLUConvDeconv1d(nn.Module):
    def __init__(self, dim: int, dim_inner: int, conv1d_kernel: int,
                 conv1d_shift: int, fused: bool = False):
        super().__init__()
        self.dim_inner = dim_inner
        self.mp = 1   # the inner channels' split (parallel/sharding.py::shard_module)
        self.kernel, self.shift = conv1d_kernel, conv1d_shift
        # (training?) -> whether the rows go through the FFN-core kernels
        self._fused = {training: (fused and conv1d_shift == 1 and swiglu_ffn.supports_shape(
            dim, dim_inner, conv1d_kernel, training)) for training in (False, True)}
        self.conv1d = nn.Conv1d(dim, dim_inner * 2, conv1d_kernel, stride=conv1d_shift)
        self.deconv1d = nn.ConvTranspose1d(dim_inner, dim, conv1d_kernel,
                                           stride=conv1d_shift)

    @property
    def fused(self) -> bool:
        """Whether the rows go through the FFN-core kernels in the current mode."""
        return self._fused[self.training]

    def forward(self, x: torch.Tensor, drop_rate: float = 0.0,
                seed: int = 0) -> torch.Tensor:
        """``x [B, S1, S2, C]`` -> FFN output ``[B, S1, S2, C]`` (conv along
        S2), computed in ``x.dtype``; dropout of ``drop_rate`` at the inner
        site (row, conv position, inner channel) and the outer one (row,
        position, channel), rows ``B*S1``."""
        b, s1, s2, c = x.shape
        diff_ks = self.kernel - self.shift
        dt = x.dtype
        seed = dp_seed(seed, active_mesh())
        rows = x.reshape(b * s1, s2, c)
        if self.fused:
            xp = F.pad(rows, (0, 0, diff_ks, diff_ks))        # [R, L + 2(k-1), C]
            y = swiglu_ffn.swiglu_conv_deconv(
                xp, self.conv1d.weight, self.conv1d.bias, self.deconv1d.weight,
                self.deconv1d.bias, self.kernel, drop_rate, seed)[:, diff_ks:diff_ks + s2]
        else:
            y = F.pad(rows.transpose(1, 2),
                      (diff_ks, _pad_len(s2, self.kernel, self.shift) - s2 - diff_ks))
            y = F.conv1d(y, self.conv1d.weight.to(dt), self.conv1d.bias.to(dt),
                         stride=self.shift)
            y = y[:, :self.dim_inner] * F.silu(y[:, self.dim_inner:])
            if drop_rate > 0.0:
                y = D.apply_mask(y, inner_mask(seed, y, 0, drop_rate), drop_rate)
            y = F.conv_transpose1d(y, self.deconv1d.weight.to(dt),
                                   self.deconv1d.bias.to(dt), stride=self.shift)
            y = y[:, :, diff_ks:diff_ks + s2].transpose(1, 2)
        if drop_rate > 0.0:
            y = D.apply_mask(y, D.row_mask(seed, D.SITE_FFN_OUTER, y, 0, drop_rate), drop_rate)
        return y.reshape(b, s1, s2, c)

    def fused_step(self, x: torch.Tensor, gamma: torch.Tensor, num_groups: int,
                   eps: float, drop_rate: float = 0.0, seed: int = 0) -> torch.Tensor:
        """``x + FFN(RMSGroupNorm(x))`` for ``x [B, S1, S2, C]`` in one
        kernel step (stride 1); ``gamma`` is the pre-norm's scale."""
        b, s1, s2, c = x.shape
        rows = x.reshape(b * s1, s2, c).contiguous()
        mesh = tp_mesh()
        if mesh is None:
            y = fused_norm_ffn_residual(
                rows, gamma, self.conv1d.weight, self.conv1d.bias, self.deconv1d.weight,
                self.deconv1d.bias, self.kernel, num_groups, eps, drop_rate,
                dp_seed(seed, active_mesh()))
            return y.reshape(b, s1, s2, c)
        if self.mp != mesh.mp:
            raise ValueError(f"the active mesh splits over mp={mesh.mp}, the module's "
                             f"inner channels over {self.mp} "
                             f"(parallel/sharding.py::shard_module)")
        y = tp_ffn_step(rows, gamma, self.conv1d.weight, self.conv1d.bias,
                        self.deconv1d.weight, self.kernel, num_groups, eps, drop_rate, seed,
                        mesh)
        y = y + self.deconv1d.bias.to(y.dtype)
        if drop_rate > 0.0:
            y = D.apply_mask(y, D.row_mask(dp_seed(seed, mesh), D.SITE_FFN_OUTER, y, 0,
                                           drop_rate), drop_rate)
        return (rows + y).reshape(b, s1, s2, c)


class ConvDeconv1d(nn.Module):
    """The ``conv1d`` FFN: ``x [B, S1, S2, C]`` -> Conv1d -> SiLU -> dropout
    -> ConvTranspose1d -> crop -> dropout, computed in ``x.dtype``; dropout
    at the SwiGLU FFN's two sites (inner: row, conv position, inner channel;
    outer: row, position, channel), rows ``B*S1``."""

    def __init__(self, dim: int, dim_inner: int, conv1d_kernel: int, conv1d_shift: int,
                 fused: bool = False):
        super().__init__()
        self.dim_inner = dim_inner
        self.mp = 1
        self.kernel, self.shift = conv1d_kernel, conv1d_shift
        self.net = nn.Sequential(
            nn.Conv1d(dim, dim_inner, conv1d_kernel, stride=conv1d_shift), nn.SiLU(),
            nn.Identity(),   # the inner dropout site (the forward applies its mask)
            nn.ConvTranspose1d(dim_inner, dim, conv1d_kernel, stride=conv1d_shift))

    fused = False   # no kernel: the plain path in every mode

    def forward(self, x: torch.Tensor, drop_rate: float = 0.0,
                seed: int = 0) -> torch.Tensor:
        b, s1, s2, c = x.shape
        diff_ks = self.kernel - self.shift
        dt = x.dtype
        seed = dp_seed(seed, active_mesh())
        conv, deconv = self.net[0], self.net[3]
        y = F.pad(x.reshape(b * s1, s2, c).transpose(1, 2),
                  (diff_ks, _pad_len(s2, self.kernel, self.shift) - s2 - diff_ks))
        y = F.silu(F.conv1d(y, conv.weight.to(dt), conv.bias.to(dt), stride=self.shift))
        if drop_rate > 0.0:
            y = D.apply_mask(y, inner_mask(seed, y, 0, drop_rate), drop_rate)
        y = F.conv_transpose1d(y, deconv.weight.to(dt), deconv.bias.to(dt), stride=self.shift)
        y = y[:, :, diff_ks:diff_ks + s2].transpose(1, 2)
        if drop_rate > 0.0:
            y = D.apply_mask(y, D.row_mask(seed, D.SITE_FFN_OUTER, y, 0, drop_rate), drop_rate)
        return y.reshape(b, s1, s2, c)
