"""Mixed-precision policy with fp32 islands.

As in the JAX package (``core/precision.py``): parameters live in fp32,
block compute runs in ``compute_dtype`` (bf16 for inference by default), and
four sites run in fp32 whatever the compute dtype:

  * the Conv2d encoder + GroupNorm,
  * the ConvTranspose2d decoder,
  * RMSGroupNorm,
  * RoPE rotation.

Softmax statistics inside attention are always fp32.

An fp32 island must be fp32 on the card too, so importing this module turns
TF32 off for matmuls and for cuDNN convolutions (cuDNN's default is TF32,
about three decimal digits).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = ["Precision", "FP32", "BF16", "precision_from_name",
           "precision_from_amp"]

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@dataclass(frozen=True)
class Precision:
    """Parameters and islands are always fp32; this picks the blocks' dtype."""

    compute_dtype: torch.dtype = torch.float32

    def cast_compute(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.compute_dtype)


FP32 = Precision()
BF16 = Precision(compute_dtype=torch.bfloat16)


def precision_from_name(name: str) -> Precision:
    """``"bf16"`` (the inference default) or ``"fp32"``."""
    if name == "bf16":
        return BF16
    if name == "fp32":
        return FP32
    raise ValueError(f"unknown precision {name!r} (expected bf16|fp32)")


def precision_from_amp(use_amp: bool, amp_dtype: str = "bfloat16") -> Precision:
    """The training config's ``use_amp``/``amp_dtype`` as a policy; float16
    maps to bf16, as in the JAX package."""
    if not use_amp or amp_dtype == "float32":
        return FP32
    if amp_dtype in ("bfloat16", "float16"):
        return BF16
    raise ValueError(f"unknown amp_dtype {amp_dtype}")
