"""Published peaks of the cards the benchmark runs on (NVIDIA data sheets,
dense rates without sparsity, at the part's full power limit), matched on
``torch.cuda.get_device_name()`` in order.  Every FLOP is held to the dense
bf16 rate, the card's highest for the precisions the port computes in, so
that no share of a peak can pass 100% whatever implements an op."""

from __future__ import annotations

from typing import Optional, Tuple

# (name fragment, dense bf16 FLOP/s, HBM bytes/s)
_CARDS = (
    ("h100 pcie", 756.5e12, 2.0e12),
    ("h100 nvl", 835.5e12, 3.9e12),
    ("h100", 989.4e12, 3.35e12),      # SXM5: "NVIDIA H100 80GB HBM3"
)


def peaks(name: str) -> Optional[Tuple[float, float]]:
    """``(bf16 FLOP/s, bytes/s)`` of the card named ``name``, or None."""
    name = name.lower()
    for key, flops, bw in _CARDS:
        if key in name:
            return flops, bw
    return None
