"""Checkpoint conversion CLI: a reference ``.pth`` -> the port's ``.pth``
(the JAX package's ``cli/convert.py``, ``.pth`` side).

    python -m mss_tf_locoformer_tpu_torch.cli.convert --input ref.pth \\
        --output model.pth [--config configs/musdb18.yaml]

Reads either reference layout -- the trainer-wrapped ``model_state_dict``
(``inference/separate.py:107-110`` of the reference) or ESPnet's flat dict
with ``separator.`` prefixes (``README.md:522-531``), or a bare state_dict
-- through ``convert/torch_ckpt.py::load_torch_checkpoint``, and writes the
port's state_dict (the reference's key schema) as ``.pth``, which
``infer/separate.py::load_model`` and the trainer load with
``strict=True``.  With ``--config``, the model that config builds is loaded
from it with ``strict=True`` before anything is written.

The JAX CLI's other direction, flax/orbax -> ``.pth``, needs JAX and orbax,
which the GPU machine has none of: an orbax directory raises, naming the
JAX package's ``cli/convert.py``, which exports it to ``.pth``.
"""

from __future__ import annotations

import argparse
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Convert a reference .pth into the port's .pth")
    p.add_argument("--input", type=str, required=True,
                   help="Reference checkpoint (.pth/.pt/.ckpt): trainer-wrapped, ESPnet "
                        "or a bare state_dict")
    p.add_argument("--output", type=str, required=True, help="Destination .pth")
    p.add_argument("--config", type=str, default=None,
                   help="Optional model config (YAML or JSON): load the result into its "
                        "model with strict=True before writing")
    return p.parse_args(argv)


def main(argv=None):
    """Returns the state_dict written."""
    args = parse_args(argv)
    if os.path.isdir(args.input):
        raise ValueError(
            f"{args.input} is a directory (an orbax checkpoint?): orbax needs JAX, which "
            f"this package does not use; export it to .pth with the JAX package's CLI, "
            f"python -m mss_tf_locoformer_tpu.cli.convert --input {args.input} "
            f"--output model.pth, then convert that file here")
    if not args.input.endswith((".pth", ".pt", ".ckpt")):
        raise ValueError(f"{args.input}: expected a .pth/.pt/.ckpt file")
    import torch

    from ..convert.torch_ckpt import load_torch_checkpoint

    state_dict = load_torch_checkpoint(args.input)
    if args.config is not None:
        from ..core.config import load_model_config
        from ..models import build_model
        build_model(load_model_config(args.config)).load_state_dict(state_dict, strict=True)
    torch.save(state_dict, args.output)
    n = sum(v.numel() for v in state_dict.values())
    print(f"torch -> torch: {len(state_dict)} tensors, {n / 1e6:.2f} M values -> {args.output}")
    return state_dict


if __name__ == "__main__":
    main()
