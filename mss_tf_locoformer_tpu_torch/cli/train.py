"""Training CLI: the JAX package's ``cli/train.py`` flags, with ``--device``
(``cuda`` by default, ``cuda:N``, or ``cpu`` when asked for) -- the port
never falls back to the CPU on its own.

    python -m mss_tf_locoformer_tpu_torch.cli.train --config configs/musdb18.yaml \\
        --device cuda [--output_dir DIR] [--resume latest]

The config is YAML, or JSON of the same structure (no PyYAML needed).
``--distributed`` and the rank flags are accepted and refused: multi-device
runs are not ported yet (ROADMAP.md, Queue 1: parallel runs).
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train TF-Locoformer MSS (PyTorch/CUDA)")
    p.add_argument("--config", type=str, required=True, help="YAML or JSON config")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default), cuda:N or cpu")
    p.add_argument("--output_dir", type=str, default=None,
                   help="Output directory (overrides config paths)")
    p.add_argument("--resume", type=str, default=None,
                   help="Resume from the newest checkpoint: a checkpoint "
                        "directory, or any other value for the output directory's")
    add_distributed_args(p)
    return p.parse_args(argv)


def add_distributed_args(p) -> None:
    """The JAX CLIs' multi-host flags, accepted so that :func:`refuse_distributed`
    can refuse them."""
    p.add_argument("--distributed", action="store_true")
    p.add_argument("--coordinator_address", type=str, default=None)
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)


def refuse_distributed(args, what: str) -> None:
    if (args.distributed or args.coordinator_address is not None
            or args.num_processes is not None or args.process_id is not None):
        raise NotImplementedError(f"distributed {what} is not ported yet "
                                  f"(ROADMAP.md, Queue 1: parallel runs)")


def main(argv=None):
    args = parse_args(argv)
    refuse_distributed(args, "training")
    from ..core.config import load_config
    from ..train.loop import Trainer

    trainer = Trainer(load_config(args.config), device=args.device,
                      output_dir=args.output_dir, resume=args.resume)
    trainer.fit()
    return trainer


if __name__ == "__main__":
    main()
