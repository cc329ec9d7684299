"""Training CLI: the JAX package's ``cli/train.py`` flags, with ``--device``
(``cuda`` by default, ``cuda:N``, or ``cpu`` when asked for) -- the port
never falls back to the CPU on its own.

    python -m mss_tf_locoformer_tpu_torch.cli.train --config configs/musdb18.yaml \\
        --device cuda [--output_dir DIR] [--resume latest]

The config is YAML, or JSON of the same structure (no PyYAML needed).

A parallel run is one process per GPU, ``config.mesh`` (``dp``, ``mp``)
laying them out (``parallel/``)::

    torchrun --nproc_per_node 4 -m mss_tf_locoformer_tpu_torch.cli.train \
        --config train.yaml --distributed --output_dir exp

``--distributed`` reads torchrun's environment; ``--coordinator_address
host:port --num_processes N --process_id I`` (the JAX CLI's flags) start a
rank without it.  Each rank takes the card of its local rank (``--device
cuda``) over NCCL; ranks that share one card (``--device cuda:0``) go over
gloo, as CPU ranks do.
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
    """The JAX CLIs' multi-process flags, shared by the training, speech
    training and evaluation CLIs."""
    p.add_argument("--distributed", action="store_true",
                   help="One process per GPU under torch.distributed (torchrun's "
                        "environment, or the flags below)")
    p.add_argument("--coordinator_address", type=str, default=None,
                   help="host:port of rank 0 (without torchrun)")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)


def maybe_init_distributed(args, timeout: float = 1800.0) -> str:
    """Start the process group when the flags ask for one; returns the
    device this rank runs on (``args.device`` without one)."""
    if args.distributed or args.coordinator_address is not None:
        from ..parallel.multihost import initialize
        return str(initialize(coordinator_address=args.coordinator_address,
                              num_processes=args.num_processes,
                              process_id=args.process_id, device=args.device,
                              timeout=timeout))
    if args.num_processes is not None or args.process_id is not None:
        # rank flags alone would run N independent jobs against one output_dir
        raise SystemExit("--num_processes/--process_id require --distributed "
                         "(torchrun) or --coordinator_address host:port")
    return args.device


def main(argv=None):
    args = parse_args(argv)
    device = maybe_init_distributed(args)
    from ..core.config import load_config
    from ..train.loop import Trainer

    trainer = Trainer(load_config(args.config), device=device,
                      output_dir=args.output_dir, resume=args.resume)
    trainer.fit()
    return trainer


if __name__ == "__main__":
    main()
