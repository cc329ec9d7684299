"""Speech-separation training CLI: the JAX package's ``cli/train_speech.py``
flags, with ``--device`` (``cuda`` by default, ``cuda:N``, or ``cpu`` when
asked for).

    python -m mss_tf_locoformer_tpu_torch.cli.train_speech \\
        --config configs/speech_wsj0_2mix.yaml --device cuda [--output_dir DIR] \\
        [--resume latest]

The config is YAML, or JSON of the same structure (no PyYAML needed).
``--distributed`` and the rank flags start a parallel run as in
``cli/train.py``, laid out by ``config.mesh``.
"""

from __future__ import annotations

import argparse

from .train import add_distributed_args, maybe_init_distributed


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Train the TF-Locoformer speech separator (PyTorch/CUDA)")
    p.add_argument("--config", type=str, required=True,
                   help="Speech-task YAML or JSON (configs/speech_*.yaml)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default), cuda:N or cpu")
    p.add_argument("--output_dir", type=str, default=None)
    p.add_argument("--resume", type=str, default=None,
                   help="Resume from the newest checkpoint: a checkpoint "
                        "directory, or any other value for the output directory's")
    add_distributed_args(p)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = maybe_init_distributed(args)
    from ..core.config import load_speech_config
    from ..train.speech import SpeechTrainer

    trainer = SpeechTrainer(load_speech_config(args.config), device=device,
                            output_dir=args.output_dir, resume=args.resume)
    trainer.fit()
    return trainer


if __name__ == "__main__":
    main()
