"""Separation CLI: the JAX package's ``cli/separate.py`` flags, with
``--device`` (``cuda`` by default, ``cuda:N``, or ``cpu`` when asked for) —
the port never falls back to the CPU on its own.  The config's ``model:``
section picks the family: ``name: bslocoformer`` (``stereo: true`` writes
true stereo stems) or TF-Locoformer.

    python -m mss_tf_locoformer_tpu_torch.cli.separate --input mix.wav \\
        --checkpoint model.pth --config configs/musdb18.yaml --device cuda
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Separate music sources using TF-Locoformer or BS-Locoformer "
                    "(PyTorch/CUDA)")
    p.add_argument("--input", type=str, required=True, help="Input WAV file")
    p.add_argument("--output_dir", type=str, default="./separated")
    p.add_argument("--checkpoint", type=str, required=True,
                   help="PyTorch .pth (trainer dict, state_dict or ESPnet)")
    p.add_argument("--config", type=str, default=None,
                   help="Config file whose model: section is read (YAML or JSON)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default), cuda:N or cpu")
    p.add_argument("--sample_rate", type=int, default=44100)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--chunk_seconds", type=float, default=8.0)
    p.add_argument("--overlap_seconds", type=float, default=1.0)
    p.add_argument("--batch_size", type=int, default=2)
    p.add_argument("--precision", type=str, default="bf16", choices=("bf16", "fp32"),
                   help="Block compute precision (fp32 islands kept either way)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import torch

    from ..core.precision import precision_from_name
    from ..infer.separate import load_model, separate_audio

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: CUDA is not available")
    torch.manual_seed(args.seed)
    model, _ = load_model(args.checkpoint, args.config,
                          precision=precision_from_name(args.precision),
                          device=device)
    stems = separate_audio(
        args.input, args.output_dir, model, sample_rate=args.sample_rate,
        chunk_seconds=args.chunk_seconds, overlap_seconds=args.overlap_seconds,
        batch_size=args.batch_size, device=device)
    print(f"Saved {len(stems)} stems to {args.output_dir}")


if __name__ == "__main__":
    main()
