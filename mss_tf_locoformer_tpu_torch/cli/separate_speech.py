"""Speech separation CLI: mixture WAV(s) -> one WAV per speaker (the JAX
package's ``cli/separate_speech.py``), with ``--device`` (``cuda`` by
default, ``cuda:N``, or ``cpu`` when asked for).

    python -m mss_tf_locoformer_tpu_torch.cli.separate_speech \\
        --config configs/speech_wsj0_2mix.yaml --checkpoint model.pth \\
        --input mix_dir_or.wav --output_dir out --device cuda

Each mixture is read mono at the config's rate, zero-padded up to a multiple
of ``--bucket_seconds`` (the JAX CLI's static-shape buckets; 0: no padding),
separated by ``models/espnet_compat.SpeechSeparator`` and cropped back.  The
padding enters the std normalisation, so the outputs equal the JAX CLI's
only with the same bucket.  Writes ``{input}_spk{i}.wav`` without peak
normalisation.  The separator's blocks run in fp32, as the JAX CLI's
(``load_speech_separator``'s default; on the card the fp32 step kernels of
``ops/cuda/step_fp32.py``).
"""

from __future__ import annotations

import argparse
import glob
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Separate speech mixtures into per-speaker WAVs (PyTorch/CUDA)")
    p.add_argument("--config", type=str, required=True,
                   help="Speech-task YAML or JSON (configs/speech_*.yaml)")
    p.add_argument("--checkpoint", type=str, required=True,
                   help="PyTorch .pth (trainer checkpoint, state_dict or ESPnet)")
    p.add_argument("--input", type=str, required=True,
                   help="Mixture WAV, or a directory of them")
    p.add_argument("--output_dir", type=str, default="./separated_speech")
    p.add_argument("--bucket_seconds", type=float, default=1.0,
                   help="Zero-pad inputs up to this granularity (0 = no padding)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default), cuda:N or cpu")
    return p.parse_args(argv)


def main(argv=None):
    """Returns ``{input path: [S, T] estimates}``."""
    args = parse_args(argv)
    import numpy as np
    import torch

    from ..core.config import load_speech_config
    from ..infer.separate import load_speech_separator
    from ..models.espnet_compat import SpeechSeparator
    from ..utils.audio import load_audio, save_audio

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: CUDA is not available")
    cfg = load_speech_config(args.config)
    sr = cfg.dataset.sample_rate
    pipe = SpeechSeparator(load_speech_separator(args.checkpoint, cfg, device=device),
                           n_fft=cfg.stft.n_fft, hop_length=cfg.stft.hop_length)

    if os.path.isdir(args.input):
        paths = sorted(p for e in ("wav", "flac", "WAV", "FLAC")
                       for p in glob.glob(os.path.join(args.input, f"*.{e}")))
        if not paths:
            raise FileNotFoundError(f"No WAV or FLAC files in {args.input}")
    else:
        paths = [args.input]

    bucket = max(0, int(args.bucket_seconds * sr))
    os.makedirs(args.output_dir, exist_ok=True)
    out = {}
    for i, path in enumerate(paths):
        audio, _ = load_audio(path, sample_rate=sr, mono=True)
        mix = audio[0]
        t = mix.shape[0]
        if bucket:
            mix = np.pad(mix, (0, max(bucket, -(-t // bucket) * bucket) - t))
        est = pipe(mix)[0][:, :t]                                      # [S, T]
        base = os.path.splitext(os.path.basename(path))[0]
        for s in range(est.shape[0]):
            # no peak normalisation: the pipeline restored the input's scale
            save_audio(os.path.join(args.output_dir, f"{base}_spk{s + 1}.wav"), est[s],
                       sr, normalize=False)
        out[path] = est
        print(f"[{i + 1}/{len(paths)}] {base}: wrote {est.shape[0]} speakers "
              f"to {args.output_dir}", flush=True)
    return out


if __name__ == "__main__":
    main()
