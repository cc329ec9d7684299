"""Speech-separation evaluation CLI (the JAX package's
``cli/evaluate_speech.py``), with ``--device`` (``cuda`` by default,
``cuda:N``, or ``cpu`` when asked for).

    python -m mss_tf_locoformer_tpu_torch.cli.evaluate_speech \\
        --config configs/speech_wsj0_2mix.yaml --checkpoint model.pth \\
        [--data_dir DIR] [--max_utts N] --device cuda

Separates every full utterance (mono) with ``SpeechSeparator``, assigns the
estimates to the references by the permutation of largest summed SI-SNR,
scores SI-SNR, SDR and STOI per utterance and writes ``results.json`` with
``mean`` and ``per_utterance`` to ``--output_dir``.  The separator's blocks
run in fp32, as the JAX CLI's (``load_speech_separator``'s default).
"""

from __future__ import annotations

import argparse
import itertools
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Evaluate the TF-Locoformer speech separator (PyTorch/CUDA)")
    p.add_argument("--config", type=str, required=True,
                   help="Speech-task YAML or JSON (configs/speech_*.yaml)")
    p.add_argument("--checkpoint", type=str, required=True,
                   help="PyTorch .pth (trainer checkpoint, state_dict or ESPnet)")
    p.add_argument("--data_dir", type=str, default=None,
                   help="Corpus root to evaluate (default: config valid_dir)")
    p.add_argument("--output_dir", type=str, default="./speech_eval")
    p.add_argument("--max_utts", type=int, default=0, help="0 = all")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default), cuda:N or cpu")
    return p.parse_args(argv)


def main(argv=None):
    """Returns ``{"mean": ..., "per_utterance": ...}`` as written."""
    args = parse_args(argv)
    import numpy as np
    import torch

    from ..core.config import load_speech_config
    from ..data.speech import SpeechMixtureDataset
    from ..eval.metrics import compute_sdr, compute_si_sdr
    from ..eval.stoi import compute_stoi
    from ..infer.separate import load_speech_separator
    from ..models.espnet_compat import SpeechSeparator
    from ..utils.common import save_json

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: CUDA is not available")
    cfg = load_speech_config(args.config)
    d = cfg.dataset
    ds = SpeechMixtureDataset(args.data_dir or d.valid_dir or d.root_dir,
                              num_spk=d.num_spk, mix_dir=d.mix_dir, spk_dirs=d.spk_dirs,
                              segment_length=None, sample_rate=d.sample_rate)
    pipe = SpeechSeparator(load_speech_separator(args.checkpoint, cfg, device=device),
                           n_fft=cfg.stft.n_fft, hop_length=cfg.stft.hop_length)
    per_utt = {}
    sums = {"si_snr": 0.0, "sdr": 0.0, "stoi": 0.0}
    n_utts = len(ds) if args.max_utts <= 0 else min(args.max_utts, len(ds))
    for i in range(n_utts):
        item = ds[i]
        mix = item["mixture"].mean(axis=0)            # mono [T]
        refs = item["sources"].mean(axis=1)           # [S, T]
        est = pipe(mix)[0]                            # [S, T]
        s = refs.shape[0]
        best = max(itertools.permutations(range(s)), key=lambda p: sum(
            compute_si_sdr(est[j], refs[p[j]]) for j in range(s)))
        si = np.mean([compute_si_sdr(est[j], refs[best[j]]) for j in range(s)])
        sd = np.mean([compute_sdr(est[j], refs[best[j]]) for j in range(s)])
        st = np.mean([compute_stoi(refs[best[j]], est[j], d.sample_rate) for j in range(s)])
        per_utt[item["name"]] = {"si_snr": float(si), "sdr": float(sd), "stoi": float(st)}
        for k, v in zip(sums, (si, sd, st)):
            sums[k] += float(v)
        print(f"[{i + 1}/{n_utts}] {item['name']}: SI-SNR {si:.2f} dB  "
              f"SDR {sd:.2f} dB  STOI {st:.3f}", flush=True)

    mean = {k: v / max(n_utts, 1) for k, v in sums.items()}
    print(f"MEAN over {n_utts} utts: SI-SNR {mean['si_snr']:.2f} dB  "
          f"SDR {mean['sdr']:.2f} dB  STOI {mean['stoi']:.3f}")
    os.makedirs(args.output_dir, exist_ok=True)
    results = {"mean": mean, "per_utterance": per_utt}
    path = os.path.join(args.output_dir, "results.json")
    save_json(results, path)
    print(f"Wrote {path}")
    return results


if __name__ == "__main__":
    main()
