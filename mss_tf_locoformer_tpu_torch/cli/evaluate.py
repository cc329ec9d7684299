"""Evaluation CLI: the JAX package's ``cli/evaluate.py`` on the port, with
``--device`` (``cuda`` by default, ``cuda:N``, or ``cpu`` when asked for).

    python -m mss_tf_locoformer_tpu_torch.cli.evaluate --config configs/musdb18.yaml \\
        --checkpoint model.pth --device cuda [--bss_eval] [--save_audio]

Separates every full track of the dataset's ``test`` subset with the chunked
overlap-add engine and scores each stem (SI-SDR, SDR, SAR, SIR of
``eval/metrics.py``; with ``--bss_eval`` also BSS Eval v3's SDR, SIR, SAR as
``bss_*``).  A stereo model (BS-Locoformer with ``stereo``) is scored on
its stereo stems against the stereo targets; a mono model on mono stems
against the channel mean of the targets, as its mixture is.  Writes
``results.json`` with ``per_track`` (each track's stems and their
``average``) and ``summary`` (the mean over tracks) to ``--output_dir``.

``--distributed`` (torchrun) or the rank flags (``cli/train.py``) shard the
tracks round-robin over the ranks (``range(rank, len(ds), world)``, tails
included: each rank separates its tracks on its own card, so unequal
shares desynchronise nothing); one gather brings every rank's scores to
rank 0, which writes the one ``results.json`` a one-rank run writes, its
tracks in the same order.
"""

from __future__ import annotations

import argparse
import os

from .train import add_distributed_args, maybe_init_distributed


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Evaluate TF-Locoformer or BS-Locoformer MSS (PyTorch/CUDA)")
    p.add_argument("--config", type=str, required=True, help="YAML or JSON config")
    p.add_argument("--checkpoint", type=str, required=True,
                   help="PyTorch .pth (trainer dict, state_dict or ESPnet)")
    p.add_argument("--output_dir", type=str, default="./evaluation_results")
    p.add_argument("--save_audio", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default), cuda:N or cpu")
    p.add_argument("--chunk_seconds", type=float, default=8.0)
    p.add_argument("--overlap_seconds", type=float, default=1.0)
    p.add_argument("--batch_size", type=int, default=2)
    p.add_argument("--bss_eval", action="store_true",
                   help="Also compute BSS Eval v3 SDR/SIR/SAR per track")
    p.add_argument("--bss_filter_len", type=int, default=512)
    add_distributed_args(p)
    return p.parse_args(argv)


def main(argv=None):
    """Returns ``{"per_track": ..., "summary": ...}`` as written (None on
    the ranks other than 0)."""
    args = parse_args(argv)
    device = maybe_init_distributed(args)
    import numpy as np
    import torch
    import torch.distributed as dist

    from ..core.config import load_config
    from ..data.musdb import MUSDBDataset
    from ..eval.metrics import evaluate_source_separation, print_metrics
    from ..infer.separate import load_model, make_engine, model_input
    from ..parallel import multihost as MH
    from ..utils.audio import save_audio
    from ..utils.common import save_json

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: CUDA is not available")
    rank, world = MH.process_index(), MH.process_count()
    config = load_config(args.config)
    model, _ = load_model(args.checkpoint, args.config, device=device)
    dcfg = config.dataset
    ds = MUSDBDataset(dcfg.root_dir, subset="test", sample_rate=dcfg.sample_rate,
                      segment_length=None, sources=list(dcfg.sources),
                      return_metadata=True, verbose=True)
    engine = make_engine(model, args.chunk_seconds, args.overlap_seconds,
                         dcfg.sample_rate, args.batch_size, device)

    os.makedirs(args.output_dir, exist_ok=True)
    scored = []   # (index, name, scores) of this rank's tracks
    for i in range(rank, len(ds), world):
        sample = ds[i]
        name = sample["track_name"]
        targets = {k: model_input(model, sample[k]) for k in dcfg.sources if k in sample}
        stems = engine(model_input(model, sample["mixture"]))
        res = evaluate_source_separation(stems, targets, metrics=config.evaluation.metrics)
        if args.bss_eval:
            from ..eval.bss_eval import bss_eval_stems
            bss = bss_eval_stems(stems, targets, filter_len=args.bss_filter_len)
            for stem, vals in bss.items():
                res.setdefault(stem, {}).update({f"bss_{m}": v for m, v in vals.items()})
        scored.append((i, name, res))
        print(f"[{i + 1}/{len(ds)}] {name}: SI-SDR {res['average']['si_sdr']:.2f} dB")
        if args.save_audio:
            tdir = os.path.join(args.output_dir, name)
            os.makedirs(tdir, exist_ok=True)
            for stem, est in stems.items():
                save_audio(os.path.join(tdir, f"{stem}.wav"),
                           est if est.ndim == 2 else np.stack([est, est]), dcfg.sample_rate)

    if world > 1:
        parts = [None] * world
        dist.all_gather_object(parts, scored)
        scored = sorted(t for part in parts for t in part)
    per_track = {name: res for _, name, res in scored}
    if rank != 0:
        return None
    summary = {}
    for s in sorted({s for r in per_track.values() for s in r}):
        names = sorted({m for r in per_track.values() for m in r.get(s, {})})
        summary[s] = {m: float(np.mean([r[s][m] for r in per_track.values()
                                        if s in r and m in r[s]]))
                      for m in names}
    print("\n=== mean over tracks ===")
    print_metrics(summary)
    results = {"per_track": per_track, "summary": summary}
    path = os.path.join(args.output_dir, "results.json")
    save_json(results, path)
    print(f"Wrote {path}")
    return results


if __name__ == "__main__":
    main()
