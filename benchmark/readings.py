"""The readings that a cell's limits are set from (``PERF.md``): the numbers
compared with the reference, for the program, for the control (the
reference one precision down in the program's place) and for the program
with a fault planted (``faults.py``), seed by seed, in one process so that
set-up and a training cell's reference are paid once per seed.

    python3 benchmark/readings.py --workload base-train --seeds 11 12 13 \\
        --seconds 3 --modes program control half_loss swapped --out readings.jsonl

Each run appends one JSON line: cell, seed, mode, checks, detail.  Checks
never run it.
"""

import argparse
import gc
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import faults, harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--modes", nargs="+", default=["program", "control"])
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    harness.check_card(cell.chips)
    import torch
    runner = harness.runner_module(cell)
    planted = faults.SEPARATION if cell.traffic["runner"] == "separate" else faults.TRAINING
    # a training cell's reference readings, kept by seed across modes
    kw = {"cache": {}} if cell.traffic["runner"] == "train" else {}
    for seed in args.seeds:
        for mode in args.modes:
            t0 = time.perf_counter()
            if mode == "program":
                outcome = runner.run(cell, seed, args.seconds, False, t0, "cuda", **kw)
            elif mode == "control":
                outcome = runner.run(cell, seed, args.seconds, False, t0, "cuda",
                                     harness.control_of(cell), **kw)
            else:
                with faults.patched(planted[mode]):
                    outcome = runner.run(cell, seed, args.seconds, False, t0, "cuda", **kw)
            row = {"cell": cell.name, "seed": seed, "mode": mode, "checks": outcome.checks,
                   "attempted": outcome.attempted, "detail": outcome.detail,
                   "wall_s": time.perf_counter() - t0}
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
            print(f"{cell.name} seed {seed} {mode}: {json.dumps(outcome.checks)} "
                  f"({row['wall_s']:.1f} s)", flush=True)
            del outcome
            gc.collect()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
