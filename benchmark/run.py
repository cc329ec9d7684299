"""Run one cell of ``BENCHMARK.json`` once on this machine's card.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the cell's end-to-end metrics (``--trace 0``) or its per-layer
metrics, the device's busy time and a breakdown (``--trace 1``) as one JSON
line, the last of standard output, after the numbers compared with the
reference and their limits on standard error.  Exits 2 without a result
when the machine lacks the cards the cell asks for, and 3 when the process
holds JAX or the JAX package once the window has closed.
"""

import time

T0 = time.perf_counter()

import argparse   # noqa: E402
import json       # noqa: E402
import os         # noqa: E402
import sys        # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    try:
        harness.check_card(cell.chips)
    except harness.NoCard as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    import torch
    outcome = harness.runner_module(cell).run(cell, args.seed, args.seconds, bool(args.trace),
                                              T0, "cuda")
    bad = harness.forbidden_modules()
    if bad:
        print(f"benchmark: the process holds {', '.join(bad)}", file=sys.stderr)
        return 3
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
            "memory_peak_bytes": outcome.memory_peak}
    line = harness.result_line(cell, outcome, bool(args.trace), info)
    print(f"benchmark: numbers {json.dumps(outcome.checks)}", file=sys.stderr)
    for key, value in outcome.detail.items():
        if key != "leaves":        # every leaf's norms: for readings.py's record
            print(f"benchmark: {key} {json.dumps(value)}", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
