"""The benchmark of duet_tpu_torch on one NVIDIA card.

    python3 h100_bench/run.py --workload CELL --seed N --seconds S --trace 0|1

Runs the cell of ``BENCHMARK.json`` named CELL once: its inputs simulated
from the seed, the program built, a cold sample and a warm-up sample on
each other input (or a second on the one), then whole samples one after
another for S seconds, the inputs in turn (``harness.run_cell``), and the
check of each input's first sample against the plain reference.  The
last line of standard output is the result as one JSON object: the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics.  The
numbers compared with the reference, each with its limit (each at its
worst over the inputs), are the last lines of standard error and the
result's last key.  Exits with 1, printing no result, when torch sees
fewer cards than the cell asks for or when JAX or the JAX package
``duet_tpu`` was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from h100_bench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="h100_bench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    harness.cache_env()
    cell = harness.load_cell(args.workload)
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), t0=T0)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
