"""The control's readings at a cell's own size, for the limits of the
numbers that decide ``correct``:

    python -m h100_bench.readings --workload CELL --seeds 1,2,3

For each seed it simulates the cell's first input, runs the reference
computed in the precision below the configuration's (``reference.control``)
in the program's place, and judges it as the benchmark judges a sample; one
JSON line a seed.  The benchmark's own runs do not run it.  Needs no card."""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

from h100_bench import compare, harness
from h100_bench.reference.control import CONTROL


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m h100_bench.readings")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        work = tempfile.mkdtemp(prefix="h100_bench-readings-")
        try:
            t = time.perf_counter()
            _, (data,) = harness.prepare(cell, seed, work, card=False,
                                         inputs=1)
            checks = compare.control_checks(
                data, work, cell.traffic["pipeline"], cell.limits, CONTROL)
            print(json.dumps({"workload": cell.name, "seed": seed,
                              "control": CONTROL.name, "checks": checks,
                              "seconds": time.perf_counter() - t}),
                  flush=True)
        finally:
            shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
