"""Readings from which the limits of ``limits/<workload>.json`` are set:
the judge's numbers for the program on many seeds, and, with ``--control``,
for faults planted in the program's outputs and for the control, the
reference itself in the program's place with TF32 products.

    python3 benchmark/calibrate.py --workload <name> --seeds 11 12 13 \
        [--control] [--seconds 10]

One process for all seeds: the engine and the kernels are built once.  Each
driver's ``calibrate(cell, seed, seconds, control)`` says what one seed
runs.  One JSON line per seed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark import harness  # noqa: E402


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", action="store_true")
    p.add_argument("--seconds", type=float, default=10.0)
    a = p.parse_args()
    cell = harness.cell(a.workload)
    driver = harness.driver(cell.traffic["kind"])
    for seed in a.seeds:
        t0 = time.perf_counter()
        res = driver.calibrate(cell, seed, a.seconds, a.control)
        res.update(workload=a.workload, seed=seed,
                   seconds=time.perf_counter() - t0)
        print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
