"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout, on a machine with the GPUs the cell asks for.
The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``compared``: each number held against the plain
reference, with its limit); the numbers compared end standard error too.
``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics.  Exits non-zero, printing no result, without the GPUs,
without the program, or with the JAX package loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from benchmark import harness  # noqa: E402

T_START = harness.process_start()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    os.environ.setdefault("USE_FLAX", "0")

    import torch

    cell = harness.cell(a.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{a.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    driver = harness.driver(cell.traffic["kind"])
    out = driver.run(cell, a.seed, a.seconds, bool(a.trace), "cuda", T_START)
    out.device = {**harness.device_description(cell.chips), **out.device}
    line = harness.result_line(cell, out, bool(a.trace))
    loaded = harness.forbidden_loaded()
    if loaded:
        print("the JAX side was loaded: " + ", ".join(loaded), file=sys.stderr)
        return 3
    for x in out.checks:
        print(f"{x.name} {x.value!r} limit {x.limit!r} "
              f"{'ok' if x.ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
