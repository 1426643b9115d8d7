"""Lane-steps K1's general build took over the lanes of each launch times
its longest lane's steps (the program's "K1_general" records of the traced
pass), in percent: finished and padded lanes count as waste."""

from benchmark import readings
from benchmark.program_trace import launch_log


def read(rec):
    records = launch_log("K1_general")
    if readings.offline_trace(rec) is None or not records:
        return None
    steps = [r["t1"].long() - r["t0"].long() for r in records]
    issued = sum(int(s.max()) * r["lanes"] for s, r in zip(steps, records))
    return 100.0 * sum(int(s.sum()) for s in steps) / issued \
        if issued else None
