"""Share of the traced pass's wall time in which nothing ran on the device,
in percent (the profiler stretches the wall: an upper bound)."""

from benchmark import readings


def read(rec):
    got = readings.offline_trace(rec)
    if got is None or got[0].busy_s() <= 0:
        return None
    return 100.0 * (1.0 - got[0].busy_s() / got[0].wall_s)
