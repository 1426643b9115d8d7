"""Traced wall time of a pass over its blocks (K1 launches), in ms."""

from benchmark import readings


def read(rec):
    got = readings.offline_trace(rec)
    if got is None or not got[1].k1_steps:
        return None
    return 1e3 * got[0].wall_s / len(got[1].k1_steps)
