"""Lane-steps K1 took over the lanes in the batch times the steps of each
launch's longest lane, in percent: finished and padded lanes count as
waste, whatever K1's tiling."""

from benchmark import readings


def read(rec):
    got = readings.offline_trace(rec)
    if got is None:
        return None
    taken, issued = got[1].k1_totals()
    return 100.0 * taken / issued if issued else None
