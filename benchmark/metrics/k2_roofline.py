"""K2's least time at the card's peaks over its device time, summed over the
traced pass's launches, in percent."""

from benchmark import readings


def read(rec):
    got = readings.offline_trace(rec)
    if got is None or not got[1].k2_calls:
        return None
    device = got[0].kernel_seconds("temporal_forward")
    if device <= 0:
        return None
    return 100.0 * readings.k2_least_seconds(got[1]) / device
