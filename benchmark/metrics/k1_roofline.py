"""K1's least time at the card's peaks, for the lane-steps its launches
took (never those issued), over its device time in the traced pass, in
percent."""

from benchmark import readings


def read(rec):
    got = readings.offline_trace(rec)
    if got is None or not got[1].k1_steps:
        return None
    device = got[0].kernel_seconds("iter_block")
    if device <= 0:
        return None
    return 100.0 * readings.k1_least_seconds(rec, got[1]) / device
