"""Operations the traced pass's inputs need (K1 per lane-step taken, K2 per
needed rollout, the epilogue's decode per frame) over its wall time at the
products' peak (``flops.PRODUCTS_PEAK``), in percent."""

from benchmark import flops, readings


def read(rec):
    got = readings.offline_trace(rec)
    if got is None or not got[1].k1_steps:
        return None
    work = readings.model_flops(rec, got[1], rec["lengths"])
    return 100.0 * work / (got[0].wall_s * flops.PRODUCTS_PEAK)
