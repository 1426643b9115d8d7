"""Mean Adam steps of a real frame (padding never counted): the stop
rule's work."""

import numpy as np

from benchmark import readings


def read(rec):
    got = readings.offline_trace(rec)
    if got is None:
        return None
    it = np.asarray(got[2].iterations)
    lengths = np.asarray(rec["lengths"])
    real = np.arange(it.shape[1])[None, :] < lengths[:, None]
    return float(it[real].mean())
