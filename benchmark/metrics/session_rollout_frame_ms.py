"""Median latency of the untraced window frames in which K2's launch counter
moved (the frames that run the rollout), in ms."""

import numpy as np


def read(rec):
    if "k2_moved" not in rec or not rec["k2_moved"].size:
        return None
    n = rec["traced_frames"]
    lat, moved = rec["latency_ms"][n:], rec["k2_moved"][n:]
    if not moved.any():
        return None
    return float(np.median(lat[moved]))
