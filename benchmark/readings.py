"""Quantities the per-layer readers share, from a run's recording: the
model's widths and the operations of the window's work.  Each returns None
where the recording holds nothing to read."""

from __future__ import annotations

import numpy as np

from benchmark import flops


def widths(rec) -> tuple:
    """(joints, latent, hidden 1, hidden 2, encoder rows) of the model."""
    w = rec["config"]["vae"]["decoder_widths"]
    s_enc = len(rec["config"]["temporal"]["past_frames"]) - 1
    return (w[3] - 4) // 4, w[0], w[1], w[2], s_enc


def offline_trace(rec):
    """(trace, launches, outputs) of the first traced pass, or None."""
    if not rec.get("traces") or "launches" not in rec:
        return None
    return rec["traces"][0], rec["launches"], rec["traced_outputs"][0]


def k1_launch_steps(launches) -> list:
    """Lane-steps taken by each K1 launch."""
    return [int(s.sum()) for s in launches.k1_steps]


def k1_least_seconds(rec, launches) -> float:
    J, L, H1, H2, _ = widths(rec)
    prod, rest = flops.k1_step_flops(J, L, H1, H2)
    total = 0.0
    for s in launches.k1_steps:
        taken = int(s.sum())
        nbytes = (flops.k1_weight_bytes(J, L, H1, H2)
                  + s.shape[0] * flops.k1_lane_bytes(J, L))
        total += flops.least_seconds(taken * prod, taken * rest, nbytes)
    return total


def k2_least_seconds(launches) -> float:
    total = 0.0
    for lanes, s_enc, s_dec in launches.k2_calls:
        prod, attn = flops.k2_lane_flops(s_enc, s_dec)
        nbytes = flops.k2_weight_bytes() + lanes * flops.k2_lane_bytes(
            s_enc, s_dec)
        total += flops.least_seconds(lanes * prod, lanes * attn, nbytes)
    return total


def model_flops(rec, launches, lengths) -> float:
    """Operations the window's inputs need: K1's per lane-step taken, K2's
    per rollout the lanes' frames need, the epilogue's decode per frame."""
    J, L, H1, H2, s_enc = widths(rec)
    prod, rest = flops.k1_step_flops(J, L, H1, H2)
    k1 = sum(k1_launch_steps(launches)) * (prod + rest)
    window = rec["config"]["tracker"]["temporal_future_window"]
    step = rec["config"]["temporal"]["sample_step"]
    frames = int(np.sum(lengths))
    if window == 0:
        k2 = frames * sum(flops.k2_lane_flops(s_enc, 1))
    else:
        steps = window // step + 1
        rollouts = int(np.sum(-(-np.asarray(lengths) // window)))
        k2 = rollouts * steps * sum(flops.k2_lane_flops(s_enc, steps))
    return k1 + k2 + frames * flops.decode_flops(J, L, H1, H2)
