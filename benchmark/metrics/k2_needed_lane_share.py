"""Lanes that began a real frame at a window boundary over the lanes K2's
rollouts ran, summed over the rollouts of the traced pass (the program's
rollout records), in percent: the rest are lanes of finished, padded or
unadvanced frames, rolled out and dropped."""

from benchmark import program_trace, readings


def read(rec):
    if readings.offline_trace(rec) is None:
        return None
    log = program_trace.launch_log("rollout")
    ran = sum(r["lanes"] for r in log)
    if not ran:
        return None
    return 100.0 * sum(program_trace.needed_lanes(r) for r in log) / ran
