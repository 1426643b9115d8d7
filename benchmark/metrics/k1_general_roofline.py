"""K1's general build: the least time, at the card's peaks, of the
lane-steps its launches took (the program's "K1_general" records; the
configuration's widths, the weights counted once a launch whatever the
layout) over the build's kernel time in the traced pass, in percent."""

from benchmark import flops, readings
from benchmark.program_trace import launch_log


def read(rec):
    got = readings.offline_trace(rec)
    records = launch_log("K1_general")
    # a narrow launch would share the kernel's name in the trace
    if got is None or not records or launch_log("K1"):
        return None
    device = got[0].kernel_seconds("iter_block")
    if device <= 0:
        return None
    J, L, H1, H2, _ = readings.widths(rec)
    prod, rest = flops.k1_step_flops(J, L, H1, H2)
    weights = flops.k1_weight_bytes(J, L, H1, H2)
    least = 0.0
    for r in records:
        taken = int((r["t1"].long() - r["t0"].long()).sum())
        least += flops.least_seconds(
            taken * prod, taken * rest,
            weights + r["lanes"] * flops.k1_lane_bytes(J, L))
    return 100.0 * least / device
