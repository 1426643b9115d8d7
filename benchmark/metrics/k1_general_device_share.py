"""K1's general build's kernel time over the device's busy time in the
traced pass, in percent: how much of the device's work the build is."""

from benchmark import readings
from benchmark.program_trace import launch_log


def read(rec):
    got = readings.offline_trace(rec)
    # a narrow launch would share the kernel's name in the trace
    if got is None or not launch_log("K1_general") or launch_log("K1"):
        return None
    busy = got[0].busy_s()
    if busy <= 0:
        return None
    return 100.0 * got[0].kernel_seconds("iter_block") / busy
