"""Pipeline blocks whose bookkeeping ran as a replay of the program's CUDA
graph over all blocks of the traced pass (the program's ``"block"`` launch
records, ``plain`` false for a replay), in percent; None where the program
keeps no such record."""

from benchmark import program_trace, readings


def read(rec):
    if readings.offline_trace(rec) is None:
        return None
    log = program_trace.launch_log("block")
    if not log:
        return None
    return 100.0 * sum(not r.get("plain", True) for r in log) / len(log)
