"""Anchor iterations that ran as a replay of the program's CUDA graph over
all anchor iterations of the traced session frames (the program's
``"anchor"`` launch records, ``plain`` false for a replay), in percent;
None where the program keeps no such record."""

from benchmark import program_trace


def read(rec):
    if program_trace.session_spans(rec) is None:
        return None
    log = program_trace.launch_log("anchor")
    if not log:
        return None
    return 100.0 * sum(not r.get("plain", True) for r in log) / len(log)
