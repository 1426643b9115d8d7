"""Rows the traced pass's copies to the host kept (each lane's prefix
that holds data) over the rows of the outputs (lanes × frames, padding
included), summed over the program's ``"to_host"`` records, in percent;
None where the program keeps no such record."""

from benchmark import program_trace, readings


def read(rec):
    if readings.offline_trace(rec) is None:
        return None
    log = program_trace.launch_log("to_host")
    rows = sum(r["rows"] for r in log)
    if not rows:
        return None
    return 100.0 * sum(r["kept"] for r in log) / rows
