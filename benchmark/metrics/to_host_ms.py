"""The traced pass's copy of its outputs to the host (the program's
``dragposer.to_host`` spans, summed), in ms; None where the program keeps
no such span."""

from benchmark import program_trace, readings


def read(rec):
    got = readings.offline_trace(rec)
    if got is None:
        return None
    spans = program_trace.Spans(got[0]).named("dragposer.to_host")
    if not spans:
        return None
    return sum(program_trace.duration_us(s) for s in spans) / 1e3
