"""Median over the traced pass's resampling points of the beam's
selection (the program's ``dragposer.beam.select`` spans: a chunk's
scores to the next chunk's states), in ms; None where the program keeps
no such span."""

from benchmark import program_trace, readings


def read(rec):
    got = readings.offline_trace(rec)
    if got is None:
        return None
    return program_trace.median_ms([
        program_trace.duration_us(s) for s in
        program_trace.Spans(got[0]).named("dragposer.beam.select")])
