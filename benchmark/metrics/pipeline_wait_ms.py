"""Median over the traced pass's blocks (the program's ``dragposer.block``
spans) of the time a block's host spends reading device values (its
``*.wait`` spans), in ms."""

from benchmark import program_trace, readings


def read(rec):
    got = readings.offline_trace(rec)
    if got is None:
        return None
    spans = program_trace.Spans(got[0])
    return program_trace.median_ms(
        [spans.wait_us(b) for b in spans.named("dragposer.block")])
