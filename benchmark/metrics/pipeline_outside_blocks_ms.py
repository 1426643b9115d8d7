"""The traced pass's ``dragposer.pipeline`` span less its blocks
(``dragposer.block``): the prologue, the outputs' allocation, the first
loop check and the epilogue's decode, in ms."""

from benchmark import program_trace, readings


def read(rec):
    got = readings.offline_trace(rec)
    if got is None:
        return None
    spans = program_trace.Spans(got[0])
    pipes = spans.named("dragposer.pipeline")
    if not pipes:
        return None
    return sum(program_trace.duration_us(p) - sum(
        program_trace.duration_us(b)
        for b in spans.inside(p, "dragposer.block")) for p in pipes) / 1e3
