"""The traced pass's ``dragposer.beam`` spans less their
``dragposer.beam.chunk`` spans (the selections, the back-trace and the
winners' copy to the host) over the ``dragposer.beam`` spans, in percent;
None where the program keeps no such span."""

from benchmark import program_trace, readings


def read(rec):
    got = readings.offline_trace(rec)
    if got is None:
        return None
    spans = program_trace.Spans(got[0])
    calls = spans.named("dragposer.beam")
    total = sum(program_trace.duration_us(c) for c in calls)
    if total <= 0:
        return None
    chunks = sum(program_trace.duration_us(s) for c in calls
                 for s in spans.inside(c, "dragposer.beam.chunk"))
    return 100.0 * (total - chunks) / total
