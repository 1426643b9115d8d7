"""Median over the traced session frames of one anchor iteration's host
time (the program's ``dragposer.anchor.step`` spans: ``_opt_body`` and
the select, the stop rule's check apart), in ms."""

from benchmark import program_trace


def read(rec):
    spans = program_trace.session_spans(rec)
    if spans is None:
        return None
    return program_trace.median_ms(
        [program_trace.duration_us(s)
         for s in spans.within("dragposer.frame", "dragposer.anchor.step")])
