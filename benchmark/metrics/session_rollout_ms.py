"""Median duration of the rollouts (the program's ``dragposer.rollout``
spans: K2's steps and the select) inside the traced session frames, in ms;
about one traced frame in the window's length runs one."""

from benchmark import program_trace


def read(rec):
    spans = program_trace.session_spans(rec)
    if spans is None:
        return None
    return program_trace.median_ms(
        [program_trace.duration_us(s)
         for s in spans.within("dragposer.frame", "dragposer.rollout")])
