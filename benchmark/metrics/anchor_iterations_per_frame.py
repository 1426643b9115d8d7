"""Anchor iterations (``dragposer.anchor.step`` spans) per traced session
frame (``dragposer.frame`` spans): Adam's steps a frame under the stop
rule and ``max_iter``."""

from benchmark import program_trace


def read(rec):
    spans = program_trace.session_spans(rec)
    if spans is None or not spans.named("dragposer.frame"):
        return None
    steps = spans.within("dragposer.frame", "dragposer.anchor.step")
    return len(steps) / len(spans.named("dragposer.frame"))
