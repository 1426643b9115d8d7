"""The program's own spans (``dragposer.*``, ``torch.profiler`` ranges it
opens itself) in a traced window, and its launch records: what the readers
of the program's phases share.  A program without them (older than its
spans) gives no span and no record, and its readers return None."""

from __future__ import annotations

import bisect
import statistics
from typing import List, Optional, Tuple

PREFIX = "dragposer."
Span = Tuple[float, float, str]      # (start µs, end µs, name)


class Spans:
    """The program's spans of one trace, sorted by start (the outer first
    where two start together)."""

    def __init__(self, trace):
        self.all: List[Span] = sorted(
            (h for h in trace.host if h[2].startswith(PREFIX)),
            key=lambda s: (s[0], -s[1]))
        self.starts = [s[0] for s in self.all]

    def named(self, name: str) -> List[Span]:
        return [s for s in self.all if s[2] == name]

    def inside(self, outer: Span, name: Optional[str] = None) -> List[Span]:
        """The spans within ``outer`` (by time), of ``name`` if given."""
        lo = bisect.bisect_left(self.starts, outer[0])
        hi = bisect.bisect_right(self.starts, outer[1])
        return [s for s in self.all[lo:hi] if s is not outer
                and s[1] <= outer[1] and (name is None or s[2] == name)]

    def wait_us(self, outer: Span) -> float:
        """µs of the outermost ``*.wait`` spans within ``outer``: the host
        reading device values there."""
        total, end = 0.0, float("-inf")
        for s in self.inside(outer):
            if s[2].endswith(".wait") and s[0] >= end:
                total += s[1] - s[0]
                end = s[1]
        return total

    def within(self, outer_name: str, name: str) -> List[Span]:
        """The spans ``name`` within any span ``outer_name``."""
        return [s for o in self.named(outer_name)
                for s in self.inside(o, name)]


def duration_us(s: Span) -> float:
    return s[1] - s[0]


def median_ms(us: List[float]) -> Optional[float]:
    return statistics.median(us) / 1e3 if us else None


def session_spans(rec) -> Optional[Spans]:
    """The traced session frames' spans, or None outside a session."""
    if not rec.get("traces") or "latency_ms" not in rec:
        return None
    return Spans(rec["traces"][0])


def launch_log(*names: str) -> list:
    """The program's launch records of the counters ``names`` (the K1
    builds: "K1", "K1_general"; "K2"; "rollout"), made while the window
    was traced; empty where the program keeps none."""
    from dragposer_tpu_torch import _build

    read = getattr(_build, "launch_log", None)
    return read(*names) if read is not None else []


def needed_lanes(record: dict) -> int:
    """The lanes of a rollout record that began a real frame at a window
    boundary: ``need``, and where the pipeline logged each lane's
    ``frame`` (after the advance) and ``limit``, ``frame < limit``."""
    need = record["need"]
    if record.get("frame") is not None:
        need = need & (record["frame"] < record["limit"])
    return int(need.sum())
