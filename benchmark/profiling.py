"""Reads a ``torch.profiler`` trace: device time by kernel, the device's busy
time, and the longest idle gaps with what the host was doing in each.

The profiler's own overhead stretches the traced wall time, so the idle
share of a traced window is an upper bound on the untraced one.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

SPAN_PREFIX = "bench."   # the harness's own spans (record_function names)


@dataclass
class Trace:
    wall_s: float = 0.0
    device: List[Tuple[float, float, str]] = field(default_factory=list)
    host: List[Tuple[float, float, str]] = field(default_factory=list)

    def kernel_seconds(self, part: str) -> float:
        """Device seconds of the operations whose name holds ``part``."""
        return sum(e - s for s, e, n in self.device if part in n) / 1e6

    def kernel_count(self) -> int:
        return len(self.device)

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device."""
        busy, end = 0.0, float("-inf")
        for s, e, _ in sorted(self.device):
            if e <= end:
                continue
            busy += e - max(s, end)
            end = e
        return busy / 1e6

    def top_ops(self, n: int = 10) -> List[list]:
        by: Dict[str, float] = {}
        for s, e, name in self.device:
            key = name[:80]
            by[key] = by.get(key, 0.0) + (e - s) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda x: -x[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """Idle device seconds summed by what the host was doing at each
        gap's middle: the harness's innermost span and the innermost
        operation there."""
        ops = sorted(self.host)
        starts = [s for s, _, _ in ops]
        spans = sorted(h for h in self.host if h[2].startswith(SPAN_PREFIX))
        span_starts = [s for s, _, _ in spans]

        def active(items, keys, t, depth=400):
            i = bisect.bisect_right(keys, t) - 1
            for j in range(i, max(i - depth, -1), -1):
                if items[j][1] >= t:
                    return items[j][2]
            return "-"

        by: Dict[str, float] = {}
        end = None
        for s, e, _ in sorted(self.device):
            if end is not None and s > end:
                mid = (s + end) / 2
                key = (active(spans, span_starts, mid, 10 ** 6) + " / "
                       + active(ops, starts, mid))[:80]
                by[key] = by.get(key, 0.0) + (s - end) / 1e6
            end = e if end is None else max(end, e)
        return [[k, v] for k, v in sorted(by.items(), key=lambda x: -x[1])[:n]]


@contextlib.contextmanager
def traced():
    """Profile the body (host and device) and yield a :class:`Trace` that is
    filled when the body ends."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    trace = Trace()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        yield trace
        torch.cuda.synchronize()
        trace.wall_s = time.perf_counter() - t0
    for e in prof.events():
        r = e.time_range
        item = (float(r.start), float(r.end), e.name)
        if e.device_type == DeviceType.CUDA:
            # an annotation on the device's timeline spans kernels: skip it
            if not getattr(e, "is_user_annotation", False):
                trace.device.append(item)
        else:
            trace.host.append(item)


def span(name: str):
    """A host span of the harness in the trace."""
    import torch

    return torch.profiler.record_function(SPAN_PREFIX + name)
