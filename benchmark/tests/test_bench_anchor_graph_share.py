"""The reader of ``anchor_graph_step_share``: the program's ``"anchor"``
launch records (one an anchor iteration, ``plain`` false for a replay of
the iteration's CUDA graph) over the traced session frames.

On the CPU every anchor iteration is an eager step, so a session reads 0%;
the share of replays is checked on stub records, and a program that keeps
no record reads nothing."""

import time

import numpy as np

from benchmark import harness, profiling, program_trace
from benchmark.drivers import session


def read(rec, cell):
    return harness.metric_reader("anchor_graph_step_share").read(
        dict(rec, cell=cell))


def test_session_on_the_cpu_reads_no_replay(small):
    from torch.profiler import ProfilerActivity, profile

    from dragposer_tpu_torch import _build

    c = small("session_4trk")
    s = session.start(c, 1.0, "cpu")
    first = c.traffic["warmup_frames"]
    frames = 3
    _build.clear_launch_logs()
    trace = profiling.Trace()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        for i in range(first, first + frames):
            with profiling.span("frame"):
                s.send(i)
        trace.wall_s = time.perf_counter() - t0
    s.close()
    trace.host = [(float(e.time_range.start), float(e.time_range.end),
                   e.name) for e in prof.events()]
    rec = dict(traces=[trace], latency_ms=np.zeros(frames),
               traced_frames=frames, k2_moved=np.zeros(0, bool))
    assert read(rec, c) == 0.0
    log = program_trace.launch_log("anchor")
    steps = program_trace.Spans(trace).named("dragposer.anchor.step")
    # one record an iteration, each iteration one step span
    assert len(log) == len(steps) >= frames
    assert all(r["plain"] and not r["capture"] for r in log)


def test_share_counts_replays(small, monkeypatch):
    """Graph replays over all anchor records, in a session's trace only."""
    c = small("session_4trk")
    records = [dict(lanes=1, capture=False, plain=False)] * 3 \
        + [dict(lanes=1, capture=False, plain=True)]
    monkeypatch.setattr(program_trace, "launch_log",
                        lambda *names: records if names == ("anchor",)
                        else [])
    empty = profiling.Trace(wall_s=1.0)
    online = dict(traces=[empty], latency_ms=np.ones(3), traced_frames=3)
    assert read(online, c) == 75.0
    offline = dict(traces=[empty], traced_outputs=[None])
    assert read(offline, c) is None
    records.clear()
    assert read(online, c) is None


def test_a_program_without_records_reads_nothing(small):
    from dragposer_tpu_torch import _build

    c = small("session_4trk")
    _build.clear_launch_logs()
    empty = profiling.Trace(wall_s=1.0)
    online = dict(traces=[empty], latency_ms=np.ones(3), traced_frames=3,
                  k2_moved=np.zeros(3, bool))
    assert read(online, c) is None
