"""The readers of the program's own spans and launch records, on the small
cells' program on the CPU: a pass and a few session frames under a CPU
profiler, with the harness's ``Launches`` recording beside them.

Each reader returns a number in the cells it lists and None in the others;
the program's K1 and K2 records equal ``Launches``' launch for launch (the
ground on which the readers of ``Launches`` can move to the program's
records)."""

import contextlib
import time

import numpy as np
import pytest
import torch

from benchmark import harness, profiling, program_trace
from benchmark.drivers import common, offline_batch, session

NEW = ("pipeline_host_ms", "pipeline_wait_ms", "pipeline_outside_blocks_ms",
       "k2_needed_lane_share", "anchor_step_host_ms",
       "anchor_iterations_per_frame", "session_rollout_ms")


@contextlib.contextmanager
def cpu_traced():
    """``profiling.traced`` on the CPU: the host's events only."""
    from torch.profiler import ProfilerActivity, profile

    trace = profiling.Trace()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        yield trace
        trace.wall_s = time.perf_counter() - t0
    trace.host = [(float(e.time_range.start), float(e.time_range.end),
                   e.name) for e in prof.events()]


def fresh_logs():
    from dragposer_tpu_torch import _build

    _build.clear_launch_logs()


def logs_equal_launches(launches):
    k1 = program_trace.launch_log("K1", "K1_general")
    assert len(k1) == len(launches.k1_steps)
    for r, steps in zip(k1, launches.k1_steps):
        assert torch.equal(r["t1"] - r["t0"], steps)
        assert r["lanes"] == steps.shape[0]
    k2 = program_trace.launch_log("K2")
    assert [(r["lanes"], r["s_enc"], r["s_dec"]) for r in k2] \
        == launches.k2_calls


def readings(rec, cell):
    return {m: harness.metric_reader(m).read(dict(rec, cell=cell))
            for m in NEW}


def listed(name):
    return {m["name"] for m in harness.cell(name).per_layer} & set(NEW)


@pytest.mark.parametrize("name", ["offline_6trk_mixed", "offline_4trk_equal"])
def test_offline_readers(small, name):
    c = small(name)
    # a short optimizer budget: the readers, not the fit, are under test
    traffic = dict(c.traffic, optimizer=dict(c.traffic["optimizer"],
                                             max_iter=12))
    s = offline_batch.Setup(c.config, traffic, 2147483901, "cpu")
    s.one_pass(frames=4)
    fresh_logs()
    launches = common.Launches()
    with launches.recording(spans=True), cpu_traced() as tr:
        _, out = s.one_pass()
    rec = dict(config=c.config, traffic=c.traffic, traces=[tr],
               traced_outputs=[out], launches=launches, lengths=s.lengths)
    got = readings(rec, c)
    assert {m for m, v in got.items() if v is not None} == listed(name)
    blocks = program_trace.Spans(tr).named("dragposer.block")
    assert len(blocks) == len(launches.k1_steps) > 0
    assert got["pipeline_host_ms"] > 0 and got["pipeline_wait_ms"] > 0
    assert got["pipeline_outside_blocks_ms"] > 0
    assert 0 < got["k2_needed_lane_share"] <= 100
    logs_equal_launches(launches)
    if c.config["tracker"]["temporal_future_window"] == 0:
        # every real frame began at a boundary, once
        needed = sum(program_trace.needed_lanes(r)
                     for r in program_trace.launch_log("rollout"))
        assert needed == int(np.sum(s.lengths))
    # the harness's K1 spans lie inside the program's K1 phases
    spans = program_trace.Spans(tr)
    k1 = [h for h in tr.host if h[2] == profiling.SPAN_PREFIX + "K1"]
    assert len(k1) == len(blocks)
    assert all(any(p[0] <= h[0] and h[1] <= p[1]
                   for p in spans.named("dragposer.block.k1")) for h in k1)


def test_session_readers(small):
    c = small("session_4trk")
    s = session.start(c, 1.0, "cpu")
    window = c.config["tracker"]["temporal_future_window"]
    first = c.traffic["warmup_frames"]
    fresh_logs()
    launches = common.Launches()
    with launches.recording(spans=True), cpu_traced() as tr:
        for i in range(first, first + window + 1):
            with profiling.span("frame"):
                s.send(i)
    s.close()
    rec = dict(traces=[tr], latency_ms=np.zeros(window + 1),
               traced_frames=window + 1, k2_moved=np.zeros(0, bool))
    got = readings(rec, c)
    assert {m for m, v in got.items() if v is not None} \
        == listed("session_4trk")
    assert 1 <= got["anchor_iterations_per_frame"] \
        <= c.traffic["optimizer"]["max_iter"]
    assert got["anchor_step_host_ms"] > 0 and got["session_rollout_ms"] > 0
    spans = program_trace.Spans(tr)
    assert len(spans.named("dragposer.frame")) == window + 1
    # one rollout in a window's frames, each of its steps a K2 launch
    assert len(spans.named("dragposer.rollout")) == 1
    logs_equal_launches(launches)
    assert launches.k2_calls and not launches.k1_steps


def test_readers_of_a_program_without_spans_read_nothing(small):
    """What the readers find where the program opens no span and keeps no
    record: nothing, and no error."""
    c = small("offline_6trk_mixed")
    empty = profiling.Trace(wall_s=1.0)
    fresh_logs()
    offline = dict(config=c.config, traffic=c.traffic, traces=[empty],
                   traced_outputs=[None], launches=common.Launches(),
                   lengths=np.ones(3))
    online = dict(traces=[empty], latency_ms=np.ones(3), traced_frames=3,
                  k2_moved=np.zeros(3, bool))
    for rec in (offline, online):
        assert all(v is None for v in readings(rec, c).values())
