"""The reader of ``pipeline_graph_block_share``: the program's ``"block"``
launch records (one a pipeline block, ``plain`` false where its
bookkeeping was a replay of the block's CUDA graph) over the traced pass.

On the CPU every block is eager, so an offline pass reads 0%, one record a
``dragposer.block`` span; the share of replays is checked on stub records,
and a program that keeps no record reads nothing."""

import time

import numpy as np

from benchmark import harness, profiling, program_trace
from benchmark.drivers import common, offline_batch


def read(rec, cell):
    return harness.metric_reader("pipeline_graph_block_share").read(
        dict(rec, cell=cell))


def test_offline_pass_on_the_cpu_reads_no_replay(small):
    from torch.profiler import ProfilerActivity, profile

    from dragposer_tpu_torch import _build

    c = small("offline_6trk_mixed")
    traffic = dict(c.traffic, optimizer=dict(c.traffic["optimizer"],
                                             max_iter=12))
    s = offline_batch.Setup(c.config, traffic, 2147483903, "cpu")
    s.one_pass(frames=4)
    _build.clear_launch_logs()
    trace = profiling.Trace()
    launches = common.Launches()
    with launches.recording(), profile(
            activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        _, out = s.one_pass()
        trace.wall_s = time.perf_counter() - t0
    trace.host = [(float(e.time_range.start), float(e.time_range.end),
                   e.name) for e in prof.events()]
    rec = dict(config=c.config, traffic=c.traffic, traces=[trace],
               traced_outputs=[out], launches=launches, lengths=s.lengths)
    assert read(rec, c) == 0.0
    log = program_trace.launch_log("block")
    blocks = program_trace.Spans(trace).named("dragposer.block")
    assert len(log) == len(blocks) == len(launches.k1_steps) > 0
    assert all(r["plain"] and not r["capture"] for r in log)


def test_share_counts_replays(small, monkeypatch):
    """Graph replays over all block records, in an offline pass only."""
    c = small("offline_4trk_equal")
    records = [dict(lanes=8, capture=True, plain=False)] \
        + [dict(lanes=8, capture=False, plain=False)] * 2 \
        + [dict(lanes=8, capture=False, plain=True)]
    monkeypatch.setattr(program_trace, "launch_log",
                        lambda *names: records if names == ("block",)
                        else [])
    empty = profiling.Trace(wall_s=1.0)
    offline = dict(traces=[empty], launches=common.Launches(),
                   traced_outputs=[None], lengths=np.ones(3))
    assert read(offline, c) == 75.0
    online = dict(traces=[empty], latency_ms=np.ones(3), traced_frames=3)
    assert read(online, c) is None
    records.clear()
    assert read(offline, c) is None


def test_a_program_without_records_reads_nothing():
    from dragposer_tpu_torch import _build

    c = harness.cell("offline_smplh52_equal")
    _build.clear_launch_logs()
    empty = profiling.Trace(wall_s=1.0)
    offline = dict(traces=[empty], launches=common.Launches(),
                   traced_outputs=[None], lengths=np.ones(3))
    assert read(offline, c) is None
