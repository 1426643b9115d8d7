"""The beam cell: found by name through files of its own, the readers of
the beam's spans on stub traces (and None without one), its trace read
from the profiler's raw events as ``profiling.traced`` reads them, and the
guard that refuses a program whose beam is not the pipelined one."""

import pytest

from benchmark import harness, profiling
from benchmark.drivers import offline_beam

CELL = "offline_3trk_beam"
READERS = ("beam_select_ms", "beam_outside_chunks_share")


def test_the_cell_resolves_to_the_beam_driver():
    c = harness.cell(CELL)
    assert c.config["name"] == "dancedb_3trk" and c.chips == 1
    assert harness.driver(c.traffic["kind"]) is offline_beam
    assert c.config["tracker"]["mask"].count(1) == 3
    assert c.config["search"]["restarts"] == 64
    got = {m["name"] for m in c.per_layer}
    assert set(READERS) | {"mfu.offline", "k1_roofline",
                           "k1_useful_step_share",
                           "pipeline_graph_block_share"} == got
    assert {m["name"] for m in c.end_to_end} == {"frames_per_s", "setup_s"}


def _rec(host):
    trace = profiling.Trace(wall_s=1.0, host=host)
    return dict(traces=[trace], launches=object(), traced_outputs=[None])


def _spans(beams):
    """Host spans of ``beams`` calls: each (start, end, [(chunk start,
    chunk end, select end)]) in µs."""
    host = []
    for lo, hi, chunks in beams:
        host.append((lo, hi, "dragposer.beam"))
        for a, b, c in chunks:
            host.append((a, b, "dragposer.beam.chunk"))
            host.append((b, c, "dragposer.beam.select"))
        host.append((chunks[-1][2], hi, "dragposer.beam.emit"))
    host.append((beams[0][0], beams[-1][1], "bench.pass"))
    return host


def test_readers_read_the_beam_spans():
    rec = _rec(_spans([(0.0, 10_000.0, [(0.0, 6_000.0, 6_100.0),
                                         (6_100.0, 9_000.0, 9_400.0)])]))
    select = harness.metric_reader("beam_select_ms").read(rec)
    outside = harness.metric_reader("beam_outside_chunks_share").read(rec)
    assert select == pytest.approx(0.25)          # median of 0.1 and 0.4
    assert outside == pytest.approx(100.0 * (10_000 - 8_900) / 10_000)


@pytest.mark.parametrize("rec", [
    dict(), dict(traces=[], launches=object()),
    _rec([(0.0, 5.0, "dragposer.pipeline"), (0.0, 5.0, "bench.pass")])],
    ids=["untraced", "no_trace", "no_beam_spans"])
def test_readers_read_nothing_without_the_spans(rec):
    for name in READERS:
        assert harness.metric_reader(name).read(rec) is None


def test_a_beam_on_the_anchor_is_refused(monkeypatch):
    from dragposer_tpu_torch.drag import hypotheses

    def anchor_beam(engine, generator, n_hypotheses, dqs, gp, gr, heights0,
                    initial_poses, *, lengths=None, branch_every=512,
                    sigma=0.25, survivors=8, init_noise=None,
                    resample_noise=None):
        raise AssertionError("never called")

    assert offline_beam.pipelined_beam() is hypotheses.run_hypotheses_batched
    monkeypatch.setattr(hypotheses, "run_hypotheses_batched", anchor_beam)
    with pytest.raises(TypeError, match="sync_k"):
        offline_beam.pipelined_beam()


def test_raw_events_read_as_the_profilers_own():
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("dragposer.beam"):
            x = torch.ones(3)
            for _ in range(20):
                x = x + 1
    trace = profiling.Trace()
    offline_beam.read_events(prof, trace)
    want = sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in prof.events())
    assert len(trace.host) == len(want) > 20 and not trace.device
    for a, b in zip(sorted(trace.host), want):
        assert a[2] == b[2]
        assert a[:2] == pytest.approx(b[:2], abs=1e-3)
