"""The SMPL-H cell: found by name through files of its own, its seeded
weights, and the readers of K1's general build on stub launch records."""

import numpy as np
import pytest
import torch

from benchmark import flops, harness, profiling, program_trace
from benchmark.drivers import offline_rig

CELL = "offline_smplh52_equal"
READERS = ("k1_general_roofline", "k1_general_device_share",
           "k1_general_useful_step_share")


def test_the_cell_resolves_to_the_rig_driver():
    c = harness.cell(CELL)
    assert c.config["name"] == "smplh52_6trk" and c.chips == 1
    assert harness.driver(c.traffic["kind"]) is offline_rig
    assert len(c.config["skeleton"]["parents"]) == 52
    got = {m["name"] for m in c.per_layer}
    assert set(READERS) | {"mfu.offline"} == got
    assert {m["name"] for m in c.end_to_end} == {"frames_per_s", "setup_s"}


def test_seeded_weights_repeat_for_a_seed_and_differ_for_another():
    config = harness.cell(CELL).config

    def draw(seed):
        rng = np.random.default_rng(seed)
        return {**offline_rig.generator_arrays(config, rng),
                **offline_rig.temporal_arrays(config, rng)}

    a, b, c = draw(3), draw(3), draw(4)
    assert a.keys() == b.keys() == c.keys()
    assert all(np.array_equal(a[k], b[k]) for k in a)
    drawn = [k for k in a if a[k].any() and a[k].std() > 0]
    assert drawn and all(not np.array_equal(a[k], c[k]) for k in drawn)
    # the masked convolutions leave nought outside each neighbourhood
    assert (a["params/decoder/convs/2/w"] == 0).mean() > 0.5


def _record(lanes, t1, layout="streamed2"):
    return dict(lanes=lanes, t0=torch.zeros(lanes, dtype=torch.int32),
                t1=torch.as_tensor(t1, dtype=torch.int32), layout=layout,
                joints=52, plain=False)


def _rec(device):
    trace = profiling.Trace(wall_s=1e-3, device=device)
    return dict(config=harness.cell(CELL).config, traces=[trace],
                launches=object(), traced_outputs=[None])


@pytest.fixture
def records(monkeypatch):
    """Stub launch records by counter name, read through
    ``program_trace.launch_log`` as the readers read them."""
    logs = {"K1": [], "K1_general": []}
    monkeypatch.setattr(program_trace, "launch_log", lambda *names: [
        r for n in names for r in logs.get(n, [])])
    return logs


def test_readers_return_none_without_records(records):
    rec = _rec([(0.0, 3.0, "iter_block_kernel"), (3.0, 4.0, "other")])
    for name in READERS:
        assert harness.metric_reader(name).read(rec) is None
        assert harness.metric_reader(name).read({}) is None


def test_readers_on_stub_records(records):
    records["K1_general"] += [_record(4, [2, 4, 0, 4]),
                              _record(2, [1, 1])]
    rec = _rec([(0.0, 3.0, "iter_block_kernel<Build<128>>"),
                (2.0, 4.0, "temporal_forward")])
    read = {n: harness.metric_reader(n).read(rec) for n in READERS}
    # lane-steps taken 10 + 2 over lanes × the longest lane 16 + 2
    assert read["k1_general_useful_step_share"] == pytest.approx(
        100 * 12 / 18)
    # K1's 3 µs of the 4 µs in which the device was busy
    assert read["k1_general_device_share"] == pytest.approx(75.0)
    J, L, H1, H2 = 52, 24, 112, 132
    prod, rest = flops.k1_step_flops(J, L, H1, H2)
    least = sum(flops.least_seconds(
        n * prod, n * rest, flops.k1_weight_bytes(J, L, H1, H2)
        + lanes * flops.k1_lane_bytes(J, L)) for n, lanes in ((10, 4),
                                                               (2, 2)))
    assert read["k1_general_roofline"] == pytest.approx(
        100 * least / 3e-6)
    # a narrow launch shares the kernel's name: no time of the build alone
    records["K1"].append(_record(4, [1, 1, 1, 1]))
    assert harness.metric_reader("k1_general_roofline").read(rec) is None
    assert harness.metric_reader("k1_general_device_share").read(rec) \
        is None
