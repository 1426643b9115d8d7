"""The port's spans and launch records (``dragposer_tpu_torch.tracing``,
``_build.KernelCounts.log``) on the CPU, under a CPU ``torch.profiler``: a
small pipelined pass at 6 trackers (window 0) and at 4 (window 16, more
lanes than the rollout's lane budget), and a few session frames through
``runtime/capi``.

The spans nest as ``tracing``'s table states; the records add up to what
the outputs show (K1's lane-steps to the frames' iterations, the rollouts'
needed lanes to the lanes' lengths at window 0, K2's launches to the
rollouts' steps); with no profiler, no span is entered and no record kept.
"""

import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke

torch.set_num_threads(1)
MODEL_DIR = "models/model_dancedb_example"
LENGTHS = np.array([10, 7, 10, 3, 9, 10], np.int32)
# 12 lanes, more than the rollout's budget of 8 at window 16; past frame 16
# the lanes reach their window boundary in different blocks
WINDOWED_LENGTHS = np.array([20, 17, 20, 18] * 3, np.int32)
SYNC_K, MAX_ITER = 4, 8
PHASES = ("k1", "finish", "begin", "targets", "wait")


def _engine(config, clip_path):
    from dragposer_tpu_torch.cli import eval_drag
    from dragposer_tpu_torch.data import encoding
    from dragposer_tpu_torch.io.bvh import BVH
    from dragposer_tpu_torch.ops.topology import Skeleton

    bvh = BVH().load(clip_path)
    _, _, parents, offsets, _ = encoding.info_from_bvh(bvh)
    engine, means, stds = eval_drag.build_engine(
        MODEL_DIR, parents, eval_drag.resolve_config(config),
        skeleton=Skeleton.build(parents, offsets, bvh.names),
        max_iter=MAX_ITER, device="cpu")
    _, _, n = eval_drag._encode(clip_path, engine.skeleton, means, stds)
    return engine, n


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tracing") / "clip.bvh")
    chip_smoke.synthetic_bvh(32, seed=5).save(path)
    return path


def _pass(config, lengths, clip):
    """The engine, one pipelined pass's inputs and a function running it
    (the outputs on the host)."""
    from dragposer_tpu_torch.drag.engine import to_host

    engine, n = _engine(config, clip)
    T, B = int(lengths.max()), len(lengths)
    lanes = lambda a: np.stack([np.roll(a, -i, 0)[:T]  # noqa: E731
                                for i in range(B)])
    dqs, gp, gr = lanes(n.dqs), lanes(n.global_pos), lanes(n.global_rot)
    heights0 = np.repeat(n.heights[:1], B, 0)

    def run():
        states = engine.init_state(torch.Generator().manual_seed(3),
                                   dqs[:, 0][:, :, None], gp[:, 0], gr[:, 0],
                                   heights0)
        _, out = engine.run_batch_pipelined(states, dqs, gp, gr,
                                            sync_k=SYNC_K, lengths=lengths)
        return to_host(out)
    return engine, run


def _spans(prof):
    """The ``dragposer.*`` spans of a profile: (start, end, name), sorted
    by start, the outer one first where two start together."""
    return sorted(((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.name.startswith("dragposer.")),
                  key=lambda s: (s[0], -s[1]))


def _inside(spans, outer, name=None):
    return [s for s in spans if outer[0] <= s[0] and s[1] <= outer[1]
            and s is not outer and (name is None or s[2] == name)]


def _profiled(run):
    from dragposer_tpu_torch import _build

    _build.clear_launch_logs()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = run()
    return out, _spans(prof)


def _logs():
    from dragposer_tpu_torch import _build

    return (_build.launch_log("K1", "K1_general"), _build.launch_log("K2"),
            _build.launch_log("rollout"))


def _real(out, lengths):
    return np.arange(out.iterations.shape[1])[None] < lengths[:, None]


@pytest.fixture(scope="module")
def six(clip):
    from dragposer_tpu_torch import tracing

    engine, run = _pass("6_trackers", LENGTHS, clip)
    out, spans = _profiled(run)
    return engine, out, spans, _logs(), tracing.counter_totals()


@pytest.fixture(scope="module")
def four(clip):
    engine, run = _pass("4_trackers", WINDOWED_LENGTHS, clip)
    out, spans = _profiled(run)
    return engine, out, spans, _logs(), None


@pytest.mark.parametrize("case", ["six", "four"])
def test_pipeline_spans_nest(case, request):
    _, _, spans, (k1, _, _), _ = request.getfixturevalue(case)
    pipes = [s for s in spans if s[2] == "dragposer.pipeline"]
    assert len(pipes) == 1
    pipe = pipes[0]
    blocks = _inside(spans, pipe, "dragposer.block")
    assert blocks and len(blocks) == len(k1)
    for name in ("prologue", "epilogue", "wait"):
        (part,) = _inside(spans, pipe, "dragposer.pipeline." + name)
        assert not any(_inside([part] + blocks, b) == [part] for b in blocks)
    for b in blocks:
        inner = [s for s in _inside(spans, b)
                 if s[2].startswith("dragposer.block.")]
        assert [s[2] for s in inner] == ["dragposer.block." + p
                                         for p in PHASES]
        (k1_span,) = _inside(spans, b, "dragposer.block.k1")
        assert not _inside(spans, k1_span)    # K1: no span inside
    (host,) = [s for s in spans if s[2] == "dragposer.to_host"]
    assert host[0] >= pipe[1]
    assert _inside(spans, host, "dragposer.to_host.wait")
    rollouts = [s for s in spans if s[2] == "dragposer.rollout"]
    phases = [s for s in spans if s[2] in ("dragposer.block.begin",
                                          "dragposer.pipeline.prologue")]
    assert rollouts and all(any(_inside([r], p) == [r] for p in phases)
                            for r in rollouts)


@pytest.mark.parametrize("case, lengths", [("six", LENGTHS),
                                           ("four", WINDOWED_LENGTHS)])
def test_k1_lane_steps_equal_the_frames_iterations(case, lengths, request):
    _, out, _, (k1, _, _), _ = request.getfixturevalue(case)
    taken = sum(int((r["t1"] - r["t0"]).sum()) for r in k1)
    assert taken == int(out.iterations[_real(out, lengths)].sum()) > 0
    assert all(r["lanes"] == len(lengths) for r in k1)


def test_window_0_needed_lanes_equal_the_lengths(six):
    from dragposer_tpu_torch import tracing

    _, _, _, (k1, _, rollouts), totals = six
    needed = sum(int(tracing.needed_lanes(r)) for r in rollouts)
    assert needed == int(LENGTHS.sum())
    # the prologue's rollout and one a block, each on the whole batch
    assert len(rollouts) == len(k1) + 1
    assert all(r["lanes"] == len(LENGTHS) for r in rollouts)
    assert totals["rollout_needed_lanes"] == needed
    assert totals["rollout_lanes"] == len(LENGTHS) * len(rollouts)


@pytest.mark.parametrize("case", ["six", "four"])
def test_k2_log_matches_the_rollouts(case, request):
    engine, _, spans, (_, k2, rollouts), _ = request.getfixturevalue(case)
    h = engine.hyper
    steps = h.temporal_future_window // h.sample_step + 1
    s_enc = len(h.past_frames) - 1
    # each step of a rollout runs the decoder over all its rows, masked
    want = [(r["lanes"], s_enc, steps) for r in rollouts
            for _ in range(steps)]
    assert [(r["lanes"], r["s_enc"], r["s_dec"]) for r in k2] == want
    assert len([s for s in spans if s[2] == "dragposer.rollout"]) \
        == len(rollouts)


def test_windowed_rollouts_run_sub_batches(four):
    """12 lanes at window 16: the budget is 8, so the prologue's rollout
    runs on every lane and later ones on the lanes that need it, where
    they are 8 or fewer."""
    from dragposer_tpu_torch import tracing

    _, _, spans, (_, _, rollouts), _ = four
    lanes = [r["lanes"] for r in rollouts]
    assert lanes[0] == len(WINDOWED_LENGTHS) and min(lanes) < 8
    assert all(int(r["need"].sum()) == r["lanes"] for r in rollouts
               if r["lanes"] <= 8)
    assert all(int(tracing.needed_lanes(r)) <= r["lanes"] for r in rollouts)
    waits = [s for s in spans if s[2] == "dragposer.rollout.wait"]
    assert len(waits) >= len(rollouts) - 1


@pytest.fixture
def counted_record_function(monkeypatch):
    calls = []
    real = torch.profiler.record_function

    def counted(name, *a, **k):
        calls.append(name)
        return real(name, *a, **k)
    monkeypatch.setattr(torch.profiler, "record_function", counted)
    return calls


def test_no_profiler_enters_no_span_and_keeps_no_record(
        clip, counted_record_function):
    from dragposer_tpu_torch import _build

    _, run = _pass("6_trackers", LENGTHS, clip)
    _build.clear_launch_logs()
    before = _build.kernel_launches()
    run()
    assert counted_record_function == []
    assert all(not log for log in _logs())
    after = _build.kernel_launches()
    assert after["K1_plain"] > before["K1_plain"]
    assert after["K2_plain"] > before["K2_plain"]
    # the same pass under a profiler enters them
    _profiled(run)
    assert "dragposer.block" in counted_record_function
    assert all(log for log in _logs())


def _session(clip, window):
    """A capi session on the CPU at 4 trackers and ``window``, warmed up,
    and a function sending its frame ``i``."""
    from dragposer_tpu_torch import config as cfg
    from dragposer_tpu_torch.runtime import capi

    wp, wq = _trackers(clip)
    c = cfg.BUILTIN_CONFIGS["4_trackers"]
    mask = c.mask_array().astype(np.float32)
    idx = np.nonzero(mask)[0]
    h = capi.init("cpu")
    capi.set_reference_skeleton(h, clip)
    capi.load_models(h, MODEL_DIR)
    capi.set_mask_and_weights(h, mask.astype("<f4").tobytes(),
                              c.weights_array().astype("<f4").tobytes())
    capi.set_lambdas(h, 1.0, 0.125, window)
    capi.set_optim_params(h, 1e-4, 0.01, 10, 0.01)
    capi.init_drag_model(h, *map(float, wp[0, 0]), *map(float, wq[0, 0]))

    def send(i):
        p = (wp[i, idx] - wp[i - 1, 0]).astype("<f4")
        r = wq[i, idx].astype("<f4")
        return capi.drag_pose(h, p.tobytes(), r.tobytes(), len(idx))
    return h, send


def _trackers(clip):
    from dragposer_tpu_torch.io.bvh import BVH

    return chip_smoke.clip_trackers(BVH().load(clip))


@pytest.fixture(scope="module")
def session(clip):
    from dragposer_tpu_torch import _build
    from dragposer_tpu_torch.runtime import capi

    window, frames = 4, 9
    h, send = _session(clip, window)
    try:
        send(1)
        _build.clear_launch_logs()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for i in range(2, 2 + frames):
                send(i)
        return window, frames, _spans(prof), _logs()
    finally:
        capi.destroy(h)


def test_session_frame_spans_nest(session):
    window, frames, spans, (k1, k2, rollouts) = session
    top = [s for s in spans if s[2] == "dragposer.frame"]
    assert len(top) == frames and not k1
    steps = 0
    for f in top:
        kids = [s[2] for s in _inside(spans, f)
                if s[2].startswith("dragposer.frame.")
                and not s[2].endswith(".wait")]
        assert kids == ["dragposer.frame.begin", "dragposer.frame.finish",
                        "dragposer.frame.reply", "dragposer.frame.reply"]
        (begin,) = _inside(spans, f, "dragposer.frame.begin")
        assert _inside(spans, begin, "dragposer.frame.begin.wait")
        (finish,) = _inside(spans, f, "dragposer.frame.finish")
        n = len(_inside(spans, f, "dragposer.anchor.step"))
        assert 1 <= n <= 10
        assert len(_inside(spans, f, "dragposer.anchor.wait")) == n + 1
        assert all(begin[1] <= s[0] and s[1] <= finish[0]
                   for s in _inside(spans, f, "dragposer.anchor.step"))
        replies = _inside(spans, f, "dragposer.frame.reply")
        assert _inside(spans, replies[1], "dragposer.frame.reply.wait")
        steps += n
    # a rollout at each window boundary (the warm-up frame was slot 0, so
    # traced frame k is slot k % window), inside its frame's begin
    rolls = [s for s in spans if s[2] == "dragposer.rollout"]
    boundaries = sum(1 for k in range(1, frames + 1) if k % window == 0)
    assert len(rolls) == len(rollouts) == boundaries > 0
    for r in rolls:
        assert any(_inside([r], b) == [r] for b in spans
                   if b[2] == "dragposer.frame.begin")
    assert all(r["lanes"] == 1 and r["frame"] is None for r in rollouts)
    assert len(k2) == len(rollouts) * (window // 4 + 1)   # sample_step 4


def test_eval_drag_profile_writes_the_counters(tmp_path, capsys):
    from dragposer_tpu_torch.cli import eval_drag

    files = chip_smoke.write_synthetic_clips(str(tmp_path), (8, 5), seed=11)
    prof = tmp_path / "prof"
    eval_drag.main([MODEL_DIR, *files, "--batch", "--device", "cpu",
                    "--profile", str(prof), "--save-dir",
                    str(tmp_path / "out")])
    assert "counters" in capsys.readouterr().out
    with open(prof / "counters.json") as f:
        c = json.load(f)
    with open(prof / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"dragposer.pipeline", "dragposer.block",
            "dragposer.to_host"} <= names
    assert c["k1_launches"] > 0 and c["k2_launches"] == c["k1_launches"] + 1
    assert 0 < c["k1_lane_steps"] <= c["k1_lane_steps_issued"]
    assert c["rollout_needed_lanes"] == 8 + 5
    assert c["rollout_lanes"] == c["k2_lanes"] == 2 * c["k2_launches"]
    assert os.path.exists(prof / "trace.json")
