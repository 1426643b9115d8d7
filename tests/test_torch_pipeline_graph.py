"""The pipeline's block bookkeeping as a CUDA graph (``pipeline._BlockGraph``,
held by an engine's ``_graphs.Holder``) and the eager blocks it
stands in for (``graphs=None``, as the CPU runs them), on the benchmark's
configurations at small sizes (``benchmark/drivers``' ``Setup``).

On the CPU: the eager blocks run where no graph is safe (CPU tensors, the
per-lane loop, constraints) and their ``"block"`` records say so
(``plain``); the holder's key refuses another model, hyperparameters,
sync_k, lane count, frame count or input tensor; the device-resident
indices of ``engine._advance_core`` and ``engine._temporal_rollout_core_T``
give the outputs of per-call uploads, and ``engine._rollout_inputs``
uploads nothing a call; and the graph's buffer discipline, held by the
engine's holder under faked CUDA events and streams
(``tests/test_torch_graphs.py``) with its replay run as the eager phases
it captures, gives the eager path's outputs bit for bit, the first call's
outputs untouched by a second.

On the card (marked ``cuda``, skipped elsewhere; on a GPU machine run
``python -m pytest tests/test_torch_pipeline_graph.py -q --noconftest``,
as ``tests/conftest.py`` imports jax), the graph against the eager blocks,
bit for bit: the 6-tracker configuration at ragged lengths, the windowed
4-tracker one, the 52-joint rig on K1's general build, two calls on one
engine with other lengths and other inputs, two streams on one engine,
and, while a profiler records, the K1 and rollout records.  The rollout's
sub-batches against every rollout on the whole batch
(``full_batch_rollouts``), bit for bit, at window 0 and 16, and a block's
``begin`` under the sync debug mode's ``"error"``.
"""

import contextlib
import copy
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import harness
from test_torch_graphs import eager_capture, fake_cuda

SEED = 2147483659
SYNC_K = 4


def _setup(cell, lanes, frames, device, max_iter=12):
    """The benchmark's engine and inputs for ``cell``'s configuration:
    ``lanes`` equal pieces of ``frames`` frames of two pooled clips."""
    c = harness.cell(cell)
    traffic = dict(kind=c.traffic["kind"], lanes=lanes, lengths="equal",
                   min_frames=frames, max_frames=frames, pool_clips=2,
                   pool_frames=2 * frames, sync_k=SYNC_K,
                   optimizer=dict(c.traffic["optimizer"], max_iter=max_iter),
                   check_lanes=2, trace_passes=1,
                   motion_seed=c.traffic["motion_seed"])
    return harness.driver(traffic["kind"]).Setup(c.config, traffic, SEED,
                                                 device)


def _ragged(setup, seed=3):
    rng = np.random.default_rng(seed)
    B, T = setup.dqs.shape[:2]
    lengths = rng.integers(1, T + 1, size=B)
    lengths[0] = T
    return torch.as_tensor(lengths, dtype=torch.int32,
                           device=setup.dqs.device)


def _states(setup):
    e = setup.engine
    return e.init_state(torch.Generator(device=setup.device),
                        setup.dqs[:, 0][:, :, None], setup.global_pos[:, 0],
                        setup.global_rot[:, 0], setup.heights0,
                        noise=setup.noise)


def _eager(setup, states, inputs, lengths, **kw):
    from dragposer_tpu_torch.drag import pipeline

    e = setup.engine
    return pipeline.run_batch_pipelined(
        e.model, e.statics, e.skeleton, e.hyper, e.tparam, states, *inputs,
        sync_k=SYNC_K, lengths=lengths, **kw)


def _inputs(setup):
    return setup.dqs, setup.global_pos, setup.global_rot


def _leaves(result):
    state, out = result
    return [*state, *out]


def _equal(got, ref):
    a, b = _leaves(got), _leaves(ref)
    assert len(a) == len(b)
    for n, (x, y) in enumerate(zip(a, b)):
        assert torch.equal(x, y), n


def full_batch_rollouts(m) -> None:
    """Every rollout on the whole batch and a select, with no sub-batch:
    the window's budget at the batch and the pipeline's lane count dropped
    (``m``: a ``monkeypatch``)."""
    from dragposer_tpu_torch.drag import engine as eng

    where_needed = eng._rollout_where_needed
    m.setattr(eng, "rollout_lane_budget", lambda batch, window: batch)
    m.setattr(eng, "_rollout_where_needed",
              lambda *args, lanes=None, **kw: where_needed(*args, **kw))


def _k2_rows(monkeypatch) -> list:
    """The rows (lanes) of each K2 call, in order, from here on."""
    from dragposer_tpu_torch.ops import temporal_fused

    rows, forward = [], temporal_fused.forward

    def spy(packed, param, enc_in, *rest):
        rows.append(enc_in.shape[0])
        return forward(packed, param, enc_in, *rest)

    monkeypatch.setattr(temporal_fused, "forward", spy)
    return rows


@contextlib.contextmanager
def _records():
    """The launch records made inside (a CPU profiler records)."""
    from dragposer_tpu_torch import _build

    _build.clear_launch_logs()
    logs = {}
    with profile(activities=[ProfilerActivity.CPU]):
        yield logs
    for name in ("block", "K1", "K1_general", "rollout"):
        logs[name] = list(_build.launch_log(name))
    _build.clear_launch_logs()


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cpu6():
    torch.set_num_threads(2)
    return _setup("offline_6trk_mixed", 6, 10, "cpu", max_iter=8)


@pytest.fixture(scope="module")
def cpu4():
    torch.set_num_threads(2)
    return _setup("offline_4trk_equal", 12, 20, "cpu", max_iter=4)


def _penalty(ctx):
    return ctx.latent.pow(2).sum(-1)


@pytest.mark.parametrize("case", ["cpu", "per_lane", "constraints"])
def test_eager_blocks_where_no_graph_is_safe(cpu6, case):
    """The engine's blocks run eagerly, each logged ``plain`` and never a
    capture, and its holder makes no graph: on CPU tensors, with the
    per-lane loop (``fast=False``) and with a constraint (which takes the
    per-lane loop too)."""
    from dragposer_tpu_torch import tracing
    from dragposer_tpu_torch.drag import pipeline

    s = cpu6
    engine = s.engine
    if case == "constraints":
        engine = engine.replica("cpu")
        engine.hyper = engine.hyper._replace(constraints=((_penalty, 0.1),))
    kw = dict(fast=False) if case == "per_lane" else {}
    lengths = _ragged(s)
    plain = pipeline.BLOCKS.plain
    with _records() as logs:
        _, out = engine.run_batch_pipelined(_states(s), *_inputs(s),
                                            sync_k=SYNC_K, lengths=lengths,
                                            **kw)
        totals = tracing.counter_totals()
    blocks = logs["block"]
    assert blocks and all(r["plain"] and not r["capture"]
                          and r["lanes"] == 6 for r in blocks)
    assert pipeline.BLOCKS.plain - plain == len(blocks)
    assert not engine._block_graphs.slots
    assert totals["pipeline_blocks"] == len(blocks)
    assert totals["pipeline_graph_replays"] == 0
    assert totals["pipeline_graph_captures"] == 0
    assert int(out.iterations.sum()) > 0


KEY_CHANGES = ["same", "model", "statics", "hyper", "sync_k", "lanes",
               "frames", "dqs_norm", "gt_pos", "gt_rot"]


@pytest.mark.parametrize("change", KEY_CHANGES)
def test_holder_key_refuses_another_call(cpu6, change):
    from dragposer_tpu_torch.drag import pipeline

    s = cpu6
    e = s.engine
    states = _states(s)
    base = dict(model=e.model, statics=e.statics, skeleton=e.skeleton,
                hyper=e.hyper, tparam=e.tparam, fast=True, sync_k=SYNC_K,
                states=states, dqs_norm=s.dqs, gt_pos=s.global_pos,
                gt_rot=s.global_rot, lengths=None)
    key = pipeline._Key(pipeline._Block(**base))
    other = dict(base)
    if change == "model":
        other["model"] = e.model._replace()
    elif change == "statics":
        other["statics"] = copy.copy(e.statics)
    elif change == "hyper":
        other["hyper"] = e.hyper._replace(max_iter=e.hyper.max_iter + 1)
    elif change == "sync_k":
        other["sync_k"] = SYNC_K + 1
    elif change == "lanes":
        cut = lambda x: x[:-1]  # noqa: E731
        other.update(dqs_norm=cut(s.dqs), gt_pos=cut(s.global_pos),
                     gt_rot=cut(s.global_rot),
                     states=type(states)(*[cut(x) for x in states]))
    elif change == "frames":
        cut = lambda x: x[:, :-1]  # noqa: E731
        other.update(dqs_norm=cut(s.dqs), gt_pos=cut(s.global_pos),
                     gt_rot=cut(s.global_rot))
    elif change != "same":
        other[change] = other[change].clone()
    assert key.matches(pipeline._Block(**other)) == (change == "same")


def _per_call_index(values, device):
    return torch.as_tensor(tuple(int(v) for v in values), device=device)


@pytest.mark.parametrize("cell", ["offline_6trk_mixed",
                                  "offline_4trk_equal"])
def test_kept_indices_equal_per_call_uploads(cpu6, cpu4, cell, monkeypatch):
    """``_advance_core``'s height joints and the rollout's hold index, kept
    on the device once, give the outputs of per-call uploads bit for bit;
    the second call takes the kept tensor."""
    from dragposer_tpu_torch.drag import engine as eng

    s = cpu6 if cell == "offline_6trk_mixed" else cpu4
    e, hyper = s.engine, s.engine.hyper
    state = _states(s)
    B, L = state.latent.shape
    rng = np.random.default_rng(11)
    final = eng._opt_init(state.latent, e.skeleton.n_joints)
    final = final._replace(aux=final.aux._replace(
        positions=torch.as_tensor(rng.normal(
            size=(B, e.skeleton.n_joints, 3)), dtype=torch.float32),
        world_rotation=torch.as_tensor(rng.normal(size=(B, 4)),
                                       dtype=torch.float32),
        world_displacement=torch.ones(B, 3)))
    adj = torch.as_tensor(rng.normal(size=(B, 3)), dtype=torch.float32)
    roll = eng._rollout_inputs(state, hyper)

    def run():
        return (eng._advance_core(e.model, hyper, state.global_pos,
                                  state.current_index, final, adj)[:5],
                eng._temporal_rollout_core_T(e.model, hyper, e.tparam,
                                             *roll))

    kept = run()
    hidx = eng._index_tensor(hyper.height_indices, "cpu")
    assert eng._index_tensor(hyper.height_indices, "cpu") is hidx
    with monkeypatch.context() as m:
        m.setattr(eng, "_index_tensor", _per_call_index)
        uploaded = run()
    (adv_k, roll_k), (adv_u, roll_u) = kept, uploaded
    assert all(torch.equal(a, b) for a, b in zip(adv_k, adv_u))
    assert torch.equal(roll_k, roll_u)
    assert roll_k.shape == (B, hyper.temporal_future_window + 1, L)


def _rollout_inputs_as_uploads(state, hyper):
    """The rollout's inputs as the anchor gathered them, its indices
    uploaded every call, and as the pipeline did, from (B, P·C) copies of
    the rings by flat indices."""
    dev, step = state.latent.device, hyper.sample_step
    past = torch.as_tensor(hyper.past_frames, device=dev)
    latp = state.latent_buffer[:, past]
    acc = past[:-1, None] + torch.arange(step, device=dev)[None]
    anchor = (latp[:, :-1], state.displacement_buffer[:, acc].sum(dim=2),
              state.heights_buffer[:, past[:-1]], latp[:, -1])
    B, n = state.latent.shape[0], len(past)
    L, H = state.latent.shape[-1], state.heights_buffer.shape[-1]
    flat = lambda x: x.reshape(B, -1).contiguous()  # noqa: E731
    latp = flat(state.latent_buffer)[:, (past[:, None] * L + torch.arange(
        L)).ravel()].reshape(B, n, L)
    disp = flat(state.displacement_buffer)[:, (acc[..., None] * 3
                                               + torch.arange(3)).ravel()]
    heights = flat(state.heights_buffer)[:, (past[:-1, None] * H
                                             + torch.arange(H)).ravel()]
    pipeline = (latp[:, :-1], disp.reshape(B, n - 1, step, 3).sum(dim=2),
                heights.reshape(B, n - 1, H), latp[:, -1])
    return anchor, pipeline


@pytest.mark.parametrize("cell", ["offline_6trk_mixed",
                                  "offline_4trk_equal"])
def test_rollout_inputs_take_kept_indices(cpu6, cpu4, cell, monkeypatch):
    """``engine._rollout_inputs`` on random rings: two calls gather by the
    same kept index tensors and make none from the host; the inputs equal,
    bit for bit, the anchor's per-call uploads and the pipeline's flat
    gathers they replace."""
    from dragposer_tpu_torch.drag import engine as eng

    s = cpu6 if cell == "offline_6trk_mixed" else cpu4
    hyper = s.engine.hyper
    gen = torch.Generator().manual_seed(5)
    state = _states(s)
    state = state._replace(**{
        name: torch.randn(getattr(state, name).shape, generator=gen)
        for name in ("latent_buffer", "displacement_buffer",
                     "heights_buffer")})
    refs = _rollout_inputs_as_uploads(state, hyper)
    taken = []
    kept = eng._index_tensor

    def spy(values, device):
        taken.append(kept(values, device))
        return taken[-1]

    def upload(*args, **kw):
        raise AssertionError("a tensor made from the host")

    monkeypatch.setattr(eng, "_index_tensor", spy)
    first = eng._rollout_inputs(state, hyper)
    for name in ("as_tensor", "tensor", "arange", "from_numpy"):
        monkeypatch.setattr(torch, name, upload)
    second = eng._rollout_inputs(state, hyper)
    monkeypatch.undo()
    n = len(taken) // 2
    assert n > 0 and len(taken) == 2 * n
    assert all(a is b for a, b in zip(taken[:n], taken[n:]))
    for ref in (*refs, second):
        assert all(torch.equal(a, b) for a, b in zip(first, ref))


@pytest.mark.parametrize("cell", ["offline_6trk_mixed",
                                  "offline_4trk_equal"])
def test_graph_buffers_equal_eager_blocks(cpu6, cpu4, cell, monkeypatch):
    """Two calls through the engine's holder and the graph's buffers
    (other lengths, the same inputs: one capture) equal the eager blocks
    bit for bit; the first call's outputs are untouched by the second; the
    records say replays, the first a capture, and keep copies of the
    buffers K1 and the rollout read."""
    from dragposer_tpu_torch import _graphs
    from dragposer_tpu_torch.drag import pipeline

    s = cpu6 if cell == "offline_6trk_mixed" else cpu4
    monkeypatch.setattr(pipeline._Block, "graphable", lambda self: True)
    fake_cuda(monkeypatch)
    captures = eager_capture(monkeypatch)
    holder = _graphs.Holder()
    states = _states(s)
    results, kept = [], []
    for seed in (3, 4):
        lengths = _ragged(s, seed)
        eager = _eager(s, states, _inputs(s), lengths)
        with _records() as logs:
            got = _eager(s, states, _inputs(s), lengths, graphs=holder)
        _equal(got, eager)
        results.append(got)
        kept.append([x.clone() for x in _leaves(got)])
        blocks = logs["block"]
        assert blocks and not any(r["plain"] for r in blocks)
        assert [r["capture"] for r in blocks] == [seed == 3] + [False] * (
            len(blocks) - 1)
        graph = holder.slots["block"]
        buffers = [graph.carry.opt.t, graph.carry.frame]
        for r in logs["K1"]:
            assert all(r["t0"] is not b for b in buffers)
        assert all(r["frame"] is not graph.carry.frame
                   for r in logs["rollout"])
    assert len(captures) == 1 and list(holder.slots) == ["block"]
    for x, y in zip(_leaves(results[0]), kept[0]):
        assert torch.equal(x, y)
    assert not torch.equal(results[0][1].iterations,
                           results[1][1].iterations)


# ---------------------------------------------------------------------------
# Card
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (CUDA graphs have no CPU mode)")
    return "cuda"


def _graphed_equals_eager(setup, lengths):
    """The engine's graph path against the eager blocks on one call:
    equal bit for bit, every block a replay."""
    from dragposer_tpu_torch.drag import pipeline

    states = _states(setup)
    eager = _eager(setup, states, _inputs(setup), lengths)
    kernel = pipeline.BLOCKS.kernel
    got = setup.engine.run_batch_pipelined(states, *_inputs(setup),
                                           sync_k=SYNC_K, lengths=lengths)
    assert pipeline.BLOCKS.kernel > kernel
    _equal(got, eager)
    return got


@pytest.mark.cuda
def test_6trk_ragged_graph_equals_eager(card):
    s = _setup("offline_6trk_mixed", 64, 24, card, max_iter=100)
    _graphed_equals_eager(s, _ragged(s))


@pytest.mark.cuda
def test_4trk_windowed_graph_equals_eager(card):
    """Window 16 over 40 frames, 48 lanes at staggered lengths: sub-batch
    rollouts (the budget is 8) and full ones."""
    from dragposer_tpu_torch import _build

    s = _setup("offline_4trk_equal", 48, 40, card, max_iter=100)
    before = _build.kernel_launches()["K2"]
    _graphed_equals_eager(s, _ragged(s, 5))
    assert _build.kernel_launches()["K2"] > before


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["6trk_ragged", "4trk_windowed"])
def test_sub_batch_rollouts_equal_full_batch(card, case, monkeypatch):
    """The graph path with the rollout's sub-batches against the same path
    with every rollout on the whole batch: equal bit for bit; K2 ran on
    fewer lanes than the batch in all."""
    if case == "6trk_ragged":
        s = _setup("offline_6trk_mixed", 64, 24, card, max_iter=100)
        lengths = _ragged(s)
    else:
        s = _setup("offline_4trk_equal", 48, 40, card, max_iter=100)
        lengths = _ragged(s, 5)
    B, states = lengths.shape[0], _states(s)
    rows = _k2_rows(monkeypatch)
    got = s.engine.run_batch_pipelined(states, *_inputs(s), sync_k=SYNC_K,
                                       lengths=lengths)
    ran = list(rows)
    with monkeypatch.context() as m:
        full_batch_rollouts(m)
        del rows[:]
        ref = s.engine.run_batch_pipelined(states, *_inputs(s),
                                           sync_k=SYNC_K, lengths=lengths)
    _equal(got, ref)
    assert ran and sum(ran) < B * len(ran)
    assert rows and all(n == B for n in rows)


@pytest.mark.cuda
def test_6trk_begin_makes_no_host_sync(card, monkeypatch):
    """Each block's ``begin`` of a 6-tracker pass at ragged lengths (the
    compaction, the gathers, K2 and the write-back) runs under
    ``torch.cuda.set_sync_debug_mode("error")``, so a synchronising call
    raises; a first pass has kept the indices and loaded K2.  Some blocks
    rolled out fewer lanes than the batch."""
    from dragposer_tpu_torch.drag import pipeline

    s = _setup("offline_6trk_mixed", 64, 24, card, max_iter=100)
    states, lengths = _states(s), _ragged(s)
    s.engine.run_batch_pipelined(states, *_inputs(s), sync_k=SYNC_K,
                                 lengths=lengths)
    given, begin = [], pipeline._Block.begin

    def strict(self, c, frame, lanes):
        given.append(lanes)
        torch.cuda.set_sync_debug_mode("error")
        try:
            return begin(self, c, frame, lanes)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    monkeypatch.setattr(pipeline._Block, "begin", strict)
    s.engine.run_batch_pipelined(states, *_inputs(s), sync_k=SYNC_K,
                                 lengths=lengths)
    torch.cuda.synchronize()
    assert given and min(given) < lengths.shape[0]


@pytest.mark.cuda
def test_smplh52_general_build_graph_equals_eager(card):
    from dragposer_tpu_torch.drag import iter_kernel

    s = _setup("offline_smplh52_equal", 64, 16, card, max_iter=30)
    general = iter_kernel.GENERAL_COUNTS.kernel
    _graphed_equals_eager(s, _ragged(s, 6))
    assert iter_kernel.GENERAL_COUNTS.kernel > general


@pytest.mark.cuda
def test_calls_with_other_lengths_and_inputs(card):
    """On one engine: the same inputs at other lengths replay the graph;
    other input tensors capture anew; each call equals its eager run, and
    the first call's outputs are unchanged after the later ones."""
    from dragposer_tpu_torch.drag import pipeline

    s = _setup("offline_6trk_mixed", 32, 16, card, max_iter=30)
    states = _states(s)
    flipped = tuple(x.flip(0).contiguous() for x in _inputs(s))
    calls = [(_inputs(s), _ragged(s, 1)), (_inputs(s), _ragged(s, 2)),
             (flipped, _ragged(s, 3))]
    outs, kept, captures = [], [], []
    for inputs, lengths in calls:
        eager = _eager(s, states, inputs, lengths)
        with _records() as logs:
            got = s.engine.run_batch_pipelined(states, *inputs,
                                               sync_k=SYNC_K,
                                               lengths=lengths)
        torch.cuda.synchronize()
        _equal(got, eager)
        outs.append(got)
        kept.append([x.clone() for x in _leaves(got)])
        captures.append(sum(r["capture"] for r in logs["block"]))
        assert not any(r["plain"] for r in logs["block"])
    assert captures == [1, 0, 1]
    graph = s.engine._block_graphs.slots["block"]
    assert graph.key.matches(pipeline._Block(
        s.engine.model, s.engine.statics, s.engine.skeleton, s.engine.hyper,
        s.engine.tparam, True, SYNC_K, states, *flipped, None))
    for got, k in zip(outs, kept):
        assert all(torch.equal(x, y) for x, y in zip(_leaves(got), k))


@pytest.mark.cuda
def test_two_streams_on_one_engine(card):
    """Two threads, each on a stream of its own, run the pipeline on one
    engine at once with inputs of their own (the graph recaptured as
    they alternate): each result equals its eager run bit for bit."""
    s = _setup("offline_6trk_mixed", 32, 16, card, max_iter=30)
    states = _states(s)
    jobs = [(_inputs(s), _ragged(s, 1)),
            (tuple(x.flip(0).contiguous() for x in _inputs(s)),
             _ragged(s, 2))]
    eager = [_eager(s, states, *job) for job in jobs]
    got = [[], []]
    barrier = threading.Barrier(2)

    def run(i):
        stream = torch.cuda.Stream(card)
        stream.wait_stream(torch.cuda.current_stream(card))
        with torch.cuda.stream(stream):
            barrier.wait()
            for _ in range(3):
                inputs, lengths = jobs[i]
                got[i].append(s.engine.run_batch_pipelined(
                    states, *inputs, sync_k=SYNC_K, lengths=lengths))
        stream.synchronize()

    threads = [threading.Thread(target=run, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for runs, ref in zip(got, eager):
        assert len(runs) == 3
        for r in runs:
            _equal(r, ref)


@pytest.mark.cuda
def test_records_under_a_profiler_equal_eager(card):
    """While a profiler records, K1's lane-steps (``t1 - t0``) and the
    rollouts' needed lanes from the graph path's records equal the eager
    run's, record by record, after the run has ended."""
    from dragposer_tpu_torch import tracing

    s = _setup("offline_6trk_mixed", 32, 16, card, max_iter=30)
    states, lengths = _states(s), _ragged(s, 7)
    s.engine.run_batch_pipelined(states, *_inputs(s), sync_k=SYNC_K,
                                 lengths=lengths)   # the capture
    runs = []
    for graphs in (False, True):
        with _records() as logs:
            if graphs:
                s.engine.run_batch_pipelined(states, *_inputs(s),
                                             sync_k=SYNC_K, lengths=lengths)
            else:
                _eager(s, states, _inputs(s), lengths)
        torch.cuda.synchronize()
        runs.append(logs)
    eager, graphed = runs
    assert [r["plain"] for r in graphed["block"]] == [False] * len(
        graphed["block"]) and not any(r["capture"] for r in graphed["block"])
    assert all(r["plain"] for r in eager["block"])
    k1 = [[(r["t1"] - r["t0"]) for r in logs["K1"]] for logs in runs]
    assert len(k1[0]) == len(k1[1]) > 0
    assert all(torch.equal(a, b) for a, b in zip(*k1))
    need = [[int(tracing.needed_lanes(r)) for r in logs["rollout"]]
            for logs in runs]
    assert need[0] == need[1] and sum(need[0]) == int(lengths.sum())
