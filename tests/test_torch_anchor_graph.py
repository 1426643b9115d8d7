"""The anchor's Adam iteration as a CUDA graph (``engine._AnchorGraph``)
and the eager loop it stands in for (``engine._optimize`` without an
engine's graphs, as the CPU runs it).

On the CPU: the eager loop runs, and the anchor's launch records say so
(``plain``), on CPU tensors, with a constraint and with an unfolded
decoder; ``engine._graphable`` refuses the last two on the card too.  The
graph's buffer discipline, held by the engine's ``_graphs.Holder`` under
faked CUDA events and streams (``tests/test_torch_graphs.py``) with its
replays run as the eager steps they capture, gives the eager loop's
outputs bit for bit.  FK's device-resident skeleton tensors give the
values and gradients of the per-call uploads they replace.

On the card (marked ``cuda``, skipped elsewhere; on a GPU machine run
``python -m pytest tests/test_torch_anchor_graph.py -q --noconftest``, as
``tests/conftest.py`` imports jax): a 4-tracker ``RealtimeSession`` on the
graph against one on the eager loop, same seed and targets, over 72 frames
that hold rollouts, frames stopped by the stop rule and frames at
``max_iter``, a mask edit and an engine rebuild: equal bit for bit.  Then
``run_batch`` at B = 5, its stacked outputs read after the last frame and
again after another run; and two threads, each on a stream of its own,
running ``run_batch`` on one engine at one lane count at once.
"""

import contextlib
import threading
import types

import numpy as np
import pytest
import torch

import chip_smoke
from test_torch_graphs import eager_capture, fake_cuda

MODEL_DIR = "models/model_dancedb_example"
FRAMES = 72
EDIT_MASK_AT = 30      # the hip tracker's weights halve, joint 10 joins
REBUILD_AT = 50        # max_iter 10 → 3: the engine is rebuilt
SEED = 7


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    from dragposer_tpu_torch.io.bvh import BVH

    path = str(tmp_path_factory.mktemp("anchor_graph") / "clip.bvh")
    chip_smoke.synthetic_bvh(FRAMES + 1, seed=5).save(path)
    bvh = BVH().load(path)
    wp, wq = chip_smoke.clip_trackers(bvh)
    return path, bvh, wp, wq


@contextlib.contextmanager
def eager_anchor():
    """Every frame's anchor through the eager loop, the CPU's path: the
    anchor without the engine's graphs."""
    from dragposer_tpu_torch.drag import engine as eng

    graphed = eng._optimize
    eng._optimize = lambda *args: graphed(*args[:10])
    try:
        yield
    finally:
        eng._optimize = graphed


def _engine(bvh, device, max_iter=None):
    from dragposer_tpu_torch.cli.eval_drag import build_engine, resolve_config
    from dragposer_tpu_torch.data import encoding
    from dragposer_tpu_torch.ops.topology import Skeleton

    _, _, parents, offsets, _ = encoding.info_from_bvh(bvh)
    sk = Skeleton.build(parents, offsets, bvh.names)
    engine, means, stds = build_engine(MODEL_DIR, parents,
                                       resolve_config("4_trackers"),
                                       skeleton=sk, device=device)
    if max_iter is not None:
        engine.hyper = engine.hyper._replace(max_iter=max_iter)
    return engine, means, stds


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cpu_setup(clip):
    _, bvh, _, _ = clip
    engine, means, stds = _engine(bvh, "cpu", max_iter=3)
    states, dqs, gp, gr = chip_smoke.lane_batch(engine, bvh, means, stds,
                                                2, 4)
    return engine, states, dqs, gp, gr


def _penalty(ctx):
    return ctx.latent.pow(2).sum(-1)


@pytest.mark.parametrize("case", ["cpu", "constraints", "unfolded"])
def test_eager_loop_where_no_graph_is_safe(cpu_setup, case):
    """The anchor's records are plain steps, one an ``anchor.step`` span,
    and no graph is made; on the card ``_graphable`` would refuse a
    constraint and an unfolded decoder as well."""
    from torch.profiler import ProfilerActivity, profile

    from dragposer_tpu_torch import _build, _graphs, tracing
    from dragposer_tpu_torch.drag import engine as eng
    from dragposer_tpu_torch.models import loading

    engine, states, dqs, gp, gr = cpu_setup
    model, hyper = engine.model, engine.hyper
    if case == "constraints":
        hyper = hyper._replace(constraints=((_penalty, 0.1),))
    if case == "unfolded":
        params, _, _ = loading.load_generator(MODEL_DIR)
        model = model._replace(
            decoder=loading.tree_to_torch(params["decoder"], "cpu"))
    on_card = types.SimpleNamespace(is_cuda=True)
    assert eng._graphable(on_card, model, hyper) == (case == "cpu")
    assert not eng._graphable(states.latent, model, hyper)

    graphs = _graphs.Holder()
    plain, kernel = eng.ANCHOR.plain, eng.ANCHOR.kernel
    _build.clear_launch_logs()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, out = eng.run_sequence(model, engine.statics, engine.skeleton,
                                  hyper, engine.tparam, states, dqs, gp, gr,
                                  graphs)
    log = _build.launch_log("anchor")
    steps = [e for e in prof.events() if e.name == "dragposer.anchor.step"]
    # a step a frame while any lane's rule holds
    n = int(out.iterations.amax(dim=0).sum())
    assert len(log) == len(steps) == n > 0
    assert all(r["plain"] and not r["capture"] and r["lanes"] == 2
               for r in log)
    assert eng.ANCHOR.plain - plain == len(log)
    assert eng.ANCHOR.kernel == kernel and not graphs.slots
    totals = tracing.counter_totals()
    assert totals["anchor_iterations"] == len(log)
    assert totals["anchor_graph_replays"] == 0
    assert totals["anchor_graph_captures"] == 0
    if case == "cpu":   # the engine's own method takes the same loop
        _, again = engine.run_batch(states, dqs, gp, gr)
        assert all(torch.equal(a, b) for a, b in zip(again, out))


def test_graph_buffers_equal_eager_loop(cpu_setup, monkeypatch):
    """``run_batch`` through the engine's holder and the graph's buffers at
    2 lanes, 1 lane, then 2 again: states and outputs equal the eager
    loop's bit for bit, and the earlier outputs are untouched by the later
    runs; a graph a lane count, captured once, every iteration a replay,
    the first of each graph a capture."""
    from torch.profiler import ProfilerActivity, profile

    from dragposer_tpu_torch import _build
    from dragposer_tpu_torch.drag import engine as eng

    base, states, dqs, gp, gr = cpu_setup
    engine = base.replica("cpu")
    one = lambda x: x[:1]  # noqa: E731
    jobs = [(states, dqs, gp, gr),
            (type(states)(*map(one, states)), one(dqs), one(gp), one(gr)),
            (states._replace(latent=states.latent * 0.5), dqs, gp, gr)]
    with eager_anchor():
        eager = [engine.run_batch(*job) for job in jobs]
    monkeypatch.setattr(eng, "_graphable",
                        lambda latent0, model, hyper: True)
    fake_cuda(monkeypatch)
    captures = eager_capture(monkeypatch)
    outs, kept, seen = [], [], set()
    for job, (e_state, e_out) in zip(jobs, eager):
        lanes = job[1].shape[0]
        _build.clear_launch_logs()
        with profile(activities=[ProfilerActivity.CPU]):
            g_state, g_out = engine.run_batch(*job)
        log = _build.launch_log("anchor")
        _build.clear_launch_logs()
        assert log and not any(r["plain"] for r in log)
        assert all(r["lanes"] == lanes for r in log)
        assert [r["capture"] for r in log] == [lanes not in seen] + [
            False] * (len(log) - 1)
        seen.add(lanes)
        for a, b in zip((*g_state, *g_out), (*e_state, *e_out)):
            assert torch.equal(a, b)
        outs.append(g_out)
        kept.append([x.clone() for x in g_out])
    assert len(captures) == 2
    assert sorted(engine._anchor_graphs.slots) == [1, 2]
    for out, k in zip(outs, kept):
        assert all(torch.equal(a, b) for a, b in zip(out, k))


def _fk_with_uploads(rootspace_q, root_pos, skeleton):
    """``fk.fk_root_space`` as it was, its constants uploaded every call."""
    from dragposer_tpu_torch.ops import quat

    def const(a):
        return torch.as_tensor(a, dtype=rootspace_q.dtype,
                               device=rootspace_q.device)

    root = rootspace_q[..., :1, :]
    world = torch.cat((root, quat.mul(root, rootspace_q[..., 1:, :])), dim=-2)
    onehot = np.eye(skeleton.n_joints, dtype=np.float32)[skeleton.parents]
    parent_rot = torch.matmul(const(onehot), world)
    offsets = const(skeleton.offsets).expand(world.shape[:-1] + (3,))
    contrib = quat.mul_vec(parent_rot, offsets)
    pos = torch.matmul(const(skeleton.ancestors), contrib)
    return pos + root_pos[..., None, :], world


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fk_skeleton_tensors_match_the_uploads(clip, dtype):
    """FK on the kept skeleton tensors: values and gradients equal to those
    of per-call uploads, bit for bit; the tensors are made once per
    skeleton, dtype and device, and kept with the skeleton."""
    from dragposer_tpu_torch.data import encoding
    from dragposer_tpu_torch.ops import fk
    from dragposer_tpu_torch.ops.topology import Skeleton

    _, bvh, _, _ = clip
    _, _, parents, offsets, _ = encoding.info_from_bvh(bvh)
    sk = Skeleton.build(parents, offsets, bvh.names)
    rng = np.random.default_rng(3)
    q = rng.normal(size=(5, sk.n_joints, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    root = rng.normal(size=(5, 3))
    g = torch.as_tensor(rng.normal(size=(5, sk.n_joints, 3)), dtype=dtype)
    grads = []
    for run in (fk.fk_root_space, _fk_with_uploads):
        x = torch.tensor(q, dtype=dtype, requires_grad=True)
        r = torch.tensor(root, dtype=dtype, requires_grad=True)
        pos, world = run(x, r, sk)
        grads.append((pos.detach(), world.detach(),
                       *torch.autograd.grad((pos * g).sum(), (x, r))))
    for got, ref in zip(*grads):
        assert torch.equal(got, ref)
    first = fk._skeleton_tensors(sk, g)
    assert all(a is b for a, b in zip(first, fk._skeleton_tensors(sk, g)))
    assert set(sk.tensors) == {(g.device, dtype)}
    other = Skeleton.build(parents, offsets, bvh.names)
    assert not other.tensors
    assert all(t.dtype == dtype for t in first)


# ---------------------------------------------------------------------------
# Card
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (CUDA graphs have no CPU mode)")
    return torch.device("cuda")


def _play_session(clip) -> list:
    """The session's frames: per frame the state's latent, the reply, the
    anchor's iterations and how many were graph replays, whether a
    rollout ran and the budget then."""
    from dragposer_tpu_torch import config as cfg
    from dragposer_tpu_torch.drag import engine as eng
    from dragposer_tpu_torch.runtime.realtime import RealtimeSession

    path, _, wp, wq = clip
    c = cfg.BUILTIN_CONFIGS["4_trackers"]
    mask, weights = c.mask_array(), c.weights_array()
    s = RealtimeSession(log_path=None, device="cuda")
    s.set_reference_skeleton(path)
    s.load_models(MODEL_DIR)
    s.set_mask_and_weights(mask, weights)
    s.set_lambdas(1.0, c.lambda_temporal, c.temporal_future_window)
    s.set_optim_params(1e-4, 0.01, 10, 0.01)
    s.init_drag_pose(wp[0, 0][None], wq[0, 0][None], seed=SEED)
    frames = []
    for f in range(1, FRAMES + 1):
        if f == EDIT_MASK_AT:
            mask, weights = mask.copy(), weights.copy()
            mask[10] = 1.0
            weights[0] *= 0.5
            s.set_mask_and_weights(mask, weights)
        if f == REBUILD_AT:
            s.set_optim_params(1e-4, 0.01, 3, 0.01)
        rollout = int(s._state.current_index) == 0
        plain, kernel = eng.ANCHOR.plain, eng.ANCHOR.kernel
        idx = s._mask_indices
        root = s._state.global_pos.cpu().numpy()
        pose = np.zeros((len(mask), 4), np.float32)
        gpos = np.zeros((1, 3), np.float32)
        s.drag_pose(wp[f, idx] - root, wq[f, idx], pose, gpos)
        replays = eng.ANCHOR.kernel - kernel
        frames.append(dict(
            latent=s._state.latent.clone(), pose=pose, gpos=gpos,
            iterations=replays + eng.ANCHOR.plain - plain, replays=replays,
            rollout=rollout, max_iter=s.max_iter))
    frames.append({k: v.clone() for k, v in s._state._asdict().items()})
    return frames


@pytest.mark.cuda
def test_session_graph_equals_eager(card, clip):
    with eager_anchor():
        eager = _play_session(clip)
    graphed = _play_session(clip)
    for n, (e, g) in enumerate(zip(eager[:-1], graphed[:-1]), start=1):
        assert torch.equal(g["latent"], e["latent"]), n
        assert np.array_equal(g["pose"], e["pose"]), n
        assert np.array_equal(g["gpos"], e["gpos"]), n
        assert g["iterations"] == e["iterations"] and e["replays"] == 0, n
        assert g["replays"] == g["iterations"], n
    assert all(torch.equal(graphed[-1][k], eager[-1][k]) for k in eager[-1])
    frames = graphed[:-1]
    assert sum(f["rollout"] for f in frames) >= 4
    assert any(0 < f["iterations"] < f["max_iter"] for f in frames)
    assert any(f["iterations"] == f["max_iter"] for f in frames)
    assert any(f["iterations"] == f["max_iter"]
               for f in frames[REBUILD_AT - 1:])


@pytest.mark.cuda
def test_run_batch_graph_equals_eager(card, clip):
    """B = 5 lanes × 24 frames: the states and the stacked outputs equal
    the eager loop's, and the outputs stay so after the graph's buffers are
    overwritten by another run."""
    from dragposer_tpu_torch.drag import engine as eng

    _, bvh, _, _ = clip
    engine, means, stds = _engine(bvh, card, max_iter=12)
    states, dqs, gp, gr = chip_smoke.lane_batch(engine, bvh, means, stds,
                                                5, 24)
    with eager_anchor():
        e_state, e_out = engine.run_batch(states, dqs, gp, gr)
    kernel = eng.ANCHOR.kernel
    g_state, g_out = engine.run_batch(states, dqs, gp, gr)
    assert eng.ANCHOR.kernel - kernel > 0
    assert 5 in engine._anchor_graphs.slots
    for got, ref in zip((*g_state, *g_out), (*e_state, *e_out)):
        assert torch.equal(got, ref)
    kept = [x.clone() for x in g_out]
    engine.run_batch(states._replace(latent=states.latent * 0.5), dqs, gp,
                     gr)
    assert all(torch.equal(a, b) for a, b in zip(g_out, kept))
    assert not torch.equal(g_out.latent[:, 0], g_out.latent[:, -1])


@pytest.mark.cuda
def test_run_batch_on_two_streams_equals_eager(card, clip):
    """Two threads, each on a stream of its own, run ``run_batch`` at the
    same B on one engine at once (as the daemon's jobs do), the graph
    captured while the other thread runs: each result equals its own
    eager result bit for bit."""
    _, bvh, _, _ = clip
    engine, means, stds = _engine(bvh, card, max_iter=12)
    states, dqs, gp, gr = chip_smoke.lane_batch(engine, bvh, means, stds,
                                                5, 16)
    jobs = [(states, dqs, gp, gr),
            (states._replace(latent=states.latent * 0.5), dqs.flip(1),
             gp.flip(1), gr.flip(1))]
    with eager_anchor():
        eager = [engine.run_batch(*job) for job in jobs]
    assert not engine._anchor_graphs.slots
    got = [[], []]
    barrier = threading.Barrier(2)

    def run(i):
        stream = torch.cuda.Stream(card)
        stream.wait_stream(torch.cuda.current_stream(card))
        with torch.cuda.stream(stream):
            barrier.wait()
            for _ in range(3):
                got[i].append(engine.run_batch(*jobs[i]))
        stream.synchronize()

    threads = [threading.Thread(target=run, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert list(engine._anchor_graphs.slots) == [5]
    for runs, (e_state, e_out) in zip(got, eager):
        assert len(runs) == 3
        for g_state, g_out in runs:
            for a, b in zip((*g_state, *g_out), (*e_state, *e_out)):
                assert torch.equal(a, b)
