"""The port's realtime API (``runtime/realtime.py``: ``RealtimeSession``,
``make_batched_step``, ``make_coalesced_step``, ``RealtimeBatch``) against
the JAX package's, on the CPU, on a seeded synthetic clip whose joints
serve as trackers (``chip_smoke.clip_trackers``).  The two RNGs differ, so
the port's sessions and batches start from the JAX package's state,
carried across.

Tolerances (float32 sums reassociated between XLA and PyTorch; measured
differences are 1e-6 and below):

* sessions and batches: state latent atol 1e-4, parent-local quaternions
  atol 1e-4, root position atol 1e-5 (the lockstep tolerances of
  ``tests/test_torch_engine_anchor.py``, the quaternions in place of the
  normalized pose), prediction buffers rtol 1e-4 / atol 1e-5 (K2's twin);
* the rollout at windows 60 and 100: rtol 1e-4 / atol 1e-5 (K2's twin);
* the port against itself: equal where the same arithmetic runs; a
  session's initial latent and a batch's to 1e-6 (the encoder's product
  at another row count).
"""

import shutil

import numpy as np
import pytest
import torch

import chip_smoke

torch.set_num_threads(1)
MODEL_DIR = "models/model_dancedb_example"
T_CLIP = 24
J = 22
LOCKSTEP = (0.0, 0.0, 1, 0.01)      # stop thresholds 0: one step a frame
REALTIME = (1e-4, 0.01, 4, 0.01)    # the realtime stop rule, max_iter 4
WINDOW = (1.0, 0.02, 16)


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    from dragposer_tpu_torch.io.bvh import BVH

    path = str(tmp_path_factory.mktemp("realtime") / "clip.bvh")
    chip_smoke.synthetic_bvh(T_CLIP, seed=5).save(path)
    wp, wq = chip_smoke.clip_trackers(BVH().load(path))
    return path, wp, wq


def _configure(s, path, optim, lambdas, config="6_trackers",
               model_dir=MODEL_DIR):
    from dragposer_tpu_torch import config as cfg

    c = cfg.BUILTIN_CONFIGS[config]
    assert s.set_reference_skeleton(path) == J
    s.load_models(model_dir)
    s.set_mask_and_weights(c.mask_array(), c.weights_array())
    s.set_optim_params(*optim)
    s.set_lambdas(*lambdas)
    return s


def _sessions(clip, optim, lambdas=WINDOW):
    """A JAX session and a port session, configured alike, the port's from
    the JAX session's initial state."""
    from dragposer_tpu.runtime.realtime import RealtimeSession as JaxSession
    from dragposer_tpu_torch.runtime.realtime import RealtimeSession

    path, wp, wq = clip
    js = _configure(JaxSession(log_path=None), path, optim, lambdas)
    ts = _configure(RealtimeSession(log_path=None, device="cpu"), path,
                    optim, lambdas)
    for s in (js, ts):
        s.init_drag_pose(wp[0, 0][None], wq[0, 0][None])
    ts._state = ts._engine.on_device(js._state)
    return js, ts


def _frame(sessions, clip, f):
    """Frame ``f`` of the clip through each session, targets relative to
    the first session's root; returns [(local (J, 4), global_pos (1, 3))]."""
    _, wp, wq = clip
    idx = sessions[0]._mask_indices
    gp = np.asarray(sessions[0]._state.global_pos)
    outs = []
    for s in sessions:
        pose = np.zeros((J, 4), np.float32)
        gpos = np.zeros((1, 3), np.float32)
        s.drag_pose(wp[f, idx] - gp, wq[f, idx], pose, gpos)
        outs.append((pose, gpos))
    return outs


def _assert_states(js, ts):
    np.testing.assert_allclose(ts._state.latent.numpy(), js._state.latent,
                               atol=1e-4)
    np.testing.assert_allclose(ts._state.global_pos.numpy(),
                               js._state.global_pos, atol=1e-5)
    np.testing.assert_allclose(ts._state.target_buffer.numpy(),
                               js._state.target_buffer, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ts._state.latent_buffer.numpy(),
                               js._state.latent_buffer, atol=1e-4)
    assert int(ts._state.current_index) == int(js._state.current_index)


def _assert_frame(outs):
    (jp, jg), (tp, tg) = outs
    np.testing.assert_allclose(tp, jp, atol=1e-4)
    np.testing.assert_allclose(tg, jg, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(tp, axis=-1), 1.0, atol=1e-5)


@pytest.mark.parametrize("optim", [LOCKSTEP, REALTIME],
                         ids=["one_step", "stop_rule"])
def test_session_matches_jax_over_8_frames(clip, optim):
    """Eight frames of the clip, window 16 (the rollout at frame 0, the
    held predictions after it), the port carrying JAX's initial state."""
    js, ts = _sessions(clip, optim)
    for f in range(8):
        _assert_frame(_frame((js, ts), clip, f))
        _assert_states(js, ts)


def test_mask_edit_and_parameter_push_do_not_rebuild(clip):
    """A live mask edit writes the engine's mask tensors in place; pushing
    unchanged parameters (as clients do every frame) rebuilds nothing; the
    edited session still agrees with JAX's."""
    from dragposer_tpu_torch import config as cfg

    js, ts = _sessions(clip, LOCKSTEP)
    _frame((js, ts), clip, 0)
    engine = ts._engine
    c4 = cfg.BUILTIN_CONFIGS["4_trackers"]
    for s in (js, ts):
        assert s.set_mask_and_weights(c4.mask_array(),
                                      c4.weights_array()) == 4
        s.set_optim_params(*LOCKSTEP)
        s.set_lambdas(*WINDOW)
    assert ts._engine is engine and not ts._engine_dirty
    np.testing.assert_array_equal(engine.model.mask.numpy(),
                                  c4.mask_array())
    np.testing.assert_array_equal(engine.model.weights.numpy(),
                                  c4.weights_array())
    for f in (1, 2):
        _assert_frame(_frame((js, ts), clip, f))
    assert ts._engine is engine
    _assert_states(js, ts)


def test_window_change_resizes_the_buffer_as_jax(clip):
    """A new future window rebuilds the engine at the next frame: the
    prediction buffer is reallocated to W + 1 zero rows and the window
    phase restarts at 0, then the rollout refills it, as in JAX."""
    js, ts = _sessions(clip, LOCKSTEP)
    for f in range(3):
        _frame((js, ts), clip, f)
    engine = ts._engine
    for s in (js, ts):
        s.set_lambdas(1.0, 0.02, 8)
    assert ts._engine_dirty
    ts._ensure_engine()
    js._ensure_engine()
    assert ts._engine is not engine
    assert tuple(ts._state.target_buffer.shape) == (9, 24)
    assert int(ts._state.current_index) == 0
    np.testing.assert_array_equal(ts._state.target_buffer.numpy(), 0.0)
    _assert_states(js, ts)
    for f in (3, 4):
        _assert_frame(_frame((js, ts), clip, f))
        _assert_states(js, ts)


@pytest.mark.parametrize("window", [60, 100])
def test_rollout_at_long_windows_matches_jax(window):
    """The rollout at the realtime default window (16 decoder steps) and at
    100 (26 steps; K2's 16-step bound once refused it) against JAX's."""
    import jax

    from dragposer_tpu.drag import engine as jeng
    from dragposer_tpu_torch.drag import engine as teng
    from dragposer_tpu_torch.ops import temporal_fused

    je, te = _engines("6_trackers")
    jh = je.hyper._replace(temporal_future_window=window)
    th = te.hyper._replace(temporal_future_window=window)
    rng = np.random.default_rng(window)
    B, P = 2, 14
    args = (rng.normal(size=(B, P, 24)), 0.01 * rng.normal(size=(B, P, 3)),
            0.9 + 0.1 * rng.normal(size=(B, P, 6)), rng.normal(size=(B, 24)))
    args = [a.astype(np.float32) for a in args]
    ref = jax.jit(lambda *a: jeng._temporal_rollout_core_T(
        je.model, jh, je.tparam, *a))(*args)
    before = temporal_fused.COUNTS.plain
    got = teng._temporal_rollout_core_T(
        te.model, th, te.tparam, *[torch.as_tensor(a) for a in args])
    assert temporal_fused.COUNTS.plain - before == window // 4 + 1
    assert tuple(got.shape) == (B, window + 1, 24)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-5)


def test_rollout_refuses_windows_past_the_positional_encoding():
    """Window 119 takes 30 decoder steps, the positional encoding's rows;
    120 takes 31 and is refused with the window named (JAX refuses it at
    trace time)."""
    from dragposer_tpu_torch.drag import engine as teng

    _, te = _engines("6_trackers")
    z = torch.zeros
    args = (z(1, 14, 24), z(1, 14, 3), z(1, 14, 6), z(1, 24))
    hyper = te.hyper._replace(temporal_future_window=119)
    out = teng._temporal_rollout_core_T(te.model, hyper, te.tparam, *args)
    assert tuple(out.shape) == (1, 120, 24)
    hyper = te.hyper._replace(temporal_future_window=120)
    with pytest.raises(ValueError, match="temporal_future_window 120"):
        teng._temporal_rollout_core_T(te.model, hyper, te.tparam, *args)


_ENGINES = {}


def _engines(config):
    if config not in _ENGINES:
        from dragposer_tpu.cli import eval_drag as jev
        from dragposer_tpu.ops.topology import Skeleton as JS
        from dragposer_tpu_torch.cli import eval_drag as tev
        from dragposer_tpu_torch.ops.topology import Skeleton as TS

        offsets = chip_smoke._BASE_OFFSETS.astype(np.float32)
        parents, names = chip_smoke.EXAMPLE_PARENTS, chip_smoke.JOINT_NAMES
        je, _, _ = jev.build_engine(MODEL_DIR, parents,
                                    jev.resolve_config(config),
                                    skeleton=JS.build(parents, offsets,
                                                      names))
        te, _, _ = tev.build_engine(MODEL_DIR, parents,
                                    tev.resolve_config(config),
                                    skeleton=TS.build(parents, offsets,
                                                      names), device="cpu")
        _ENGINES[config] = (je, te)
    return _ENGINES[config]


# ---------------------------------------------------------------------------
# RealtimeBatch and the coalesced step
# ---------------------------------------------------------------------------

def _batches(clip, n, optim, lambdas=WINDOW, stagger=False):
    """JAX and port batches of ``n`` avatars (avatar 1 at 4 trackers,
    avatar 2 at 3), the port's from JAX's initial state."""
    from dragposer_tpu_torch import config as cfg

    _, wp, wq = clip
    js, ts = _sessions(clip, optim, lambdas)
    jb, tb = js.make_batch(n), ts.make_batch(n)
    for avatar, name in ((1, "4_trackers"), (2, "3_trackers")):
        c = cfg.BUILTIN_CONFIGS[name]
        for b in (jb, tb):
            b.set_mask_and_weights(avatar, c.mask_array(), c.weights_array())
    gp0 = np.repeat(wp[0, 0][None], n, 0)
    gr0 = np.repeat(wq[0, 0][None], n, 0)
    jb.init_drag_pose(gp0, gr0, stagger_phases=stagger)
    tb.init_drag_pose(gp0, gr0, stagger_phases=stagger)
    tb._state = tb._engine.on_device(jb._state)
    return jb, tb


def _batch_targets(batch, clip, f):
    """Dense targets of frame ``f + avatar`` for every avatar, relative to
    its root."""
    _, wp, wq = clip
    n = batch.n_avatars
    gp = np.asarray(batch._state.global_pos)
    frames = (f + np.arange(n)) % T_CLIP
    return wp[frames] - gp[:, None], wq[frames]


def test_batch_matches_jax(clip):
    """Three avatars at 6, 4 and 3 trackers step together for three frames
    (the realtime stop rule, max_iter 4; the rollout at frame 0), the port
    from JAX's state."""
    jb, tb = _batches(clip, 3, REALTIME)
    for f in range(3):
        tpos, trot = _batch_targets(jb, clip, f)
        jl, jg = jb.drag_pose(tpos, trot)
        tl, tg = tb.drag_pose(tpos, trot)
        assert tl.shape == (3, J, 4) and tg.shape == (3, 3)
        np.testing.assert_allclose(tl, jl, atol=1e-4)
        np.testing.assert_allclose(tg, jg, atol=1e-5)
        np.testing.assert_allclose(tb._state.latent.numpy(),
                                   jb._state.latent, atol=1e-4)
        np.testing.assert_allclose(tb._state.target_buffer.numpy(),
                                   jb._state.target_buffer, rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_array_equal(tb._state.current_index.numpy(),
                                      jb._state.current_index)


def test_inactive_joint_targets_do_not_leak(clip):
    """Avatar 2 (3 trackers) ignores targets at joints its mask leaves out:
    garbage there changes nothing of its frame, bit for bit."""
    jb, tb = _batches(clip, 3, LOCKSTEP)
    state = tb._state
    tpos, trot = _batch_targets(jb, clip, 0)
    clean, _ = tb.drag_pose(tpos, trot)
    tb._state = state
    tpos = tpos.copy()
    tpos[2, [3, 7]] = 99.0
    dirty, _ = tb.drag_pose(tpos, trot)
    np.testing.assert_array_equal(dirty[2], clean[2])


def test_stagger_fill_matches_jax(clip):
    """``stagger_phases``: one init-time rollout of the whole batch and
    phases ``(arange(n)·W // n) % W``, as JAX's ``_stagger_fill``."""
    jb, tb = _batches(clip, 5, LOCKSTEP)
    state = jb._state
    jnew = jb._stagger_fill(jb._model_b(), state)
    tnew = tb._stagger_fill(tb._engine.on_device(state))
    n, w = 5, WINDOW[2]
    np.testing.assert_array_equal(tnew.current_index.numpy(),
                                  (np.arange(n) * w) // n % w)
    np.testing.assert_array_equal(tnew.current_index.numpy(),
                                  jnew.current_index)
    assert np.abs(tnew.target_buffer.numpy()).max() > 0
    np.testing.assert_allclose(tnew.target_buffer.numpy(),
                               jnew.target_buffer, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("case", ["window_1", "no_temporal"])
def test_stagger_fill_is_a_no_op(clip, tmp_path, case):
    """Without the temporal model, or at a window of 1 or less, staggering
    leaves the state as the unstaggered init makes it."""
    from dragposer_tpu_torch.runtime.realtime import RealtimeSession

    path, wp, wq = clip
    model_dir = MODEL_DIR
    if case == "no_temporal":
        model_dir = str(tmp_path / "model")
        shutil.copytree(MODEL_DIR, model_dir)
        (tmp_path / "model" / "temporal.npz").unlink()
    lambdas = (1.0, 0.02, 1) if case == "window_1" else WINDOW
    s = _configure(RealtimeSession(log_path=None, device="cpu"), path,
                   LOCKSTEP, lambdas, model_dir=model_dir)
    assert (s._temporal is None) == (case == "no_temporal")
    b = s.make_batch(4)
    gp0, gr0 = np.zeros((4, 3)), np.tile([[1.0, 0, 0, 0]], (4, 1))
    b.init_drag_pose(gp0, gr0)
    plain = b._state
    b.init_drag_pose(gp0, gr0, stagger_phases=True)
    for x, y in zip(b._state, plain):
        assert torch.equal(x, y)


def test_every_avatar_draws_the_same_initial_latent(clip):
    """One draw for the crowd, the one a session with the same seed takes."""
    from dragposer_tpu_torch.runtime.realtime import RealtimeSession

    path, wp, wq = clip
    s = _configure(RealtimeSession(log_path=None, device="cpu"), path,
                   LOCKSTEP, WINDOW)
    s.init_drag_pose(wp[0, 0][None], wq[0, 0][None], seed=7)
    b = s.make_batch(4)
    b.init_drag_pose(np.repeat(wp[0, 0][None], 4, 0),
                     np.repeat(wq[0, 0][None], 4, 0), seed=7)
    lat = b._state.latent
    for i in range(1, 4):
        assert torch.equal(lat[i], lat[0])
    # the encoder's product at 4 rows against 1 rounds apart in the last ulp
    np.testing.assert_allclose(lat[0].numpy(), s._state.latent.numpy(),
                               rtol=0, atol=1e-6)
    b.init_drag_pose(np.zeros((4, 3)), np.tile([[1.0, 0, 0, 0]], (4, 1)),
                     seed=8)
    assert not torch.equal(b._state.latent[0], s._state.latent)


def test_coalesced_step_keeps_padding_lanes_bit_for_bit(clip):
    """Inactive lanes come back as they went in; active lanes take the
    batched frame's state."""
    from dragposer_tpu_torch.drag import engine as teng
    from dragposer_tpu_torch.runtime.realtime import make_coalesced_step

    jb, tb = _batches(clip, 4, LOCKSTEP)
    engine = tb._engine
    states = tuple(teng.DragState(*[x[i] for x in tb._state])
                   for i in range(4))
    tpos, trot = _batch_targets(jb, clip, 0)
    active = np.array([True, False, True, False])
    step = make_coalesced_step(engine, 4)
    outs, local, gp = step(engine.model, tb._masks.numpy(),
                           tb._weights.numpy(), states, tpos, trot, active)
    assert local.shape == (4, J, 4) and gp.shape == (4, 3)
    for i in (1, 3):
        for x, y in zip(outs[i], states[i]):
            assert torch.equal(x, y)
    new_b, _, _ = tb._step(tb._model_b(), tb._state, torch.as_tensor(tpos),
                           torch.as_tensor(trot))
    for i in (0, 2):
        for x, y in zip(outs[i], new_b):
            assert torch.equal(x, y[i])
        assert not torch.equal(outs[i].latent, states[i].latent)
    with pytest.raises(ValueError):
        step(engine.model, tb._masks.numpy(), tb._weights.numpy(),
             states[:3], tpos, trot, active)
