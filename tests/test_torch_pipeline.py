"""The port's whole slice against the JAX package: pipelined batched
reconstruction (``drag/pipeline.run_batch_pipelined``), with K1's inner
loop and with the per-lane one (constraints, an unfolded decoder), on the
CPU (plain twins of both kernels), on a seeded synthetic clip.

Both runtimes start from the same ``DragState``, made by the JAX package
and carried across, because the two RNGs differ.

* Knife-edge-free mode (stop thresholds 0, ``min_loss_incr`` very
  negative, ``max_iter`` 5): every lane runs exactly ``max_iter`` steps per
  frame in both runtimes, so iteration counts must be equal and poses,
  root positions and latents agree to float32 reassociation, amplified by
  Adam's sign-like first step and by the recurrent buffers: latent atol
  1e-4, root position atol 1e-5, normalized pose rtol 1e-3 / atol 2e-3 (the
  atol of ``tests/test_pipeline.py``'s lockstep check; normalized channels
  divide by stds down to ~1e-2).
* Under the real stop rule one flipped iteration count changes a lane's
  trajectory from there on (``pipeline.py:24-28``), so the comparison is
  statistical: mean iterations within 10% and mean final position loss
  within 25%.
"""

import numpy as np
import pytest
import torch

import chip_smoke

torch.set_num_threads(1)
MODEL_DIR = "models/model_dancedb_example"
KNIFE_FREE = dict(stop_eps_pos=0.0, stop_eps_rot=0.0, min_loss_incr=-1e9,
                  max_iter=5)
T_FRAMES = 16
LENGTHS = np.array([16, 13, 16, 5, 15, 16], np.int32)
# windowed config: more lanes than the rollout's lane budget (8 for 24
# lanes at window 16) and staggered window phases, so each block's rollout
# runs on a gathered sub-batch (``engine._rollout_where_needed``).  Eight
# frames: at 4 trackers the lockstep difference compounds through the
# recurrent buffers (one lane of 24 grows from ~1e-6 to 8e-4 by frame 11),
# so the latent tolerance holds over a shorter horizon than at 6 trackers.
WINDOWED_LENGTHS = np.array([8, 6, 8, 3] * 6, np.int32)


def _build_setup(tmp_path_factory, config, lengths, stagger,
                 use_temporal=True):
    import jax
    import jax.numpy as jnp

    from dragposer_tpu import config as jc
    from dragposer_tpu.cli import eval_drag as jev
    from dragposer_tpu.data import encoding as jenc
    from dragposer_tpu.drag import engine as jeng
    from dragposer_tpu.io.bvh import BVH
    from dragposer_tpu.ops.topology import Skeleton as JS
    from dragposer_tpu_torch.cli import eval_drag as tev
    from dragposer_tpu_torch.drag import engine as teng
    from dragposer_tpu_torch.ops.topology import Skeleton as TS

    T = int(lengths.max())
    path = str(tmp_path_factory.mktemp("slice") / "clip.bvh")
    chip_smoke.synthetic_bvh(T + 8, seed=3).save(path)
    bvh = BVH().load(path)
    rots, pos, parents, offsets, _ = jenc.info_from_bvh(bvh)
    jsk = JS.build(parents, offsets, bvh.names)
    tsk = TS.build(parents, offsets, bvh.names)
    je, means, stds = jev.build_engine(MODEL_DIR, parents,
                                       jev.resolve_config(config),
                                       use_temporal=use_temporal,
                                       skeleton=jsk)
    te, _, _ = tev.build_engine(MODEL_DIR, parents,
                                tev.resolve_config(config),
                                use_temporal=use_temporal, skeleton=tsk,
                                device="cpu")
    m = jenc.encode_motion(offsets, pos[:, 0], rots, jsk,
                           height_indices=jc.HEIGHT_INDICES)
    n = jenc.normalize(m, means, stds)
    b = len(lengths)
    # per-lane phase offsets, so lanes differ
    roll = lambda x: np.stack([np.roll(x, -(i % 8), 0)[:T]  # noqa: E731
                               for i in range(b)])
    dqs, gp, gr = roll(n.dqs), roll(n.global_pos), roll(n.global_rot)
    h0 = jnp.tile(jnp.asarray(m.heights[0])[None], (b, 1))
    keys = jax.random.split(jax.random.PRNGKey(0), b)
    states = jax.vmap(lambda k, d, g, r, h: jeng.init_state(
        je.model, je.statics, je.hyper, k, d[0][:, None], g[0], r[0], h))(
        keys, jnp.asarray(dqs), jnp.asarray(gp), jnp.asarray(gr), h0)
    if stagger:
        window = je.hyper.temporal_future_window
        states = states._replace(current_index=jnp.asarray(
            np.arange(b) % window, jnp.int32))
    tstates = teng.DragState(*[torch.as_tensor(np.array(x)) for x in states])
    return je, te, states, tstates, dqs, gp, gr, lengths


@pytest.fixture(scope="module")
def slice_setup(tmp_path_factory):
    return _build_setup(tmp_path_factory, "6_trackers", LENGTHS, False)


@pytest.fixture(scope="module")
def windowed_setup(tmp_path_factory):
    return _build_setup(tmp_path_factory, "4_trackers", WINDOWED_LENGTHS,
                        True)


def _run_both(setup, jax_fast=True, jax_hyper=None, **hyper):
    """Both pipelines under ``hyper`` overrides (JAX's under
    ``jax_hyper`` too, for constraint functions of its own)."""
    import jax

    je, te, states, tstates, dqs, gp, gr, lengths = setup
    jh, th = je.hyper, te.hyper
    je.hyper = jh._replace(**{**hyper, **(jax_hyper or {})})
    te.hyper = th._replace(**hyper)
    je._run_pipelined = {}        # its jitted runner closes over the hyper
    try:
        _, jo = je.run_batch_pipelined(states, dqs, gp, gr, sync_k=4,
                                       lengths=lengths, fast=jax_fast)
        _, to = te.run_batch_pipelined(tstates, dqs, gp, gr, sync_k=4,
                                       lengths=lengths)
    finally:
        je.hyper, te.hyper = jh, th
        je._run_pipelined = {}
    return jax.tree.map(np.asarray, jo), to


def _assert_lockstep(jo, to, lengths, max_iter=KNIFE_FREE["max_iter"]):
    it = to.iterations.numpy()
    np.testing.assert_array_equal(it, jo.iterations)
    for i, n in enumerate(lengths):       # ragged lanes halt at their length
        assert (it[i, :n] == max_iter).all()
        assert (it[i, n:] == 0).all()
        np.testing.assert_array_equal(to.pose.numpy()[i, n:], 0.0)
    np.testing.assert_allclose(to.latent.numpy(), jo.latent, atol=1e-4)
    np.testing.assert_allclose(to.global_pos.numpy(), jo.global_pos,
                               atol=1e-5)
    np.testing.assert_allclose(to.pose.numpy(), jo.pose, rtol=1e-3,
                               atol=2e-3)
    np.testing.assert_allclose(to.loss_pos.numpy(), jo.loss_pos, rtol=1e-3,
                               atol=1e-7)


def test_pipeline_lockstep_matches_jax(slice_setup):
    from dragposer_tpu_torch.drag import fast_iter
    from dragposer_tpu_torch.ops import temporal_fused

    before = (fast_iter.COUNTS.plain, temporal_fused.COUNTS.plain)
    jo, to = _run_both(slice_setup, **KNIFE_FREE)
    # the CPU run went through both plain twins, never a kernel
    assert fast_iter.COUNTS.plain > before[0]
    assert temporal_fused.COUNTS.plain > before[1]
    assert fast_iter.COUNTS.kernel == 0 and temporal_fused.COUNTS.kernel == 0
    _assert_lockstep(jo, to, LENGTHS)


def test_windowed_pipeline_lockstep_matches_jax(windowed_setup,
                                                monkeypatch):
    """4-tracker config (window 16): the rollout runs on the sub-batch of
    lanes at a window boundary and its predictions are held across the
    window; staggered phases make that sub-batch smaller than the batch."""
    from dragposer_tpu_torch.drag import engine as teng

    _, te, _, _, _, _, _, lengths = windowed_setup
    assert te.hyper.temporal_future_window == 16
    rollout_batches = []
    core = teng._temporal_rollout_core_T

    def spy(model, hyper, tparam, lat, *rest):
        rollout_batches.append(lat.shape[0])
        return core(model, hyper, tparam, lat, *rest)

    monkeypatch.setattr(teng, "_temporal_rollout_core_T", spy)
    jo, to = _run_both(windowed_setup, **KNIFE_FREE)
    assert 0 < min(rollout_batches) < len(lengths)
    _assert_lockstep(jo, to, lengths)


# The other configs in knife-edge-free lockstep: 5 and 3 trackers (3 as
# ``build_engine`` builds it, one start) on the windowed case's 24
# staggered lanes of 8 frames, and 6 trackers without the temporal model
# (``--no-temporal``; K1 then gets lambda_t = 0) in both engines.
@pytest.mark.parametrize("config,lengths,stagger,use_temporal", [
    ("5_trackers", WINDOWED_LENGTHS, True, True),
    ("3_trackers", WINDOWED_LENGTHS, True, True),
    ("6_trackers", LENGTHS, False, False)],
    ids=["5_trackers", "3_trackers", "6_trackers-no_temporal"])
def test_config_pipeline_lockstep_matches_jax(tmp_path_factory, config,
                                              lengths, stagger,
                                              use_temporal):
    from dragposer_tpu_torch.ops import temporal_fused

    setup = _build_setup(tmp_path_factory, config, lengths, stagger,
                         use_temporal)
    assert setup[1].hyper.use_temporal == use_temporal
    rollouts = temporal_fused.COUNTS.plain
    jo, to = _run_both(setup, **KNIFE_FREE)
    _assert_lockstep(jo, to, lengths)
    assert (temporal_fused.COUNTS.plain > rollouts) == use_temporal


def test_pipeline_stop_rule_statistics_match_jax(slice_setup):
    jo, to = _run_both(slice_setup, max_iter=100)
    valid = np.arange(T_FRAMES)[None, :] < LENGTHS[:, None]
    it_t = to.iterations.numpy()[valid].astype(float)
    it_j = jo.iterations[valid].astype(float)
    assert it_t.min() >= 1 and it_j.min() >= 1
    assert abs(it_t.mean() - it_j.mean()) <= 0.1 * it_j.mean(), (
        it_t.mean(), it_j.mean())
    lp_t, lp_j = to.loss_pos.numpy()[valid].mean(), jo.loss_pos[valid].mean()
    assert abs(lp_t - lp_j) <= 0.25 * lp_j, (lp_t, lp_j)


def test_per_lane_loop_lockstep_matches_jax(slice_setup):
    """With the reference's constraint bundle the pipeline's inner loop is
    the anchor's per-lane step (JAX's ``fast=False``): knife-edge-free
    lockstep at one Adam step a frame, K1 and its twin untouched."""
    from dragposer_tpu.drag import constraints as jcons
    from dragposer_tpu_torch.drag import constraints as tcons
    from dragposer_tpu_torch.drag import fast_iter

    before = (fast_iter.COUNTS.plain, fast_iter.COUNTS.kernel)
    jo, to = _run_both(slice_setup, jax_fast=False,
                       jax_hyper=dict(constraints=jcons.REFERENCE_BUNDLE),
                       **dict(KNIFE_FREE, max_iter=1,
                              constraints=tcons.REFERENCE_BUNDLE))
    assert (fast_iter.COUNTS.plain, fast_iter.COUNTS.kernel) == before
    _assert_lockstep(jo, to, LENGTHS, max_iter=1)


def test_unported_paths_raise(slice_setup):
    """The constraint and unfolded-decoder cases run the per-lane inner
    loop with K1 untouched (and refuse ``fast=True``); the default device
    raises without a GPU."""
    from dragposer_tpu_torch._device import resolve_device
    from dragposer_tpu_torch.drag import fast_iter, pipeline
    from dragposer_tpu_torch.models import loading

    _, te, _, tstates, dqs, gp, gr, _ = slice_setup
    args = [torch.as_tensor(a[:, :2]) for a in (dqs, gp, gr)]
    params, _, _ = loading.load_generator(MODEL_DIR)
    unfolded = te.model._replace(
        decoder=loading.tree_to_torch(params["decoder"], "cpu"))
    hyper = te.hyper._replace(max_iter=3)
    for model, h in ((te.model, hyper._replace(
            constraints=((lambda ctx: ctx.latent.pow(2).sum(-1), 0.1),))),
            (unfolded, hyper)):
        before = (fast_iter.COUNTS.plain, fast_iter.COUNTS.kernel)
        _, out = pipeline.run_batch_pipelined(
            model, te.statics, te.skeleton, h, te.tparam, tstates, *args)
        assert (fast_iter.COUNTS.plain, fast_iter.COUNTS.kernel) == before
        assert torch.isfinite(out.pose).all() and out.iterations.min() >= 1
        with pytest.raises(ValueError, match="fast inner loop"):
            pipeline.run_batch_pipelined(
                model, te.statics, te.skeleton, h, te.tparam, tstates,
                *args, fast=True)
    # the default device is CUDA; without a GPU it raises, never falls back
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            resolve_device()
