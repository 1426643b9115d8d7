"""The port's per-lane anchor path (``drag/engine.py``: ``_drag_loss``,
``frame_step``, ``DragEngine.run``/``run_batch``/``step``/
``step_realtime``) against the JAX package's, on the CPU, on a seeded
synthetic clip.  The two RNGs differ, so both runtimes start from the
JAX package's ``DragState``, carried across.

Tolerances:

* ``_drag_loss``: total and loss terms rtol 1e-5 / atol 1e-6, gradient
  rtol 1e-4 / atol 2e-5·max|g| (the floors of ROADMAP Queue 3: XLA and
  PyTorch associate sums differently);
* lockstep at one Adam step a frame (``max_iter=1``, stop thresholds 0):
  iterations equal, latent atol 1e-4, root position atol 1e-5, normalized
  pose rtol 1e-3 / atol 2e-3 (those of ``tests/test_torch_pipeline.py``);
  Adam's first step is sign-like, so the full stop rule is held by
  statistics only (mean iterations within 10%, mean position loss within
  25%);
* the port against itself (``run_batch`` against ``run``, ``step``
  against ``run``): 1e-6, the pose as quaternions 5e-6 (the CPU's
  products round with the lane count).
"""

import numpy as np
import pytest
import torch

import chip_smoke

torch.set_num_threads(1)
MODEL_DIR = "models/model_dancedb_example"
LOCKSTEP = dict(stop_eps_pos=0.0, stop_eps_rot=0.0, min_loss_incr=-1e9,
                max_iter=1)
T_CLIP = 32
_SETUPS = {}


def _setup(tmp_path_factory, config):
    """JAX and port engines for ``config``, the normalized clip (T, ...)
    and a JAX initial state (per lane)."""
    if config in _SETUPS:
        return _SETUPS[config]
    import jax

    from dragposer_tpu import config as jc
    from dragposer_tpu.cli import eval_drag as jev
    from dragposer_tpu.data import encoding as jenc
    from dragposer_tpu.drag import engine as jeng
    from dragposer_tpu.io.bvh import BVH
    from dragposer_tpu.ops.topology import Skeleton as JS
    from dragposer_tpu_torch.cli import eval_drag as tev
    from dragposer_tpu_torch.ops.topology import Skeleton as TS

    path = str(tmp_path_factory.mktemp("anchor") / "clip.bvh")
    chip_smoke.synthetic_bvh(T_CLIP, seed=5).save(path)
    bvh = BVH().load(path)
    rots, pos, parents, offsets, _ = jenc.info_from_bvh(bvh)
    jsk = JS.build(parents, offsets, bvh.names)
    tsk = TS.build(parents, offsets, bvh.names)
    je, means, stds = jev.build_engine(MODEL_DIR, parents,
                                       jev.resolve_config(config),
                                       skeleton=jsk)
    te, _, _ = tev.build_engine(MODEL_DIR, parents,
                                tev.resolve_config(config), skeleton=tsk,
                                device="cpu")
    m = jenc.encode_motion(offsets, pos[:, 0], rots, jsk,
                           height_indices=jc.HEIGHT_INDICES)
    n = jenc.normalize(m, means, stds)
    clip = (n.dqs, n.global_pos, n.global_rot)
    state = jeng.init_state(je.model, je.statics, je.hyper,
                            jax.random.PRNGKey(1), n.dqs[0][:, None],
                            n.global_pos[0], n.global_rot[0], m.heights[0])
    _SETUPS[config] = (je, te, clip, state, m.heights[0])
    return _SETUPS[config]


def _jax_engine(je, **hyper):
    """A JAX engine under ``hyper`` overrides (it compiles per hyper)."""
    from dragposer_tpu.drag import engine as jeng

    return jeng.DragEngine(je.model, je.statics, je.skeleton,
                           je.hyper._replace(**hyper), je.tparam)


def _port_engine(te, **hyper):
    import copy

    e = copy.copy(te)
    e.hyper = te.hyper._replace(**hyper)
    return e


def _np(tree):
    return type(tree)(*[np.asarray(x) for x in tree])


def _assert_lockstep(jo, to):
    np.testing.assert_array_equal(np.asarray(to.iterations), jo.iterations)
    np.testing.assert_allclose(np.asarray(to.latent), jo.latent, atol=1e-4)
    np.testing.assert_allclose(np.asarray(to.global_pos), jo.global_pos,
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(to.pose), jo.pose, rtol=1e-3,
                               atol=2e-3)


def _loss_inputs(te, je, clip, state, B, seed):
    """B random latents and one frame's targets, as numpy."""
    from dragposer_tpu.drag import engine as jeng

    rng = np.random.default_rng(seed)
    lat = rng.standard_normal((B, 24)).astype(np.float32)
    dqs, gp, gr = clip
    tpos, trot = jeng._eval_targets(je.model, je.skeleton, state, dqs[3],
                                    gp[3], gr[3])
    tlat = (0.5 * rng.standard_normal((B, 24))).astype(np.float32)
    return lat, np.asarray(tpos), np.asarray(trot), tlat


@pytest.mark.parametrize("decoder", ["folded", "unfolded"])
@pytest.mark.parametrize("bundle", ["none", "reference"])
@pytest.mark.parametrize("config", ["6_trackers", "3_trackers"])
def test_drag_loss_value_and_grad_match_jax(tmp_path_factory, config,
                                            bundle, decoder):
    """8 random latents per lane against ``jax.value_and_grad`` of JAX's
    ``_drag_loss``, through the folded decoder (``decode_folded_flat``)
    and the unfolded one (``vae.decode``), with and without the reference's
    constraint bundle."""
    import jax
    import jax.numpy as jnp

    from dragposer_tpu.drag import constraints as jcons
    from dragposer_tpu.drag import engine as jeng
    from dragposer_tpu.models import loading as jload
    from dragposer_tpu_torch.drag import constraints as tcons
    from dragposer_tpu_torch.drag import engine as teng
    from dragposer_tpu_torch.models import loading as tload

    je, te, clip, state, _ = _setup(tmp_path_factory, config)
    B = 8
    lat, tpos, trot, tlat = _loss_inputs(te, je, clip, state, B, seed=11)
    jmodel, tmodel = je.model, te.model
    if decoder == "unfolded":
        from dragposer_tpu import config as jc

        jparams, _, _ = jload.load_generator(MODEL_DIR, je.skeleton.parents,
                                             jc.VAE_PARAM)
        tparams, _, _ = tload.load_generator(MODEL_DIR)
        jmodel = jmodel._replace(decoder=jparams["decoder"])
        tmodel = tmodel._replace(
            decoder=tload.tree_to_torch(tparams["decoder"], "cpu"))
    jh = je.hyper._replace(constraints=jcons.REFERENCE_BUNDLE
                           if bundle == "reference" else ())
    th = te.hyper._replace(constraints=tcons.REFERENCE_BUNDLE
                           if bundle == "reference" else ())
    f = jax.vmap(jax.value_and_grad(jeng._drag_loss, has_aux=True),
                 in_axes=(0, None, None, None, None, None, None, None, None,
                          0))
    (jt, jaux), jg = f(jnp.asarray(lat), jmodel, je.statics, je.skeleton, jh,
                      state.global_pos, state.global_rot, tpos, trot,
                      jnp.asarray(tlat))
    rep = lambda a: torch.as_tensor(np.array(a))[None].expand(  # noqa: E731
        (B,) + np.shape(a))
    z = torch.tensor(lat, requires_grad=True)
    tt, taux = teng._drag_loss(z, tmodel, te.statics, te.skeleton, th,
                               rep(state.global_pos), rep(state.global_rot),
                               rep(tpos), rep(trot), torch.as_tensor(tlat))
    (tg,) = torch.autograd.grad(tt.sum(), z)
    assert tt.shape == (B,)
    np.testing.assert_allclose(tt.detach().numpy(), jt, rtol=1e-5, atol=1e-6)
    for name in ("loss_pos", "loss_rot", "world_displacement",
                 "displacement", "world_rotation", "positions", "pose"):
        np.testing.assert_allclose(
            getattr(taux, name).detach().numpy(), getattr(jaux, name),
            rtol=1e-5, atol=2e-5 if name == "pose" else 1e-6, err_msg=name)
    jg = np.asarray(jg)
    np.testing.assert_allclose(tg.numpy(), jg, rtol=1e-4,
                               atol=2e-5 * np.abs(jg).max())


@pytest.mark.parametrize("config", ["6_trackers", "4_trackers"])
def test_frame_step_matches_jax(tmp_path_factory, config):
    """Three frames at one Adam step each, each frame started from the JAX
    state of that frame: the 4-tracker frames cover the rollout at a window
    boundary (``current_index`` 0) and the held predictions (1, 2)."""
    import jax

    from dragposer_tpu.drag import engine as jeng
    from dragposer_tpu_torch.drag import engine as teng

    je, te, clip, state, _ = _setup(tmp_path_factory, config)
    jh = je.hyper._replace(**LOCKSTEP)
    th = te.hyper._replace(**LOCKSTEP)
    dqs, gp, gr = clip
    jstep = jax.jit(lambda s, d, p, r: jeng.eval_frame_step(
        je.model, je.statics, je.skeleton, jh, je.tparam, s, (d, p, r)))
    T = lambda a: torch.as_tensor(np.array(a))[None]  # noqa: E731
    for f in range(3):
        jnew, jo = jstep(state, dqs[f], gp[f], gr[f])
        tnew, to = teng.eval_frame_step(
            te.model, te.statics, te.skeleton, th, te.tparam,
            teng.DragState(*[T(x) for x in state]), (T(dqs[f]), T(gp[f]),
                                                    T(gr[f])))
        to = teng._lane(to)
        _assert_lockstep(_np(jo), to)
        tnew = teng._lane(tnew)
        np.testing.assert_allclose(tnew.target_buffer.numpy(),
                                   jnew.target_buffer, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(tnew.latent_buffer.numpy(),
                                   jnew.latent_buffer, atol=1e-4)
        np.testing.assert_allclose(tnew.heights_buffer.numpy(),
                                   jnew.heights_buffer, atol=1e-5)
        np.testing.assert_allclose(tnew.displacement_buffer.numpy(),
                                   jnew.displacement_buffer, atol=1e-5)
        assert int(tnew.current_index) == int(jnew.current_index)
        state = jnew


@pytest.mark.parametrize("config", ["6_trackers", "4_trackers"])
def test_run_lockstep_matches_jax(tmp_path_factory, config):
    """``DragEngine.run`` over 8 frames at one Adam step a frame."""
    je, te, clip, state, _ = _setup(tmp_path_factory, config)
    args = tuple(a[:8] for a in clip)
    _, jo = _jax_engine(je, **LOCKSTEP).run(state, *args)
    new, to = _port_engine(te, **LOCKSTEP).run(state, *args)
    assert to.latent.shape == (8, 24) and new.latent.shape == (24,)
    _assert_lockstep(_np(jo), to)


def _lane_inputs(te, clip, state, B, T):
    """B lanes of the clip, lane b starting b frames in, from the same
    initial state with lane-dependent latents."""
    from dragposer_tpu_torch.drag import engine as teng

    s = te.on_device(state)
    lanes = teng.DragState(*[x[None].repeat((B,) + (1,) * x.dim())
                             for x in s])
    lanes = lanes._replace(latent=lanes.latent * torch.linspace(
        0.8, 1.2, B)[:, None])
    args = [torch.stack([torch.as_tensor(a[b:b + T]) for b in range(B)])
            for a in clip]
    return lanes, args


def test_run_batch_equals_run(tmp_path_factory):
    """``run_batch`` on 3 lanes against 3 calls of ``run``, in lockstep at
    one Adam step a frame: the CPU's products differ in the last bits with
    the lane count, which later Adam steps amplify past 1e-6."""
    from dragposer_tpu_torch.drag import engine as teng

    _, te, clip, state, _ = _setup(tmp_path_factory, "6_trackers")
    e = _port_engine(te, **LOCKSTEP)
    lanes, args = _lane_inputs(te, clip, state, 3, 8)
    _, ob = e.run_batch(lanes, *args)
    _, std_q = teng._quat_stats(te.model)
    for b in range(3):
        _, o = e.run(teng.DragState(*[x[b] for x in lanes]),
                     *[a[b] for a in args])
        # the pose as quaternions (normalized channels divide by stds
        # down to ~1e-2), to 5e-6: the decoder's products on 3 rows and on
        # 1 round apart by a few float32 ulps, 2e-6 at most measured
        np.testing.assert_allclose((ob.pose[b] * std_q).numpy(),
                                   (o.pose * std_q).numpy(), atol=5e-6)
        for name in ("latent", "global_pos", "loss_pos"):
            np.testing.assert_allclose(getattr(ob, name)[b].numpy(),
                                       getattr(o, name).numpy(), rtol=1e-6,
                                       atol=1e-6, err_msg=name)
        np.testing.assert_array_equal(ob.iterations[b].numpy(),
                                      o.iterations.numpy())


def test_stop_rule_statistics_match_jax(tmp_path_factory):
    """The full stop rule (``max_iter`` 100) over 4 lanes × 24 frames:
    mean iterations within 10%, mean final position loss within 25%."""
    import jax.numpy as jnp

    from dragposer_tpu.drag import engine as jeng

    je, te, clip, state, _ = _setup(tmp_path_factory, "6_trackers")
    lanes, args = _lane_inputs(te, clip, state, 4, 24)
    _, to = te.run_batch(lanes, *args)
    jlanes = jeng.DragState(*[jnp.asarray(x.numpy()) for x in lanes])
    _, jo = je.run_batch(jlanes, *[a.numpy() for a in args])
    it_t, it_j = to.iterations.float().mean().item(), \
        float(np.asarray(jo.iterations).mean())
    assert to.iterations.min() >= 1
    assert abs(it_t - it_j) <= 0.1 * it_j, (it_t, it_j)
    lp_t = to.loss_pos.mean().item()
    lp_j = float(np.asarray(jo.loss_pos).mean())
    assert abs(lp_t - lp_j) <= 0.25 * lp_j, (lp_t, lp_j)


def test_step_equals_a_frame_of_run(tmp_path_factory):
    """``step`` given ``_eval_targets`` is the first frame of ``run``."""
    from dragposer_tpu_torch.drag import engine as teng

    _, te, clip, state, _ = _setup(tmp_path_factory, "4_trackers")
    s = te.on_device(state)
    dqs, gp, gr = (torch.as_tensor(a[:1]) for a in clip)
    tpos, trot = teng._eval_targets(te.model, te.skeleton, teng._lead(s),
                                    dqs, gp, gr)
    new_s, out_s = te.step(s, tpos[0], trot[0])
    new_r, out_r = te.run(s, dqs, gp, gr)
    for a, b in zip(out_s, out_r):
        np.testing.assert_allclose(a.numpy(), b[0].numpy(), rtol=1e-6,
                                   atol=1e-6)
    for a, b in zip(new_s, new_r):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-6)


def test_step_realtime_matches_jax(tmp_path_factory):
    """``step_realtime`` (quaternion targets in, parent-local quaternions
    and the root position out) against JAX's at one Adam step."""
    import jax.numpy as jnp

    from dragposer_tpu.drag import engine as jeng

    je, te, clip, state, _ = _setup(tmp_path_factory, "6_trackers")
    dqs, gp, gr = clip
    tpos, _ = jeng._eval_targets(je.model, je.skeleton, state, dqs[2],
                                 gp[2], gr[2])
    rng = np.random.default_rng(4)
    tquat = rng.standard_normal((22, 4)).astype(np.float32)
    tquat /= np.linalg.norm(tquat, axis=-1, keepdims=True)
    jnew, jlocal, jgp = _jax_engine(je, **LOCKSTEP).step_realtime(
        state, tpos, jnp.asarray(tquat))
    tnew, tlocal, tgp = _port_engine(te, **LOCKSTEP).step_realtime(
        state, np.asarray(tpos), tquat)
    assert tlocal.shape == (22, 4) and tgp.shape == (3,)
    np.testing.assert_allclose(tlocal.numpy(), np.asarray(jlocal), atol=1e-5)
    np.testing.assert_allclose(tgp.numpy(), np.asarray(jgp), atol=1e-5)
    np.testing.assert_allclose(tnew.latent.numpy(), np.asarray(jnew.latent),
                               atol=1e-4)
