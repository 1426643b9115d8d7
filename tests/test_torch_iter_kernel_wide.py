"""K1's inner loop on models wider than its narrow build, on the CPU,
against the JAX package: the pipelined path (``run_batch_pipelined``) at
``latent_dim`` 48 on the example skeleton and on a 33-joint chain (folded
widths 40/72/136: H2 72 > 64 and J > 32), ``evaluate_batched`` at latent
48 (which raised before the general build), the size checks that now
apply only where a kernel launches, and the topology masks past 32
joints.

Each model is a random generator (``chip_smoke.wide_generator``: the
port's ``vae.init_params``, seeded) given to both packages as numpy, with
``use_temporal=False``; both start from the JAX package's initial states.
Knife-edge-free lockstep (stop thresholds 0, ``max_iter`` 5, a few lanes ×
8 frames) holds iteration counts equal and the values to
``tests/test_torch_pipeline.py``'s tolerances: latent atol 1e-4, root
position atol 1e-5, normalized pose rtol 1e-3 / atol 2e-3, position loss
rtol 1e-3 / atol 1e-7.
"""

import numpy as np
import pytest
import torch

import chip_smoke

torch.set_num_threads(1)
KNIFE_FREE = dict(stop_eps_pos=0.0, stop_eps_rot=0.0, min_loss_incr=-1e9,
                  max_iter=5)
LENGTHS = np.array([8, 6, 8, 3], np.int32)


def _engines(bvh, parents, params, means, stds, param, mask, weights):
    """The JAX and the port engine on the same numpy generator."""
    from dragposer_tpu.drag import engine as jeng
    from dragposer_tpu.models import vae as jvae
    from dragposer_tpu.ops.topology import Skeleton as JS
    from dragposer_tpu_torch.cli import eval_drag as ev
    from dragposer_tpu_torch.drag import engine as teng
    from dragposer_tpu_torch.models import vae as tvae
    from dragposer_tpu_torch.ops.topology import Skeleton as TS

    L = param["latent_dim"]
    hyper = dict(max_iter=ev.EVAL_MAX_ITER,
                 stop_eps_pos=ev.EVAL_STOP_EPS_POS,
                 stop_eps_rot=ev.EVAL_STOP_EPS_ROT,
                 min_loss_incr=ev.EVAL_MIN_LOSS_INCR,
                 learning_rate=ev.EVAL_LR, lambda_rot=ev.EVAL_LAMBDA_ROT,
                 use_temporal=False, joint_adjustment=None)
    fields = dict(decoder=params["decoder"], encoder=params["encoder"],
                  temporal=None, mean_dqs=means["dqs"], std_dqs=stds["dqs"],
                  mean_disp=means["displacement"],
                  std_disp=stds["displacement"],
                  means_latent=np.zeros(L, np.float32),
                  stds_latent=np.ones(L, np.float32), mask=mask,
                  weights=weights)
    je = jeng.DragEngine(jeng.DragModel(**fields),
                         jvae.build_statics(parents, param),
                         JS.build(parents, bvh.offsets, bvh.names),
                         jeng.DragHyper(**hyper), None)
    te = teng.DragEngine(teng.DragModel(**fields),
                         tvae.build_statics(parents, param),
                         TS.build(parents, bvh.offsets, bvh.names),
                         teng.DragHyper(**hyper), None, device="cpu")
    return je, te


def _lanes(je, bvh, means, stds):
    """Four lanes of the clip (lane i starting i frames in), the JAX
    package's initial states and their port copy."""
    import jax
    import jax.numpy as jnp

    from dragposer_tpu import config as jc
    from dragposer_tpu.data import encoding as jenc
    from dragposer_tpu.drag import engine as jeng
    from dragposer_tpu_torch.drag import engine as teng

    rots, pos, _, offsets, _ = jenc.info_from_bvh(bvh)
    m = jenc.encode_motion(offsets, pos[:, 0], rots, je.skeleton,
                           height_indices=jc.HEIGHT_INDICES)
    n = jenc.normalize(m, means, stds)
    T, b = int(LENGTHS.max()), len(LENGTHS)
    roll = lambda x: np.stack([np.roll(x, -i, 0)[:T]  # noqa: E731
                               for i in range(b)])
    dqs, gp, gr = roll(n.dqs), roll(n.global_pos), roll(n.global_rot)
    h0 = jnp.tile(jnp.asarray(m.heights[0])[None], (b, 1))
    keys = jax.random.split(jax.random.PRNGKey(0), b)
    states = jax.vmap(lambda k, d, g, r, h: jeng.init_state(
        je.model, je.statics, je.hyper, k, d[0][:, None], g[0], r[0], h))(
        keys, jnp.asarray(dqs), jnp.asarray(gp), jnp.asarray(gr), h0)
    tstates = teng.DragState(*[torch.as_tensor(np.array(x)) for x in states])
    return states, tstates, dqs, gp, gr


def _lockstep(je, te, states, tstates, dqs, gp, gr):
    import jax

    from dragposer_tpu_torch.drag import fast_iter, iter_kernel

    je.hyper = je.hyper._replace(**KNIFE_FREE)
    te.hyper = te.hyper._replace(**KNIFE_FREE)
    _, jo = je.run_batch_pipelined(states, dqs, gp, gr, sync_k=4,
                                   lengths=LENGTHS)
    jo = jax.tree.map(np.asarray, jo)
    before = fast_iter.COUNTS.plain
    _, to = te.run_batch_pipelined(tstates, dqs, gp, gr, sync_k=4,
                                   lengths=LENGTHS)
    # the CPU run took K1's inner loop through its plain twin
    assert fast_iter.COUNTS.plain > before
    assert fast_iter.COUNTS.kernel == iter_kernel.GENERAL_COUNTS.kernel == 0
    it = to.iterations.numpy()
    np.testing.assert_array_equal(it, jo.iterations)
    for i, n in enumerate(LENGTHS):
        assert (it[i, :n] == KNIFE_FREE["max_iter"]).all()
        assert (it[i, n:] == 0).all()
    np.testing.assert_allclose(to.latent.numpy(), jo.latent, atol=1e-4)
    np.testing.assert_allclose(to.global_pos.numpy(), jo.global_pos,
                               atol=1e-5)
    np.testing.assert_allclose(to.pose.numpy(), jo.pose, rtol=1e-3,
                               atol=2e-3)
    np.testing.assert_allclose(to.loss_pos.numpy(), jo.loss_pos, rtol=1e-3,
                               atol=1e-7)


def test_pipeline_at_latent_48_matches_jax():
    from dragposer_tpu_torch import config as tc

    bvh = chip_smoke.synthetic_bvh(16, seed=3)
    parents = chip_smoke.EXAMPLE_PARENTS
    params, means, stds, param = chip_smoke.wide_generator(parents, 48)
    cfg = tc.SIX_TRACKERS
    je, te = _engines(bvh, parents, params, means, stds, param,
                      cfg.mask_array(), cfg.weights_array())
    assert te.model.decoder["ws"][0].shape == (40, 48)
    _lockstep(je, te, *_lanes(je, bvh, means, stds))


def test_pipeline_on_a_33_joint_chain_matches_jax():
    bvh = chip_smoke.synthetic_chain_bvh(33, 16)
    parents = chip_smoke.chain_parents(33)
    params, means, stds, param = chip_smoke.wide_generator(parents, 24)
    mask, weights = chip_smoke.chain_tracker_mask(33)
    je, te = _engines(bvh, parents, params, means, stds, param, mask,
                      weights)
    assert [tuple(w.shape) for w in te.model.decoder["ws"]] == [
        (40, 24), (72, 40), (136, 72)]
    _lockstep(je, te, *_lanes(je, bvh, means, stds))


def test_evaluate_batched_at_latent_48_runs(tmp_path, capsys):
    """A latent-48 generator, no temporal model, two copies of a clip, 8
    frames: the case that raised ``K1 takes J ≤ 32, L ≤ 32, hidden ≤ 64``
    before the general build.  Both packages run it and land in the same
    range: the two start from different random latents, so MPJPE agrees
    within 50% (a random decoder's fit varies more than a trained one's,
    bounded to 20% in tests/test_torch_eval_drag.py)."""
    from dragposer_tpu.cli import eval_drag as jev
    from dragposer_tpu.data import encoding as jenc
    from dragposer_tpu.io.bvh import BVH
    from dragposer_tpu.ops.topology import Skeleton as JS
    from dragposer_tpu_torch.cli import eval_drag as tev
    from dragposer_tpu_torch.ops.topology import Skeleton as TS

    model = chip_smoke.write_wide_model(str(tmp_path / "model"), 48)
    path = str(tmp_path / "clip.bvh")
    chip_smoke.synthetic_bvh(24, seed=3).save(path)
    files = [path, path]
    first = BVH().load(path)
    _, _, parents, offsets, _ = jenc.info_from_bvh(first)
    cfg = "6_trackers"
    je, jm, js = jev.build_engine(model, parents, jev.resolve_config(cfg),
                                  use_temporal=False,
                                  skeleton=JS.build(parents, offsets,
                                                    first.names))
    te, tm, ts = tev.build_engine(model, parents, tev.resolve_config(cfg),
                                  use_temporal=False,
                                  skeleton=TS.build(parents, offsets,
                                                    first.names),
                                  device="cpu")
    ref = jev.evaluate_batched(je, jm, js, je.skeleton, files, max_frames=8,
                               save_dir=str(tmp_path / "jax"),
                               mesh_devices=1)
    got = tev.evaluate_batched(te, tm, ts, te.skeleton, files, max_frames=8,
                               save_dir=str(tmp_path / "torch"))
    assert "frames/s" in capsys.readouterr().out
    for (mt, et), (mj, ej) in zip(got, ref):
        assert np.isfinite([mt, et]).all()
        assert abs(mt - mj) <= 0.5 * mj, (mt, mj)


@pytest.mark.parametrize("n_joints,latent", [(22, 48), (33, 24), (64, 24),
                                             (128, 128), (130, 24)])
def test_kernel_context_on_the_cpu_takes_any_width(n_joints, latent):
    """``make_kernel_context`` and ``run_block_fused`` on CPU tensors take
    any width (the plain twin); :func:`iter_kernel.build_for` names the
    build a launch would take, and past the general build's limits the
    error names them."""
    from dragposer_tpu_torch.drag import fast_iter
    from dragposer_tpu_torch.drag import iter_kernel as ik

    engine = chip_smoke.wide_engine(n_joints, latent, device="cpu")[0]
    ctx, kctx, opt, active, state, tposT, trotT, tlat = chip_smoke.k1_inputs(
        engine, 6)
    H1, H2 = kctx.W1.shape[0], kctx.W2.shape[0]
    got = ik.run_block_fused(ctx, kctx, engine.hyper, 2, opt, active, state,
                             tposT, trotT, tlat)
    ref = fast_iter.run_block(ctx, engine.hyper, 2, opt, active, state,
                              tposT, trotT, tlat)
    torch.testing.assert_close(got.latent, ref.latent, rtol=0, atol=0)
    W = -(-n_joints // 32)
    assert kctx.topo.shape == (1 + 3 * W, n_joints)
    narrow = n_joints <= 32 and latent <= 32 and max(H1, H2) <= 64
    # split fragments for the narrow build, whole weights for the general
    assert kctx.frags.numel() == sum(
        (128 if narrow else 64) * (-(-w.shape[0] // 8))
        * (-(-w.shape[1] // 8)) for w in (kctx.W1, kctx.W2, kctx.W3))
    if narrow:
        assert ik.build_for(n_joints, latent, H1, H2) == "narrow"
    elif n_joints <= 128:
        assert ik.build_for(n_joints, latent, H1, H2) == "general"
    else:
        with pytest.raises(ValueError,
                           match="J ≤ 128, L ≤ 128, hidden ≤ 272"):
            ik.build_for(n_joints, latent, H1, H2)


def test_build_limits():
    from dragposer_tpu_torch.drag import iter_kernel as ik

    assert ik.build_for(22, 24, 40, 60) == "narrow"
    assert ik.build_for(32, 32, 64, 64) == "narrow"
    assert ik.build_for(22, 48, 40, 60) == "general"
    assert ik.build_for(33, 24, 40, 72) == "general"
    assert ik.build_for(128, 128, 272, 272) == "general"
    for sizes in ((129, 24, 40, 40), (64, 129, 40, 40), (64, 24, 280, 40)):
        with pytest.raises(ValueError, match="general build"):
            ik.build_for(*sizes)


@pytest.mark.parametrize("n_joints", [33, 64, 100])
def test_topology_masks_past_32_joints(n_joints):
    """Word w of joint j's masks holds joints 32w..32w+31: the ancestor,
    descendant and child sets of the ancestor matrix A (the JAX fast_iter
    layout: row j the ancestors of j, root excluded, j included) on a
    random topologically ordered tree."""
    from dragposer_tpu_torch.drag.iter_kernel import topology_masks

    rng = np.random.default_rng(n_joints)
    parents = np.array([0] + [int(rng.integers(0, j))
                              for j in range(1, n_joints)])
    A = np.zeros((n_joints, n_joints), np.int64)   # row j: ancestors of j
    for j in range(1, n_joints):
        A[j] = A[parents[j]]
        A[j, j] = 1
    masks = topology_masks(parents)
    W = -(-n_joints // 32)
    assert masks.shape == (3 * W, n_joints) and masks.dtype == np.uint32

    def bits(rows):
        return np.array([[(int(rows[a // 32, j]) >> (a % 32)) & 1
                          for a in range(n_joints)]
                         for j in range(n_joints)])

    np.testing.assert_array_equal(bits(masks[:W]), A)
    np.testing.assert_array_equal(bits(masks[W:2 * W]), A.T)
    child = np.zeros((n_joints, n_joints), np.int64)
    child[parents[1:], np.arange(1, n_joints)] = 1
    np.testing.assert_array_equal(bits(masks[2 * W:]), child)
