"""The port's hypothesis beam (``drag/hypotheses.py``) on the anchor
(``DragEngine.run_batch``), on the CPU, on seeded synthetic clips.

* With R = 1 the beam is ``engine.run`` (bit for bit: the same operations
  on one lane, chunked).
* With the JAX package's draws handed to the port (initial noise and
  resampling noise, drawn from JAX's key schedule) and one Adam step a
  frame, the resampling map ``parents`` equals JAX's and the cumulative
  fit losses agree to rtol 1e-4 over 3 chunks of 8 frames.
* ``run_hypotheses_batched`` gives each file what the file gets alone: a
  ragged file padded to the longest is unaffected by its padding (latents
  1e-5, cumulative loss rtol 1e-5: lanes round apart by a few float32 ulps
  with the lane count).
* The incumbent is never lost: after a resampling point lane 0 continues
  the best lineage exactly, as the same lane run alone does (latents 1e-5
  at one Adam step a frame: more steps amplify the lane-count rounding).
"""

import numpy as np
import pytest
import torch

import chip_smoke

torch.set_num_threads(1)
MODEL_DIR = "models/model_dancedb_example"
LOCKSTEP = dict(stop_eps_pos=0.0, stop_eps_rot=0.0, min_loss_incr=-1e9,
                max_iter=1)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    from dragposer_tpu_torch.cli import eval_drag as tev
    from dragposer_tpu_torch.data import encoding
    from dragposer_tpu_torch.io.bvh import BVH
    from dragposer_tpu_torch.ops.topology import Skeleton

    files = chip_smoke.write_synthetic_clips(
        str(tmp_path_factory.mktemp("beam")), (24, 16), seed=9)
    bvh = BVH().load(files[0])
    _, _, parents, offsets, _ = encoding.info_from_bvh(bvh)
    sk = Skeleton.build(parents, offsets, bvh.names)
    te, means, stds = tev.build_engine(MODEL_DIR, parents,
                                       tev.resolve_config("4_trackers"),
                                       skeleton=sk, device="cpu")
    clips = []
    for path in files:
        _, motion, norm = tev._encode(path, sk, means, stds)
        clips.append((norm.dqs, norm.global_pos, norm.global_rot,
                      motion.heights[0]))
    return te, parents, clips


def _engine(te, **hyper):
    import copy

    e = copy.copy(te)
    e.hyper = te.hyper._replace(**hyper)
    return e


def _noise(R, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((R, 24)).astype(np.float32),
            rng.standard_normal((n, R, 24)).astype(np.float32))


def test_one_hypothesis_is_run(setup):
    from dragposer_tpu_torch.drag import engine as teng
    from dragposer_tpu_torch.drag import hypotheses

    te, _, clips = setup
    e = _engine(te, max_iter=20)
    dqs, gp, gr, h0 = (a[:8] if a.ndim > 1 else a for a in clips[0])
    init, _ = _noise(1, 0, 3)
    pose0 = dqs[0][:, None]
    out, parents, scores = hypotheses.run_hypotheses(
        e, None, 1, dqs, gp, gr, h0, pose0, branch_every=3,
        init_noise=init)
    state = e.init_state(None, pose0[None], gp[:1], gr[:1], h0[None],
                         noise=init)
    _, ref = e.run(teng.DragState(*[x[0] for x in state]), dqs, gp, gr)
    assert parents.shape == (3, 1) and scores.shape == (3, 1)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a, b.numpy())


def _jax_draws(seed, R, n_resample):
    """JAX's ``run_hypotheses`` draws: per-lane init noise, then one (R, L)
    draw a resampling point."""
    import jax

    key = jax.random.PRNGKey(seed)
    key, init_key = jax.random.split(key)
    keys = jax.random.split(init_key, R)
    init = np.stack([np.asarray(jax.random.normal(k, (1, 24)))[0]
                     for k in keys])
    eps = []
    for _ in range(n_resample):
        key, nk = jax.random.split(key)
        eps.append(np.asarray(jax.random.normal(nk, (R, 24))))
    return init, np.stack(eps)


def test_parents_and_cum_match_jax(setup):
    from dragposer_tpu.cli import eval_drag as jev
    from dragposer_tpu.drag import engine as jeng
    from dragposer_tpu.drag import hypotheses as jhyp
    from dragposer_tpu.ops.topology import Skeleton as JS
    from dragposer_tpu_torch.drag import hypotheses

    te, parents, clips = setup
    R, seed = 8, 5
    dqs, gp, gr, h0 = clips[0]
    pose0 = dqs[0][:, None]
    je, _, _ = jev.build_engine(MODEL_DIR, parents,
                                jev.resolve_config("4_trackers"),
                                skeleton=JS.build(parents,
                                                  te.skeleton.offsets))
    je = jeng.DragEngine(je.model, je.statics, je.skeleton,
                         je.hyper._replace(**LOCKSTEP), je.tparam)
    import jax

    kw = dict(branch_every=8, sigma=0.25, survivors=3, return_all=True)
    jout, jpar, jsc, jcum = jhyp.run_hypotheses(
        je, jax.random.PRNGKey(seed), R, dqs, gp, gr, h0, pose0, **kw)
    init, eps = _jax_draws(seed, R, 2)
    tout, tpar, tsc, tcum = hypotheses.run_hypotheses(
        _engine(te, **LOCKSTEP), None, R, dqs, gp, gr, h0, pose0,
        init_noise=init, resample_noise=eps, **kw)
    assert tpar.shape == (3, R)
    np.testing.assert_array_equal(tpar, jpar)
    np.testing.assert_allclose(tsc, jsc, rtol=1e-4)
    np.testing.assert_allclose(tcum, jcum, rtol=1e-4)
    np.testing.assert_allclose(tout.latent, np.asarray(jout.latent),
                               atol=1e-4)


def test_batched_is_invariant_to_ragged_lengths_and_padding(setup):
    from dragposer_tpu_torch.drag import hypotheses

    te, _, clips = setup
    e = _engine(te, **LOCKSTEP)
    R, T = 4, 12
    lengths = np.array([12, 8])

    def pad(x, n):
        return np.concatenate((x[:n], np.repeat(x[n - 1:n], T - n, 0)))

    dqs, gp, gr = (np.stack([pad(c[i], n) for c, n in zip(clips, lengths)])
                   for i in range(3))
    h0 = np.stack([c[3] for c in clips])
    init, eps = _noise(2 * R, 2, seed=8)
    kw = dict(branch_every=4, sigma=0.5, survivors=2)
    out, cum = hypotheses.run_hypotheses_batched(
        e, None, R, dqs, gp, gr, h0, dqs[:, 0][:, :, None], lengths=lengths,
        init_noise=init, resample_noise=eps, **kw)
    assert out.latent.shape == (2, T, 24) and cum.shape == (2, R)
    for f, n in enumerate(lengths):
        lanes = slice(f * R, (f + 1) * R)
        alone, cum1 = hypotheses.run_hypotheses_batched(
            e, None, R, dqs[f:f + 1, :n], gp[f:f + 1, :n], gr[f:f + 1, :n],
            h0[f:f + 1], dqs[f:f + 1, 0][:, :, None], init_noise=init[lanes],
            resample_noise=eps[:, lanes], **kw)
        np.testing.assert_allclose(out.latent[f, :n], alone.latent[0],
                                   atol=1e-5)
        np.testing.assert_allclose(cum[f].min(), cum1[0].min(), rtol=1e-5)


def test_incumbent_is_never_lost(setup):
    """One survivor and a large re-seed: after the resampling point every
    lane descends from the first chunk's best lane, lane 0 without noise, so
    its lineage is that lane's own run, and the winner's loss is no worse."""
    from dragposer_tpu_torch.drag import engine as teng
    from dragposer_tpu_torch.drag import hypotheses

    te, _, clips = setup
    e = _engine(te, **LOCKSTEP)
    R = 4
    dqs, gp, gr, h0 = (a[:16] if a.ndim > 1 else a for a in clips[0])
    pose0 = dqs[0][:, None]
    init, eps = _noise(R, 1, seed=2)
    out, parents, scores, cum = hypotheses.run_hypotheses(
        e, None, R, dqs, gp, gr, h0, pose0, branch_every=8, sigma=3.0,
        survivors=1, return_all=True, init_noise=init, resample_noise=eps)
    best = int(np.argmin(scores[0]))
    np.testing.assert_array_equal(parents[0], [best] * R)
    np.testing.assert_array_equal(parents[1], np.arange(R))
    state = e.init_state(None, pose0[None], gp[:1], gr[:1], h0[None],
                         noise=init[best:best + 1])
    _, solo = e.run(teng.DragState(*[x[0] for x in state]), dqs, gp, gr)
    np.testing.assert_allclose(out.latent[0], solo.latent.numpy(), atol=1e-5)
    solo_cum = (solo.loss_pos + solo.loss_rot).mean().item()
    assert cum.min() <= solo_cum * (1 + 1e-5)
    np.testing.assert_allclose(cum[0], solo_cum, rtol=1e-5)
