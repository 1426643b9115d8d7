"""K1's plain twin (port ``fast_iter.run_block`` on the CPU) against JAX
``fast_iter.run_block`` and the interpret-mode Pallas kernel
``iter_kernel.run_block_fused``, mirroring ``tests/test_iter_kernel.py``.

The JAX side is built from the in-repo example checkpoint, the example
parents and seeded bone offsets; inputs are seeded numpy arrays handed to
both packages.  Tolerances are those of ``tests/test_iter_kernel.py``, for
its reason: forward and gradient agree to rtol 1e-5 / 1e-4 (the anchor);
whole blocks to rtol 5e-4, atol 5e-5·sync_k, because Adam's first step is
sign-like (lr·g/(|g| + eps)) and amplifies the reassociation differences of
a near-zero gradient component into latent differences that compound.

``test_hand_gradient_matches_autograd`` checks, on the CPU, the hand-written
backward that the CUDA kernel (``csrc/iter_block.cu``) implements: a torch
transcription of the kernel's per-lane reverse pass — FK as ancestor sums
and position gradients as descendant sums over the kernel's topology
masks, each joint gathering its children's terms, quaternion-product and
rotation transposes — against autograd.  The kernel's tensor-core
products are held in ``tests/test_torch_iter_pack.py``.
"""

import numpy as np
import pytest
import torch

from conftest import EXAMPLE_PARENTS

torch.set_num_threads(1)
MODEL_DIR = "models/model_dancedb_example"


@pytest.fixture(scope="module")
def setup():
    from dragposer_tpu.cli import eval_drag as jev
    from dragposer_tpu.ops.topology import Skeleton as JS
    from dragposer_tpu_torch.cli import eval_drag as tev
    from dragposer_tpu_torch.ops.topology import Skeleton as TS

    offsets = np.random.default_rng(2).normal(size=(22, 3)) * 0.15
    offsets[0] = 0.0
    jsk, tsk = JS.build(EXAMPLE_PARENTS, offsets), TS.build(EXAMPLE_PARENTS,
                                                            offsets)
    je, _, _ = jev.build_engine(MODEL_DIR, EXAMPLE_PARENTS,
                                jev.resolve_config("6_trackers"),
                                use_temporal=True, skeleton=jsk)
    te, _, _ = tev.build_engine(MODEL_DIR, EXAMPLE_PARENTS,
                                tev.resolve_config("6_trackers"),
                                use_temporal=True, skeleton=tsk, device="cpu")
    return je, jsk, te, tsk


def _inputs(B, seed=0, J=22, L=24):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    z0 = f(B, L) * 0.7
    gr = f(B, 4)
    gr /= np.linalg.norm(gr, axis=-1, keepdims=True)
    tpos = f(B, J, 3) * 0.3
    q = f(B, J, 4)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    tlat = f(B, L) * 0.2
    active = np.arange(B) % 5 != 3           # a few masked-out lanes
    return z0, gr, tpos, q, tlat, active


def _both(setup, B, seed=0, per_lane=False):
    """JAX and port (model, context, opt, targets) from the same numbers."""
    import jax
    import jax.numpy as jnp

    from dragposer_tpu.drag import engine as jeng
    from dragposer_tpu.drag import fast_iter as jfi
    from dragposer_tpu.ops import quat as jq
    from dragposer_tpu_torch.drag import engine as teng
    from dragposer_tpu_torch.drag import fast_iter as tfi

    je, jsk, te, tsk = setup
    z0, gr, tpos, q, tlat, active = _inputs(B, seed)
    trot = np.asarray(jq.to_matrix(q))
    jmodel, tmodel = je.model, te.model
    if per_lane:
        rng = np.random.default_rng(seed + 1)
        mask = (rng.uniform(size=(B, 22)) < 0.4).astype(np.float32)
        weights = np.broadcast_to(np.asarray(jmodel.weights),
                                  (B, 22, 2)).copy()
        jmodel = jmodel._replace(mask=jnp.asarray(mask),
                                 weights=jnp.asarray(weights))
        tmodel = tmodel._replace(mask=torch.as_tensor(mask),
                                 weights=torch.as_tensor(weights))
    jctx = jfi.make_context(jmodel, jsk, je.hyper)
    tctx = tfi.make_context(tmodel, tsk, te.hyper)
    jopt = jax.vmap(lambda z: jeng._opt_init(z, 22))(jnp.asarray(z0))
    topt = teng._opt_init(torch.as_tensor(z0), 22)
    tposT = np.ascontiguousarray(np.moveaxis(tpos, 0, -1))
    trotT = np.ascontiguousarray(np.moveaxis(trot, 0, -1))

    class JState:
        global_rot = jnp.asarray(gr)

    class TState:
        global_rot = torch.as_tensor(gr)

    J = (jmodel, jctx, jopt, jnp.asarray(active), JState, jnp.asarray(tposT),
         jnp.asarray(trotT), jnp.asarray(tlat))
    T = (tmodel, tctx, topt, torch.as_tensor(active), TState,
         torch.as_tensor(tposT), torch.as_tensor(trotT), torch.as_tensor(tlat))
    return J, T


def test_forward_and_grad_match_jax(setup):
    import jax
    import jax.numpy as jnp

    from dragposer_tpu.drag import fast_iter as jfi
    from dragposer_tpu_torch.drag import fast_iter as tfi

    je, _, te, _ = setup
    J, T = _both(setup, 32)
    _, jctx, jopt, _, JState, jtp, jtr, jtl = J
    _, tctx, topt, _, TState, ttp, ttr, ttl = T
    zj, zt = jopt.latent.T, topt.latent.T.contiguous()
    args_j = (JState.global_rot.T, jtp, jtr, jtl.T)
    args_t = (TState.global_rot.T, ttp, ttr, ttl.T)
    ref = jfi.forward_T(jctx, je.hyper, zj, *args_j)
    g_ref = jax.grad(lambda z: jnp.sum(
        jfi.forward_T(jctx, je.hyper, z, *args_j).total))(zj)
    zg = zt.clone().requires_grad_(True)
    got = tfi.forward_T(tctx, te.hyper, zg, *args_t)
    (g,) = torch.autograd.grad(got.total.sum(), zg)
    for name in ("total", "loss_pos", "loss_rot", "disp", "wr", "wd",
                 "pos"):
        np.testing.assert_allclose(getattr(got, name).detach().numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    # the normalized pose divides unit quats by stds as small as ~1e-2, so
    # a 1e-7 difference in a quat component is ~1e-5 there
    np.testing.assert_allclose(got.pose_cm.detach().numpy(),
                               np.asarray(ref.pose_cm), rtol=1e-5, atol=2e-5)
    # a gradient component is a sum of terms as large as the largest
    # component that cancel; their reassociation error scales with the
    # terms, so the absolute floor is relative to max |g|
    g_ref = np.asarray(g_ref)
    np.testing.assert_allclose(g.numpy(), g_ref, rtol=1e-4,
                               atol=2e-5 * np.abs(g_ref).max())


# --- a torch transcription of csrc/iter_block.cu's per-lane reverse pass ---

def _qmul(a, b):
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return (aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw)


def _conj(a):
    return (a[0], -a[1], -a[2], -a[3])


def _cross(a, b):
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _qrot_grad(q, v, g):
    qv = q[1:]
    c1 = _cross(qv, v)
    vg = _cross(v, g)
    gq_, qv_, gv_ = _dot(g, qv), _dot(qv, v), _dot(g, v)
    gq = (2 * _dot(c1, g),) + tuple(
        2 * (q[0] * vg[i] + gq_ * v[i] + qv_ * g[i] - 2 * gv_ * qv[i])
        for i in range(3))
    gqv = _cross(g, qv)
    qq = _dot(qv, qv)
    gv = tuple(g[i] + 2 * (q[0] * gqv[i] + gq_ * qv[i] - qq * g[i])
               for i in range(3))
    return gq, gv


def _to_matrix_grad(q, g):
    w, x, y, z = q
    return (2 * (-z * g[1] + y * g[2] + z * g[3] - x * g[5] - y * g[6]
                 + x * g[7]),
            2 * (y * g[1] + z * g[2] + y * g[3] - 2 * x * g[4] - w * g[5]
                 + z * g[6] + w * g[7] - 2 * x * g[8]),
            2 * (-2 * y * g[0] + x * g[1] + w * g[2] + x * g[3] + z * g[5]
                 - w * g[6] + z * g[7] - 2 * y * g[8]),
            2 * (-2 * z * g[0] - w * g[1] + x * g[2] + w * g[3] - 2 * z * g[4]
                 + y * g[5] + x * g[6] + y * g[7]))


def _hand_grad(ctx, hyper, zT, grT, tposT, trotT, tlatT):
    """d total / d z (L, B) by the kernel's reverse pass."""
    from dragposer_tpu_torch.drag import fast_iter as tfi
    from dragposer_tpu_torch.drag import iter_kernel as tik

    J = ctx.parents.shape[0]
    par = ctx.parents.tolist()
    lk = lambda a: torch.where(a >= 0, a, 0.2 * a)  # noqa: E731
    dlk = lambda h, g: torch.where(h >= 0, g, 0.2 * g)  # noqa: E731
    h1 = lk(ctx.W1 @ zT + ctx.b1)
    h2 = lk(ctx.W2 @ h1 + ctx.b2)
    h3 = ctx.W3p @ h2 + ctx.b3p
    x = h3[: 4 * J].reshape(4, J, -1) * ctx.sq + ctx.mq
    nrm = torch.sqrt((x * x).sum(0))
    u = tuple(x / nrm)
    disp = tuple(h3[4 * J: 4 * J + 3] * ctx.sd + ctx.md)
    W = _qmul(tuple(grT), tuple(c[0] for c in u))
    world = [list(_qmul(tuple(c[None] for c in W), u))[c].clone()
             for c in range(4)]
    for c in range(4):
        world[c][0] = W[c]
    wd = tfi._qrot(*W, *disp)
    pw = tuple(w[par] for w in world)
    off = tuple(ctx.offs[c] for c in range(3))
    contrib = tfi._qrot(*pw, *off)
    bits = lambda m: [a for a in range(J) if (int(m) >> a) & 1]  # noqa: E731
    anc, desc, child = tik.topology_masks(par)
    pos = []
    for j in range(J):   # ancestor sums over the kernel's masks
        acc = [torch.zeros_like(W[0]) for _ in range(3)]
        for a in bits(anc[j]):
            acc = [acc[c] + contrib[c][a] for c in range(3)]
        pos.append([acc[c] + wd[c] for c in range(3)])
    pos = [torch.stack([p[c] for p in pos]) for c in range(3)]
    n_ee = ctx.n_ee
    gpos = [2 * ctx.w_pos / (n_ee * 3) * (pos[c] - tposT[:, c])
            for c in range(3)]
    rm = tfi._rotmat_planes(*world)
    gm = [hyper.lambda_rot * 2 * ctx.w_rot / (n_ee * 9)
          * (rm[k] - trotT[:, k // 3, k % 3]) for k in range(9)]
    gw = [g.clone() for g in _to_matrix_grad(world, gm)]
    gwd = tuple(g.sum(0) for g in gpos)
    gpw = {}
    for j in range(1, J):   # descendant sums, sent to the parent
        sub = [sum(gpos[c][d] for d in bits(desc[j])) for c in range(3)]
        gpw[j], _ = _qrot_grad(tuple(p[j] for p in pw),
                               tuple(o[j] for o in off), sub)
    for j in range(J):      # each joint gathers its children's
        for ch in bits(child[j]):
            for c in range(4):
                gw[c][j] = gw[c][j] + gpw[ch][c]
    cu = _conj(u)
    gW_parts = _qmul(tuple(g[1:] for g in gw), tuple(c[1:] for c in cu))
    gu = [torch.cat((torch.zeros_like(g[:1]), g[1:]))
          for g in _qmul(_conj(tuple(w[None] for w in W)), tuple(gw))]
    gWd, gdisp = _qrot_grad(W, disp, gwd)
    gW = tuple(gw[c][0] + gW_parts[c].sum(0) + gWd[c] for c in range(4))
    gq0 = _qmul(_conj(tuple(grT)), gW)
    for c in range(4):
        gu[c][0] = gq0[c]
    ug = sum(u[c] * gu[c] for c in range(4))
    gx = torch.stack([(gu[c] - u[c] * ug) / nrm for c in range(4)]) * ctx.sq
    g3 = torch.cat((gx.reshape(4 * J, -1),
                    torch.stack(gdisp) * ctx.sd))
    g2 = dlk(h2, ctx.W3p.T @ g3)
    g1 = dlk(h1, ctx.W2.T @ g2)
    L = zT.shape[0]
    return ctx.W1.T @ g1 + hyper.lambda_temporal * 2 * (zT - tlatT) / L


@pytest.mark.parametrize("per_lane", [False, True])
def test_hand_gradient_matches_autograd(setup, per_lane):
    from dragposer_tpu_torch.drag import fast_iter as tfi

    _, _, te, _ = setup
    _, T = _both(setup, 24, seed=3, per_lane=per_lane)
    _, tctx, topt, _, TState, ttp, ttr, ttl = T
    zT = topt.latent.T.contiguous()
    args = (TState.global_rot.T, ttp, ttr, ttl.T)
    zg = zT.clone().requires_grad_(True)
    (g_ref,) = torch.autograd.grad(
        tfi.forward_T(tctx, te.hyper, zg, *args).total.sum(), zg)
    g = _hand_grad(tctx, te.hyper, zT, *args)
    np.testing.assert_allclose(g.numpy(), g_ref.numpy(), rtol=1e-4,
                               atol=1e-6)


@pytest.mark.parametrize("sync_k,B,per_lane", [(1, 16, False),
                                               (4, 130, False),
                                               (4, 40, True)])
def test_block_matches_jax(setup, sync_k, B, per_lane):
    from dragposer_tpu.drag import fast_iter as jfi
    from dragposer_tpu.drag import iter_kernel as jik
    from dragposer_tpu_torch.drag import fast_iter as tfi
    from dragposer_tpu_torch.drag import iter_kernel as tik

    je, jsk, te, tsk = setup
    J, T = _both(setup, B, per_lane=per_lane)
    jmodel, jctx, jopt, jact, JState, jtp, jtr, jtl = J
    tmodel, tctx, topt, tact, TState, ttp, ttr, ttl = T
    refs = [jfi.run_block(jctx, je.hyper, sync_k, jopt, jact, JState, jtp,
                          jtr, jtl, jmodel, je.statics, jsk),
            jik.run_block_fused(jctx, jik.make_kernel_context(jctx),
                                je.hyper, sync_k, jopt, jact, JState, jtp,
                                jtr, jtl)]
    before = tfi.COUNTS.plain
    got = tik.run_block_fused(tctx, tik.make_kernel_context(tctx), te.hyper,
                              sync_k, topt, tact, TState, ttp, ttr, ttl)
    assert tfi.COUNTS.plain == before + 1 and tfi.COUNTS.kernel == 0
    tol = dict(rtol=5e-4, atol=5e-5 * sync_k)
    for ref in refs:
        np.testing.assert_array_equal(got.t.numpy(), np.asarray(ref.t))
        for name in ("latent", "m", "v", "decoded_latent", "prev_loss",
                     "loss_pos", "loss_rot", "loss_incr"):
            np.testing.assert_allclose(getattr(got, name).numpy(),
                                       np.asarray(getattr(ref, name)),
                                       err_msg=name, **tol)
        for name in ("loss_pos", "loss_rot", "world_displacement",
                     "displacement", "world_rotation", "positions", "pose"):
            np.testing.assert_allclose(getattr(got.aux, name).numpy(),
                                       np.asarray(getattr(ref.aux, name)),
                                       err_msg=f"aux.{name}", **tol)


def test_block_respects_stop_rule(setup):
    """Lanes that satisfy the stop rule at block entry do not move."""
    from dragposer_tpu_torch.drag import iter_kernel as tik

    _, _, te, _ = setup
    _, T = _both(setup, 16)
    _, tctx, topt, _, TState, ttp, ttr, ttl = T
    done = torch.arange(16) < 4
    topt = topt._replace(
        loss_pos=torch.where(done, 0.0, topt.loss_pos),
        loss_rot=torch.where(done, 0.0, topt.loss_rot))
    got = tik.run_block_fused(tctx, tik.make_kernel_context(tctx), te.hyper,
                              3, topt, torch.ones(16, dtype=torch.bool),
                              TState, ttp, ttr, ttl)
    np.testing.assert_array_equal(got.t[:4].numpy(), 0)
    np.testing.assert_array_equal(got.latent[:4].numpy(),
                                  topt.latent[:4].numpy())
    assert (got.t[4:].numpy() == 3).all()


def test_kernel_context_needs_topological_parents(setup):
    from dragposer_tpu_torch.drag import iter_kernel as tik

    _, _, _, _ = setup
    _, T = _both(setup, 4)
    ctx = T[1]
    bad = ctx._replace(parents=ctx.parents.flip(0))
    with pytest.raises(ValueError):
        tik.make_kernel_context(bad)
