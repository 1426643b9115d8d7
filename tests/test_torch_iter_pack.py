"""What K1 (``csrc/iter_block.cu``) computes beyond its plain twin, held on
the CPU: the fragment packing of its weights, the topology masks of its
per-joint stage, the aux it writes from each lane's last forward, and its
3xTF32 decoder products.

A CUDA kernel cannot run here, so its tensor-core choreography is emulated
in torch, thread by thread as the kernel indexes it: ``mma.m16n8k8.tf32``
fragments (PTX layout: A a0..a3 at (g, t), (g+8, t), (g, t+4), (g+8, t+4);
B b0, b1 at (t, g), (t+4, g); C c0..c3 at (g, 2t), (g, 2t+1), (g+8, 2t),
(g+8, 2t+1), lane = 4g + t), the accumulator-to-A renumbering, and the
forward (float4) and transposed (float2) reads of the packed weights.
Each emulated mma forms its products exactly (float64) and rounds the sum
to float32 once, as the tensor cores do to within their truncation; as in
the kernel, each k-step's passes start from zero and are added to the
running sum in float32.

Tolerances: the packing reproduces each weight to 2⁻²² relative (hi + lo
of a TF32 split); a block at sync_k = 1 is held to ``chip_smoke.K1_TOL``
against the interpret-mode JAX kernel, which the same emulation in one
TF32 pass must fail — so the tolerance tells 3xTF32 from TF32.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from conftest import EXAMPLE_PARENTS
from test_torch_iter_kernel import _both, setup  # noqa: F401

torch.set_num_threads(1)
LANE = torch.arange(32)
G, T = LANE // 4, LANE % 4


# --- the kernel's fragment choreography, emulated ---

def _tf32(x):
    from dragposer_tpu_torch.ops.temporal_fused import tf32_round

    return tf32_round(x)


def _c_tiles(X):
    """(NB, 16, 8n) → accumulator fragments of each 8-column tile,
    (NB, n, 32, 4)."""
    NB, _, w = X.shape
    Xt = X.reshape(NB, 16, w // 8, 8).permute(0, 2, 1, 3)
    return torch.stack([Xt[:, :, G, 2 * T], Xt[:, :, G, 2 * T + 1],
                        Xt[:, :, G + 8, 2 * T], Xt[:, :, G + 8, 2 * T + 1]],
                       dim=-1)


def _from_c_tiles(c):
    NB, n = c.shape[:2]
    Xt = torch.zeros((NB, n, 16, 8), dtype=c.dtype)
    Xt[:, :, G, 2 * T] = c[..., 0]
    Xt[:, :, G, 2 * T + 1] = c[..., 1]
    Xt[:, :, G + 8, 2 * T] = c[..., 2]
    Xt[:, :, G + 8, 2 * T + 1] = c[..., 3]
    return Xt.permute(0, 2, 1, 3).reshape(NB, 16, 8 * n)


def _mma(d, a, b):
    """d (NB, 32, 4) += A·B from a (NB, 32, 4) and b (32, 2) fragments."""
    NB = a.shape[0]
    A = torch.zeros((NB, 16, 8), dtype=torch.float64)
    A[:, G, T] = a[..., 0].double()
    A[:, G + 8, T] = a[..., 1].double()
    A[:, G, T + 4] = a[..., 2].double()
    A[:, G + 8, T + 4] = a[..., 3].double()
    Bm = torch.zeros((8, 8), dtype=torch.float64)
    Bm[T, G] = b[:, 0].double()
    Bm[T + 4, G] = b[:, 1].double()
    return _c_tiles((A @ Bm + _from_c_tiles(d[:, None]).double()).float()
                    )[:, 0]


def _c_to_a(c, passes):
    a = c[..., [0, 2, 1, 3]]
    hi = _tf32(a)
    return hi, _tf32(a - hi)


def _mma3(d, ah, al, bh, bl, passes):
    """One k-step's passes from a zero accumulator, added in float32."""
    s = torch.zeros_like(d)
    if passes == 3:
        s = _mma(s, al, bh)
        s = _mma(s, ah, bl)
    return d + _mma(s, ah, bh)


def fragment_position(f):
    from dragposer_tpu_torch.drag.iter_kernel import fragment_position

    return fragment_position(f)


def _load_b(P, k, n):
    """The kernel's ``load_b``: the float4 at the lane's position of block
    (n, k) → (b hi (32, 2), b lo (32, 2))."""
    w = P[n, k, fragment_position(LANE)]
    return w[:, [0, 2]], w[:, [1, 3]]


def _load_bt(P, k, n):
    """The kernel's ``load_bt``: W[8k + 2t][8n + g] and W[8k + 2t + 1][8n +
    g] as float2 {hi, lo} reads of the forward-packed block (k, n)."""
    e = (G & 1) * 2
    f0 = (8 * T + (G >> 1)) ^ (2 * T)
    f1 = (8 * T + 4 + (G >> 1)) ^ (2 * T)
    blk = P[k, n]
    return (torch.stack([blk[f0, e], blk[f1, e]], dim=-1),
            torch.stack([blk[f0, e + 1], blk[f1, e + 1]], dim=-1))


def _forward_product(x, P, bias, passes):
    """The kernel's ``forward_product``: x (NB, ks, 32, 4) → y (NB, nt, 32,
    4), bias added."""
    nt, ks = P.shape[:2]
    y = torch.zeros((x.shape[0], nt, 32, 4))
    for k in range(ks):
        ah, al = _c_to_a(x[:, k], passes)
        for n in range(nt):
            bh, bl = _load_b(P, k, n)
            y[:, n] = _mma3(y[:, n], ah, al, bh, bl, passes)
    bp = torch.zeros(8 * nt)
    bp[: bias.shape[0]] = bias
    b0, b1 = bp.reshape(nt, 8)[:, 2 * T], bp.reshape(nt, 8)[:, 2 * T + 1]
    return y + torch.stack([b0, b1, b0, b1], dim=-1)


def _backward_product(gout, P, passes):
    """The kernel's ``backward_product`` without the gates: gout (NB, kt,
    32, 4) over W's rows → (NB, ks, 32, 4) over its columns."""
    kt, ks = P.shape[:2]
    gin = torch.zeros((gout.shape[0], ks, 32, 4))
    for k in range(kt):
        ah, al = _c_to_a(gout[:, k], passes)
        for n in range(ks):
            bh, bl = _load_bt(P, k, n)
            gin[:, n] = _mma3(gin[:, n], ah, al, bh, bl, passes)
    return gin


def _pad_tiles(X, cols):
    """(B, w) → (NB, 16, cols) zero-padded."""
    B, w = X.shape
    NB = -(-B // 16)
    out = torch.zeros((NB * 16, cols))
    out[:B, :w] = X
    return out.reshape(NB, 16, cols)


def _unpad(X, B, w):
    return X.reshape(-1, X.shape[-1])[:B, :w]


def emulated_decoder(kctx, Z, passes):
    """The kernel's decoder forward at Z (B, L): (h1, h2, h3) with h1, h2
    after LeakyReLU, and a function G3 (B, H3) → dL/dZ through the
    transposed products, gated by the forward's pre-activations."""
    from dragposer_tpu_torch.drag.iter_kernel import pack_fragments

    B = Z.shape[0]
    Ps = [pack_fragments(w) for w in (kctx.W1, kctx.W2, kctx.W3)]
    x = _c_tiles(_pad_tiles(Z, 8 * Ps[0].shape[1]))
    y1 = _forward_product(x, Ps[0], kctx.b1, passes)
    a1 = torch.where(y1 >= 0, y1, 0.2 * y1)
    y2 = _forward_product(a1, Ps[1], kctx.b2, passes)
    a2 = torch.where(y2 >= 0, y2, 0.2 * y2)
    y3 = _forward_product(a2, Ps[2], kctx.b3, passes)

    def backward(G3):
        g = _c_tiles(_pad_tiles(G3, 8 * Ps[2].shape[0]))
        g2 = _backward_product(g, Ps[2], passes)
        g2 = torch.where(y2 >= 0, g2, 0.2 * g2)
        g1 = _backward_product(g2, Ps[1], passes)
        g1 = torch.where(y1 >= 0, g1, 0.2 * g1)
        gz = _backward_product(g1, Ps[0], passes)
        return _unpad(_from_c_tiles(gz), B, Z.shape[1])

    H = [w.shape[0] for w in (kctx.W1, kctx.W2, kctx.W3)]
    return ([_unpad(_from_c_tiles(y), B, h)
             for y, h in ((a1, H[0]), (a2, H[1]), (y3, H[2]))], backward)


# --- the packing ---

@pytest.fixture(scope="module")
def kctx(setup):  # noqa: F811
    from dragposer_tpu_torch.drag import iter_kernel as tik

    _, T_ = _both(setup, 4)
    return tik.make_kernel_context(T_[1])


@pytest.mark.parametrize("name", ["W1", "W2", "W3"])
def test_packed_fragments_reproduce_weights(kctx, name):
    """hi + lo read through the kernel's forward and transposed addressing
    is the weight to 2⁻²², zero in the padding."""
    from dragposer_tpu_torch.drag.iter_kernel import pack_fragments

    w = getattr(kctx, name).double()
    P = pack_fragments(getattr(kctx, name))
    nt, ks = P.shape[:2]
    Wp = torch.zeros((8 * nt, 8 * ks), dtype=torch.float64)
    Wp[: w.shape[0], : w.shape[1]] = w
    tol = 2.0 ** -22 * Wp.abs() + 1e-30
    for n in range(nt):
        for k in range(ks):
            bh, bl = _load_b(P, k, n)
            got = bh.double() + bl.double()
            want = torch.stack([Wp[8 * n + G, 8 * k + 2 * T],
                                Wp[8 * n + G, 8 * k + 2 * T + 1]], dim=-1)
            assert ((got - want).abs() <= torch.stack(
                [tol[8 * n + G, 8 * k + 2 * T],
                 tol[8 * n + G, 8 * k + 2 * T + 1]], dim=-1)).all()
            assert torch.equal(bh, _tf32(bh)) and torch.equal(bl, _tf32(bl))
    for k in range(nt):            # transposed: k over W's rows
        for n in range(ks):
            bh, bl = _load_bt(P, k, n)
            got = bh.double() + bl.double()
            want = torch.stack([Wp[8 * k + 2 * T, 8 * n + G],
                                Wp[8 * k + 2 * T + 1, 8 * n + G]], dim=-1)
            assert ((got - want).abs() <= torch.stack(
                [tol[8 * k + 2 * T, 8 * n + G],
                 tol[8 * k + 2 * T + 1, 8 * n + G]], dim=-1)).all()


def test_fragment_reads_are_free_of_bank_conflicts():
    """The forward float4 reads (8 lanes a 128-byte wavefront) and the
    transposed float2 reads (16 lanes a wavefront) of one packed block hit
    distinct banks."""
    pos = fragment_position(LANE)
    assert sorted(pos.tolist()) == list(range(32))
    for q in range(4):   # float4: lanes 8q..8q+7, 4 banks each
        assert len(set((pos[8 * q: 8 * q + 8] % 8).tolist())) == 8
    e = (G & 1) * 2
    for f in ((8 * T + (G >> 1)) ^ (2 * T), (8 * T + 4 + (G >> 1)) ^ (2 * T)):
        word = f * 4 + e
        for h in range(2):   # float2: lanes 16h..16h+15, 2 banks each
            assert len(set(((word[16 * h: 16 * h + 16] % 32) // 2)
                           .tolist())) == 16


def test_topology_masks_match_jax_ancestor_matrix(setup):  # noqa: F811
    from dragposer_tpu.drag import fast_iter as jfi
    from dragposer_tpu_torch.drag.iter_kernel import topology_masks

    je, jsk, _, _ = setup
    A = np.asarray(jfi.make_context(je.model, jsk, je.hyper).A)
    anc, desc, child = topology_masks(EXAMPLE_PARENTS)
    J = len(EXAMPLE_PARENTS)
    bits = lambda m: np.array([(int(x) >> a) & 1 for x in m  # noqa: E731
                               for a in range(J)]).reshape(J, J)
    np.testing.assert_array_equal(bits(anc), A)
    np.testing.assert_array_equal(bits(desc), A.T)
    want = np.zeros((J, J), np.int64)
    for j in range(1, J):
        want[EXAMPLE_PARENTS[j], j] = 1
    np.testing.assert_array_equal(bits(child), want)


@pytest.mark.parametrize("passes", [3, 1])
def test_emulated_decoder_against_float64(kctx, passes):
    """The emulated products against float64: 3xTF32 to ~float32, one TF32
    pass three orders of magnitude worse."""
    rng = np.random.default_rng(5)
    B = 37
    Z = torch.as_tensor(rng.normal(size=(B, 24)).astype(np.float32))
    G3 = torch.as_tensor(rng.normal(size=(B, kctx.W3.shape[0]))
                         .astype(np.float32) * 1e-2)
    (h1, h2, h3), backward = emulated_decoder(kctx, Z, passes)
    W1, W2, W3 = (kctx.W1.double(), kctx.W2.double(), kctx.W3.double())
    p1 = Z.double() @ W1.T + kctx.b1.double()
    r1 = torch.where(p1 >= 0, p1, 0.2 * p1)
    p2 = r1 @ W2.T + kctx.b2.double()
    r2 = torch.where(p2 >= 0, p2, 0.2 * p2)
    r3 = r2 @ W3.T + kctx.b3.double()
    g2 = G3.double() @ W3
    g2 = torch.where(p2 >= 0, g2, 0.2 * g2)
    g1 = g2 @ W2
    g1 = torch.where(p1 >= 0, g1, 0.2 * g1)
    gz = g1 @ W1
    rel = lambda a, b: float((a.double() - b).abs().max()  # noqa: E731
                             / b.abs().max())
    errs = [rel(h3, r3), rel(backward(G3), gz)]
    if passes == 3:
        assert max(errs) < 1e-6, errs
    else:
        assert min(errs) > 1e-4, errs


# --- the aux from the last forward ---

def test_last_forward_is_aux_at_decoded(setup):  # noqa: F811
    """For every lane that steps, the twin's forward at its last step is
    ``aux_at(decoded_latent)``: the kernel may write the aux from it."""
    from dragposer_tpu_torch.drag import fast_iter as tfi

    _, _, te, _ = setup
    B = 40
    _, T_ = _both(setup, B, seed=7)
    _, tctx, topt, tact, TState, ttp, ttr, ttl = T_
    hyper = te.hyper._replace(max_iter=6)   # some lanes stop inside
    forwards = []
    forward = tfi.forward_T

    def recording(*args):
        f = forward(*args)
        forwards.append(f)
        return f

    tfi.forward_T = recording
    try:
        out = tfi.run_block(tctx, hyper, 8, topt, tact, TState, ttp, ttr,
                            ttl)
    finally:
        tfi.forward_T = forward
    steps = (out.t - topt.t).numpy()
    assert (steps >= 1).sum() > B // 2 and len(set(steps.tolist())) > 1
    last = {"loss_pos": [], "loss_rot": [], "world_displacement": [],
            "displacement": [], "world_rotation": [], "positions": [],
            "pose": []}
    for b in np.nonzero(steps >= 1)[0]:
        f = forwards[steps[b] - 1]     # the run's forwards: steps, then aux
        last["loss_pos"].append(f.loss_pos[b])
        last["loss_rot"].append(f.loss_rot[b])
        last["world_displacement"].append(f.wd[:, b])
        last["displacement"].append(f.disp[:, b])
        last["world_rotation"].append(f.wr[:, b])
        last["positions"].append(f.pos[:, :, b])
        last["pose"].append(f.pose_cm[tctx.unperm, b])
    stepped = torch.as_tensor(steps >= 1)
    for name, vals in last.items():
        got = torch.stack(vals).detach()
        want = getattr(out.aux, name)[stepped]
        # the same formulas on the same latents; only the batch around
        # each lane differs
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=name)


# --- 3xTF32 against the TPU kernel ---

def _emulated_step(te, tctx, kctx, topt, tact, TState, ttp, ttr, ttl,
                   passes):
    """One block at sync_k = 1 as the kernel computes it: the decoder and
    its transpose through the emulated fragments, the per-joint stage in
    plain float32 (its hand-written reverse is held to autograd in
    tests/test_torch_iter_kernel.py), Adam as in the twin."""
    from dragposer_tpu_torch.drag import engine as teng
    from dragposer_tpu_torch.drag import fast_iter as tfi

    hyper = te.hyper
    z = topt.latent
    (_, _, h3), backward = emulated_decoder(kctx, z, passes)
    hT = h3.T.contiguous().requires_grad_(True)
    zT = z.T.contiguous().requires_grad_(True)
    f = tfi.loss_from_decoded(tctx, hyper, hT, zT, TState.global_rot.T, ttp,
                              ttr, ttl.T)
    gh, gzt = torch.autograd.grad(f.total.sum(), (hT, zT))
    g = backward(gh.T) + gzt.T
    active = tact     # every lane's stop rule holds at a fresh carry
    m = (1.0 - teng._ADAM_B1) * g
    v = (1.0 - teng._ADAM_B2) * g * g
    m_hat = m / (1.0 - teng._ADAM_B1)
    v_hat = v / (1.0 - teng._ADAM_B2)
    z_n = z - hyper.learning_rate * m_hat / (torch.sqrt(v_hat)
                                             + teng._ADAM_EPS)
    a = active[:, None]
    total = f.total.detach()
    sel = lambda new, old: torch.where(active, new, old)  # noqa: E731
    c = lambda x: x.detach().contiguous()  # noqa: E731
    aux = teng._LossAux(
        loss_pos=c(f.loss_pos), loss_rot=c(f.loss_rot),
        world_displacement=c(f.wd.T), displacement=c(f.disp.T),
        world_rotation=c(f.wr.T), positions=c(f.pos.permute(2, 0, 1)),
        pose=c(f.pose_cm[tctx.unperm].T))
    return teng._OptCarry(
        latent=torch.where(a, z_n, z), m=torch.where(a, m, topt.m),
        v=torch.where(a, v, topt.v), t=sel(topt.t + 1, topt.t),
        prev_loss=sel(total, topt.prev_loss),
        loss_pos=sel(f.loss_pos.detach(), topt.loss_pos),
        loss_rot=sel(f.loss_rot.detach(), topt.loss_rot),
        loss_incr=sel(topt.prev_loss - total, topt.loss_incr),
        decoded_latent=torch.where(a, z, topt.decoded_latent), aux=aux)


@pytest.mark.parametrize("passes", [3, 1])
def test_emulated_kernel_step_against_jax_kernel(setup, passes):  # noqa: F811
    """sync_k = 1: the emulated 3xTF32 step within K1_TOL of the
    interpret-mode Pallas kernel in every lane; one TF32 pass outside it."""
    from dragposer_tpu.drag import iter_kernel as jik
    from dragposer_tpu_torch.drag import iter_kernel as tik

    je, _, te, _ = setup
    B = 48
    J_, T_ = _both(setup, B, seed=11)
    _, jctx, jopt, jact, JState, jtp, jtr, jtl = J_
    _, tctx, topt, tact, TState, ttp, ttr, ttl = T_
    ref = jik.run_block_fused(jctx, jik.make_kernel_context(jctx), je.hyper,
                              1, jopt, jact, JState, jtp, jtr, jtl)
    got = _emulated_step(te, tctx, tik.make_kernel_context(tctx), topt,
                         tact, TState, ttp, ttr, ttl, passes)
    ref_t = type(got)(*[type(got.aux)(*[torch.as_tensor(np.array(x))
                                        for x in ref.aux])
                        if i == 9 else torch.as_tensor(np.array(x))
                        for i, x in enumerate(ref)])
    r = chip_smoke.k1_agreement(got, ref_t, B, 1)
    assert r["t_mismatch"] == 0, r
    if passes == 3:
        assert r["ok"] and r["lanes_over_tol"] == 0, r
    else:
        assert not r["ok"] and r["lanes_over_tol"] > 0, r
