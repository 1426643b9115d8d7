"""K2's plain twin (port ``ops/temporal_fused.forward`` on the CPU) against
JAX ``models/temporal.forward`` and the interpret-mode Pallas kernel
``ops/temporal_fused.forward``, on the example checkpoint.

Tolerance rtol 1e-4, atol 1e-5, as ``tests/test_temporal_fused.py``: the
same function with softmax, LayerNorm and the 2048-wide FF sums
reassociated.  Masks: the rollout's (1, S_dec) visibility mask and a full
(S_dec, S_dec) causal mask; column 0 is always visible.

The CUDA kernel forms its products on the tensor cores as 3xTF32 from
weights split at pack time: the split, the fragment layout and the 3-term
product's accuracy are held here in plain PyTorch (the kernel itself runs
only on the card, ``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)
MODEL_DIR = "models/model_dancedb_example"


@pytest.fixture(scope="module")
def setup():
    from dragposer_tpu import config as jc
    from dragposer_tpu.models import loading as jl
    from dragposer_tpu.ops import temporal_fused as jf
    from dragposer_tpu_torch.ops import temporal_fused as tf

    params, _, _ = jl.load_temporal(MODEL_DIR, jc.TEMPORAL_PARAM)
    return (params, jc.TEMPORAL_PARAM,
            jf.pack_params(params, jc.TEMPORAL_PARAM),
            tf.pack_params(params, jc.TEMPORAL_PARAM, "cpu"))


def _mask(kind, s_dec):
    if kind == "row":
        m = np.where(np.arange(s_dec) <= s_dec // 2, 0.0, -np.inf)[None]
    else:
        m = np.where(np.tri(s_dec, dtype=bool), 0.0, -np.inf)
    return m.astype(np.float32)


@pytest.mark.parametrize("b,s_dec,kind", [(1, 1, "row"), (3, 1, "row"),
                                          (5, 5, "row"), (3, 5, "square"),
                                          (1, 5, "square")])
def test_plain_twin_matches_jax(setup, b, s_dec, kind):
    from dragposer_tpu.models import temporal as jt
    from dragposer_tpu.ops import temporal_fused as jf
    from dragposer_tpu_torch.ops import temporal_fused as tf

    params, param, jpacked, tpacked = setup
    rng = np.random.default_rng(b * 10 + s_dec)
    enc = rng.normal(size=(b, 14, 33)).astype(np.float32)
    dec = rng.normal(size=(b, s_dec, 24)).astype(np.float32)
    mask = _mask(kind, s_dec)
    ref = np.asarray(jt.forward(params, param, enc, dec, tgt_mask=mask))
    ker = np.asarray(jf.forward(jpacked, param, enc, dec, mask))
    before = tf.COUNTS.plain
    got = tf.forward(tpacked, param, torch.as_tensor(enc),
                     torch.as_tensor(dec), torch.as_tensor(mask)).numpy()
    assert tf.COUNTS.plain == before + 1 and tf.COUNTS.kernel == 0
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, ker, rtol=1e-4, atol=1e-5)


def test_pointer_table_order(setup):
    """84 weights in the order the CUDA kernel's enums expect; projection
    matrices (in, out) fragment-packed as (out/8, in8/8, 32, 4), FF
    matrices as split wgmma tiles of 64 hidden columns."""
    from dragposer_tpu_torch.ops import temporal_fused as tf

    ptrs = tf._pointers(setup[3])
    assert len(ptrs) == 9 + 3 * 10 + 3 * 15
    shapes = [tuple(p.shape) for p in ptrs]
    assert shapes[:9] == [(6, 5, 32, 4), (48,), (6, 3, 32, 4), (48,),
                          (3, 6, 32, 4), (24,), (30, 48), (2, 48), (2, 48)]
    assert shapes[9:19] == [(18, 6, 32, 4), (144,), (6, 6, 32, 4), (48,),
                            (32, 2, 6, 8, 2, 8, 4), (2048,),
                            (32, 2, 8, 6, 2, 8, 4), (48,), (2, 48), (2, 48)]
    assert shapes[39:45] == [(18, 6, 32, 4), (144,), (6, 6, 32, 4), (48,),
                             (18, 6, 32, 4), (144,)]
    assert all(p.is_contiguous() and p.dtype == torch.float32 for p in ptrs)
    keys = [k for k, _ in tf._weights(setup[3])]
    assert keys[:9] == list(tf._HEAD_KEYS)
    assert keys[9:19] == list(tf._ENC_KEYS)
    assert keys[39:54] == list(tf._DEC_KEYS)


def _unpack(frag):
    """Invert ``frag_pack``: (hi, lo) as (K8, N) arrays."""
    f = frag.numpy().transpose(1, 0, 2, 3)
    kt, nt = f.shape[:2]
    hi = np.full((kt * 8, nt * 8), np.nan, np.float32)
    lo = hi.copy()
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for kk in range(kt):
            cols = np.arange(nt) * 8 + g
            hi[8 * kk + t, cols] = f[kk, :, lane, 0]
            hi[8 * kk + t + 4, cols] = f[kk, :, lane, 1]
            lo[8 * kk + t, cols] = f[kk, :, lane, 2]
            lo[8 * kk + t + 4, cols] = f[kk, :, lane, 3]
    return hi, lo


def _untile(tiles, second):
    """Invert ``ff_tiles`` by the kernel's addressing: B[n, k] of chunk c,
    k-step ks at core (n // 8, k // 4 of the k-step), row n % 8, element
    k % 4; FF2's k = 2e + j is hidden column 8ks + k'."""
    from dragposer_tpu_torch.ops.temporal_fused import FC

    t = tiles.numpy()
    nch, nks, ni = t.shape[:3]
    if second:
        w = np.full((2048, 48), np.nan, np.float32)
    else:
        w = np.full((48, 2048), np.nan, np.float32)
    for c in range(nch):
        for ks in range(nks):
            for i in range(ni):
                for j in range(2):
                    for r in range(8):
                        for e in range(4):
                            v = t[c, ks, i, j, r, e]
                            if second:
                                w[FC * c + 8 * ks + 2 * e + j, 8 * i + r] = v
                            else:
                                w[8 * ks + 4 * j + e, FC * c + 8 * i + r] = v
    return w


def _tf32_bits_clear(x):
    return not np.any(x.view(np.int32) & 0x1FFF)


def test_tf32_round_is_round_to_nearest_ties_away():
    """The rounding of PTX ``cvt.rna.tf32.f32``: nearest with 10 mantissa
    bits, ties away from zero, non-finite values unchanged."""
    from dragposer_tpu_torch.ops import temporal_fused as tf

    u = 2.0 ** -10
    x = torch.tensor([1 + u / 2, -(1 + u / 2), 1 + u / 2 - 2 ** -23,
                      1 + 1.5 * u, 3.0, 0.0, float("inf"), float("-inf")],
                     dtype=torch.float32)
    want = [1 + u, -(1 + u), 1.0, 1 + 2 * u, 3.0, 0.0, float("inf"),
            float("-inf")]
    assert tf.tf32_round(x).tolist() == want
    assert torch.isnan(tf.tf32_round(torch.tensor([float("nan")]))).all()
    rng = np.random.default_rng(0)
    v = torch.as_tensor((rng.normal(size=4096) * 10.0 ** rng.integers(
        -6, 6, 4096)).astype(np.float32))
    r = tf.tf32_round(v)
    assert _tf32_bits_clear(r.numpy())
    assert bool(((r - v).abs() <= v.abs() * 2.0 ** -11).all())
    # no TF32 value lies nearer: the neighbour on the other side of v
    other = r - torch.sign(r - v) * r.abs() * u
    assert bool(((other - v).abs() >= (r - v).abs() * (1 - 2 ** -10)).all())


def test_split_reproduces_every_packed_weight(setup):
    """Every matrix of the kernel's table inverts, by the kernel's
    addressing, to (hi, lo) of the (in, out) matrix: hi and lo TF32, hi +
    lo equal to the float32 weight to 2^-22 relative, the projections' K
    padding zero."""
    from dragposer_tpu_torch.ops import temporal_fused as tf

    packed = setup[3]
    n_frag = n_ff = 0
    for (key, w), frag in zip(tf._weights(packed), tf._pointers(packed)):
        wn = w.numpy()
        if key in tf._FF:
            hi, lo = (_untile(frag[:, i], key == "ff_w2") for i in (0, 1))
            assert not np.isnan(hi).any() and not np.isnan(lo).any()
            flat = wn
            n_ff += 1
        elif key in tf._MATRICES:
            K = w.shape[0]
            hi, lo = _unpack(frag)
            assert hi.shape == (-(-K // 8) * 8, w.shape[1])
            assert not np.isnan(hi).any() and not np.isnan(lo).any()
            assert not hi[K:].any() and not lo[K:].any()
            hi, lo, flat = hi[:K], lo[:K], wn
            n_frag += 1
        else:
            assert frag is w
            continue
        assert _tf32_bits_clear(hi) and _tf32_bits_clear(lo)
        assert (np.abs(flat - (hi + lo)) <= np.abs(flat) * 2.0 ** -22).all(), \
            key
    assert (n_frag, n_ff) == (3 + 3 * 2 + 3 * 4, 3 * 2 + 3 * 2)


@pytest.mark.parametrize("s_dec,kind", [(1, "row"), (5, "square")])
def test_3xtf32_forward_meets_k2_tolerance_single_tf32_fails(setup, s_dec,
                                                              kind):
    """The kernel's arithmetic through the full forward of the example
    checkpoint at B = 3: 3xTF32 products within K2's tolerance
    (``chip_smoke.K2_TOL``) of the float32 twin; one TF32 pass is not."""
    from dragposer_tpu_torch.ops import temporal_fused as tf

    tpacked = setup[3]
    rng = np.random.default_rng(7 + s_dec)
    enc = torch.as_tensor(rng.normal(size=(3, 14, 33)).astype(np.float32))
    dec = torch.as_tensor(rng.normal(size=(3, s_dec, 24)).astype(np.float32))
    mask = torch.as_tensor(_mask(kind, s_dec))
    ref = tf.forward_plain(tpacked, enc, dec, mask)
    three = tf.forward_plain(tpacked, enc, dec, mask, mm=tf.matmul_3xtf32)
    one = tf.forward_plain(tpacked, enc, dec, mask, mm=tf.matmul_tf32)
    torch.testing.assert_close(three, ref, rtol=1e-4, atol=1e-5)
    assert not torch.allclose(one, ref, rtol=1e-4, atol=1e-5)


def test_matmul_3xtf32_is_float32_accurate():
    """One 2048-deep product: 3xTF32 within a few float32 roundings of the
    float64 product, a single TF32 pass ~2^-11 off."""
    from dragposer_tpu_torch.ops import temporal_fused as tf

    rng = np.random.default_rng(3)
    a = rng.normal(size=(16, 2048)).astype(np.float32)
    b = rng.normal(size=(2048, 48)).astype(np.float32) * 0.02
    exact = a.astype(np.float64) @ b.astype(np.float64)
    scale = np.abs(a).astype(np.float64) @ np.abs(b).astype(np.float64)
    three = tf.matmul_3xtf32(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    one = tf.matmul_tf32(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    assert (np.abs(three - exact) / scale).max() < 1e-6
    assert (np.abs(one - exact) / scale).max() > 1e-5


def test_lanes_per_block_fills_the_block():
    """G lanes of S rows each: at most 128 rows, more than 112 (every
    warp's m16 tile busy in the encoder), G = 9 on the main path."""
    from dragposer_tpu_torch.ops import temporal_fused as tf

    assert tf.lanes_per_block(14, 1) == 9
    for s_enc in range(1, 17):
        for s_dec in range(1, 17):
            rows = tf.lanes_per_block(s_enc, s_dec) * max(s_enc, s_dec)
            assert 112 < rows <= tf.ROWS
