"""K4a/K4b's plain twins (port ``ops/attn_fused.attn_core_lanes`` on the
CPU) against JAX ``ops/attn_fused.attn_core_lanes`` in interpret mode, for
the shapes of ``tests/test_attn_fused.py``, with and without the causal
mask, and for the masks the card kernels skip keys by
(``chip_smoke.k4_mask``): scattered -inf entries, and a fully masked query
row, whose outputs are NaN (0/0) in both packages, at the same positions.

Tolerances as the JAX file: forward rtol 1e-5 / atol 1e-5, gradients rtol
1e-4 / atol 1e-5 (the same f32 arithmetic, sums reassociated).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from dragposer_tpu.ops import attn_fused as jaf
from dragposer_tpu_torch.ops import attn_fused as taf

torch.set_num_threads(1)


def _qkv(seed, sq, sk, b, h=4, dh=12):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(sq, h, dh, b)).astype(np.float32),
            rng.normal(size=(sk, h, dh, b)).astype(np.float32),
            rng.normal(size=(sk, h, dh, b)).astype(np.float32),
            rng.normal(size=(sq, h, dh, b)).astype(np.float32))


def _causal(s):
    return np.where(np.tri(s, dtype=bool), 0.0, -np.inf).astype(np.float32)


CASES = [(15, 15, 64, False), (15, 14, 130, False), (1, 15, 8, False),
         (15, 15, 32, True), (14, 14, 20, True)]


@pytest.mark.parametrize("sq,sk,b,causal", CASES)
def test_forward_and_grads_match_jax(sq, sk, b, causal):
    q, k, v, g = _qkv(sq * 100 + b, sq, sk, b)
    mask = _causal(sq) if causal else None
    jm = None if mask is None else jnp.asarray(mask)
    o, vjp = jax.vjp(lambda q, k, v: jaf.attn_core_lanes(q, k, v, jm),
                     q, k, v)
    ref_grads = vjp(g)
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    tm = None if mask is None else torch.as_tensor(mask)
    before = (taf.COUNTS_FWD.plain, taf.COUNTS_BWD.plain)
    ot = taf.attn_core_lanes(*ts, tm)
    ot.backward(torch.as_tensor(g))
    assert (taf.COUNTS_FWD.plain, taf.COUNTS_BWD.plain) == (before[0] + 1,
                                                           before[1] + 1)
    assert taf.COUNTS_FWD.kernel == 0 and taf.COUNTS_BWD.kernel == 0
    np.testing.assert_allclose(ot.detach().numpy(), np.asarray(o),
                               rtol=1e-5, atol=1e-5)
    for name, t, r in zip(("dq", "dk", "dv"), ts, ref_grads):
        assert np.isfinite(t.grad.numpy()).all(), name
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


# a fully masked query row (NaN there, and in every dk and dv entry of its
# heads and lanes), and scattered -inf entries in a non-causal mask
@pytest.mark.parametrize("sq,sk,b,kind", [(15, 15, 24, "dead_row"),
                                          (15, 14, 20, "scattered"),
                                          (8, 15, 16, "scattered")])
def test_skipped_keys_match_jax(sq, sk, b, kind):
    q, k, v, g = _qkv(sq * 100 + b, sq, sk, b)
    mask = chip_smoke.k4_mask(kind, sq, sk, seed=sq * 100 + sk).numpy()
    assert np.isneginf(mask).any() and np.isfinite(mask).any()
    o, vjp = jax.vjp(lambda q, k, v: jaf.attn_core_lanes(
        q, k, v, jnp.asarray(mask)), q, k, v)
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    ot = taf.attn_core_lanes(*ts, torch.as_tensor(mask))
    ot.backward(torch.as_tensor(g))
    pairs = [("o", ot.detach().numpy(), np.asarray(o), 1e-5)]
    pairs += [(n, t.grad.numpy(), np.asarray(r), 1e-4)
              for n, t, r in zip(("dq", "dk", "dv"), ts, vjp(g))]
    for name, got, ref, rtol in pairs:
        nan = np.isnan(ref)
        assert nan.any() == (kind == "dead_row"), name
        np.testing.assert_array_equal(np.isnan(got), nan, err_msg=name)
        np.testing.assert_allclose(got[~nan], ref[~nan], rtol=rtol,
                                   atol=1e-5, err_msg=name)


def test_masked_keys_have_no_influence():
    q, k, v, _ = _qkv(1, 15, 15, 16)
    mask = torch.as_tensor(_causal(15))
    base = taf.attn_core_lanes(*map(torch.as_tensor, (q, k, v)), mask)
    v2 = v.copy()
    v2[5:] += 100.0
    moved = taf.attn_core_lanes(*map(torch.as_tensor, (q, k, v2)), mask)
    np.testing.assert_array_equal(moved[:5].numpy(), base[:5].numpy())


def test_wrapper_rejects_bad_input():
    q, k, v, _ = _qkv(2, 15, 15, 8)
    with pytest.raises(ValueError):
        taf.attn_core_lanes(torch.as_tensor(q[:, :, :8]),
                            torch.as_tensor(k[:, :, :8]),
                            torch.as_tensor(v[:, :, :8]))
    with pytest.raises(ValueError):
        taf.attn_core_lanes(torch.as_tensor(np.zeros((17, 4, 12, 2),
                                                     np.float32)),
                            torch.as_tensor(k), torch.as_tensor(v))
