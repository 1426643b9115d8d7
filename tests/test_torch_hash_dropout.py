"""Port ``ops/hash_dropout`` and the K3 lanes mask against the JAX package.

Masks, ``fmix32`` and the integer streams must be equal bit for bit for the
same int32 seed (portable uint32 arithmetic on both sides).  ``normal``
(Box-Muller) goes through ``log``, ``cos`` and ``sqrt``, which differ by
ulps between XLA:CPU and PyTorch: atol 2e-6 on values of magnitude < 6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dragposer_tpu.ops import ff_fused as jff
from dragposer_tpu.ops import hash_dropout as jhd
from dragposer_tpu_torch.ops import ff_fused as tff
from dragposer_tpu_torch.ops import hash_dropout as thd

SEEDS = [0, 1, 4242, 2 ** 31 - 2]
SHAPES = [(7,), (3, 5, 11), (15, 48, 33), (14, 14, 4, 9)]


def test_fmix32_bitwise():
    x = (np.arange(1 << 18, dtype=np.uint64) * 2654435761
         % (1 << 32)).astype(np.uint32)
    x = np.concatenate([x, np.array([0, 1, 2 ** 31, 2 ** 32 - 1], np.uint32)])
    ref = np.asarray(jhd.fmix32(jnp.asarray(x))).astype(np.int64)
    got = thd.fmix32(torch.as_tensor(x.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_keep_mask_bitwise(seed, shape, rate):
    ref = np.asarray(jhd.keep_mask(shape, rate, jnp.int32(seed)))
    got = thd.keep_mask(shape, rate, seed).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_matches(seed):
    shape = (2, 14, 22, 8)
    ref = np.asarray(jhd.normal(shape, jnp.int32(seed)))
    got = thd.normal(shape, seed).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-6)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_dropout_matches(rate):
    x = np.random.default_rng(0).normal(size=(15, 48, 20)).astype(np.float32)
    ref = np.asarray(jhd.dropout(jnp.asarray(x), rate, jnp.int32(77), True))
    got = thd.dropout(torch.as_tensor(x), rate, 77, True).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        thd.dropout(torch.as_tensor(x), rate, 77, False).numpy(), x)


def test_seeds_for_host_draw():
    a = thd.seeds_for(torch.Generator().manual_seed(3), 64)
    b = thd.seeds_for(torch.Generator().manual_seed(3), 64)
    assert a == b and len(a) == 64
    assert all(isinstance(s, int) and 0 <= s < 2 ** 31 - 1 for s in a)


@pytest.mark.parametrize("b", [60, 130, 300])
def test_ff_lanes_mask_bitwise(b):
    """The K3 hidden mask (token, hidden row, lane) as JAX's interpret-mode
    kernel draws it: w1 = 0, b1 = 1, w2 = I gives y = keep · scale."""
    s, f, rate, seed = 3, 64, 0.1, 881
    y = jff._fwd_call_T(rate, jnp.zeros((s, f, b)), jnp.zeros((f, f)),
                        jnp.ones((f,)), jnp.eye(f), jnp.zeros((f,)),
                        jnp.array([seed], jnp.int32))
    ref = np.asarray(y) > 0.5
    got = tff.keep_mask_lanes(s, f, b, rate, seed).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        np.asarray(y)[ref], np.full(int(ref.sum()), thd.keep_scale(rate),
                                    np.float32))
