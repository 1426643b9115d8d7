"""K3a/K3b's plain twins (port ``ops/ff_fused.ff_dropout_seeded``, rows
layout, on the CPU) against JAX ``ops/ff_fused._ff_dropout`` in interpret
mode.

M = 300 spans two of the TPU kernel's 256-row tiles, the second ragged (JAX
pads it with zero rows); M = 100 is less than one tile.  Same int32 seed on
both sides: the masks are equal bit for bit, so the comparison is of
values.  Tolerances: y to rtol/atol 1e-5; each gradient to 2e-5 · max|g|
per entry, as the lanes-layout tests (float32 sums reassociated between
XLA:CPU and PyTorch; the weight gradients sum over all M rows).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dragposer_tpu.ops import ff_fused as jff
from dragposer_tpu_torch.ops import ff_fused as tff

torch.set_num_threads(1)
D = 48


def _inputs(m, f, seed):
    rng = np.random.default_rng(seed)
    bound = np.sqrt(6 / (f + D))
    return dict(
        x=rng.normal(size=(m, D)).astype(np.float32),
        w1=(rng.uniform(-1, 1, (f, D)) * bound).astype(np.float32),
        b1=(rng.uniform(-1, 1, f) / np.sqrt(D)).astype(np.float32),
        w2=(rng.uniform(-1, 1, (D, f)) * bound).astype(np.float32),
        b2=(rng.uniform(-1, 1, D) / np.sqrt(f)).astype(np.float32),
        g=rng.normal(size=(m, D)).astype(np.float32))


@pytest.mark.parametrize("m,f", [(300, 256), (100, 128), (300, 2048)])
@pytest.mark.parametrize("rate", [0.3, 0.0])
def test_forward_and_grads_match_jax(m, f, rate):
    a = _inputs(m, f, m + f)
    seed = 4321

    def jfn(x, w1, b1, w2, b2):
        return jff._ff_dropout(rate, False, x, w1.T, b1, w2.T, b2,
                               jnp.array([seed], jnp.int32))

    names = ("x", "w1", "b1", "w2", "b2")
    y, vjp = jax.vjp(jfn, *[a[n] for n in names])
    ref_grads = vjp(a["g"])

    ts = [torch.tensor(a[n], requires_grad=True) for n in names]
    before = (tff.COUNTS_FWD_ROWS.plain, tff.COUNTS_BWD_ROWS.plain)
    yt = tff.ff_dropout_seeded(ts[0], {"w": ts[1], "b": ts[2]},
                               {"w": ts[3], "b": ts[4]}, rate, seed)
    yt.backward(torch.as_tensor(a["g"]))
    assert (tff.COUNTS_FWD_ROWS.plain, tff.COUNTS_BWD_ROWS.plain) == (
        before[0] + 1, before[1] + 1)
    assert tff.COUNTS_FWD_ROWS.kernel == 0 and tff.COUNTS_BWD_ROWS.kernel == 0
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(y),
                               rtol=1e-5, atol=1e-5)
    for name, t, r in zip(("dx", "dw1", "db1", "dw2", "db2"), ts, ref_grads):
        r = np.asarray(r)
        np.testing.assert_allclose(t.grad.numpy(), r, rtol=0,
                                   atol=2e-5 * float(np.abs(r).max()),
                                   err_msg=name)


def _jax_mask(seed, m, f, rate):
    """The TPU kernel's mask (tests/test_ff_fused.py's extraction): W1ᵀ = 0,
    b1 = 1 so the hidden is 1, W2ᵀ = I so y is keep · scale."""
    y = jff._fwd_call(rate, jnp.zeros((m, f)), jnp.zeros((f, f)),
                      jnp.ones((f,)), jnp.eye(f), jnp.zeros((f,)),
                      jnp.array([seed], jnp.int32))
    return np.asarray(y > 0.5)


def _port_mask(seed, m, f, rate):
    """The same extraction through the port's public function: W1 = 0,
    b1 = 1, and W2 selecting D hidden columns at a time."""
    cols = []
    rows = torch.arange(D)
    for f0 in range(0, f, D):
        f0 = min(f0, f - D)
        w2 = torch.zeros((D, f))
        w2[rows, f0 + rows] = 1.0
        y = tff.ff_dropout_seeded(torch.zeros((m, D)),
                                  {"w": torch.zeros((f, D)),
                                   "b": torch.ones(f)},
                                  {"w": w2, "b": torch.zeros(D)}, rate, seed)
        cols.append((f0, y > 0.5))
    keep = torch.zeros((m, f), dtype=torch.bool)
    for f0, c in cols:
        keep[:, f0:f0 + D] = c
    return keep.numpy()


@pytest.mark.parametrize("m,seed", [(300, 12345), (200, 7)])
def test_mask_bit_equal_to_jax(m, seed):
    f, rate = 256, 0.3
    ref = _jax_mask(seed, m, f, rate)
    np.testing.assert_array_equal(_port_mask(seed, m, f, rate), ref)
    np.testing.assert_array_equal(
        tff.keep_mask_rows(m, f, rate, seed).numpy(), ref)
    assert abs(ref.mean() - (1 - rate)) < 0.02


def test_mask_depends_on_row_tile():
    """Rows 0..43 and 256..299 share their in-tile positions but not their
    tile ids, so their masks differ."""
    keep = tff.keep_mask_rows(300, 256, 0.3, 99)
    assert float((keep[:44] != keep[256:]).float().mean()) > 0.2


@pytest.mark.parametrize("bad", ["dtype", "width", "shape", "rate",
                                 "grad_shape"])
def test_rows_wrapper_rejects_bad_input(bad):
    a = {k: torch.as_tensor(v) for k, v in _inputs(10, 128, 1).items()}
    if bad == "dtype":
        a["x"] = a["x"].double()
    elif bad == "width":
        a["w1"], a["b1"] = a["w1"][:100], a["b1"][:100]
    elif bad == "shape":
        a["x"] = a["x"][:, :40]
    rate = 1.0 if bad == "rate" else 0.1
    args = ({"w": a["w1"], "b": a["b1"]}, {"w": a["w2"], "b": a["b2"]},
            rate, 3)
    if bad == "grad_shape":
        # the Function itself takes (M, D) only
        with pytest.raises(ValueError):
            tff._FFDropoutRows.apply(a["x"][None], a["w1"], a["b1"],
                                     a["w2"], a["b2"], 0.1, 3)
        return
    with pytest.raises(ValueError):
        tff.ff_dropout_seeded(a["x"], *args)


def test_leading_dims_are_rows_in_c_order():
    """(B, S, D) input: row m = b·S + s of the flattened (M, D)."""
    a = _inputs(12, 128, 3)
    t = {k: torch.as_tensor(v) for k, v in a.items()}
    ff1, ff2 = {"w": t["w1"], "b": t["b1"]}, {"w": t["w2"], "b": t["b2"]}
    y3 = tff.ff_dropout_seeded(t["x"].reshape(3, 4, D), ff1, ff2, 0.3, 5)
    y2 = tff.ff_dropout_seeded(t["x"], ff1, ff2, 0.3, 5)
    assert y3.shape == (3, 4, D)
    np.testing.assert_array_equal(y3.reshape(12, D).numpy(), y2.numpy())
