"""The FF kernels' products in 3xTF32 (the arithmetic of K3a-K3d on the
tensor cores), on the CPU.

``forward_plain{,_rows}(mm=matmul_3xtf32)`` forms W1·x (the
pre-activation) and W2·h from TF32 splits (hi·hi + hi·lo + lo·hi in
float32), as K3a/K3c do; ``backward_plain{,_rows}(mm=matmul_3xtf32)``
forms the recomputed pre-activation the same way, and W2ᵀg, W1ᵀdpre, dW1
and dW2, as K3b/K3d do.  Each twin must hold K3's card tolerance
(``chip_smoke.K3_TOL``: rtol 1e-4, atol 2e-6·max|ref|) against the float32
twin and the JAX-parity tolerance of ``test_torch_ff_fused.py`` (lanes) and
``test_torch_ff_rows.py`` (rows) against JAX in interpret mode with
``bf16=False``; the same products in one TF32 pass (``matmul_tf32``) must
fail K3_TOL, so the tolerance tells 3xTF32 from TF32.  Shapes are the
parity tests'; rates 0.1 and 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from dragposer_tpu.ops import ff_fused as jff
from dragposer_tpu_torch.ops import ff_fused as tff
from dragposer_tpu_torch.ops.temporal_fused import matmul_3xtf32, matmul_tf32

torch.set_num_threads(1)
D = 48
SEED = 4321
# (layout, shape of x, hidden width F)
CASES = [("lanes", (2, D, 130), 2048), ("lanes", (2, D, 300), 2048),
         ("lanes", (3, D, 16), 2048), ("rows", (300, D), 256),
         ("rows", (100, D), 128), ("rows", (300, D), 2048)]


def _inputs(shape, f, seed):
    rng = np.random.default_rng(seed)
    bound = np.sqrt(6 / (f + D))
    return dict(
        x=rng.normal(size=shape).astype(np.float32),
        w1=(rng.uniform(-1, 1, (f, D)) * bound).astype(np.float32),
        b1=(rng.uniform(-1, 1, f) / np.sqrt(D)).astype(np.float32),
        w2=(rng.uniform(-1, 1, (D, f)) * bound).astype(np.float32),
        b2=(rng.uniform(-1, 1, D) / np.sqrt(f)).astype(np.float32),
        g=rng.normal(size=shape).astype(np.float32))


def _twin_fwd(layout, a, rate, mm=torch.matmul):
    fwd = tff.forward_plain if layout == "lanes" else tff.forward_plain_rows
    t = {k: torch.as_tensor(v) for k, v in a.items()}
    return fwd(t["x"], t["w1"], t["b1"], t["w2"], t["b2"], rate, SEED,
               mm=mm)


def _twin(layout, a, rate, mm=torch.matmul):
    bwd = tff.backward_plain if layout == "lanes" else tff.backward_plain_rows
    t = {k: torch.as_tensor(v) for k, v in a.items()}
    return bwd(t["x"], t["w1"], t["b1"], t["w2"], t["g"], rate, SEED, mm=mm)


def _jax_fn(layout, rate):
    if layout == "lanes":
        def fn(x, w1, b1, w2, b2):
            return jff.ff_dropout_lanes(x, {"w": w1, "b": b1},
                                        {"w": w2, "b": b2}, rate,
                                        jnp.int32(SEED), bf16=False)
    else:
        def fn(x, w1, b1, w2, b2):
            return jff._ff_dropout(rate, False, x, w1.T, b1, w2.T, b2,
                                   jnp.array([SEED], jnp.int32))
    return fn


def _jax_y(layout, a, rate):
    return np.asarray(_jax_fn(layout, rate)(
        *[a[n] for n in ("x", "w1", "b1", "w2", "b2")]))


def _jax_grads(layout, a, rate):
    _, vjp = jax.vjp(_jax_fn(layout, rate),
                     *[a[n] for n in ("x", "w1", "b1", "w2", "b2")])
    return [np.asarray(r) for r in vjp(a["g"])]


def _case_id(case):
    layout, shape, f = case
    return f"{layout}-{'x'.join(map(str, shape))}-F{f}"


@pytest.mark.parametrize("rate", [0.1, 0.0])
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_forward_3xtf32_twin_holds_k3_tol_and_jax_parity(case, rate):
    layout, shape, f = case
    a = _inputs(shape, f, sum(shape) + f)
    got = _twin_fwd(layout, a, rate, mm=matmul_3xtf32)
    errs, ok = chip_smoke.k3_within_tol((got,), (_twin_fwd(layout, a, rate),))
    assert ok, errs
    # the parity tests' forward tolerances
    rtol = 1e-4 if layout == "lanes" else 1e-5
    np.testing.assert_allclose(got.numpy(), _jax_y(layout, a, rate),
                               rtol=rtol, atol=1e-5)


@pytest.mark.parametrize("rate", [0.1, 0.0])
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_forward_k3_tol_refuses_one_tf32_pass(case, rate):
    layout, shape, f = case
    a = _inputs(shape, f, sum(shape) + f)
    errs, ok = chip_smoke.k3_within_tol(
        (_twin_fwd(layout, a, rate, mm=matmul_tf32),),
        (_twin_fwd(layout, a, rate),))
    assert not ok, errs


@pytest.mark.parametrize("rate", [0.1, 0.0])
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_3xtf32_twin_holds_k3_tol_and_jax_parity(case, rate):
    layout, shape, f = case
    a = _inputs(shape, f, sum(shape) + f)
    ref = _twin(layout, a, rate)
    got = _twin(layout, a, rate, mm=matmul_3xtf32)
    errs, ok = chip_smoke.k3_within_tol(got, ref)
    assert ok, errs
    for name, t, r in zip(("dx", "dw1", "db1", "dw2", "db2"), got,
                          _jax_grads(layout, a, rate)):
        scale = float(np.abs(r).max())
        if layout == "lanes":
            np.testing.assert_allclose(t.numpy(), r, rtol=1e-4,
                                       atol=2e-6 * scale, err_msg=name)
        else:
            np.testing.assert_allclose(t.numpy(), r, rtol=0,
                                       atol=2e-5 * scale, err_msg=name)


@pytest.mark.parametrize("rate", [0.1, 0.0])
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_k3_tol_refuses_one_tf32_pass(case, rate):
    layout, shape, f = case
    a = _inputs(shape, f, sum(shape) + f)
    errs, ok = chip_smoke.k3_within_tol(
        _twin(layout, a, rate, mm=matmul_tf32), _twin(layout, a, rate))
    assert not ok, errs


@pytest.mark.parametrize("layout", ["lanes", "rows"])
def test_mm_reaches_only_the_gradient_products(layout):
    """With an exact ``mm`` the backward twin is the float32 twin: ``mm``
    forms the recomputed pre-activation (as the forward does) and the four
    gradient products, and nothing else."""
    a = _inputs((2, D, 70) if layout == "lanes" else (140, D), 128, 5)
    calls = []

    def mm(x, y):
        calls.append((tuple(x.shape), tuple(y.shape)))
        return x @ y

    got = _twin(layout, a, 0.1, mm=mm)
    ref = _twin(layout, a, 0.1)
    assert len(calls) == 5
    # the first is the pre-activation, W1·x
    assert calls[0] == (((128, D), (2, D, 70)) if layout == "lanes" else
                        ((140, D), (D, 128)))
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=0, atol=0)


@pytest.mark.parametrize("layout", ["lanes", "rows"])
def test_forward_mm_forms_both_products(layout):
    """``mm`` forms the forward's two products, W1·x then W2·h, and
    nothing else: with an exact ``mm`` the twin is the float32 twin."""
    a = _inputs((2, D, 70) if layout == "lanes" else (140, D), 128, 5)
    calls = []

    def mm(x, y):
        calls.append((tuple(x.shape), tuple(y.shape)))
        return x @ y

    got = _twin_fwd(layout, a, 0.1, mm=mm)
    torch.testing.assert_close(got, _twin_fwd(layout, a, 0.1), rtol=0,
                               atol=0)
    if layout == "lanes":
        assert calls == [((128, D), (2, D, 70)), ((D, 128), (2, 128, 70))]
    else:
        assert calls == [((140, D), (D, 128)), ((140, 128), (128, D))]
