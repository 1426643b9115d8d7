"""K3c/K3d's plain twins (port ``ops/ff_fused.ff_dropout_lanes`` on the CPU)
against JAX ``ops/ff_fused.ff_dropout_lanes`` in interpret mode, at the
model's full hidden width F = 2048.

B = 130 pads the lanes (tile 130 → JAX pads to 256); B = 300 gives two lane
tiles (nb = 2), so the tile index of the mask is exercised.  Same seed on
both sides: the masks are equal bit for bit, so the comparison is of values.
Tolerances: y to rtol 1e-4 / atol 1e-5 (2048-term sums reassociated between
XLA:CPU and PyTorch); each gradient to rtol 1e-4 with an absolute floor of
2e-6 · max|ref| (the weight gradients sum over every S·B column).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dragposer_tpu.ops import ff_fused as jff
from dragposer_tpu_torch.ops import ff_fused as tff

torch.set_num_threads(1)
F, D = 2048, 48


def _inputs(s, b, seed):
    rng = np.random.default_rng(seed)
    bound = np.sqrt(6 / (F + D))
    return dict(
        x=rng.normal(size=(s, D, b)).astype(np.float32),
        w1=(rng.uniform(-1, 1, (F, D)) * bound).astype(np.float32),
        b1=(rng.uniform(-1, 1, F) / np.sqrt(D)).astype(np.float32),
        w2=(rng.uniform(-1, 1, (D, F)) * bound).astype(np.float32),
        b2=(rng.uniform(-1, 1, D) / np.sqrt(F)).astype(np.float32),
        g=rng.normal(size=(s, D, b)).astype(np.float32))


def _close(got, ref, name):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=1e-4,
                               atol=2e-6 * float(np.abs(ref).max()),
                               err_msg=name)


@pytest.mark.parametrize("s,b", [(2, 130), (2, 300), (3, 16)])
@pytest.mark.parametrize("rate", [0.1, 0.0])
def test_forward_and_grads_match_jax(s, b, rate):
    a = _inputs(s, b, s * 1000 + b)
    seed = 12345

    def jfn(x, w1, b1, w2, b2):
        return jff.ff_dropout_lanes(x, {"w": w1, "b": b1}, {"w": w2, "b": b2},
                                    rate, jnp.int32(seed), bf16=False)

    names = ("x", "w1", "b1", "w2", "b2")
    y, vjp = jax.vjp(jfn, *[a[n] for n in names])
    ref_grads = vjp(a["g"])

    ts = [torch.tensor(a[n], requires_grad=True) for n in names]
    before = (tff.COUNTS_FWD.plain, tff.COUNTS_BWD.plain)
    yt = tff.ff_dropout_lanes(ts[0], {"w": ts[1], "b": ts[2]},
                              {"w": ts[3], "b": ts[4]}, rate, seed)
    yt.backward(torch.as_tensor(a["g"]))
    assert (tff.COUNTS_FWD.plain, tff.COUNTS_BWD.plain) == (before[0] + 1,
                                                           before[1] + 1)
    assert tff.COUNTS_FWD.kernel == 0 and tff.COUNTS_BWD.kernel == 0
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(y),
                               rtol=1e-4, atol=1e-5)
    for name, t, r in zip(("dx", "dw1", "db1", "dw2", "db2"), ts, ref_grads):
        _close(t.grad.numpy(), r, name)


def test_rate_zero_is_plain_feed_forward():
    a = _inputs(2, 20, 5)
    t = {k: torch.as_tensor(v) for k, v in a.items()}
    y = tff.forward_plain(t["x"], t["w1"], t["b1"], t["w2"], t["b2"], 0.0, 9)
    h = torch.relu(torch.einsum("fd,sdb->sfb", t["w1"], t["x"])
                   + t["b1"][None, :, None])
    ref = torch.einsum("df,sfb->sdb", t["w2"], h) + t["b2"][None, :, None]
    np.testing.assert_allclose(y.numpy(), ref.numpy(), rtol=1e-6, atol=1e-6)


def test_mask_rate_and_seed_dependence():
    m1 = tff.keep_mask_lanes(15, F, 64, 0.1, 1)
    m2 = tff.keep_mask_lanes(15, F, 64, 0.1, 2)
    assert abs(float(m1.float().mean()) - 0.9) < 0.005
    assert float((m1 != m2).float().mean()) > 0.1


@pytest.mark.parametrize("bad", ["dtype", "width", "shape", "rate"])
def test_wrapper_rejects_bad_input(bad):
    a = {k: torch.as_tensor(v) for k, v in _inputs(2, 8, 1).items()}
    if bad == "dtype":
        a["x"] = a["x"].double()
    elif bad == "width":
        a["w1"], a["b1"] = a["w1"][:100], a["b1"][:100]
    elif bad == "shape":
        a["x"] = a["x"][:, :40]
    rate = 1.0 if bad == "rate" else 0.1
    with pytest.raises(ValueError):
        tff.ff_dropout_lanes(a["x"], {"w": a["w1"], "b": a["b1"]},
                             {"w": a["w2"], "b": a["b2"]}, rate, 3)
