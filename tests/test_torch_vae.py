"""The port's pose VAE (``models/vae.py``: init, unfolded and folded
decoder, forward, sample) against the JAX package, on the CPU.

Parameters are the example checkpoint's and a JAX init, carried across with
``loading.tree_to_torch``; the normal draws are JAX's, handed to the port.
Tolerances: outputs to rtol 1e-5 / atol 1e-5 (float32 contractions
reassociated between XLA:CPU and PyTorch, then a per-quaternion
normalization and a division by the data's standard deviations).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dragposer_tpu import config as jc
from dragposer_tpu.models import vae as jv
from dragposer_tpu_torch import config as tc
from dragposer_tpu_torch.models import loading
from dragposer_tpu_torch.models import temporal as ttm
from dragposer_tpu_torch.models import vae as tv
from dragposer_tpu_torch.ops import topology

torch.set_num_threads(2)
MODEL_DIR = "models/model_dancedb_example"
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def example():
    params, means, stds = loading.load_generator(MODEL_DIR)
    return params, means["dqs"], stds["dqs"]


def test_init_params_tree_masks_and_distributions(example_parents):
    jp = jax.device_get(jv.init_params(jax.random.PRNGKey(0),
                                       example_parents, jc.VAE_PARAM))
    tp = tv.init_params(torch.Generator().manual_seed(0), example_parents,
                        tc.VAE_PARAM)
    jl, tl = dict(ttm.named_leaves(jp)), dict(ttm.named_leaves(tp))
    assert sorted(jl) == sorted(tl)
    for path, t in tl.items():
        assert t.shape == np.shape(jl[path]) and t.requires_grad, path
    assert not tl["encoder/f_logvar/w"].detach().any()
    statics = tv.build_statics(example_parents, tc.VAE_PARAM)
    for part, masks in (("encoder", statics.enc_masks),
                        ("decoder", statics.dec_masks)):
        for l, mask in enumerate(masks):
            w = tl[f"{part}/convs/{l}/w"].detach().numpy()
            assert not np.any(w * (1.0 - mask)), (part, l)   # outside: 0
            inside = w[mask > 0]
            assert np.count_nonzero(inside) == inside.size
    # U(±1/√fan_in) on each joint's block, as JAX draws it
    hood = topology.neighbor_lists(np.asarray(example_parents), 2,
                                   add_displacement=False)
    cols = topology.expand_neighbors(hood, 8)
    w0 = tl["encoder/convs/0/w"].detach().numpy()
    for j in (0, 5, 21):
        bound = 1.0 / np.sqrt(len(cols[j]))
        block = w0[j * 8:(j + 1) * 8][:, cols[j]]
        assert np.abs(block).max() <= bound
        assert np.abs(block).max() >= 0.5 * bound


def test_count_params_matches_jax(example_parents):
    jp = jv.init_params(jax.random.PRNGKey(1), example_parents, jc.VAE_PARAM)
    tp = tv.init_params(torch.Generator().manual_seed(1), example_parents,
                        tc.VAE_PARAM)
    js = jv.build_statics(example_parents, jc.VAE_PARAM)
    ts = tv.build_statics(example_parents, tc.VAE_PARAM)
    assert tv.count_params(tp, ts) == jv.count_params(jp, js) == 168352


def _trees(example, example_parents, which):
    if which == "example":
        return example[0]
    return jax.device_get(jv.init_params(jax.random.PRNGKey(4),
                                         example_parents, jc.VAE_PARAM))


@pytest.mark.parametrize("which", ["example", "init"])
def test_decode_and_decode_folded_match_jax(example, example_parents, which):
    params = _trees(example, example_parents, which)
    _, mean, std = example
    js = jv.build_statics(example_parents, jc.VAE_PARAM)
    ts = tv.build_statics(example_parents, tc.VAE_PARAM)
    z = np.random.default_rng(2).normal(size=(7, 24)).astype(np.float32)
    ref = jv.decode(params["decoder"], js, jnp.asarray(z), mean, std)
    tp = loading.tree_to_torch(params, "cpu")
    tmean, tstd = torch.as_tensor(mean), torch.as_tensor(std)
    got = tv.decode(tp["decoder"], ts, torch.as_tensor(z), tmean, tstd)
    folded_ref = jv.decode_folded(jv.fold_decoder(params["decoder"], js),
                                  jnp.asarray(z), mean, std)
    folded = tv.decode_folded(tv.fold_decoder(params["decoder"], ts, "cpu"),
                              torch.as_tensor(z), tmean, tstd)
    for g, r in ((got, ref), (folded, folded_ref), (folded, ref)):
        assert g[0].shape == (7, 88, 1) and g[1].shape == (7, 3, 1)
        for a, b in zip(g, r):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_forward_and_sample_match_jax_with_the_same_noise(example,
                                                          example_parents):
    params, mean, std = example
    js = jv.build_statics(example_parents, jc.VAE_PARAM)
    ts = tv.statics_on(tv.build_statics(example_parents, tc.VAE_PARAM),
                       "cpu")
    tp = loading.tree_to_torch(params, "cpu")
    tmean, tstd = torch.as_tensor(mean), torch.as_tensor(std)
    x = np.random.default_rng(3).normal(size=(5, 176, 1)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    ref = jv.forward(params, js, key, jnp.asarray(x), mean, std)
    noise = torch.as_tensor(np.asarray(jax.random.normal(key, (5, 24))))
    got = tv.forward(tp, ts, None, torch.as_tensor(x), tmean, tstd, noise)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)

    centre = np.linspace(-0.5, 0.5, 24).astype(np.float32)
    for m in (None, centre):
        ref = jv.sample(params, js, key, 6, mean, std, mean=m)
        noise = torch.as_tensor(np.asarray(jax.random.normal(key, (6, 24))))
        got = tv.sample(tp, ts, None, 6, tmean, tstd, mean=m, noise=noise)
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    drawn = tv.sample(tp, ts, torch.Generator().manual_seed(0), 6, tmean,
                      tstd)
    assert torch.isfinite(drawn[0]).all()
