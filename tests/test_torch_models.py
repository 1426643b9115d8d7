"""Port VAE and temporal model against the JAX package, on the in-repo
example checkpoint carried across with ``loading.tree_to_torch``.

Tolerances: the folded decoder weights are built by the same numpy code,
so they are compared exactly; float32 forwards agree to 1e-5 relative
(matmul summation order differs between XLA:CPU and torch); the temporal
transformer to rtol 1e-4 / atol 1e-5 as in ``tests/test_temporal_fused.py``
(softmax and LayerNorm reassociate).
"""

import numpy as np
import pytest
import torch

from conftest import EXAMPLE_PARENTS

torch.set_num_threads(1)
MODEL_DIR = "models/model_dancedb_example"


@pytest.fixture(scope="module")
def vae_setup():
    from dragposer_tpu import config as jc
    from dragposer_tpu.models import loading as jl
    from dragposer_tpu.models import vae as jvae
    from dragposer_tpu_torch.models import vae as tvae

    params, means, stds = jl.load_generator(MODEL_DIR, EXAMPLE_PARENTS,
                                            jc.VAE_PARAM)
    return (params, means, stds, jvae.build_statics(EXAMPLE_PARENTS,
                                                    jc.VAE_PARAM),
            tvae.build_statics(EXAMPLE_PARENTS, jc.VAE_PARAM))


def test_checkpoint_load_same_tree():
    from dragposer_tpu.models import checkpoint as jck
    from dragposer_tpu_torch.models import checkpoint as tck

    for name in ("generator", "temporal"):
        jp, je = jck.load(f"{MODEL_DIR}/{name}.npz")
        tp, te = tck.load(f"{MODEL_DIR}/{name}.npz")
        import jax

        jl, jdef = jax.tree.flatten((jp, je))
        tl, tdef = jax.tree.flatten((tp, te))
        assert jdef == tdef
        for a, b in zip(tl, jl):
            np.testing.assert_array_equal(a, b)


def test_fold_and_decode_match(vae_setup):
    from dragposer_tpu.models import vae as jvae
    from dragposer_tpu_torch.models import vae as tvae

    params, means, stds, js, ts = vae_setup
    jf = jvae.fold_decoder(params["decoder"], js)
    tf = tvae.fold_decoder(params["decoder"], ts, "cpu")
    for a, b in zip(tf["ws"] + tf["bs"], jf["ws"] + jf["bs"]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    z = np.random.default_rng(3).normal(size=(7, 24)).astype(np.float32)
    jp, jd = jvae.decode_folded_flat(jf, z, means["dqs"], stds["dqs"])
    tp, td = tvae.decode_folded_flat(tf, torch.as_tensor(z),
                                     torch.as_tensor(means["dqs"]),
                                     torch.as_tensor(stds["dqs"]))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-5)


def test_encode_matches(vae_setup):
    from dragposer_tpu.models import vae as jvae
    from dragposer_tpu_torch.models import loading, vae as tvae

    params, _, _, js, ts = vae_setup
    x = np.random.default_rng(4).normal(size=(5, 176, 1)).astype(np.float32)
    jmu, jlv = jvae.encode(params["encoder"], js, x)
    enc = loading.tree_to_torch(params["encoder"], "cpu")
    tmu, tlv = tvae.encode(enc, ts, torch.as_tensor(x))
    np.testing.assert_allclose(tmu.numpy(), np.asarray(jmu), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tlv.numpy(), np.asarray(jlv), rtol=1e-5,
                               atol=1e-5)
    # reparameterize draws from the torch.Generator: seeded, reproducible
    g1 = torch.Generator().manual_seed(1)
    g2 = torch.Generator().manual_seed(1)
    np.testing.assert_array_equal(tvae.reparameterize(g1, tmu, tlv).numpy(),
                                  tvae.reparameterize(g2, tmu, tlv).numpy())


@pytest.mark.parametrize("s_dec", [1, 5])
def test_temporal_forward_matches(s_dec):
    from dragposer_tpu import config as jc
    from dragposer_tpu.models import loading as jl
    from dragposer_tpu.models import temporal as jt
    from dragposer_tpu_torch.models import loading, temporal as tt

    params, _, _ = jl.load_temporal(MODEL_DIR, jc.TEMPORAL_PARAM)
    tp = loading.tree_to_torch(params, "cpu")
    rng = np.random.default_rng(s_dec)
    enc = rng.normal(size=(3, 14, 33)).astype(np.float32)
    dec = rng.normal(size=(3, s_dec, 24)).astype(np.float32)
    mask = np.where(np.arange(s_dec) <= s_dec // 2, 0.0,
                    -np.inf).astype(np.float32)[None]
    ref = jt.forward(params, jc.TEMPORAL_PARAM, enc, dec, tgt_mask=mask)
    got = tt.forward(tp, jc.TEMPORAL_PARAM, torch.as_tensor(enc),
                     torch.as_tensor(dec), torch.as_tensor(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-5)
    encT, decT = np.moveaxis(enc, 0, -1), np.moveaxis(dec, 0, -1)
    refT = jt.forward_T(params, jc.TEMPORAL_PARAM, encT, decT, tgt_mask=mask)
    gotT = tt.forward_T(tp, jc.TEMPORAL_PARAM, torch.as_tensor(encT),
                        torch.as_tensor(decT), torch.as_tensor(mask))
    np.testing.assert_allclose(gotT.numpy(), np.asarray(refT), rtol=1e-4,
                               atol=1e-5)


def test_linear_matches():
    """``models/temporal.linear`` on the example's input projection, 1e-5
    relative as the other float32 forwards."""
    from dragposer_tpu import config as jc
    from dragposer_tpu.models import loading as jl
    from dragposer_tpu.models import temporal as jt
    from dragposer_tpu_torch.models import loading, temporal as tt

    params, _, _ = jl.load_temporal(MODEL_DIR, jc.TEMPORAL_PARAM)
    p = params["in_proj_enc"]
    x = np.random.default_rng(0).normal(
        size=(3, 5, np.shape(p["w"])[1])).astype(np.float32)
    got = tt.linear(torch.as_tensor(x), loading.tree_to_torch(p, "cpu"))
    np.testing.assert_allclose(got.numpy(), np.asarray(jt.linear(x, p)),
                               rtol=1e-5, atol=1e-6)
