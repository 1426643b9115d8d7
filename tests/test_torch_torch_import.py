"""The port's import of the reference's ``.pt`` checkpoints
(``models/torch_import.py``, ``models/loading.py``'s fallback,
``cli/import_checkpoint.py``) against the JAX package's, on the CPU.

No reference ``.pt`` is in the repository, so the test writes them: a
``generator.pt`` + ``data.pt`` from the in-repo ``generator.npz`` under the
reference's state-dict names (with the masks and pool matrices the
reference stores beside the weights), and a ``temporal.pt`` with the JAX
package's own exporter (``tools/export_temporal_pt.py``), read as the file
it writes.  Both packages read the same files: their trees must be equal
exactly (both copy float32 tensors to numpy).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)
MODEL_DIR = "models/model_dancedb_example"
REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
EXAMPLE_PARENTS = np.array(
    [0, 0, 1, 2, 3, 0, 5, 6, 7, 0, 9, 10, 11, 12, 11, 14, 15, 16, 11, 18, 19,
     20], dtype=np.int64)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def write_reference_pt(out_dir, break_mask=False, break_pool=False):
    """``generator.pt`` and ``data.pt`` of the in-repo generator under the
    reference's state-dict names (``python/src/train.py:257-319``)."""
    from dragposer_tpu_torch import config as cfg
    from dragposer_tpu_torch.models import checkpoint, vae

    params, extra = checkpoint.load(os.path.join(MODEL_DIR, "generator.npz"))
    st = vae.build_statics(EXAMPLE_PARENTS, cfg.VAE_PARAM)
    sd = {}
    enc, dec = params["encoder"], params["decoder"]
    for l in range(vae.N_LAYERS):
        pre = f"autoencoder.encoder.layers.{l}"
        sd[f"{pre}.0.weight"] = _t(enc["convs"][l]["w"])
        sd[f"{pre}.0.bias"] = _t(enc["convs"][l]["b"])
        mask = np.array(st.enc_masks[l])
        if break_mask and l == 1:
            mask.flat[0] = 1.0 - mask.flat[0]
        sd[f"{pre}.0.mask"] = _t(mask)
        pool = np.array(st.enc_pools[l])
        if break_pool and l == 2:
            pool.flat[0] += 1e-3
        sd[f"{pre}.1.weight"] = _t(pool)
        pre = f"autoencoder.decoder.layers.{l}"
        sd[f"{pre}.0.weight"] = _t(st.dec_unpools[l])
        sd[f"{pre}.1.weight"] = _t(dec["convs"][l]["w"])
        sd[f"{pre}.1.bias"] = _t(dec["convs"][l]["b"])
        sd[f"{pre}.1.mask"] = _t(st.dec_masks[l])
    for name, p in (("encoder.f_mu", enc["f_mu"]),
                    ("encoder.f_logvar", enc["f_logvar"]),
                    ("decoder.f_latent", dec["f_latent"])):
        sd[f"autoencoder.{name}.weight"] = _t(p["w"])
        sd[f"autoencoder.{name}.bias"] = _t(p["b"])
    os.makedirs(out_dir, exist_ok=True)
    torch.save({"model_state_dict": sd},
               os.path.join(out_dir, "generator.pt"))
    torch.save({k: {n: _t(v) for n, v in extra[k].items()}
                for k in ("means", "stds")},
               os.path.join(out_dir, "data.pt"))


def write_temporal_pt(out_dir):
    """``temporal.pt`` of the in-repo temporal model, written by the JAX
    package's exporter as a subprocess."""
    subprocess.run([sys.executable, os.path.join(REPO, "tools",
                                                 "export_temporal_pt.py"),
                    os.path.join(REPO, MODEL_DIR),
                    os.path.join(out_dir, "temporal.pt")],
                   check=True, capture_output=True, timeout=120,
                   env=dict(os.environ, JAX_PLATFORMS="cpu"))


def assert_trees_equal(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            assert_trees_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_trees_equal(x, y, f"{path}/{i}")
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.shape == y.shape and x.dtype == y.dtype, path
        np.testing.assert_array_equal(x, y, err_msg=path)


@pytest.fixture(scope="module")
def ref_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("reference_model"))
    write_reference_pt(d)
    write_temporal_pt(d)
    return d


def test_generator_pt_matches_jax(ref_dir):
    from dragposer_tpu import config as jc
    from dragposer_tpu.models import torch_import as jti
    from dragposer_tpu_torch import config as tc
    from dragposer_tpu_torch.models import checkpoint
    from dragposer_tpu_torch.models import torch_import as tti

    ref = jti.load_generator(ref_dir, EXAMPLE_PARENTS, jc.VAE_PARAM)
    got = tti.load_generator(ref_dir, EXAMPLE_PARENTS, tc.VAE_PARAM)
    assert_trees_equal(got, ref)
    # and the weights are the .npz's they were written from
    params, extra = checkpoint.load(os.path.join(MODEL_DIR, "generator.npz"))
    assert_trees_equal(got, (params, extra["means"], extra["stds"]))


def test_temporal_pt_matches_jax(ref_dir):
    from dragposer_tpu import config as jc
    from dragposer_tpu.models import torch_import as jti
    from dragposer_tpu_torch import config as tc
    from dragposer_tpu_torch.models import torch_import as tti

    ref = jti.load_temporal(ref_dir, jc.TEMPORAL_PARAM)
    got = tti.load_temporal(ref_dir, tc.TEMPORAL_PARAM)
    assert_trees_equal(got, ref)


@pytest.mark.parametrize("broken", ["mask", "pool"])
def test_mismatched_statics_raise(tmp_path, broken):
    from dragposer_tpu import config as jc
    from dragposer_tpu.models import torch_import as jti
    from dragposer_tpu_torch import config as tc
    from dragposer_tpu_torch.models import torch_import as tti

    write_reference_pt(str(tmp_path), break_mask=broken == "mask",
                       break_pool=broken == "pool")
    with pytest.raises(AssertionError, match=broken):
        jti.load_generator(str(tmp_path), EXAMPLE_PARENTS, jc.VAE_PARAM)
    with pytest.raises(AssertionError, match=broken):
        tti.load_generator(str(tmp_path), EXAMPLE_PARENTS, tc.VAE_PARAM)


def test_loading_falls_back_to_pt(ref_dir):
    from dragposer_tpu import config as jc
    from dragposer_tpu.models import loading as jl
    from dragposer_tpu_torch.models import loading as tl

    got = tl.load_generator(ref_dir, EXAMPLE_PARENTS)
    assert_trees_equal(got, jl.load_generator(ref_dir, EXAMPLE_PARENTS,
                                              jc.VAE_PARAM))
    assert_trees_equal(tl.load_temporal(ref_dir),
                       jl.load_temporal(ref_dir, jc.TEMPORAL_PARAM))
    with pytest.raises(ValueError, match="parents"):
        tl.load_generator(ref_dir)
    # the native files win where both exist
    params, means, _ = tl.load_generator(MODEL_DIR, EXAMPLE_PARENTS)
    assert means["dqs"].shape == (176,)


def test_build_engine_reads_pt_model_dir(ref_dir):
    """``eval_drag.build_engine`` on a directory of ``.pt`` files only."""
    import chip_smoke
    from dragposer_tpu_torch.cli import eval_drag as tev
    from dragposer_tpu_torch.data import encoding
    from dragposer_tpu_torch.ops.topology import Skeleton

    bvh = chip_smoke.synthetic_bvh(8, seed=5)
    _, _, parents, offsets, _ = encoding.info_from_bvh(bvh)
    engine, means, _ = tev.build_engine(
        ref_dir, parents, tev.resolve_config("6_trackers"),
        skeleton=Skeleton.build(parents, offsets, bvh.names), device="cpu")
    native, _, _ = tev.build_engine(
        MODEL_DIR, parents, tev.resolve_config("6_trackers"),
        skeleton=Skeleton.build(parents, offsets, bvh.names), device="cpu")
    for a, b in zip(engine.model.decoder["ws"], native.model.decoder["ws"]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert engine.hyper.use_temporal


def test_import_checkpoint_round_trips(ref_dir, tmp_path):
    """Both CLIs write the same ``.npz`` files (the same leaves and
    ``extra`` keys) from the ``.pt`` files, equal to the in-repo ones."""
    import chip_smoke
    from dragposer_tpu.cli import import_checkpoint as jic
    from dragposer_tpu.models import checkpoint as jck
    from dragposer_tpu_torch.cli import import_checkpoint as tic
    from dragposer_tpu_torch.models import checkpoint

    bvh_path = str(tmp_path / "skeleton.bvh")
    chip_smoke.synthetic_bvh(4, seed=1).save(bvh_path)
    jic.main([ref_dir, str(tmp_path / "jax"), bvh_path])
    tic.main([ref_dir, str(tmp_path / "torch"), bvh_path])
    for name in ("generator.npz", "temporal.npz"):
        got = checkpoint.load(str(tmp_path / "torch" / name))
        assert_trees_equal(got, jck.load(str(tmp_path / "jax" / name)))
        assert_trees_equal(got, checkpoint.load(os.path.join(MODEL_DIR,
                                                             name)))
    assert (tmp_path / "torch" / "parameters.json").read_text() == (
        tmp_path / "jax" / "parameters.json").read_text()
