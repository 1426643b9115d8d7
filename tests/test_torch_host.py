"""Port host modules against the JAX package: config, topology, BVH I/O,
quaternions, dual quaternions, FK and the motion encoding.

Inputs are seeded numpy arrays and a synthetic clip (``chip_smoke.
synthetic_bvh``); both packages get the same data.  Tolerances: exact for
numpy-only modules (same code), 1e-6 absolute for float32 elementwise
quaternion math (same formulas, different libraries' transcendental
functions), 1e-5 for FK and encodings whose ancestor sums reassociate.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from conftest import EXAMPLE_PARENTS

torch.set_num_threads(1)
RNG = np.random.default_rng(11)


def _unit(*shape):
    q = RNG.normal(size=shape + (4,)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


@pytest.fixture(scope="module")
def clip_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("clip") / "clip.bvh"
    chip_smoke.synthetic_bvh(40, seed=5).save(str(path))
    return str(path)


def test_config_matches():
    from dragposer_tpu import config as jc
    from dragposer_tpu_torch import config as tc

    assert tc.VAE_PARAM == jc.VAE_PARAM
    assert tc.TEMPORAL_PARAM == jc.TEMPORAL_PARAM
    assert tc.HEIGHT_INDICES == jc.HEIGHT_INDICES
    for name, cfg in jc.BUILTIN_CONFIGS.items():
        assert tc.BUILTIN_CONFIGS[name] == tc.TrackerConfig(
            **{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})


def test_topology_identical():
    from dragposer_tpu.models import vae as jvae
    from dragposer_tpu.ops import topology as jt
    from dragposer_tpu_torch import config as tc
    from dragposer_tpu_torch.models import vae as tvae
    from dragposer_tpu_torch.ops import topology as tt

    p = EXAMPLE_PARENTS
    np.testing.assert_array_equal(tt.ancestor_matrix(p), jt.ancestor_matrix(p))
    assert tt.neighbor_lists(p, 2) == jt.neighbor_lists(p, 2)
    assert tt.pooling_schedule(p) == jt.pooling_schedule(p)
    js, ts = jvae.build_statics(p, tc.VAE_PARAM), tvae.build_statics(
        p, tc.VAE_PARAM)
    for name in ("enc_masks", "enc_pools", "dec_masks", "dec_unpools"):
        for a, b in zip(getattr(ts, name), getattr(js, name)):
            np.testing.assert_array_equal(a, b)


def test_bvh_roundtrip_identical(clip_path, tmp_path):
    from dragposer_tpu.io.bvh import BVH as JBVH
    from dragposer_tpu_torch.io.bvh import BVH as TBVH

    j, t = JBVH().load(clip_path), TBVH().load(clip_path)
    assert t.names == j.names
    for name in ("parents", "offsets", "rot_order", "positions", "rotations"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
    out = tmp_path / "again.bvh"
    t.save(str(out))
    np.testing.assert_array_equal(TBVH().load(str(out)).rotations,
                                  t.rotations)


def test_quat_ops_match():
    from dragposer_tpu.ops import dual_quat as jdq
    from dragposer_tpu.ops import quat as jq
    from dragposer_tpu_torch.ops import dual_quat as tdq
    from dragposer_tpu_torch.ops import quat as tq

    a, b = _unit(6, 5), _unit(6, 5)
    v = RNG.normal(size=(6, 5, 3)).astype(np.float32)
    T = torch.as_tensor
    close = lambda x, y: np.testing.assert_allclose(  # noqa: E731
        np.asarray(x), np.asarray(y), atol=1e-6)
    close(tq.mul(T(a), T(b)), jq.mul(a, b))
    close(tq.inverse(T(a)), jq.inverse(a))
    close(tq.mul_vec(T(a), T(v)), jq.mul_vec(a, v))
    close(tq.to_matrix(T(a)), jq.to_matrix(a))
    close(tq.unroll(T(a), axis=0), jq.unroll(a, axis=0))
    order = np.array([list("zyx"), list("xyz"), list("yzx"), list("xzy"),
                      list("zxy")])
    idx = jq.order_to_indices(order)
    np.testing.assert_array_equal(tq.order_to_indices(order), idx)
    ang = RNG.uniform(-1.4, 1.4, size=(6, 5, 3)).astype(np.float32)
    close(tq.from_euler(T(ang), T(idx)[None]), jq.from_euler(ang, idx[None]))
    close(tq.to_euler(T(a), T(idx)[None]), jq.to_euler(a, idx[None]))
    dq = jdq.from_rotation_translation(a, v)
    close(tdq.from_rotation_translation(T(a), T(v)), dq)
    close(tdq.unroll(T(np.array(dq)), axis=0), jdq.unroll(dq, axis=0))
    for x, y in zip(tdq.to_rotation_translation(T(np.array(dq))),
                    jdq.to_rotation_translation(dq)):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), atol=1e-5)


def test_fk_matches():
    from dragposer_tpu.ops import fk as jfk
    from dragposer_tpu.ops.topology import Skeleton as JS
    from dragposer_tpu_torch.ops import fk as tfk
    from dragposer_tpu_torch.ops.topology import Skeleton as TS

    offsets = RNG.normal(size=(22, 3)).astype(np.float32)
    js, ts = JS.build(EXAMPLE_PARENTS, offsets), TS.build(EXAMPLE_PARENTS,
                                                          offsets)
    q = _unit(4, 22)
    root = RNG.normal(size=(4, 3)).astype(np.float32)
    T = torch.as_tensor
    for jf, tf in ((jfk.fk_root_space, tfk.fk_root_space),
                   (jfk.fk_local, tfk.fk_local)):
        for x, y in zip(tf(T(q), T(root), ts), jf(q, root, js)):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=1e-5)
    for x, y in zip(tfk.to_root_space(T(q), T(root), ts),
                    jfk.to_root_space(q, root, js)):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=1e-5)
    np.testing.assert_allclose(tfk.from_root_quat(T(q), ts).numpy(),
                               np.asarray(jfk.from_root_quat(q, js)),
                               atol=1e-6)


def test_fk_parent_rows_equal_the_gather():
    """FK's parent rows as a one-hot product (its backward sums in a fixed
    order on the card): the forward equals ``index_select`` bit for bit,
    the gradient within 1e-6 (a parent's children summed in another
    order), second derivatives included (the VAE trainer's
    ``create_graph``)."""
    from dragposer_tpu_torch.ops import fk as tfk
    from dragposer_tpu_torch.ops.topology import Skeleton as TS

    ts = TS.build(EXAMPLE_PARENTS, np.zeros((22, 3), np.float32))
    parents = torch.as_tensor(ts.parents)
    x = torch.tensor(_unit(3, 22), requires_grad=True)
    g = torch.as_tensor(RNG.normal(size=(3, 22, 4)).astype(np.float32))
    got, ref = tfk._parent_rows(x, ts), x.index_select(-2, parents)
    assert torch.equal(got, ref)
    (dg,) = torch.autograd.grad((got ** 2 * g).sum(), x, create_graph=True)
    (dr,) = torch.autograd.grad((ref ** 2 * g).sum(), x, create_graph=True)
    np.testing.assert_allclose(dg.detach().numpy(), dr.detach().numpy(),
                               rtol=0, atol=1e-6)
    (hg,) = torch.autograd.grad(dg.sum(), x)
    (hr,) = torch.autograd.grad(dr.sum(), x)
    np.testing.assert_allclose(hg.numpy(), hr.numpy(), rtol=0, atol=1e-6)


def test_encoding_matches(clip_path):
    from dragposer_tpu import config as jc
    from dragposer_tpu.data import encoding as je
    from dragposer_tpu.io.bvh import BVH as JBVH
    from dragposer_tpu.ops.topology import Skeleton as JS
    from dragposer_tpu_torch.data import encoding as te
    from dragposer_tpu_torch.io.bvh import BVH as TBVH
    from dragposer_tpu_torch.models import loading
    from dragposer_tpu_torch.ops.topology import Skeleton as TS

    jr, jp, parents, offsets, _ = je.info_from_bvh(JBVH().load(clip_path))
    tr, tp, tpar, toff, _ = te.info_from_bvh(TBVH().load(clip_path))
    np.testing.assert_allclose(tr, jr, atol=1e-6)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tpar, parents)
    np.testing.assert_array_equal(toff, offsets)

    jm = je.encode_motion(offsets, jp[:, 0], jr, JS.build(parents, offsets),
                          height_indices=jc.HEIGHT_INDICES)
    tm = te.encode_motion(offsets, jp[:, 0], jr, TS.build(parents, offsets),
                          height_indices=jc.HEIGHT_INDICES)
    for name in ("dqs", "displacement", "global_pos", "global_rot",
                 "heights"):
        np.testing.assert_allclose(getattr(tm, name), getattr(jm, name),
                                   atol=1e-5, err_msg=name)
    _, means, stds = loading.load_generator("models/model_dancedb_example")
    jn, tn = je.normalize(jm, means, stds), te.normalize(tm, means, stds)
    np.testing.assert_allclose(tn.dqs, jn.dqs, rtol=1e-4, atol=1e-4)
    # heights come from component 1 (y) although the skeleton is z-up
    np.testing.assert_allclose(tm.heights[:, 0], tm.global_pos[:, 1],
                               atol=1e-6)
