"""The port's leaf modules and small API gaps against the JAX package's, on
the CPU: the numpy clients ``client.playback`` and ``client.vr`` on seeded
synthetic clips (``chip_smoke.synthetic_bvh``), the browser viewer's
request handler (``cli.interactive``), ``cli.visualize``,
``ops.quat.dot``/``from_matrix``/``normalize(eps)``,
``TrackerConfig.n_end_effectors``, and ``skeleton_conv`` with reflect
padding, kernel 3 and stride 2, with ``vae.encode`` at that stride.

The client modules are numpy copies running the same float32/float64
arithmetic on the same inputs: equal to 1e-6 absolute.  The quaternion and
convolution functions are float32 in both frameworks: 1e-6 absolute
(values of order 1), the ``vae.encode`` heads 1e-5 (sums of ~100 terms).
"""

import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

import chip_smoke

torch.set_num_threads(1)
MODEL_DIR = "models/model_dancedb_example"


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("leaves") / "clip.bvh")
    chip_smoke.synthetic_bvh(40, seed=11).save(path)
    return path


def test_playback_matches_jax(clip):
    from dragposer_tpu.client import playback as jp
    from dragposer_tpu.client import retarget as jr
    from dragposer_tpu_torch.client import playback as tp
    from dragposer_tpu_torch.client import retarget as tr

    jret, tret = jr.TrackerRetargeter(clip), tr.TrackerRetargeter(clip)
    jpb, tpb = jp.BVHPlayback(clip, jret), tp.BVHPlayback(clip, tret)
    np.testing.assert_allclose(tpb._pos, jpb._pos, atol=1e-6)
    np.testing.assert_allclose(tpb._rot, jpb._rot, atol=1e-6)
    for _ in range(5):
        assert tpb.update_trackers() == jpb.update_trackers()
        np.testing.assert_allclose(tret.tracker_pos, jret.tracker_pos,
                                   atol=1e-6)
        for j in range(tret.n_joints):
            for a, b in zip(tret.get_retarget(j), jret.get_retarget(j)):
                np.testing.assert_allclose(a, b, atol=1e-6)
    tpb.paused = jpb.paused = True
    assert tpb.update_trackers() == jpb.update_trackers() == tpb.frame
    tpb.reset()
    assert tpb.frame == 0


def test_vr_provider_and_rig_match_jax(clip):
    """The BVH-driven 6-device rig, detection, role assignment and
    identification, joint calibration and the VRIK rig's per-frame
    targets, step for step against the JAX module."""
    from dragposer_tpu.client import retarget as jr
    from dragposer_tpu.client import vr as jvr
    from dragposer_tpu_torch.client import retarget as tr
    from dragposer_tpu_torch.client import vr as tvr

    perm = [3, 0, 5, 2, 4, 1]
    jprov = jvr.BVHDeviceProvider(clip, permutation=perm, trigger_frames={0})
    tprov = tvr.BVHDeviceProvider(clip, permutation=perm, trigger_frames={0})
    for f in (0, 7, 19):
        jprov.frame = tprov.frame = f
        for a, b in zip(tprov.poll(), jprov.poll()):
            assert (a.index, a.render_model, a.tracking_ok) == (
                b.index, b.render_model, b.tracking_ok)
            np.testing.assert_allclose(a.position, b.position, atol=1e-6)
            np.testing.assert_allclose(a.rotation, b.rotation, atol=1e-6)
    jprov.frame = tprov.frame = 0
    jdet = jvr.detect_devices(jprov.poll())
    tdet = tvr.detect_devices(tprov.poll())
    assert tdet.ok == jdet.ok
    jroles, troles = (jvr.assign_device_indices(jdet),
                      tvr.assign_device_indices(tdet))
    assert troles == jroles
    poses = lambda p: {d.index: (d.position, d.rotation)  # noqa: E731
                       for d in p.poll()}
    assert tvr.identify_devices(troles, poses(tprov)) == \
        jvr.identify_devices(jroles, poses(jprov))

    def rig(vr, ret_mod, prov):
        class StubDriver:
            def __init__(self):
                self.retargeter = ret_mod.TrackerRetargeter(clip)
                j = self.retargeter.n_joints
                self.mask = np.zeros(j, np.float32)
                self.weights = np.ones((j, 2), np.float32)

        driver = StubDriver()
        r = vr.VRIKRig(driver)
        pose0 = {role: prov.device_pose(role, 0) for role in vr.SIX_ROLES}
        jw0, _ = prov.joint_world(0)
        bones = {role: jw0[vr.ROLE_JOINT[role]] for role in vr.SIX_ROLES}
        r.set_joint_offsets(vr.setup_joints(pose0, bones,
                                            compute_offsets_hands=True))
        r.calibrate(pose0)
        out = []
        for f in (5, 23):
            r.before_retarget({role: prov.device_pose(role, f)
                               for role in vr.SIX_ROLES})
            out.append((driver.mask.copy(), driver.weights.copy(),
                        driver.retargeter.tracker_pos.copy()))
        r.active[vr.ROLE_TRACKER_LEFT] = False
        r.before_retarget({role: prov.device_pose(role, 23)
                           for role in vr.SIX_ROLES})
        out.append((driver.mask.copy(), driver.weights.copy(),
                    driver.retargeter.tracker_pos.copy()))
        return out

    for got, ref in zip(rig(tvr, tr, tprov), rig(jvr, jr, jprov)):
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a, b, atol=1e-6)


def test_interactive_handler_answers_a_fake_request(clip):
    """``cli.interactive``'s app on the CPU behind its HTTP handler: the
    viewer page, one FBIK step and one playback step, the mask reset and
    the pause toggle, as a browser would send them."""
    from http.server import ThreadingHTTPServer

    from dragposer_tpu_torch.cli import interactive

    app = interactive.InteractiveApp(MODEL_DIR, clip, window=8, max_iter=2,
                                     device="cpu")
    server = ThreadingHTTPServer(("127.0.0.1", 0),
                                 interactive.make_handler(app))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"

    def post(path, body=None):
        req = urllib.request.Request(base + path,
                                     data=json.dumps(body or {}).encode(),
                                     method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            return json.loads(r.read())

    try:
        with urllib.request.urlopen(base + "/", timeout=60) as r:
            assert b"<canvas" in r.read()
        J = app.poser.n_joints
        out = post("/api/step", {"mode": "fbik", "moved": [[3, [0.1, 0.2,
                                                                0.3]]]})
        assert np.isfinite(out["joints"]).all()
        assert np.asarray(out["joints"]).shape == (J, 3)
        assert out["bones"] == [[int(app.poser.parents[i]), i]
                                for i in range(1, J)]
        # the app applied frame 0 when it started
        out = post("/api/step", {"mode": "playback"})
        assert out["frame"] == 1 and np.isfinite(out["joints"]).all()
        assert post("/api/step", {"mode": "playback"})["frame"] == 2
        reset = post("/api/reset_mask")
        assert sum(reset["mask"]) == 6 and reset["weights"][0][0] == 10.0
        assert post("/api/pause") == {"paused": True}
        assert post("/api/pb_reset") == {"frame": 0}
    finally:
        server.shutdown()
        server.server_close()


def test_visualize_renders_and_matches_jax_positions(clip, tmp_path):
    from dragposer_tpu.cli import visualize as jvis
    from dragposer_tpu.io.bvh import BVH as JBVH
    from dragposer_tpu_torch.cli import visualize as tvis
    from dragposer_tpu_torch.io.bvh import BVH

    got, gp = tvis.world_positions(BVH().load(clip), 3, 20, 2, device="cpu")
    ref, rp = jvis.world_positions(JBVH().load(clip), 3, 20, 2)
    np.testing.assert_allclose(got, ref, atol=1e-5)
    np.testing.assert_array_equal(gp, rp)
    pytest.importorskip("matplotlib")
    out = str(tmp_path / "out.gif")
    tvis.main([clip, clip, out, "--frames", "6", "--stride", "2",
               "--device", "cpu"])
    with open(out, "rb") as f:
        assert f.read(6) in (b"GIF87a", b"GIF89a")


def test_visualize_runs_on_cuda_unless_given_cpu(clip, monkeypatch):
    """``cli.visualize`` is an entry point: its FK runs on ``cuda`` by
    default, and without a card it raises rather than drop to the CPU."""
    from dragposer_tpu_torch.cli import visualize as tvis
    from dragposer_tpu_torch.io.bvh import BVH

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tvis.world_positions(BVH().load(clip), 0, 4, 1)


def test_quat_api_matches_jax():
    from dragposer_tpu.ops import quat as jq
    from dragposer_tpu_torch.ops import quat as tq

    rng = np.random.default_rng(3)
    q = rng.normal(size=(64, 4)).astype(np.float32)
    q[0] = 0.0                                # the eps floor's case
    q2 = rng.normal(size=(64, 4)).astype(np.float32)
    t = torch.as_tensor
    np.testing.assert_allclose(tq.dot(t(q), t(q2)).numpy(),
                               np.asarray(jq.dot(q, q2)), atol=1e-6)
    for eps in (0.0, 1e-3):
        got = tq.normalize(t(q[1:] if eps == 0.0 else q), eps=eps).numpy()
        ref = np.asarray(jq.normalize(q[1:] if eps == 0.0 else q, eps=eps))
        np.testing.assert_allclose(got, ref, atol=1e-6)
    # rotation matrices of unit quaternions in every Shepperd branch
    u = q2 / np.linalg.norm(q2, axis=-1, keepdims=True)
    m = np.array(jq.to_matrix(u))
    got = tq.from_matrix(t(m)).numpy()
    np.testing.assert_allclose(got, np.asarray(jq.from_matrix(m)), atol=1e-6)
    np.testing.assert_allclose(np.abs(np.sum(got * u, -1)), 1.0, atol=1e-5)


def test_n_end_effectors_matches_jax():
    from dragposer_tpu import config as jc
    from dragposer_tpu_torch import config as tc

    for name, cfg in tc.BUILTIN_CONFIGS.items():
        assert cfg.n_end_effectors == jc.BUILTIN_CONFIGS[name].n_end_effectors
    assert tc.SIX_TRACKERS.n_end_effectors == 6


@pytest.mark.parametrize("kernel,stride", [(3, 2), (3, 1), (5, 2), (1, 2)])
def test_skeleton_conv_matches_jax(kernel, stride):
    import jax.numpy as jnp

    from dragposer_tpu.models import skeleton_nn as jnn
    from dragposer_tpu_torch.models import skeleton_nn as tnn

    rng = np.random.default_rng(kernel * 10 + stride)
    x = rng.normal(size=(3, 16, 9)).astype(np.float32)
    w = rng.normal(size=(12, 16, kernel)).astype(np.float32)
    b = rng.normal(size=(12,)).astype(np.float32)
    mask = (rng.random((12, 16, kernel)) < 0.5).astype(np.float32)
    pad = (kernel - 1) // 2
    ref = np.asarray(jnn.skeleton_conv(jnp.asarray(x), {"w": w, "b": b},
                                       mask, pad, stride))
    got = tnn.skeleton_conv(torch.as_tensor(x), {"w": torch.as_tensor(w),
                                                 "b": torch.as_tensor(b)},
                            torch.as_tensor(mask), pad, stride).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-5)


@pytest.mark.parametrize("window", [1, 5])
def test_vae_encode_with_kernel_and_stride_matches_jax(window):
    """A VAE of kernel 3 and encoder stride 2 (fresh JAX weights, carried
    across): ``vae.encode`` on windows of 1 and 5 frames."""
    import jax

    from dragposer_tpu import config as jc
    from dragposer_tpu.models import vae as jvae
    from dragposer_tpu_torch import config as tc
    from dragposer_tpu_torch.models import loading
    from dragposer_tpu_torch.models import vae as tvae

    param = dict(jc.VAE_PARAM, kernel_size_temporal_dim=3,
                 stride_encoder_conv=2)
    parents = chip_smoke.EXAMPLE_PARENTS
    jparams = jvae.init_params(jax.random.PRNGKey(4), parents, param)
    jst = jvae.build_statics(parents, param)
    tst = tvae.build_statics(parents, dict(tc.VAE_PARAM, **{
        k: param[k] for k in ("kernel_size_temporal_dim",
                              "stride_encoder_conv")}))
    assert (tst.padding, tst.stride) == (jst.padding, jst.stride) == (1, 2)
    # three stride-2 convolutions take 5 frames (and 1) to 1, the width the
    # linear heads take
    enc = loading.tree_to_torch(jax.device_get(jparams["encoder"]), "cpu")
    x = np.random.default_rng(5).normal(
        size=(4, 8 * len(parents), window)).astype(np.float32)
    jmu, jlv = jvae.encode(jparams["encoder"], jst, x)
    tmu, tlv = tvae.encode(enc, tst, torch.as_tensor(x))
    np.testing.assert_allclose(tmu.numpy(), np.asarray(jmu), atol=1e-5)
    np.testing.assert_allclose(tlv.numpy(), np.asarray(jlv), atol=1e-5)
