"""The port's client layer against the JAX package's, on the CPU:
``client/math.py`` and ``client/retarget.py`` (numpy copies: equal on
seeded inputs; the retargeter's BVH is decoded by each package's own
reader, so 1e-6), ``client/driver.py`` (the reference client's frame on the
port's ``RealtimeSession``: bone lengths, no rebuild on a live mask edit or
a parameter push, the damped root adjustment, and three client frames
against JAX's ``ClientDragPoser`` carrying its session state: rotations
atol 1e-4, root atol 1e-5) and ``runtime/client.py`` (the same request
bytes as the JAX ``DaemonClient``).
"""

import json
import os
import socket
import struct
import threading

import numpy as np
import pytest
import torch

import chip_smoke

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL_DIR = os.path.join(REPO, "models", "model_dancedb_example")


def _quats(rng, *shape):
    q = rng.normal(size=shape + (4,)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def test_math_equals_jax():
    from dragposer_tpu.client import math as jm
    from dragposer_tpu_torch.client import math as tm

    rng = np.random.default_rng(0)
    p = rng.normal(size=(5, 3)).astype(np.float32)
    a, b = _quats(rng, 5), _quats(rng, 5)
    m = rng.normal(size=(3, 2)).astype(np.float32)
    cases = [
        ("unity_to_python_pos", (p,)), ("python_to_unity_pos", (p,)),
        ("unity_to_python_rot", (a,)), ("python_to_unity_rot", (a,)),
        ("ensure_continuity", (a, b)), ("slerp", (a, b, 0.3)),
        ("slerp", (a, a * 0.9999, 0.5)),
        ("smooth_rotations", (a, b, 1 / 60, 10.0)),
        ("fast_negexp", (np.abs(p),)),
        ("damp_adjustment_implicit", (p, 0.1, 1 / 60)),
        ("adjust_root", (p[0], p[1], p[2], 0.1, 1 / 60)),
        ("quat_mul", (a, b)), ("quat_inverse", (a,)),
        ("quat_mul_vec", (a, p)),
        ("from_matrix", (np.eye(3)[[1, 2, 0]],)),
        ("look_rotation", (p[0], p[1])),
        ("quaternion_from_continuous", (m,)),
    ]
    for name, args in cases:
        np.testing.assert_array_equal(getattr(tm, name)(*args),
                                      getattr(jm, name)(*args), err_msg=name)
    assert tm.LN2 == jm.LN2


@pytest.fixture(scope="module")
def skeleton_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("client") / "skeleton.bvh")
    chip_smoke.synthetic_bvh(8, seed=9).save(path)
    return path


def test_retarget_equals_jax(skeleton_path):
    from dragposer_tpu.client import retarget as jr
    from dragposer_tpu_torch.client import retarget as tr

    rng = np.random.default_rng(1)
    jt, tt = jr.TrackerRetargeter(skeleton_path), tr.TrackerRetargeter(
        skeleton_path)
    for name in ("root_align", "tracker_pos", "tracker_rot",
                 "inverse_target_tpose", "source_tpose"):
        np.testing.assert_allclose(getattr(tt, name), getattr(jt, name),
                                   atol=1e-6, err_msg=name)
    for k in (0, 13, 17):
        pos = rng.normal(size=3).astype(np.float32)
        rot = _quats(rng)
        for r in (jt, tt):
            r.set_tracker(k, pos, rot)
            r.retarget_all()
        for got, want in zip(tt.get_retarget(k), jt.get_retarget(k)):
            np.testing.assert_allclose(got, want, atol=1e-6)
    local = _quats(rng, tt.n_joints)
    for got, want in zip(tr.fk_world(tt.parents, tt.offsets, local, pos),
                         jr.fk_world(jt.parents, jt.offsets, local, pos)):
        np.testing.assert_allclose(got, want, atol=1e-6)


def _posers(skeleton_path):
    from dragposer_tpu.client.driver import ClientDragPoser as JaxPoser
    from dragposer_tpu_torch.client.driver import ClientDragPoser

    kw = dict(temporal_future_window=16, max_iter=4, log_path=None)
    jd = JaxPoser(skeleton_path, MODEL_DIR, **kw)
    td = ClientDragPoser(skeleton_path, MODEL_DIR, device="cpu", **kw)
    for d in (jd, td):
        d.initialize_pose()
    td.session._state = td.session._engine.on_device(jd.session._state)
    return jd, td


def _move_trackers(posers, k):
    """The masked trackers moved by a few cm, the same for each poser."""
    rng = np.random.default_rng(k)
    d0 = posers[0]
    for j in np.nonzero(d0.mask > 0.1)[0]:
        pos = d0.retargeter.tracker_pos[j] + 0.02 * rng.normal(size=3)
        rot = d0.retargeter.tracker_rot[j]
        for d in posers:
            d.retargeter.set_tracker(int(j), pos, rot)


def test_poser_frames_match_jax(skeleton_path):
    jd, td = _posers(skeleton_path)
    np.testing.assert_allclose(td.local_rotations, jd.local_rotations,
                               atol=1e-6)
    for k in range(3):
        _move_trackers((jd, td), k)
        for d in (jd, td):
            d.step(1.0 / 60.0)
        np.testing.assert_allclose(td.local_rotations, jd.local_rotations,
                                   atol=1e-4)
        np.testing.assert_allclose(td.root_position, jd.root_position,
                                   atol=1e-5)
        assert td.last_frame_ms > 0


@pytest.fixture(scope="module")
def poser(skeleton_path):
    from dragposer_tpu_torch.client.driver import ClientDragPoser

    d = ClientDragPoser(skeleton_path, MODEL_DIR, temporal_future_window=16,
                        max_iter=4, log_path=None, device="cpu")
    d.initialize_pose()
    return d


def test_poser_steps_need_initialize_pose(skeleton_path):
    from dragposer_tpu_torch.client.driver import ClientDragPoser

    d = ClientDragPoser(skeleton_path, MODEL_DIR, log_path=None,
                        device="cpu")
    with pytest.raises(RuntimeError, match="initialize_pose"):
        d.step()


def test_poser_keeps_bone_lengths(poser):
    _move_trackers((poser,), 7)
    poser.step(1.0 / 60.0)
    pos, _ = poser.world_pose()
    for i in range(1, len(poser.parents)):
        np.testing.assert_allclose(
            np.linalg.norm(pos[i] - pos[poser.parents[i]]),
            np.linalg.norm(poser.offsets[i]), rtol=1e-4, atol=1e-6)


def test_poser_mask_edit_and_param_push_do_not_rebuild(poser):
    """``FBIK.cs`` edits the mask every frame and the client pushes the
    optimizer parameters every frame: neither rebuilds the engine."""
    engine = poser.session._engine
    poser.mask[:] = 0
    poser.mask[[13, 17, 21]] = 1          # 3 trackers, live
    poser.weights[13, 0] = 20.0
    poser.step(1.0 / 60.0)
    assert poser.session._engine is engine
    assert len(poser.session._mask_indices) == 3
    np.testing.assert_array_equal(engine.model.mask.numpy(), poser.mask)
    poser.mask[:] = 0
    poser.mask[[0, 3, 7, 13, 17, 21]] = 1
    poser.weights[13, 0] = 5.0
    for _ in range(2):
        poser.step(1.0 / 60.0)
    assert poser.session._engine is engine
    pos, _ = poser.world_pose()
    assert np.isfinite(pos).all()


def test_poser_root_adjustment_pulls_the_root(poser):
    poser.retargeter.retarget_all()
    target, _ = poser.retargeter.get_retarget(poser.adjustment_joint)
    poser.root_position = poser.root_position + np.float32([0.3, 0.0, 0.2])
    before = np.linalg.norm(poser.world_pose()[0][poser.adjustment_joint]
                            - target)
    poser._adjust_joint(dt=0.5)
    after = np.linalg.norm(poser.world_pose()[0][poser.adjustment_joint]
                           - target)
    assert after < before


# ---------------------------------------------------------------------------
# runtime/client.py: the bytes on the wire
# ---------------------------------------------------------------------------

class _Recorder:
    """A one-connection Unix-socket server that records each request frame
    and answers ok with a canned body, or with an error for opcode 11 when
    ``fail`` is set."""

    def __init__(self, path, fail=False):
        self.frames = []
        self.srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self.srv.bind(path)
        self.srv.listen(1)
        self.fail = fail
        self.thread = threading.Thread(target=self._serve, daemon=True)
        self.thread.start()

    def _serve(self):
        conn, _ = self.srv.accept()
        with conn:
            while True:
                hdr = conn.recv(4, socket.MSG_WAITALL)
                if len(hdr) < 4:
                    return
                (length,) = struct.unpack("<I", hdr)
                frame = conn.recv(length, socket.MSG_WAITALL)
                self.frames.append(hdr + frame)
                if frame[0] == 11 and self.fail:
                    body, status = b"NotImplementedError: no", 1
                elif frame[0] == 11:
                    body, status = json.dumps(
                        {"results": [], "elapsed_s": 0.0}).encode(), 0
                elif frame[0] == 12:
                    body, status = b"{}", 0
                else:
                    body, status = b"", 0
                conn.sendall(struct.pack("<IB", len(body) + 1, status) + body)

    def close(self):
        self.thread.join(timeout=10)
        self.srv.close()


@pytest.mark.parametrize("fail", [False, True], ids=["ok", "error"])
def test_daemon_client_sends_what_jax_sends(tmp_path, fail):
    from dragposer_tpu.runtime.client import DaemonClient as JaxClient
    from dragposer_tpu.runtime.client import DaemonError as JaxError
    from dragposer_tpu_torch.runtime.client import DaemonClient, DaemonError

    recorded = []
    for k, (cls, err) in enumerate(((JaxClient, JaxError),
                                    (DaemonClient, DaemonError))):
        path = str(tmp_path / f"s{k}.sock")
        rec = _Recorder(path, fail)
        with cls(path, timeout=30) as c:
            c.ping()
            assert c.stats() == {}
            kw = dict(config="4_trackers", max_frames=12, save_dir="out",
                      restarts=4, branch_every=16, branch_survivors=2)
            if fail:
                with pytest.raises(err, match="NotImplementedError"):
                    c.eval_batch("m", "s.bvh", ["a.bvh", "b.bvh"], **kw)
            else:
                assert c.eval_batch("m", "s.bvh", ["a.bvh", "b.bvh"],
                                    **kw) == {"results": [],
                                              "elapsed_s": 0.0}
        rec.close()
        recorded.append(rec.frames)
    assert len(recorded[0]) == 3
    assert recorded[0] == recorded[1]
