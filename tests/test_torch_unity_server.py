"""The port's legacy TCP bridge (``cli/unity_server.py``) against the JAX
package's, on the CPU: one window of 64 frames × 6 sparse joints × 7
little-endian float32 in, 22 × 4 float32 parent-local wxyz rotations out.
The window comes from a seeded synthetic clip.  The reply is held against
JAX's ``build_reconstructor`` on the same window at atol 1e-4 (an encoder
and a decoder in float32, sums reassociated), and the socket against the
port's own in-process reconstruction bit for bit.
"""

import socket
import struct
import threading
import time

import numpy as np
import pytest
import torch

import chip_smoke

torch.set_num_threads(1)
MODEL_DIR = "models/model_dancedb_example"
WINDOW = 64
N_SPARSE = 6
N_JOINTS = 22


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """The skeleton path and a reference-format window: the sparse joints'
    local rotations and global root positions of 64 frames."""
    from dragposer_tpu_torch import config as cfg
    from dragposer_tpu_torch.data import encoding
    from dragposer_tpu_torch.io.bvh import BVH

    path = str(tmp_path_factory.mktemp("unity") / "clip.bvh")
    chip_smoke.synthetic_bvh(WINDOW, seed=3).save(path)
    rots, pos, _, _, _ = encoding.info_from_bvh(BVH().load(path))
    sparse = cfg.VAE_PARAM["sparse_joints"]
    buf = np.zeros((WINDOW, N_SPARSE, 7), np.float32)
    buf[:, :, :3] = pos[:, sparse]
    buf[:, :, 3:] = rots[:, sparse]
    return path, buf


def _dense(buf, sparse):
    pos = np.zeros((WINDOW, N_JOINTS, 3), np.float32)
    rot = np.zeros((WINDOW, N_JOINTS, 4), np.float32)
    rot[:, :, 0] = 1.0
    pos[:, sparse] = buf[:, :, :3]
    rot[:, sparse] = buf[:, :, 3:]
    return pos, rot


def test_reconstructor_matches_jax(clip):
    from dragposer_tpu.cli import unity_server as jus
    from dragposer_tpu_torch import config as cfg
    from dragposer_tpu_torch.cli import unity_server as tus

    path, buf = clip
    pos, rot = _dense(buf, cfg.VAE_PARAM["sparse_joints"])
    jrec, jsk = jus.build_reconstructor(MODEL_DIR, path)
    trec, tsk = tus.build_reconstructor(MODEL_DIR, path, device="cpu")
    assert tsk.n_joints == jsk.n_joints == N_JOINTS
    want = np.asarray(jrec(pos, rot))
    got = trec(pos, rot)
    assert got.shape == (N_JOINTS, 4) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-4)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-4)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_round_trip_over_tcp(clip):
    from dragposer_tpu_torch import config as cfg
    from dragposer_tpu_torch.cli import unity_server

    path, buf = clip
    port = _free_port()
    server = threading.Thread(
        target=unity_server.serve, args=(MODEL_DIR, path),
        kwargs={"port": port, "max_sessions": 1, "device": "cpu"},
        daemon=True)
    server.start()
    payload = buf.astype("<f4").tobytes()
    assert len(payload) == WINDOW * N_SPARSE * 7 * 4
    reply, t0 = None, time.time()
    while reply is None and time.time() - t0 < 60:
        try:
            with socket.create_connection(("127.0.0.1", port),
                                          timeout=60) as c:
                c.sendall(payload)
                want = N_JOINTS * 4 * 4
                data = b""
                while len(data) < want:
                    chunk = c.recv(want - len(data))
                    assert chunk, "the bridge closed before its reply"
                    data += chunk
                reply = data
        except ConnectionRefusedError:
            time.sleep(0.2)
    assert reply is not None, "could not connect to the bridge"
    quats = np.asarray(struct.unpack(f"<{N_JOINTS * 4}f", reply),
                       np.float32).reshape(N_JOINTS, 4)
    reconstruct, _ = unity_server.build_reconstructor(MODEL_DIR, path,
                                                      device="cpu")
    pos, rot = _dense(buf, cfg.VAE_PARAM["sparse_joints"])
    np.testing.assert_array_equal(quats, reconstruct(pos, rot))
    server.join(timeout=30)
    assert not server.is_alive()
