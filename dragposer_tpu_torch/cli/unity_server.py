"""Legacy TCP bridge (reference ``python/src/unity.py`` protocol parity;
port of ``dragposer_tpu/cli/unity_server.py``).

Blocking TCP server on 127.0.0.1:2222.  Protocol (little-endian float32):

* request: 64 frames × 6 sparse joints × 7 floats (pos x,y,z + quat w,x,y,z)
* reply:   22 joints × 4 floats — parent-local wxyz rotations of the last
  reconstructed pose (VAE reconstruction only, no drag optimization).

Note: the reference file has bitrotted against its own model (it indexes the
generator's output tuple and denormalizes 88 channels with 176-channel
stats, ``unity.py:96-107``); this implementation performs the documented
intent — encode the sparse window, decode, return local rotations — with
the current single-frame VAE.  The VAE runs on ``cuda`` unless
``--device cpu`` is given; the bridge launches no kernel of its own.
"""

from __future__ import annotations

import argparse
import socket
import struct

import numpy as np
import torch

from dragposer_tpu_torch import config as cfg
from dragposer_tpu_torch._device import resolve_device
from dragposer_tpu_torch.data import encoding
from dragposer_tpu_torch.io.bvh import BVH
from dragposer_tpu_torch.models import loading, vae
from dragposer_tpu_torch.ops import dual_quat, fk
from dragposer_tpu_torch.ops.topology import Skeleton

HOST = "127.0.0.1"
PORT = 2222
WINDOW = 64  # must match the client
SENT_POSE_INDEX = -1


def build_reconstructor(model_dir: str, reference_bvh: str, device=None):
    """Returns (fn(positions (W,J,3), rotations (W,J,4)) → local rots (J,4),
    skeleton).  The dual quaternions are formed on the host; the VAE runs
    on ``device`` (``cuda`` unless ``"cpu"``)."""
    dev = resolve_device(device)
    bvh = BVH().load(reference_bvh)
    _, _, parents, offsets, _ = encoding.info_from_bvh(bvh)
    skeleton = Skeleton.build(parents, offsets, bvh.names)
    params, means, stds = loading.load_generator(model_dir)
    params = loading.tree_to_torch(params, dev)
    statics = vae.build_statics(parents, cfg.VAE_PARAM)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    mean_dqs, std_dqs = t(means["dqs"]), t(stds["dqs"])
    mean_q, std_q = vae.quat_stats(mean_dqs, std_dqs)

    def reconstruct(positions: np.ndarray, rotations: np.ndarray) -> np.ndarray:
        dqs = dual_quat.from_rotation_translation(
            torch.as_tensor(rotations, dtype=torch.float32),
            torch.as_tensor(positions, dtype=torch.float32))
        dqs = dual_quat.unroll(dqs, axis=0).reshape(WINDOW, -1).to(dev)
        dqs = (dqs - mean_dqs) / std_dqs
        with torch.no_grad():
            mu, _ = vae.encode(params["encoder"], statics, dqs[:, :, None])
            motion, _ = vae.decode(params["decoder"], statics, mu, mean_dqs,
                                   std_dqs)                # (W, 88, 1)
            rs = (motion[SENT_POSE_INDEX, :, 0] * std_q
                  + mean_q).reshape(-1, 4)
            local = fk.from_root_quat(rs, skeleton)
        return local.cpu().numpy()

    return reconstruct, skeleton


def serve(model_dir: str, reference_bvh: str, host: str = HOST,
          port: int = PORT, max_sessions: int | None = None, device=None):
    reconstruct, skeleton = build_reconstructor(model_dir, reference_bvh,
                                                device)
    sparse = cfg.VAE_PARAM["sparse_joints"]
    msg_size = WINDOW * len(sparse) * 7 * 4
    sessions = 0
    while max_sessions is None or sessions < max_sessions:
        with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind((host, port))
            s.listen()
            print(f"listening on {host}:{port} ...")
            conn, addr = s.accept()
            sessions += 1
            with conn:
                print(f"connected by {addr}")
                while True:
                    data = b""
                    while len(data) < msg_size:
                        chunk = conn.recv(msg_size - len(data))
                        if not chunk:
                            break
                        data += chunk
                    if len(data) < msg_size:
                        break
                    floats = np.frombuffer(data, dtype="<f4").astype(np.float32)
                    floats = floats.reshape(WINDOW, len(sparse), 7)
                    j = skeleton.n_joints
                    pos = np.zeros((WINDOW, j, 3), np.float32)
                    rot = np.zeros((WINDOW, j, 4), np.float32)
                    rot[:, :, 0] = 1.0
                    pos[:, sparse, :] = floats[:, :, :3]
                    rot[:, sparse, :] = floats[:, :, 3:]
                    local = reconstruct(pos, rot)
                    conn.sendall(
                        struct.pack(f"<{local.size}f", *local.reshape(-1))
                    )


def main(argv=None):
    parser = argparse.ArgumentParser(description="TCP bridge for Unity clients")
    parser.add_argument("model_path", type=str)
    parser.add_argument("reference_bvh", type=str)
    parser.add_argument("--host", type=str, default=HOST)
    parser.add_argument("--port", type=int, default=PORT)
    parser.add_argument("--device", default=None,
                        help="torch device of the VAE (default cuda)")
    args = parser.parse_args(argv)
    serve(args.model_path, args.reference_bvh, args.host, args.port,
          device=args.device)


if __name__ == "__main__":
    main()
