"""Flat session bridge (port of ``dragposer_tpu/runtime/capi.py``).

The serving daemon (``runtime/server.py``) maps its opcodes onto these
functions, and the embedded C ABI (``dragposer_tpu_torch/native/abi.cpp``)
calls them through the CPython C API: only scalars and ``bytes`` cross the
boundary, arrays as little-endian float32 buffers.

Handles are integers so several sessions can coexist (the reference DLL
hands out one ``DragPoser*`` per ``init_drag_poser``, ``exportFunc.cpp``).
A session is created on the device :func:`init` is given (the daemon's).
"""

from __future__ import annotations

import threading

import numpy as np

from dragposer_tpu_torch.runtime.realtime import RealtimeSession

_sessions: dict[int, RealtimeSession] = {}
_next_id = 1
_id_lock = threading.Lock()  # the daemon serves connections on threads


def init(device=None) -> int:
    """A new session on ``device`` (``cuda`` unless ``"cpu"``)."""
    global _next_id
    session = RealtimeSession(device=device)
    with _id_lock:
        handle = _next_id
        _next_id += 1
    _sessions[handle] = session
    return handle


def destroy(handle: int) -> None:
    _sessions.pop(handle, None)


def get_session(handle: int) -> RealtimeSession:
    """The session object behind a handle (serving daemon: request
    coalescing needs direct access to session state/config)."""
    return _sessions[handle]


def set_reference_skeleton(handle: int, bvh_path: str) -> int:
    return _sessions[handle].set_reference_skeleton(bvh_path)


def load_models(handle: int, model_dir: str) -> None:
    _sessions[handle].load_models(model_dir)


def set_mask_and_weights(handle: int, mask: bytes, weights: bytes) -> int:
    s = _sessions[handle]
    j = s.skeleton.n_joints
    m = np.frombuffer(mask, dtype="<f4", count=j)
    w = np.frombuffer(weights, dtype="<f4", count=2 * j).reshape(j, 2)
    return s.set_mask_and_weights(m, w)


def init_drag_model(handle: int, px: float, py: float, pz: float,
                    qw: float, qx: float, qy: float, qz: float) -> None:
    _sessions[handle].init_drag_pose(
        np.array([[px, py, pz]], np.float32),
        np.array([[qw, qx, qy, qz]], np.float32),
    )


def set_optim_params(handle: int, stop_eps_pos: float, stop_eps_rot: float,
                     max_iter: int, lr: float) -> None:
    _sessions[handle].set_optim_params(stop_eps_pos, stop_eps_rot, max_iter, lr)


def set_lambdas(handle: int, lambda_rot: float, lambda_temporal: float,
                temporal_future_window: int) -> None:
    _sessions[handle].set_lambdas(lambda_rot, lambda_temporal,
                                  temporal_future_window)


def set_global_pos(handle: int, x: float, y: float, z: float) -> None:
    _sessions[handle].set_global_pos(np.array([[x, y, z]], np.float32))


def drag_pose(handle: int, ee_pos: bytes, ee_rot: bytes, n_ee: int) -> bytes:
    """ee_pos: n_ee×3 f32; ee_rot: n_ee×4 f32 (wxyz).

    Returns (J×4 local wxyz quats ⊕ 3 global position floats) as f32 bytes.
    """
    s = _sessions[handle]
    j = s.skeleton.n_joints
    tpos = np.frombuffer(ee_pos, dtype="<f4", count=3 * n_ee).reshape(n_ee, 3)
    trot = np.frombuffer(ee_rot, dtype="<f4", count=4 * n_ee).reshape(n_ee, 4)
    out_pose = np.zeros((j, 4), np.float32)
    out_gp = np.zeros((1, 3), np.float32)
    s.drag_pose(tpos, trot, out_pose, out_gp)
    return np.concatenate((out_pose.reshape(-1), out_gp.reshape(-1))).astype(
        "<f4"
    ).tobytes()
