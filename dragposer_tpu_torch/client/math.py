"""Client-side math — the reference Unity client's per-frame formulas
(a copy of ``dragposer_tpu/client/math.py``, numpy only).

The reference ships these inside the C# client (``DragPoserUnity``); they are
product behavior (smoothing, damping, coordinate conventions) that any
consumer of the realtime engine needs, so they live here as a tested NumPy
library.  Conventions follow the C# exactly:

* "unity" quaternions are (x, y, z, w) in Unity's LEFT-handed, y-up frame;
* "python" quaternions are (w, x, y, z) in the BVH RIGHT-handed frame
  (z is negated between the two — ``Core/DragPoser.cs:233-263``);
* positions convert by negating z (``DragPoser.cs:234-245``).

All functions broadcast over leading axes.
"""

from __future__ import annotations

import numpy as np

LN2 = 0.69314718056  # MathExtensions.cs:168


# ---------------------------------------------------------------------------
# Coordinate conversions (Core/DragPoser.cs:233-263)
# ---------------------------------------------------------------------------

def unity_to_python_pos(p: np.ndarray) -> np.ndarray:
    """BVH z+ is Unity z- (``DragPoser.cs:233-237``)."""
    p = np.asarray(p, np.float32)
    return np.stack([p[..., 0], p[..., 1], -p[..., 2]], axis=-1)


python_to_unity_pos = unity_to_python_pos  # the map is an involution


def unity_to_python_rot(q_xyzw: np.ndarray) -> np.ndarray:
    """LH→RH (negate x, y; z negated twice) then xyzw→wxyz
    (``DragPoser.cs:246-254``)."""
    q = np.asarray(q_xyzw, np.float32)
    x, y, z, w = -q[..., 0], -q[..., 1], q[..., 2], q[..., 3]
    out = np.stack([w, x, y, z], axis=-1)
    return _normalize_safe(out)


def python_to_unity_rot(q_wxyz: np.ndarray) -> np.ndarray:
    """wxyz→xyzw then RH→LH (``DragPoser.cs:256-263``)."""
    q = np.asarray(q_wxyz, np.float32)
    x, y, z, w = -q[..., 1], -q[..., 2], q[..., 3], q[..., 0]
    out = np.stack([x, y, z, w], axis=-1)
    return _normalize_safe(out)


def _normalize_safe(q: np.ndarray, eps: float = 1e-12) -> np.ndarray:
    n = np.linalg.norm(q, axis=-1, keepdims=True)
    return np.where(n > eps, q / np.maximum(n, eps), q)


# ---------------------------------------------------------------------------
# Hemisphere continuity + smoothing (Core/DragPoser.cs:226-275)
# ---------------------------------------------------------------------------

def ensure_continuity(current: np.ndarray, nxt: np.ndarray) -> np.ndarray:
    """Flip ``nxt`` to the hemisphere of ``current`` (``DragPoser.cs:266-275``):
    if dot(current, -nxt) > dot(current, nxt), negate nxt.  Works for any
    consistent 4-component layout."""
    current = np.asarray(current, np.float32)
    nxt = np.asarray(nxt, np.float32)
    d = np.sum(current * nxt, axis=-1, keepdims=True)
    return np.where(d < 0.0, -nxt, nxt)


def slerp(a: np.ndarray, b: np.ndarray, t: float) -> np.ndarray:
    """Unity ``Quaternion.Slerp`` semantics: t clamped to [0,1], shortest
    path (sign flip), nlerp fallback for near-parallel inputs
    (used by ``DragPoser.cs:228``)."""
    a = _normalize_safe(np.asarray(a, np.float32))
    b = _normalize_safe(np.asarray(b, np.float32))
    t = float(np.clip(t, 0.0, 1.0))
    d = np.sum(a * b, axis=-1, keepdims=True)
    b = np.where(d < 0.0, -b, b)
    d = np.abs(d)
    close = d > 0.9995
    theta = np.arccos(np.clip(d, -1.0, 1.0))
    sin_t = np.sin(theta)
    w_a = np.where(close, 1.0 - t, np.sin((1.0 - t) * theta) / np.where(close, 1.0, sin_t))
    w_b = np.where(close, t, np.sin(t * theta) / np.where(close, 1.0, sin_t))
    return _normalize_safe(w_a * a + w_b * b)


def smooth_rotations(current: np.ndarray, target: np.ndarray, dt: float,
                     rotation_smooth: float) -> np.ndarray:
    """Per-frame pose smoothing (``DragPoser.cs:226-231``):
    slerp(current, target, dt * RotationSmooth)."""
    return slerp(current, target, dt * rotation_smooth)


# ---------------------------------------------------------------------------
# Damped root adjustment (Utils/MathExtensions.cs:163-175, DragPoser.cs:202-211)
# ---------------------------------------------------------------------------

def fast_negexp(x: np.ndarray) -> np.ndarray:
    """The C# polynomial approximation of e^-x (``MathExtensions.cs:172-175``)."""
    x = np.asarray(x, np.float32)
    return 1.0 / (1.0 + x + 0.48 * x * x + 0.235 * x * x * x)


def damp_adjustment_implicit(goal: np.ndarray, halflife: float, dt: float,
                             eps: float = 1e-5) -> np.ndarray:
    """Damp a point from zero toward ``goal``
    (``MathExtensions.cs:166-170``): goal * (1 - e^-(ln2·dt/(halflife+eps)))."""
    goal = np.asarray(goal, np.float32)
    return goal * (1.0 - fast_negexp((LN2 * dt) / (halflife + eps)))


def adjust_root(root_pos: np.ndarray, joint_world_pos: np.ndarray,
                tracker_world_pos: np.ndarray, halflife: float,
                dt: float) -> np.ndarray:
    """The client's per-frame root correction (``DragPoser.cs:202-211``):
    move the character root a damped fraction of the tracker−joint gap."""
    difference = np.asarray(tracker_world_pos, np.float32) - np.asarray(
        joint_world_pos, np.float32)
    return np.asarray(root_pos, np.float32) + damp_adjustment_implicit(
        difference, halflife, dt)


# ---------------------------------------------------------------------------
# Rotation builders (Utils/MathExtensions.cs, TrackerRetargeter.cs:99-106)
# ---------------------------------------------------------------------------

def quat_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Hamilton product, wxyz layout (broadcasting)."""
    aw, ax, ay, az = (a[..., i] for i in range(4))
    bw, bx, by, bz = (b[..., i] for i in range(4))
    return np.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], axis=-1)


def quat_inverse(q: np.ndarray) -> np.ndarray:
    """Unit-quaternion inverse (conjugate), wxyz."""
    return np.concatenate([q[..., :1], -q[..., 1:]], axis=-1)


def quat_mul_vec(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Rotate vector(s) by unit quaternion(s), wxyz."""
    qv = q[..., 1:]
    t = 2.0 * np.cross(qv, v)
    return v + q[..., :1] * t + np.cross(qv, t)


def from_matrix(m: np.ndarray) -> np.ndarray:
    """Rotation matrix (3,3) → wxyz quaternion (Shepperd's method)."""
    m = np.asarray(m, np.float64)
    t = np.trace(m)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w, x, y, z = 0.25 * s, (m[2, 1] - m[1, 2]) / s, \
            (m[0, 2] - m[2, 0]) / s, (m[1, 0] - m[0, 1]) / s
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        w, x, y, z = (m[2, 1] - m[1, 2]) / s, 0.25 * s, \
            (m[0, 1] + m[1, 0]) / s, (m[0, 2] + m[2, 0]) / s
    elif m[1, 1] > m[2, 2]:
        s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
        w, x, y, z = (m[0, 2] - m[2, 0]) / s, (m[0, 1] + m[1, 0]) / s, \
            0.25 * s, (m[1, 2] + m[2, 1]) / s
    else:
        s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
        w, x, y, z = (m[1, 0] - m[0, 1]) / s, (m[0, 2] + m[2, 0]) / s, \
            (m[1, 2] + m[2, 1]) / s, 0.25 * s
    return np.asarray([w, x, y, z], np.float32)


def look_rotation(forward: np.ndarray, up: np.ndarray) -> np.ndarray:
    """Unity ``quaternion.LookRotation``: rotation whose z-axis is
    ``forward`` and whose y-axis is as close to ``up`` as possible
    (used by ``TrackerRetargeter.cs:99-106``).  Returns wxyz."""
    f = np.asarray(forward, np.float32)
    f = f / np.linalg.norm(f)
    r = np.cross(np.asarray(up, np.float32), f)
    rn = np.linalg.norm(r)
    if rn < 1e-8:
        raise ValueError("look_rotation: forward and up are colinear")
    r = r / rn
    u = np.cross(f, r)
    m = np.stack([r, u, f], axis=-1)   # columns = x, y, z axes
    return from_matrix(m)


def quaternion_from_continuous(m: np.ndarray) -> np.ndarray:
    """6D continuous rotation → wxyz quaternion
    (``MathExtensions.cs:150-161``): Gram-Schmidt on two 3-vectors."""
    m = np.asarray(m, np.float32)
    b1 = m[:, 0] / np.linalg.norm(m[:, 0])
    c1 = m[:, 1] - np.dot(b1, m[:, 1]) * b1
    b2 = c1 / np.linalg.norm(c1)
    b3 = np.cross(b1, b2)
    return from_matrix(np.stack([b1, b2, b3], axis=-1))
