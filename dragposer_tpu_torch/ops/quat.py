"""Quaternion functions on torch tensors (port of ``dragposer_tpu/ops/quat.py``).

Conventions are those of the JAX package (and of pymotion, which the
reference uses):

* scalar-first storage ``[w, x, y, z]`` on the last axis;
* rotation matrices act on column vectors (``R @ v``);
* Euler angles are in radians and compose *in channel order*: for an order
  ``"xyz"`` the matrix is ``Rx(a) @ Ry(b) @ Rz(c)``.

All functions are elementwise over arbitrary leading batch dims.
"""

from __future__ import annotations

import numpy as np
import torch

_AXIS_INDEX = {"x": 0, "y": 1, "z": 2}


def mul(q1, q2):
    """Hamilton product ``q1 ⊗ q2`` (applies q2's rotation first)."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack(
        (
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ),
        dim=-1,
    )


def conjugate(q):
    return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


def inverse(q):
    """True quaternion inverse ``conj(q) / |q|²``."""
    return conjugate(q) / torch.sum(q * q, dim=-1, keepdim=True)


def normalize(q, eps: float = 0.0):
    """Unit-normalize along the last axis, the norm clamped to ``eps`` from
    below when ``eps`` is given (reference: ``quat_torch.normalize``)."""
    n = torch.linalg.norm(q, dim=-1, keepdim=True)
    if eps:
        n = torch.clamp(n, min=eps)
    return q / n


def dot(q1, q2):
    return torch.sum(q1 * q2, dim=-1)


def mul_vec(q, v):
    """Rotate ``v`` by unit ``q``: ``v + 2 q_w (q_v × v) + 2 q_v × (q_v × v)``."""
    qw = q[..., :1]
    qv, v = torch.broadcast_tensors(q[..., 1:], v)
    t = 2.0 * torch.linalg.cross(qv, v, dim=-1)
    return v + qw * t + torch.linalg.cross(qv, t, dim=-1)


def unroll(q, axis: int = 0):
    """Sign continuity along ``axis``: flip ``q[i]`` when its dot with the
    (already unrolled) previous element is negative (cumulative product of
    the raw consecutive-dot signs, as in the JAX package)."""
    q = torch.movedim(q, axis, 0)
    d = torch.sum(q[1:] * q[:-1], dim=-1)
    signs = torch.where(d < 0.0, -1.0, 1.0).to(q.dtype)
    flips = torch.cat((torch.ones_like(signs[:1]), torch.cumprod(signs, dim=0)))
    return torch.movedim(q * flips[..., None], 0, axis)


def to_matrix(q):
    """Quaternion → 3×3 rotation matrix (valid for unit quaternions)."""
    w, x, y, z = q.unbind(-1)
    x2, y2, z2 = x + x, y + y, z + z
    xx, yy, zz = x * x2, y * y2, z * z2
    wx, wy, wz = w * x2, w * y2, w * z2
    xy, xz, yz = x * y2, x * z2, y * z2
    return torch.stack(
        (
            torch.stack((1.0 - (yy + zz), xy - wz, xz + wy), dim=-1),
            torch.stack((xy + wz, 1.0 - (xx + zz), yz - wx), dim=-1),
            torch.stack((xz - wy, yz + wx, 1.0 - (xx + yy)), dim=-1),
        ),
        dim=-2,
    )


def from_matrix(m):
    """3×3 rotation matrix → unit quaternion (branchless Shepperd: the
    numerically strongest of four constructions)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22,
                      1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], dim=-1)
    qw = torch.sqrt(torch.clamp(qw, min=1e-12)) * 0.5
    d = 4.0 * qw
    c0 = torch.stack([qw[..., 0], (m21 - m12) / d[..., 0],
                      (m02 - m20) / d[..., 0], (m10 - m01) / d[..., 0]], -1)
    c1 = torch.stack([(m21 - m12) / d[..., 1], qw[..., 1],
                      (m01 + m10) / d[..., 1], (m02 + m20) / d[..., 1]], -1)
    c2 = torch.stack([(m02 - m20) / d[..., 2], (m01 + m10) / d[..., 2],
                      qw[..., 2], (m12 + m21) / d[..., 2]], -1)
    c3 = torch.stack([(m10 - m01) / d[..., 3], (m02 + m20) / d[..., 3],
                      (m12 + m21) / d[..., 3], qw[..., 3]], -1)
    choice = torch.argmax(qw, dim=-1)
    cands = torch.stack([c0, c1, c2, c3], dim=-2)
    q = torch.take_along_dim(cands, choice[..., None, None], dim=-2)[..., 0, :]
    return normalize(q)


def order_to_indices(order) -> np.ndarray:
    """Per-joint Euler order chars (..., 3) → int32 axis indices."""
    arr = np.asarray(order)
    flat = np.array([_AXIS_INDEX[str(c).lower()] for c in arr.reshape(-1)],
                    dtype=np.int32)
    return flat.reshape(arr.shape)


def _axis_quat(axis_index, angle):
    half = 0.5 * angle
    s = torch.sin(half)
    zero = torch.zeros_like(s)
    return torch.stack((torch.cos(half),
                        torch.where(axis_index == 0, s, zero),
                        torch.where(axis_index == 1, s, zero),
                        torch.where(axis_index == 2, s, zero)), dim=-1)


def from_euler(angles, order_idx):
    """Euler (radians, channel order) → quaternion,
    ``q = q(order[0]) ⊗ q(order[1]) ⊗ q(order[2])``."""
    order_idx = torch.as_tensor(order_idx, device=angles.device)
    order_idx = torch.broadcast_to(order_idx, angles.shape)
    q0 = _axis_quat(order_idx[..., 0], angles[..., 0])
    q1 = _axis_quat(order_idx[..., 1], angles[..., 1])
    q2 = _axis_quat(order_idx[..., 2], angles[..., 2])
    return mul(mul(q0, q1), q2)


def to_euler(q, order_idx):
    """Quaternion → Euler angles (radians) in the given channel order; the
    inverse of :func:`from_euler` for the six Tait–Bryan orders, with the
    JAX package's gimbal-lock rule."""
    order_idx = torch.as_tensor(order_idx, device=q.device, dtype=torch.long)
    order_idx = torch.broadcast_to(order_idx, q.shape[:-1] + (3,))
    i, j, k = order_idx.unbind(-1)
    eps = torch.where(j == (i + 1) % 3, 1.0, -1.0).to(q.dtype)
    m = to_matrix(q)

    def g(r, c):
        row = torch.take_along_dim(m, r[..., None, None].expand(
            r.shape + (1, 3)), dim=-2)
        return torch.take_along_dim(row, c[..., None, None], dim=-1)[..., 0, 0]

    r_ik, r_jk, r_kk = g(i, k), g(j, k), g(k, k)
    r_ij, r_ii, r_ji, r_jj = g(i, j), g(i, i), g(j, i), g(j, j)
    sin_b = torch.clamp(eps * r_ik, -1.0, 1.0)
    b = torch.arcsin(sin_b)
    a = torch.atan2(-eps * r_jk, r_kk)
    c = torch.atan2(-eps * r_ij, r_ii)
    locked = (r_jk * r_jk + r_kk * r_kk) < 1e-10
    a = torch.where(locked, torch.atan2(torch.sign(sin_b) * r_ji, r_jj), a)
    c = torch.where(locked, torch.zeros_like(c), c)
    return torch.stack((a, b, c), dim=-1)
