"""Dual quaternions on torch tensors (port of ``dragposer_tpu/ops/dual_quat.py``).

Stored as 8 floats on the last axis, ``[real(4), dual(4)]``, with the dual
part ``0.5 · t_quat ⊗ real`` encoding translation ``t``.
"""

from __future__ import annotations

import torch

from dragposer_tpu_torch.ops import quat


def from_rotation_translation(q, t):
    t_quat = torch.cat((torch.zeros_like(t[..., :1]), t), dim=-1)
    return torch.cat((q, 0.5 * quat.mul(t_quat, q)), dim=-1)


def to_rotation_translation(dq):
    real = dq[..., :4]
    t_quat = 2.0 * quat.mul(dq[..., 4:], quat.inverse(real))
    return real, t_quat[..., 1:]


def unroll(dq, axis: int = 0):
    """Sign continuity along ``axis`` based on the real part."""
    dq = torch.movedim(dq, axis, 0)
    real = dq[..., :4]
    d = torch.sum(real[1:] * real[:-1], dim=-1)
    signs = torch.where(d < 0.0, -1.0, 1.0).to(dq.dtype)
    flips = torch.cat((torch.ones_like(signs[:1]), torch.cumprod(signs, dim=0)))
    return torch.movedim(dq * flips[..., None], 0, axis)
