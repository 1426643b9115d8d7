"""Forward kinematics and root-space transforms (port of ``dragposer_tpu/ops/fk.py``).

The pose representation is *root-space* (each joint's rotation is already
composed from the root's child down to the joint), so:

* world rotation: ``world[j] = world_root ⊗ rootspace[j]``;
* world position: ``pos = root_pos + A @ contrib`` with the static ancestor
  matrix ``A`` and ``contrib[j] = rotate(world[parent[j]], offset[j])``;
* root-space → local: ``local[j] = inv(rootspace[parent[j]]) ⊗ rootspace[j]``.

For local-rotation inputs the world rotations are composed level by level
over the static depth schedule.  All functions broadcast over leading dims.
"""

from __future__ import annotations

import torch

from dragposer_tpu_torch.ops import quat
from dragposer_tpu_torch.ops.topology import Skeleton


def _const(a, like):
    return torch.as_tensor(a, dtype=like.dtype, device=like.device)


def _positions_from_world(world_rot, root_pos, skeleton: Skeleton):
    parents = torch.as_tensor(skeleton.parents, device=world_rot.device)
    parent_rot = world_rot.index_select(-2, parents)
    offsets = _const(skeleton.offsets, world_rot).expand(
        world_rot.shape[:-1] + (3,))
    contrib = quat.mul_vec(parent_rot, offsets)
    pos = torch.matmul(_const(skeleton.ancestors, world_rot), contrib)
    return pos + root_pos[..., None, :]


def fk_root_space(rootspace_q, root_pos, skeleton: Skeleton):
    """FK for a root-space pose whose slot 0 holds the root's world rotation.
    Returns ``(positions (...,J,3), world rotations (...,J,4))``."""
    root = rootspace_q[..., :1, :]
    world = torch.cat((root, quat.mul(root, rootspace_q[..., 1:, :])), dim=-2)
    return _positions_from_world(world, root_pos, skeleton), world


def fk_local(local_q, root_pos, skeleton: Skeleton):
    """FK for local rotations (slot 0 = root world rotation)."""
    world = local_q.clone()
    for level in skeleton.levels[1:]:
        idx = torch.as_tensor(level, device=local_q.device)
        pidx = torch.as_tensor(skeleton.parents[level], device=local_q.device)
        world[..., idx, :] = quat.mul(world.index_select(-2, pidx),
                                      local_q.index_select(-2, idx))
    return _positions_from_world(world, root_pos, skeleton), world


def from_root_quat(rootspace_q, skeleton: Skeleton):
    """Root-space quats → parent-local quats (slot 0 passed through)."""
    parents = torch.as_tensor(skeleton.parents, device=rootspace_q.device)
    parent_q = rootspace_q.index_select(-2, parents)
    local = quat.mul(quat.inverse(parent_q), rootspace_q)
    keep = torch.as_tensor(skeleton.parents == 0,
                           device=rootspace_q.device)[..., None]
    return torch.where(keep, rootspace_q, local)


def to_root_space(local_q, root_pos, skeleton: Skeleton):
    """Local rotations → root-space rotations and root-frame positions.

    The accumulation starts from identity at the root; slot 0 of the
    returned rotations is ``local_q[..., 0, :]`` and slot 0 of positions is
    ``root_pos``."""
    rs = local_q.clone()
    rs[..., 0, :] = _const([1.0, 0.0, 0.0, 0.0], local_q)
    for level in skeleton.levels[2:]:
        idx = torch.as_tensor(level, device=local_q.device)
        pidx = torch.as_tensor(skeleton.parents[level], device=local_q.device)
        rs[..., idx, :] = quat.mul(rs.index_select(-2, pidx),
                                   local_q.index_select(-2, idx))
    pos = _positions_from_world(rs, root_pos, skeleton)
    rs[..., 0, :] = local_q[..., 0, :]
    return rs, pos
