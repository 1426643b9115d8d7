"""Forward kinematics and root-space transforms (port of ``dragposer_tpu/ops/fk.py``).

The pose representation is *root-space* (each joint's rotation is already
composed from the root's child down to the joint), so:

* world rotation: ``world[j] = world_root ⊗ rootspace[j]``;
* world position: ``pos = root_pos + A @ contrib`` with the static ancestor
  matrix ``A`` and ``contrib[j] = rotate(world[parent[j]], offset[j])``;
* root-space → local: ``local[j] = inv(rootspace[parent[j]]) ⊗ rootspace[j]``.

For local-rotation inputs the world rotations are composed level by level
over the static depth schedule.  All functions broadcast over leading dims.
The skeleton's constants (the one-hot parent matrix, the offsets, ``A``)
are device tensors built once per skeleton, dtype and device and kept
with the skeleton (:func:`_skeleton_tensors`): FK copies nothing from the
host per call, so the anchor's iteration can be captured as a CUDA graph.
"""

from __future__ import annotations

import numpy as np
import torch

from dragposer_tpu_torch.ops import quat
from dragposer_tpu_torch.ops.topology import Skeleton


def _const(a, like):
    return torch.as_tensor(a, dtype=like.dtype, device=like.device)


def _skeleton_tensors(skeleton: Skeleton, like):
    """The one-hot parent matrix (J, J), the offsets (J, 3) and the
    ancestor matrix (J, J) of ``skeleton`` as tensors of ``like``'s dtype
    on its device, uploaded once and kept with the skeleton."""
    key = (like.device, like.dtype)
    got = skeleton.tensors.get(key)
    if got is None:
        onehot = np.eye(skeleton.n_joints, dtype=np.float32)[
            np.asarray(skeleton.parents)]
        got = skeleton.tensors[key] = tuple(
            _const(a, like) for a in (onehot, skeleton.offsets,
                                      skeleton.ancestors))
    return got


def _parent_rows(x, skeleton: Skeleton):
    """``x[..., parents[j], :]`` for every joint j, as the product of the
    one-hot parent matrix with ``x``.  The backward of ``index_select``
    sums the gradients of joints that share a parent with atomics on the
    card, in an order that changes from run to run, and a realtime
    session's frames then drift apart past 1e-5 within tens of frames; a
    product's backward sums them in a fixed order.  The forward is exact:
    one term of each sum is nonzero."""
    return torch.matmul(_skeleton_tensors(skeleton, x)[0], x)


def _positions_from_world(world_rot, root_pos, skeleton: Skeleton):
    _, offsets, ancestors = _skeleton_tensors(skeleton, world_rot)
    parent_rot = _parent_rows(world_rot, skeleton)
    contrib = quat.mul_vec(parent_rot,
                           offsets.expand(world_rot.shape[:-1] + (3,)))
    pos = torch.matmul(ancestors, contrib)
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
