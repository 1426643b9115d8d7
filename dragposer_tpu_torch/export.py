"""Result export: normalized pose streams → BVH (port of
``dragposer_tpu/export.py``).

Denormalize the quaternion channels, optionally integrate incremental root
rotations and displacements with a drift reset to ground truth every
``correct_drift_frames`` frames (the VAE's evaluation), convert root-space
→ local, and write Euler degrees back into a copy of the source BVH.  The
drag evaluation passes absolute root rotations
(``are_root_rot_incr=False``) and ``global_pos``.  Host-side (CPU torch).
"""

from __future__ import annotations

import copy
from typing import Dict, Optional

import numpy as np
import torch

from dragposer_tpu_torch.io.bvh import BVH
from dragposer_tpu_torch.ops import fk, quat
from dragposer_tpu_torch.ops.topology import Skeleton


def result_to_bvh(poses: np.ndarray, means: Dict[str, np.ndarray],
                  stds: Dict[str, np.ndarray], bvh: BVH, skeleton: Skeleton,
                  *, global_pos: Optional[np.ndarray] = None,
                  displacement: Optional[np.ndarray] = None,
                  are_root_rot_incr: bool = True,
                  correct_drift_frames: int = 64,
                  gt_rotations: Optional[np.ndarray] = None) -> BVH:
    """``poses`` (F, J*4) normalized quat channels.  Their root slot is the
    per-frame increment of the root rotation, integrated from
    ``gt_rotations`` (F, 4) at the start of every block of
    ``correct_drift_frames`` frames, or with ``are_root_rot_incr=False``
    the world root rotation.  Root positions: ``global_pos`` (F, 3) world
    positions, or ``displacement`` (F, 3) normalized root-space steps
    summed per block from the source's position at the block start, or the
    source's."""
    frames = poses.shape[0]
    mean_q = means["dqs"].reshape(-1, 8)[:, :4].reshape(-1)
    std_q = stds["dqs"].reshape(-1, 8)[:, :4].reshape(-1)
    qs = (poses * std_q + mean_q).reshape(frames, -1, 4).astype(np.float32)
    if are_root_rot_incr:
        assert gt_rotations is not None, "drift reset needs GT root rotations"
        qs[:, 0] = _integrate_blocks(qs[:, 0], gt_rotations,
                                     correct_drift_frames)
    local = fk.from_root_quat(torch.as_tensor(qs), skeleton)
    order_idx = quat.order_to_indices(bvh.rot_order)
    rotations = np.degrees(
        quat.to_euler(local, torch.as_tensor(order_idx)[None]).numpy())
    out = copy.deepcopy(bvh)
    out.rotations = rotations
    positions = bvh.positions[:frames].copy()
    if global_pos is not None:
        positions[:, 0, :] = global_pos
    elif displacement is not None:
        disp = (displacement * stds["displacement"]
                + means["displacement"]).astype(np.float32)
        world = quat.mul_vec(local[:, 0], torch.as_tensor(disp)).numpy()
        for start in range(0, frames, correct_drift_frames):
            end = min(start + correct_drift_frames, frames)
            positions[start + 1:end, 0] = positions[start, 0] + np.cumsum(
                world[start + 1:end], axis=0)
    out.positions = positions
    return out


def _integrate_blocks(incr: np.ndarray, gt: np.ndarray,
                      block: int) -> np.ndarray:
    """Per block of ``block`` frames, the prefix quaternion products of the
    increments, the first frame's replaced by the ground truth."""
    frames = incr.shape[0]
    n_blocks = -(-frames // block)
    acc = torch.tensor([1.0, 0.0, 0.0, 0.0]).repeat(n_blocks * block, 1)
    acc[:frames] = torch.as_tensor(incr, dtype=torch.float32)
    acc[::block] = torch.as_tensor(np.asarray(gt)[::block][:n_blocks],
                                   dtype=torch.float32)
    acc = acc.reshape(n_blocks, block, 4)
    for i in range(1, block):
        acc[:, i] = quat.mul(acc[:, i - 1], acc[:, i])
    return acc.reshape(-1, 4)[:frames].numpy()
