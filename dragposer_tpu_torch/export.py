"""Result export: normalized pose streams → BVH (port of
``dragposer_tpu/export.py``, the absolute-root path the batched evaluation
uses: ``global_pos`` given, ``are_root_rot_incr=False``).

Denormalize the quaternion channels, convert root-space → local, write
Euler degrees back into a copy of the source BVH.  Host-side (CPU torch).
"""

from __future__ import annotations

import copy
from typing import Dict

import numpy as np
import torch

from dragposer_tpu_torch.io.bvh import BVH
from dragposer_tpu_torch.ops import fk, quat
from dragposer_tpu_torch.ops.topology import Skeleton


def result_to_bvh(poses: np.ndarray, means: Dict[str, np.ndarray],
                  stds: Dict[str, np.ndarray], bvh: BVH, skeleton: Skeleton,
                  *, global_pos: np.ndarray) -> BVH:
    """``poses`` (F, J*4) normalized quat channels whose root slot is the
    world root rotation; ``global_pos`` (F, 3) world root positions."""
    frames = poses.shape[0]
    mean_q = means["dqs"].reshape(-1, 8)[:, :4].reshape(-1)
    std_q = stds["dqs"].reshape(-1, 8)[:, :4].reshape(-1)
    qs = (poses * std_q + mean_q).reshape(frames, -1, 4).astype(np.float32)
    local = fk.from_root_quat(torch.as_tensor(qs), skeleton)
    order_idx = quat.order_to_indices(bvh.rot_order)
    rotations = np.degrees(
        quat.to_euler(local, torch.as_tensor(order_idx)[None]).numpy())
    out = copy.deepcopy(bvh)
    out.rotations = rotations
    positions = bvh.positions[:frames].copy()
    positions[:, 0, :] = global_pos
    out.positions = positions
    return out
