"""MPJPE / MPEEPE (port of ``dragposer_tpu/metrics.positional_error``).

Both sequences are FK-ed with the root translation zeroed (root rotation
kept), so only the pose is measured.  MPJPE averages the per-joint L2 error
over all joints and frames; MPEEPE over the sparse end effectors, root
excluded.  Host-side (CPU torch).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from dragposer_tpu_torch.data import encoding
from dragposer_tpu_torch.io.bvh import BVH
from dragposer_tpu_torch.ops import fk
from dragposer_tpu_torch.ops.topology import Skeleton

SPARSE_JOINTS = (0, 4, 8, 13, 17, 21)


def _positions(bvh: BVH, downsample: int = 1) -> np.ndarray:
    rots, _, parents, offsets, _ = encoding.info_from_bvh(bvh)
    rots = rots[::downsample]
    sk = Skeleton.build(parents, offsets)
    pos, _ = fk.fk_local(torch.as_tensor(rots),
                         torch.zeros(rots.shape[0], 3), sk)
    return pos.numpy()


def positional_error(gt_bvh: BVH, eval_bvh: BVH, *, downsample_gt: int = 1,
                     sparse_joints: Sequence[int] = SPARSE_JOINTS
                     ) -> Tuple[float, float]:
    """Returns (MPJPE, MPEEPE) in skeleton units (meters)."""
    gt_pos = _positions(gt_bvh, downsample_gt)
    pos = _positions(eval_bvh)
    n = min(pos.shape[0], gt_pos.shape[0])
    err = np.linalg.norm(pos[:n] - gt_pos[:n], axis=-1)
    return float(err.mean()), float(err[:, list(sparse_joints)[1:]].mean())
