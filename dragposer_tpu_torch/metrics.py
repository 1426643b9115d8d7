"""MPJPE / MPEEPE and jitter (port of ``dragposer_tpu/metrics.py``).

For MPJPE / MPEEPE both sequences are FK-ed with the root translation
zeroed (root rotation kept), so only the pose is measured.  MPJPE averages
the per-joint L2 error over all joints and frames; MPEEPE over the sparse
end effectors, root excluded.  Jitter is measured on world positions.
Host-side (CPU torch).
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


def jitter(bvh: BVH, *, downsample: int = 1) -> float:
    """Mean third-derivative magnitude of the world joint positions, m/s³:
    the mean over joints and frames of ‖x(t+1) − 3x(t) + 3x(t−1) − x(t−2)‖
    · fps³, root translation included (the smoothness of the delivered
    motion)."""
    rots, pos, parents, offsets, _ = encoding.info_from_bvh(bvh)
    rots, pos = rots[::downsample], pos[::downsample]
    sk = Skeleton.build(parents, offsets)
    p, _ = fk.fk_local(torch.as_tensor(rots), torch.as_tensor(pos[:, 0, :]),
                       sk)
    p = p.numpy()
    fps = 1.0 / (float(bvh.frame_time) * downsample)
    d3 = (p[3:] - 3.0 * p[2:-1] + 3.0 * p[1:-2] - p[:-3]) * fps ** 3
    return float(np.linalg.norm(d3, axis=-1).mean())
