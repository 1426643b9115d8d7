"""Motion encoding: BVH → normalized root-space dual-quaternion features
(port of ``dragposer_tpu/data/encoding.py``).

* root displacement per frame, rotated into the *current* frame's root space;
* root rotation as incremental quaternions (frame 0 = identity);
* every joint as a root-space dual quaternion (zero global translation);
* the root's 8-channel slot is ``[incremental quat (4), root-space
  displacement (3), 0]``;
* dual quaternions sign-unrolled along time;
* heights = world-y of selected joints (component index 1 — a reference
  quirk kept verbatim even on z-up data).

Host-side: the math runs in float32 torch on the CPU and returns NumPy.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from dragposer_tpu_torch.io.bvh import BVH
from dragposer_tpu_torch.ops import dual_quat, fk, quat
from dragposer_tpu_torch.ops.topology import Skeleton


def info_from_bvh(bvh: BVH):
    """BVH → (rotations (F,J,4) unit & unrolled, positions (F,J,3), parents,
    offsets, bvh), with the root parent and root offset forced to zero."""
    order_idx = quat.order_to_indices(bvh.rot_order)
    angles = torch.as_tensor(np.radians(bvh.rotations), dtype=torch.float32)
    rots = quat.from_euler(angles, torch.as_tensor(order_idx)[None])
    rots = quat.normalize(quat.unroll(rots, axis=0)).numpy()
    parents = np.asarray(bvh.parents).copy()
    parents[0] = 0
    offsets = np.asarray(bvh.offsets, dtype=np.float32).copy()
    offsets[0] = 0.0
    return rots, bvh.positions.astype(np.float32), parents, offsets, bvh


@dataclass
class EncodedMotion:
    """Per-sequence encoded features (denormalized)."""

    dqs: np.ndarray                 # (F, J*8)
    displacement: np.ndarray        # (F, 3) root-space
    global_pos: np.ndarray          # (F, 3)
    global_rot: np.ndarray          # (F, 4) world root rotation
    heights: Optional[np.ndarray]   # (F, H) or None
    offsets: np.ndarray             # (J, 3)
    displacement_acc: Optional[np.ndarray] = None   # (F, 3) or None


def encode_motion(offsets: np.ndarray, global_pos: np.ndarray,
                  rotations: np.ndarray, skeleton: Skeleton, *,
                  downsample: int = 1,
                  height_indices: Optional[Sequence[int]] = None,
                  sample_step: Optional[int] = None) -> EncodedMotion:
    if global_pos.shape[0] != rotations.shape[0]:
        raise ValueError(f"frame mismatch: {global_pos.shape[0]} positions "
                         f"vs {rotations.shape[0]} rotations")
    if downsample > 1:
        global_pos = global_pos[::downsample]
        rotations = rotations[::downsample]

    rot = torch.as_tensor(rotations, dtype=torch.float32)
    gp = torch.as_tensor(global_pos, dtype=torch.float32)
    root_rot = rot[:, 0, :]

    disp_world = torch.cat((torch.zeros(1, 3), gp[1:] - gp[:-1]), dim=0)
    displacement = quat.mul_vec(quat.inverse(root_rot), disp_world)
    incr = torch.cat((torch.tensor([[1.0, 0.0, 0.0, 0.0]]),
                      quat.mul(quat.inverse(root_rot[:-1]), root_rot[1:])))

    rs_rot, rs_pos = fk.to_root_space(rot, torch.zeros_like(gp), skeleton)
    dqs = dual_quat.from_rotation_translation(rs_rot, rs_pos)

    heights = None
    if height_indices is not None:
        dq_r, dq_t = dual_quat.to_rotation_translation(dqs)
        t_world = quat.mul_vec(dq_r[:, 0:1, :], dq_t) + gp[:, None, :]
        heights = t_world[:, list(height_indices), 1].numpy()

    dqs = dqs.clone()
    dqs[:, 0, :4] = incr
    dqs = dual_quat.unroll(dqs, axis=0)
    dqs[:, 0, 4:7] = displacement
    dqs[:, 0, 7] = 0.0

    displacement_acc = None
    if sample_step is not None:
        # accumulated displacement over the next `sample_step` frames (zero
        # near the tail, as the reference's motion_data.py:288-291)
        d = displacement.numpy()
        displacement_acc = np.zeros_like(d)
        for i in range(0, d.shape[0] - sample_step):
            displacement_acc[i] = d[i: i + sample_step].sum(axis=0)
    return EncodedMotion(
        dqs=dqs.reshape(dqs.shape[0], -1).numpy(),
        displacement=displacement.numpy(),
        global_pos=gp.numpy(),
        global_rot=root_rot.numpy(),
        heights=heights,
        offsets=np.asarray(skeleton.offsets),
        displacement_acc=displacement_acc,
    )


class RunningStats:
    """Cross-file statistics: mean of per-file means, sqrt(mean of per-file
    variances); zero-variance channels forced to std 1 (the reference's
    ``motion_data.py:125-155``)."""

    def __init__(self):
        self._means_dqs, self._vars_dqs = [], []
        self._means_disp, self._vars_disp = [], []

    def add(self, motion: EncodedMotion) -> None:
        self._means_dqs.append(motion.dqs.mean(axis=0))
        self._vars_dqs.append(motion.dqs.var(axis=0, ddof=1))
        self._means_disp.append(motion.displacement.mean(axis=0))
        self._vars_disp.append(motion.displacement.var(axis=0, ddof=1))

    def finalize(self):
        means = {
            "dqs": np.mean(self._means_dqs, axis=0).astype(np.float32),
            "displacement": np.mean(self._means_disp,
                                    axis=0).astype(np.float32),
        }
        stds = {
            "dqs": np.sqrt(np.mean(self._vars_dqs, axis=0)).astype(np.float32),
            "displacement": np.sqrt(np.mean(self._vars_disp,
                                            axis=0)).astype(np.float32),
        }
        for s in stds.values():
            s[s < 1e-10] = 1.0
        return means, stds


def normalize(motion: EncodedMotion, means: Dict[str, np.ndarray],
              stds: Dict[str, np.ndarray]) -> EncodedMotion:
    return EncodedMotion(
        dqs=(motion.dqs - means["dqs"]) / stds["dqs"],
        displacement=((motion.displacement - means["displacement"])
                      / stds["displacement"]),
        global_pos=motion.global_pos,
        global_rot=motion.global_rot,
        heights=motion.heights,
        offsets=motion.offsets,
        displacement_acc=motion.displacement_acc,
    )
