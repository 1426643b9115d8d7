"""T-pose tracker retargeting — port of ``Core/TrackerRetargeter.cs``
(a copy of ``dragposer_tpu/client/retarget.py`` on this package's BVH reader
and encoding).

The reference calibrates against a T-pose BVH: a *root align* rotation maps
the BVH character's facing onto the app's canonical forward/up, and per-joint
alignments re-express a tracker's live orientation in the character's frame:

    retPos = RootAlign · (pos − rootPos) + rootPos        (cs:87-89)
    retRot = RootAlign · (TargetTPoseᵢ⁻¹ · rot) · (RootAlign⁻¹ · SourceTPoseᵢ)
                                                           (cs:90-92)

All rotations here are wxyz numpy arrays in the client's (Unity-convention,
left-handed y-up) world space; use ``client.math.python_to_unity_*`` /
``unity_to_python_*`` at the engine boundary.  Trackers are indexed by
python skeleton joint index (0..J-1) — the C# indirection through
``HumanBodyBones`` collapses because the tracker skeleton IS the reference
skeleton here.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from dragposer_tpu_torch.client import math as cm
from dragposer_tpu_torch.data import encoding
from dragposer_tpu_torch.io.bvh import BVH


def fk_world(parents: np.ndarray, offsets: np.ndarray, local_rots: np.ndarray,
             root_pos: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """NumPy forward kinematics: parent-local wxyz rotations → world
    positions/rotations.  (Client-side; the engine's FK is ``ops/fk.py``.)"""
    j = len(parents)
    pos = np.zeros((j, 3), np.float32)
    rot = np.zeros((j, 4), np.float32)
    pos[0] = root_pos
    rot[0] = local_rots[0]
    for i in range(1, j):
        p = parents[i]
        rot[i] = cm.quat_mul(rot[p], local_rots[i])
        pos[i] = pos[p] + cm.quat_mul_vec(rot[p], offsets[i])
    return pos, rot


def _to_unity_rot_wxyz(q_py: np.ndarray) -> np.ndarray:
    """BVH right-handed wxyz → Unity left-handed, kept in wxyz storage."""
    q = cm.python_to_unity_rot(q_py)            # xyzw
    return np.concatenate([q[..., 3:4], q[..., :3]], axis=-1)


class TrackerRetargeter:
    """Calibrated tracker → character-space retargeting.

    Mirrors ``TrackerRetargeter.cs``: ``Calibrate`` (cs:170-186) at
    construction; move trackers with :meth:`set_tracker`; read
    character-space targets with :meth:`retarget` (cs:77-96).
    """

    def __init__(self, tpose_bvh_path: str,
                 bvh_forward_local=(0.0, 0.0, 1.0),
                 bvh_up_local=(0.0, 1.0, 0.0),
                 reset_orientation: bool = False):
        bvh = BVH().load(tpose_bvh_path)
        rots, pos, parents, offsets, _ = encoding.info_from_bvh(bvh)
        self.parents = parents
        self.offsets = np.asarray(offsets, np.float32)
        self.names = list(bvh.names)
        j = len(parents)

        # frame-0 world pose in BVH space, then into the client frame
        w_pos_py, w_rot_py = fk_world(parents, self.offsets, rots[0],
                                      pos[0, 0])
        w_pos = cm.python_to_unity_pos(w_pos_py)
        w_rot = _to_unity_rot_wxyz(w_rot_py)

        # Root align (cs:98-109): map the BVH hips' facing onto canonical
        # forward/up.  target LookRotation(forward, up) == identity.
        fwd = cm.quat_mul_vec(w_rot[0], np.asarray(bvh_forward_local, np.float32))
        up = cm.quat_mul_vec(w_rot[0], np.asarray(bvh_up_local, np.float32))
        self.root_align = cm.look_rotation(fwd, up)
        self.inv_root_align = cm.quat_inverse(self.root_align)

        # Create trackers at the aligned T-pose (cs:112-131)
        self.tracker_pos = cm.quat_mul_vec(self.root_align[None], w_pos)
        if reset_orientation:
            self.tracker_rot = np.tile(
                np.asarray([1.0, 0, 0, 0], np.float32), (j, 1))
        else:
            self.tracker_rot = cm.quat_mul(self.root_align[None], w_rot)

        # Joint alignments (cs:151-168)
        self.inverse_target_tpose = cm.quat_inverse(self.tracker_rot)
        self.source_tpose = w_rot.copy()

        self._ret_pos = self.tracker_pos.copy()
        self._ret_rot = self.source_tpose.copy()
        self.retarget_all()

    @property
    def n_joints(self) -> int:
        return len(self.parents)

    def set_tracker(self, joint: int, pos: np.ndarray, rot_wxyz: np.ndarray):
        """Move a tracker (the app's analogue of dragging a Transform)."""
        self.tracker_pos[joint] = np.asarray(pos, np.float32)
        self.tracker_rot[joint] = np.asarray(rot_wxyz, np.float32)

    def retarget_all(self) -> None:
        """Recompute all retargeted targets (cs:77-96, OnRetargetTrackers)."""
        root_pos = self.tracker_pos[0]
        self._ret_pos = cm.quat_mul_vec(
            self.root_align[None], self.tracker_pos - root_pos) + root_pos
        lhs = cm.quat_mul(self.inverse_target_tpose, self.tracker_rot)
        rhs = cm.quat_mul(self.inv_root_align[None], self.source_tpose)
        self._ret_rot = cm.quat_mul(self.root_align[None],
                                    cm.quat_mul(lhs, rhs))

    def get_retarget(self, joint: int) -> Tuple[np.ndarray, np.ndarray]:
        """(cs:72-76) — call :meth:`retarget_all` after moving trackers."""
        return self._ret_pos[joint], self._ret_rot[joint]
