"""The interactive client driver — port of ``Core/DragPoser.cs`` (and of
``dragposer_tpu/client/driver.py``, on this package's realtime session).

Owns the engine session (the in-process :class:`RealtimeSession`, same
surface as the reference's DLL — ``DragPoserDLL.cs``), a
:class:`TrackerRetargeter`, and a client-side skeleton, and runs the
reference client's per-frame pipeline (``DragPoser.cs:139-148``):

    check/update buffers → fill EE targets → DragPose() → smooth pose →
    damped root adjustment → push global position

Public knobs mirror the C# inspector fields: ``rotation_smooth``,
``do_adjustment``, ``adjustment_joint``, ``adjustment_halflife``, ``mask``,
``weights``, and the optimizer parameters.  ``FBIK.cs``'s live mask/weight
editing is just mutating ``mask``/``weights`` between frames — the engine's
dense-mask design makes that recompile-free.

World space here follows the Unity client (left-handed, y-up, wxyz storage);
all engine I/O converts via ``client.math`` exactly where the C# does.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

from dragposer_tpu_torch.client import math as cm
from dragposer_tpu_torch.client.retarget import TrackerRetargeter, fk_world
from dragposer_tpu_torch.data import encoding
from dragposer_tpu_torch.io.bvh import BVH
from dragposer_tpu_torch.runtime.realtime import RealtimeSession


def _to_unity_wxyz(q_py: np.ndarray) -> np.ndarray:
    q = cm.python_to_unity_rot(q_py)
    return np.concatenate([q[..., 3:4], q[..., :3]], axis=-1)


def _to_python_wxyz(q_unity_wxyz: np.ndarray) -> np.ndarray:
    xyzw = np.concatenate([q_unity_wxyz[..., 1:], q_unity_wxyz[..., :1]],
                          axis=-1)
    return cm.unity_to_python_rot(xyzw)


class ClientDragPoser:
    """Reference client behavior on top of the realtime engine."""

    def __init__(self, reference_skeleton_bvh: str, models_path: str,
                 *, rotation_smooth: float = 10.0,
                 do_adjustment: bool = True,
                 adjustment_joint: int = 0,
                 adjustment_halflife: float = 0.1,
                 stop_eps_pos: float = 1e-4, stop_eps_rot: float = 1e-2,
                 max_iter: int = 10, learning_rate: float = 1e-2,
                 lambda_rot: float = 1.0, lambda_temporal: float = 0.02,
                 temporal_future_window: int = 60,
                 mask: Optional[np.ndarray] = None,
                 weights: Optional[np.ndarray] = None,
                 session: Optional[RealtimeSession] = None,
                 log_path: Optional[str] = None, device=None):
        self.rotation_smooth = rotation_smooth
        self.do_adjustment = do_adjustment
        self.adjustment_joint = adjustment_joint
        self.adjustment_halflife = adjustment_halflife
        self.stop_eps_pos, self.stop_eps_rot = stop_eps_pos, stop_eps_rot
        self.max_iter, self.learning_rate = max_iter, learning_rate
        self.lambda_rot, self.lambda_temporal = lambda_rot, lambda_temporal
        self.temporal_future_window = temporal_future_window

        # --- Awake (DragPoser.cs:63-103)
        self.session = session or RealtimeSession(log_path=log_path,
                                                  device=device)
        j = self.session.set_reference_skeleton(reference_skeleton_bvh)
        self.n_joints = j
        self.session.load_models(models_path)

        # default 6-tracker mask/weights (FBIK.cs:124-141)
        if mask is None:
            mask = np.zeros(j, np.float32)
            mask[[0, 3, 7, 13, 17, 21]] = 1.0
        if weights is None:
            weights = np.ones((j, 2), np.float32)
            weights[0, 0] = 10.0
            weights[[3, 7, 13, 17, 21], 0] = 5.0
        self.mask = np.asarray(mask, np.float32)
        self.weights = np.asarray(weights, np.float32)
        self._n_ee = self.session.set_mask_and_weights(self.mask, self.weights)
        self._push_params()

        # retargeter + client skeleton state (tpose = reference skeleton)
        self.retargeter = TrackerRetargeter(reference_skeleton_bvh)
        self.parents = self.retargeter.parents
        # the client skeleton lives in the Unity-convention frame: bone
        # offsets convert like positions (BVHImporter does this on import)
        self.offsets = cm.python_to_unity_pos(self.retargeter.offsets)

        # SkeletonTransforms: local rotations (unity wxyz) + root position.
        # The C# creates the skeleton at the T-pose's WORLD rotations
        # (cs:89-102); parent-local rotations follow from the chain.
        bvh = BVH().load(reference_skeleton_bvh)
        rots, pos0, _, _, _ = encoding.info_from_bvh(bvh)
        _, w_rot_py = fk_world(self.parents, self.offsets, rots[0],
                               pos0[0, 0])
        tpose_world = _to_unity_wxyz(w_rot_py)
        self.local_rotations = np.tile(
            np.asarray([1.0, 0, 0, 0], np.float32), (j, 1))
        for i in range(j):
            p = self.parents[i]
            if i == 0:
                self.local_rotations[i] = tpose_world[i]
            else:
                self.local_rotations[i] = cm.quat_mul(
                    cm.quat_inverse(tpose_world[p]), tpose_world[i])
        self.root_position = np.zeros(3, np.float32)
        self.target_rotations = self.local_rotations.copy()
        self._prev_ee_rotations = np.tile(
            np.asarray([1.0, 0, 0, 0], np.float32), (j, 1))
        self._initialized = False
        self.last_frame_ms = 0.0

    # ------------------------------------------------------------------
    def _push_params(self):
        self.session.set_optim_params(self.stop_eps_pos, self.stop_eps_rot,
                                      self.max_iter, self.learning_rate)
        self.session.set_lambdas(self.lambda_rot, self.lambda_temporal,
                                 self.temporal_future_window)

    # ------------------------------------------------------------------
    def initialize_pose(self):
        """AfterRetargetTrackers (DragPoser.cs:126-137): seed the engine from
        the retargeted hips tracker."""
        self.retargeter.retarget_all()
        ret_pos, ret_rot = self.retargeter.get_retarget(0)
        root_py = cm.unity_to_python_pos(ret_pos)
        self.root_position = ret_pos.astype(np.float32).copy()
        self.session.init_drag_pose(root_py.reshape(1, 3),
                                    _to_python_wxyz(ret_rot).reshape(1, 4))
        self._initialized = True

    # ------------------------------------------------------------------
    def _check_and_update_buffers(self):
        """CheckAndUpdateBuffers (cs:150-173): binarize the mask at 0.1 and
        push mask/weights/params every frame (live editing support)."""
        self.mask = np.where(self.mask > 0.1, 1.0, 0.0).astype(np.float32)
        self._n_ee = self.session.set_mask_and_weights(self.mask, self.weights)
        self._push_params()

    def _fill_buffers(self):
        """FillBuffers (cs:175-195): root-relative positions + hemisphere-
        continuous rotations for the active end effectors, engine space."""
        idx = np.nonzero(self.mask > 0.1)[0]
        tpos = np.zeros((len(idx), 3), np.float32)
        trot = np.zeros((len(idx), 4), np.float32)
        for n, i in enumerate(idx):
            ret_pos, ret_rot = self.retargeter.get_retarget(int(i))
            tpos[n] = cm.unity_to_python_pos(ret_pos - self.root_position)
            rot = _to_python_wxyz(ret_rot)
            rot = cm.ensure_continuity(self._prev_ee_rotations[i], rot)
            self._prev_ee_rotations[i] = rot
            trot[n] = rot
        return tpos, trot

    def _update_pose(self, out_pose, out_global_pos, dt):
        """UpdatePose (cs:213-231): convert, hemisphere-fix against the
        CURRENT rotation, slerp-smooth, set root."""
        for i in range(self.n_joints):
            rot = _to_unity_wxyz(out_pose[i])
            rot = cm.ensure_continuity(self.local_rotations[i], rot)
            self.target_rotations[i] = rot
        self.local_rotations = cm.smooth_rotations(
            self.local_rotations, self.target_rotations, dt,
            self.rotation_smooth)
        self.root_position = cm.python_to_unity_pos(
            out_global_pos[0]).astype(np.float32)

    def _adjust_joint(self, dt):
        """AdjustJoint (cs:202-211): damped root pull toward the adjustment
        tracker."""
        ret_pos, _ = self.retargeter.get_retarget(self.adjustment_joint)
        pos, _ = self.world_pose()
        self.root_position = cm.adjust_root(
            self.root_position, pos[self.adjustment_joint], ret_pos,
            self.adjustment_halflife, dt)

    # ------------------------------------------------------------------
    def step(self, dt: float = 1.0 / 60.0):
        """OnDragPoser (cs:139-148) — one client frame."""
        if not self._initialized:
            raise RuntimeError("call initialize_pose() first")
        t0 = time.time()
        self.retargeter.retarget_all()
        self._check_and_update_buffers()
        tpos, trot = self._fill_buffers()
        out_pose = np.zeros((self.n_joints, 4), np.float32)
        out_gp = np.zeros((1, 3), np.float32)
        self.session.drag_pose(tpos, trot, out_pose, out_gp)
        self._update_pose(out_pose, out_gp, dt)
        if self.do_adjustment:
            self._adjust_joint(dt)
        self.session.set_global_pos(
            cm.unity_to_python_pos(self.root_position).reshape(1, 3))
        self.last_frame_ms = (time.time() - t0) * 1e3

    # ------------------------------------------------------------------
    def world_pose(self):
        """Current smoothed client skeleton in world space."""
        return fk_world(self.parents, self.offsets, self.local_rotations,
                        self.root_position)
