"""BVH-driven tracker playback — port of ``BVH/BVHPlayback.cs`` (the port's
numpy-only copy of ``dragposer_tpu/client/playback.py``).

Drives a :class:`TrackerRetargeter`'s trackers from a BVH animation, frame
by frame (cs:29-48): each update sets every tracker to the animation's world
pose for the current frame, then advances (wrapping).  Combined with
:class:`client.driver.ClientDragPoser` this reproduces the reference's
sparse-tracker demo: the animation moves the trackers, the engine
reconstructs the full body.
"""

from __future__ import annotations

import numpy as np

from dragposer_tpu_torch.client import math as cm
from dragposer_tpu_torch.client.retarget import TrackerRetargeter, fk_world
from dragposer_tpu_torch.data import encoding
from dragposer_tpu_torch.io.bvh import BVH


class BVHPlayback:
    def __init__(self, bvh_path: str, retargeter: TrackerRetargeter,
                 target_framerate: int = 60):
        bvh = BVH().load(bvh_path)
        rots, pos, parents, offsets, frame_time = encoding.info_from_bvh(bvh)
        self.retargeter = retargeter
        self.target_framerate = target_framerate
        # precompute world tracker poses for every frame (unity space)
        n = rots.shape[0]
        self._pos = np.zeros((n, len(parents), 3), np.float32)
        self._rot = np.zeros((n, len(parents), 4), np.float32)
        offsets = np.asarray(offsets, np.float32)
        for f in range(n):
            wp, wr = fk_world(parents, offsets, rots[f], pos[f, 0])
            self._pos[f] = cm.python_to_unity_pos(wp)
            q = cm.python_to_unity_rot(wr)
            self._rot[f] = np.concatenate([q[..., 3:4], q[..., :3]], axis=-1)
        self.n_frames = n
        self.frame = 0
        self.paused = False

    def update_trackers(self) -> int:
        """Set every tracker to the animation's current-frame world pose and
        advance (cs:29-48).  Returns the frame that was applied."""
        applied = self.frame
        for i in range(self.retargeter.n_joints):
            self.retargeter.set_tracker(i, self._pos[applied, i],
                                        self._rot[applied, i])
        self.retargeter.retarget_all()
        if not self.paused:
            self.frame = (self.frame + 1) % self.n_frames
        return applied

    def reset(self):
        self.frame = 0
