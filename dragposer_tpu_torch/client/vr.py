"""VR device plumbing — hardware-agnostic port of the reference's SteamVR
layer (SURVEY §2.3 "VR device plumbing", ~1.5k LoC of C#); the port's
numpy-only copy of ``dragposer_tpu/client/vr.py``.

What is ported (the actual capability — every formula and state transition):

* ``VRController.cs`` — device detection/classification by tracked-device
  render-model name + tracking status (``DetectDevices``, :244-316), device
  index assignment (``SetDevicesIndex``, :319-370), least-squares plane-fit
  **role identification** — which physical tracker is the waist vs the feet,
  which controller is left vs right — from a T-pose stance
  (``IdentifyDevices``/``FitPlane``, :373-541, :567-610), walk-in-avatar
  T-pose **joint-offset calibration** (``SetupJoints``, :177-225), and the
  trigger-driven setup state machine with its 0.5 s cooldown
  (``Update``, :130-175).
* ``Applications/VRIK.cs`` — the six-role rig: per-device child-offset
  calibration (:172-206), per-frame end-effector targets and live
  per-device dropout toggles written into the drag mask/weights (:64-113).
* ``Utils/DisplayMirror.cs`` — the timed status-message display the setup
  flow talks through (:79-160).  (``TextToTexture.cs`` only rasterizes the
  text onto a texture; the display here is headless and keeps a history.)

The only thing *not* ported is the OpenVR binding itself: device poses enter
through the :class:`DeviceProvider` protocol.  :class:`ScriptedDeviceProvider`
stands in for SteamVR in tests, and :class:`BVHDeviceProvider` synthesizes a
full 6-device rig (HMD + 2 controllers + 3 trackers, each mounted at an
offset from its body joint) from a BVH clip, so the complete VR path —
detect → identify → calibrate → per-frame VRIK targets → drag engine — runs
end to end with no hardware.

Conventions: Unity-frame (left-handed, y-up) positions and **wxyz**
quaternions throughout, matching ``client.retarget``; ``client.math``
converts at the engine boundary.  Unity's ``transform.forward`` is the
rotated +z axis.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from dragposer_tpu_torch.client import math as cm

# ---------------------------------------------------------------------------
# Roles and their skeleton joints (VRIK.cs:101-106 — ankle indices 3/7, not
# the toe indices the offline eval configs use)
# ---------------------------------------------------------------------------

ROLE_HMD = "hmd"
ROLE_CONTROLLER_LEFT = "controller_left"
ROLE_CONTROLLER_RIGHT = "controller_right"
ROLE_TRACKER_ROOT = "tracker_root"
ROLE_TRACKER_LEFT = "tracker_left"
ROLE_TRACKER_RIGHT = "tracker_right"

SIX_ROLES = (ROLE_TRACKER_ROOT, ROLE_TRACKER_LEFT, ROLE_TRACKER_RIGHT,
             ROLE_HMD, ROLE_CONTROLLER_LEFT, ROLE_CONTROLLER_RIGHT)

ROLE_JOINT = {
    ROLE_TRACKER_ROOT: 0,      # hips
    ROLE_TRACKER_LEFT: 3,      # left ankle ("LeftFoot")
    ROLE_TRACKER_RIGHT: 7,     # right ankle ("RightFoot")
    ROLE_HMD: 13,              # head
    ROLE_CONTROLLER_LEFT: 17,  # left wrist
    ROLE_CONTROLLER_RIGHT: 21,  # right wrist
}

# VRIK.cs:107-112 — hips position weight 10, everything else 5
ROLE_POS_WEIGHT = {ROLE_TRACKER_ROOT: 10.0, ROLE_TRACKER_LEFT: 5.0,
                   ROLE_TRACKER_RIGHT: 5.0, ROLE_HMD: 5.0,
                   ROLE_CONTROLLER_LEFT: 5.0, ROLE_CONTROLLER_RIGHT: 5.0}

HEAD_COSINE_DEVIATION_THRESHOLD = 0.5   # VRController.cs:12
MAX_HEAD_TO_WAIST_DISTANCE = 0.8        # VRController.cs:13
SETUP_COOLDOWN_S = 0.5                  # VRController.cs:132
CONTROLLER_HAND_OFFSET = np.array([0.0, 0.0, -0.175], np.float32)  # :199,210


# ---------------------------------------------------------------------------
# Device records and providers
# ---------------------------------------------------------------------------

@dataclass
class TrackedDevice:
    """One row of the runtime's tracked-device table (what
    ``GetDeviceToAbsoluteTrackingPose`` + ``Prop_RenderModelName_String``
    yield per device, ``VRController.cs:251-291``)."""
    index: int
    render_model: str          # e.g. "generic_hmd", "vive_controller", "tracker_vive_..."
    tracking_ok: bool          # eTrackingResult == Running_OK
    position: np.ndarray       # (3,) world, unity frame
    rotation: np.ndarray       # (4,) wxyz, unity frame

    def forward(self) -> np.ndarray:
        """transform.forward — the rotated +z axis."""
        return cm.quat_mul_vec(self.rotation, np.array([0.0, 0.0, 1.0],
                                                       np.float32))


class DeviceProvider:
    """The hardware boundary — everything SteamVR supplied to the reference.

    ``poll()`` returns the current tracked-device table; ``trigger_down()``
    is SteamVR's GrabPinch action edge (``VRController.cs:544-549``)."""

    def poll(self) -> List[TrackedDevice]:  # pragma: no cover - interface
        raise NotImplementedError

    def trigger_down(self) -> bool:  # pragma: no cover - interface
        raise NotImplementedError


def classify_device(dev: TrackedDevice) -> Optional[str]:
    """Render-model-name classification (``VRController.cs:274-291``; the
    reference deliberately matches name substrings because the device-class
    enum "sometimes returns the wrong class", :260-265)."""
    if not dev.tracking_ok:
        return None
    name = dev.render_model
    if "hmd" in name:
        return "hmd"
    if "controller" in name:
        return "controller"
    if "tracker_vive" in name:
        return "tracker"
    return None


@dataclass
class DetectResult:
    """Outcome of a detection pass (``DetectDevices``)."""
    ok: bool
    num_controllers: int
    num_trackers: int
    hmd_index: Optional[int]
    controller_indices: List[int]
    tracker_indices: List[int]
    message: str


def detect_devices(devices: Sequence[TrackedDevice]) -> DetectResult:
    """Count and classify connected devices (``VRController.cs:244-316``).

    Requires ≥2 controllers and ≥3 trackers, like the reference (:295,312).
    Tracker/controller indices are recorded in table order — role assignment
    is provisional until :func:`identify_devices` fixes it from the T-pose.
    """
    hmd_index: Optional[int] = None
    controllers: List[int] = []
    trackers: List[int] = []
    for dev in devices:
        kind = classify_device(dev)
        if kind == "hmd" and hmd_index is None:
            hmd_index = dev.index
        elif kind == "controller":
            controllers.append(dev.index)
        elif kind == "tracker":
            trackers.append(dev.index)
    ok = len(controllers) >= 2 and len(trackers) >= 3
    message = (f"Found {len(controllers)} controller(s) and "
               f"{len(trackers)} tracker(s).")
    if not ok:
        message += " Please, connect more controllers and/or trackers."
    return DetectResult(ok, len(controllers), len(trackers), hmd_index,
                        controllers, trackers, message)


def assign_device_indices(det: DetectResult) -> Dict[str, int]:
    """Provisional role→device-index map (``SetDevicesIndex``,
    ``VRController.cs:319-370``): trackers by discovery order — root gets
    TrackerIndices[0], *right* gets [1], *left* gets [2] (:342,352,362);
    controllers keep their runtime-assigned left/right slots, modelled here
    as discovery order."""
    roles: Dict[str, int] = {}
    if det.hmd_index is not None:
        roles[ROLE_HMD] = det.hmd_index
    if det.num_controllers >= 1:
        roles[ROLE_CONTROLLER_LEFT] = det.controller_indices[0]
    if det.num_controllers >= 2:
        roles[ROLE_CONTROLLER_RIGHT] = det.controller_indices[1]
    if det.num_trackers >= 1:
        roles[ROLE_TRACKER_ROOT] = det.tracker_indices[0]
    if det.num_trackers >= 2:
        roles[ROLE_TRACKER_RIGHT] = det.tracker_indices[1]
    if det.num_trackers >= 3:
        roles[ROLE_TRACKER_LEFT] = det.tracker_indices[2]
    return roles


# ---------------------------------------------------------------------------
# Plane fit + role identification
# ---------------------------------------------------------------------------

def fit_plane(points: np.ndarray) -> Optional[Tuple[float, float, float,
                                                    float]]:
    """Least-squares plane ``z = a·x + b·y + (−d)`` through ≥3 points,
    returned as (a, b, c=−1, d) — the exact normal-equations solve of
    ``VRController.FitPlane`` (:567-610).  None when degenerate."""
    points = np.asarray(points, np.float64)
    if len(points) < 3:
        return None
    diff = points - points.mean(axis=0)
    xx = float((diff[:, 0] * diff[:, 0]).sum())
    xy = float((diff[:, 0] * diff[:, 1]).sum())
    xz = float((diff[:, 0] * diff[:, 2]).sum())
    yy = float((diff[:, 1] * diff[:, 1]).sum())
    yz = float((diff[:, 1] * diff[:, 2]).sum())
    det = xx * yy - xy * xy
    if det == 0.0:
        return None
    mean = points.mean(axis=0)
    a = (yy * xz - xy * yz) / det
    b = (xx * yz - xy * xz) / det
    c = -1.0
    d = -a * mean[0] - b * mean[1] + mean[2]
    return (a, b, c, d)


class IdentifyError(ValueError):
    """Identification failed; ``.message`` is the user-facing text the
    reference shows on the mirror."""

    def __init__(self, message: str):
        super().__init__(message)
        self.message = message


def identify_devices(
    roles: Dict[str, int],
    poses: Dict[int, Tuple[np.ndarray, np.ndarray]],
    up: np.ndarray = np.array([0.0, 1.0, 0.0], np.float32),
) -> Dict[str, int]:
    """T-pose plane-fit role identification (``IdentifyDevices``,
    ``VRController.cs:373-541``).

    Given the provisional role map and each device's (position, rotation),
    fit a plane to all device positions, orient its normal by the HMD's
    forward, project the devices onto the plane, and read roles off the
    in-plane (u, v) coordinates relative to the HMD:

    * controllers: u < 0 → left hand, else right hand (:512-522);
    * trackers: |v| < 0.8 m → waist, else u < 0 → left foot, else right
      foot (:523-537).

    Returns a NEW role map; raises :class:`IdentifyError` with the
    reference's message when the plane fit fails or the head is not aligned
    with the body plane (|cos| < 0.5, :463-476).  Mirrors the reference's
    overwrite semantics: if e.g. both controllers project to the same side,
    one slot is overwritten and the other keeps its provisional device.
    """
    hmd_idx = roles.get(ROLE_HMD)
    if hmd_idx is None or hmd_idx not in poses:
        raise IdentifyError("Not enough devices! Need at least two "
                            "controllers and/or trackers.")

    controller_roles = [r for r in (ROLE_CONTROLLER_LEFT,
                                    ROLE_CONTROLLER_RIGHT)
                        if r in roles and roles[r] in poses]
    tracker_roles = [r for r in (ROLE_TRACKER_ROOT, ROLE_TRACKER_LEFT,
                                 ROLE_TRACKER_RIGHT)
                     if r in roles and roles[r] in poses]
    if len(controller_roles) + len(tracker_roles) < 2:
        raise IdentifyError("Not enough devices! Need at least two "
                            "controllers and/or trackers.")

    device_ids = ([roles[ROLE_HMD]]
                  + [roles[r] for r in controller_roles]
                  + [roles[r] for r in tracker_roles])
    points = np.stack([np.asarray(poses[i][0], np.float64)
                       for i in device_ids])

    plane = fit_plane(points)
    if plane is None:
        raise IdentifyError("Could not identify tracked objects! Make sure "
                            "you're standing on a T-pose.")
    a, b, c, d = plane
    n = np.array([a, b, c], np.float64)
    n /= np.linalg.norm(n)

    hmd_rot = poses[hmd_idx][1]
    f = cm.quat_mul_vec(np.asarray(hmd_rot, np.float32),
                        np.array([0.0, 0.0, 1.0], np.float32))
    f = np.asarray(f, np.float64)
    f /= np.linalg.norm(f)

    deviation = float(np.dot(n, f))
    if abs(deviation) < HEAD_COSINE_DEVIATION_THRESHOLD:
        raise IdentifyError("Your head is not aligned with the rest of your "
                            "body! Make sure you're standing on a T-pose.")
    if deviation < 0.0:
        n = -n

    # a point on the plane (VRController.cs:483) and the in-plane frame
    p = np.array([0.0, 0.0, -d / c], np.float64)
    dist = (points - p) @ n
    projected = points - dist[:, None] * n

    v_axis = np.asarray(up, np.float64)
    u_axis = np.cross(v_axis, n)
    u0 = float(projected[0] @ u_axis)
    v0 = float(projected[0] @ v_axis)
    uv = np.stack([projected @ u_axis - u0, projected @ v_axis - v0], axis=1)

    out = dict(roles)
    ci0 = 1
    for k, role in enumerate(controller_roles):
        u_coord = uv[ci0 + k, 0]
        if u_coord < 0.0:
            out[ROLE_CONTROLLER_LEFT] = roles[role]
        else:
            out[ROLE_CONTROLLER_RIGHT] = roles[role]
    ti0 = ci0 + len(controller_roles)
    for k, role in enumerate(tracker_roles):
        u_coord, v_coord = uv[ti0 + k]
        if abs(v_coord) < MAX_HEAD_TO_WAIST_DISTANCE:
            out[ROLE_TRACKER_ROOT] = roles[role]
        elif u_coord < 0.0:
            out[ROLE_TRACKER_LEFT] = roles[role]
        else:
            out[ROLE_TRACKER_RIGHT] = roles[role]
    return out


# ---------------------------------------------------------------------------
# Joint-offset calibration
# ---------------------------------------------------------------------------

@dataclass
class JointOffset:
    """A device-local child joint (``SetupJoints`` creates one GameObject
    per device, ``VRController.cs:186-224``): ``local_pos`` is the body
    joint's offset in device space; ``local_rot`` is the inverse of the
    device's rotation at calibration time, so the joint's world rotation is
    identity in the calibration stance."""
    local_pos: np.ndarray   # (3,)
    local_rot: np.ndarray   # (4,) wxyz

    def world(self, device_pos: np.ndarray,
              device_rot: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Joint world pose given the live device pose."""
        pos = np.asarray(device_pos, np.float32) + cm.quat_mul_vec(
            device_rot, self.local_pos)
        rot = cm.quat_mul(device_rot, self.local_rot)
        return pos, rot


def setup_joints(
    device_poses: Dict[str, Tuple[np.ndarray, np.ndarray]],
    avatar_bones: Dict[str, np.ndarray],
    compute_offsets_hands: bool = False,
) -> Dict[str, JointOffset]:
    """Walk-in-avatar joint calibration (``SetupJoints``,
    ``VRController.cs:177-225``): the user stands in a T-pose inside a
    reference avatar; each device gets a child joint at the matching avatar
    bone, expressed in device space:

        local_pos = R_dev⁻¹ · (bone_pos − device_pos)
        local_rot = R_dev⁻¹

    Controllers use a fixed grip offset (0, 0, −0.175) unless
    ``compute_offsets_hands`` (:193-211, mirroring ``ComputeOffsetsHands``).
    ``device_poses``/``avatar_bones`` are keyed by role.
    """
    out: Dict[str, JointOffset] = {}
    for role, (dpos, drot) in device_poses.items():
        inv = cm.quat_inverse(drot)
        if role in (ROLE_CONTROLLER_LEFT, ROLE_CONTROLLER_RIGHT) and \
                not compute_offsets_hands:
            local_pos = CONTROLLER_HAND_OFFSET.copy()
        else:
            bone = np.asarray(avatar_bones[role], np.float32)
            local_pos = cm.quat_mul_vec(
                inv, bone - np.asarray(dpos, np.float32))
        out[role] = JointOffset(np.asarray(local_pos, np.float32),
                                np.asarray(inv, np.float32))
    return out


# ---------------------------------------------------------------------------
# Status display (DisplayMirror.cs, headless)
# ---------------------------------------------------------------------------

@dataclass
class _DisplayEvent:
    at: float
    text: str
    background: Optional[Tuple[float, float, float, float]]


class StatusDisplay:
    """Timed status messages (``DisplayMirror.cs:79-160``): ``show_text``
    displays a message for N seconds then restores what was there;
    ``show_text_again`` chains two messages (the second with its own timer;
    0 seconds means "stays until replaced").  Headless: ``text`` /
    ``background`` are the current state, ``history`` records everything
    ever shown (what the VR user would have read on the mirror)."""

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self.text = ""
        self.background: Optional[Tuple[float, float, float, float]] = None
        self.history: List[str] = []
        self._schedule: List[_DisplayEvent] = []

    def _set(self, text: str,
             background: Optional[Tuple[float, float, float, float]]):
        self.text = text
        self.background = background
        if text:
            self.history.append(text)

    def clean_text(self):
        """DisplayMirror.CleanText (:81-85)."""
        self._schedule.clear()
        self._set("", None)

    def show_text(self, message: str, background=None, secs: int = 0):
        """DisplayMirror.ShowText (:87-99): show now; when ``secs`` > 0,
        restore the previous message afterwards."""
        self.tick()
        old_text, old_bg = self.text, self.background
        self._set(message, background)
        if secs > 0:
            self._schedule.append(
                _DisplayEvent(self._clock() + secs, old_text, old_bg))
            self._schedule.sort(key=lambda e: e.at)

    def show_text_again(self, message: str, background, secs: int,
                        message2: str, background2, secs2: int):
        """DisplayMirror.ShowTextAgain (:101-108 + :131-160): message now
        for ``secs``, then the previous text is restored and ``message2``
        replaces it (for ``secs2``, or indefinitely when 0)."""
        self.tick()
        now = self._clock()
        old_text, old_bg = self.text, self.background
        self._set(message, background)
        t1 = now + max(secs, 0)
        if secs > 0:
            self._schedule.append(_DisplayEvent(t1, old_text, old_bg))
        self._schedule.append(_DisplayEvent(t1, message2, background2))
        if secs2 > 0:
            self._schedule.append(
                _DisplayEvent(t1 + secs2, old_text, old_bg))
        self._schedule.sort(key=lambda e: e.at)

    def tick(self):
        """Apply due scheduled transitions (the coroutine bodies)."""
        now = self._clock()
        while self._schedule and self._schedule[0].at <= now:
            ev = self._schedule.pop(0)
            self._set(ev.text, ev.background)


# colors the reference uses on the mirror (RGBA)
_WHITE = (1.0, 1.0, 1.0, 0.5)
_GREEN = (0.0, 1.0, 0.0, 0.5)
_RED = (1.0, 0.0, 0.0, 0.5)


# ---------------------------------------------------------------------------
# Scripted / BVH device providers
# ---------------------------------------------------------------------------

class ScriptedDeviceProvider(DeviceProvider):
    """Deterministic provider for tests: a fixed device table plus a queue
    of trigger presses."""

    def __init__(self, devices: List[TrackedDevice],
                 triggers: Optional[List[bool]] = None):
        self.devices = devices
        self._triggers = list(triggers or [])

    def poll(self) -> List[TrackedDevice]:
        return list(self.devices)

    def trigger_down(self) -> bool:
        if self._triggers:
            return self._triggers.pop(0)
        return False


class BVHDeviceProvider(DeviceProvider):
    """Synthesizes a 6-device SteamVR rig from a BVH clip: each device is
    rigidly mounted at a fixed offset from its body joint (an HMD sits in
    front of the head, trackers strap onto hips/ankles, controllers are held
    in the hands), reproducing the situation the reference's calibration
    exists to solve.  Device table order is shuffled by ``permutation`` so
    identification actually has work to do.

    The example data is AMASS-convention (right-handed, z-up); a real VR
    runtime would present the person standing in a left-handed y-up world,
    so the provider erects the clip with the signed-permutation map
    ``(x, y, z)_bvh → (−x, z, y)_world`` (det −1 — the same kind of RH→LH
    conversion the Unity BVH importer performs): up becomes +y, the
    T-pose facing becomes +z, and the anatomical left hand lands at −x,
    exactly where Unity's LH frame puts the left of a +z-facing person.
    Rotations conjugate accordingly: ``(w, x, y, z) → (w, x, −z, −y)``."""

    def __init__(self, bvh_path: str, permutation: Optional[Sequence[int]]
                 = None, trigger_frames: Optional[Sequence[int]] = None):
        from dragposer_tpu_torch.client.retarget import fk_world
        from dragposer_tpu_torch.data import encoding
        from dragposer_tpu_torch.io.bvh import BVH

        bvh = BVH().load(bvh_path)
        rots, pos, parents, offsets, _ = encoding.info_from_bvh(bvh)
        self.parents = parents
        self._offsets = np.asarray(offsets, np.float32)
        self._rots = rots
        self._root_pos = pos[:, 0]
        self.n_frames = len(rots)
        self.frame = 0
        self._fk_world = fk_world
        self._trigger_frames = set(trigger_frames or [])

        # device mounts: (local position on the joint, local rotation) in
        # the erected frame, where frame-0 joint rotations are ~identity
        rot_z90 = np.array([np.cos(np.pi / 4), 0, 0, np.sin(np.pi / 4)],
                           np.float32)  # 90° about z
        ident = np.array([1.0, 0, 0, 0], np.float32)
        self.mounts = {
            ROLE_HMD: (np.array([0.0, 0.08, 0.10], np.float32), ident),
            ROLE_CONTROLLER_LEFT: (np.array([0.0, 0.0, 0.175], np.float32),
                                   rot_z90),
            ROLE_CONTROLLER_RIGHT: (np.array([0.0, 0.0, 0.175], np.float32),
                                    cm.quat_inverse(rot_z90)),
            ROLE_TRACKER_ROOT: (np.array([0.0, 0.0, -0.12], np.float32),
                                ident),
            ROLE_TRACKER_LEFT: (np.array([0.0, 0.05, 0.0], np.float32),
                                rot_z90),
            ROLE_TRACKER_RIGHT: (np.array([0.0, 0.05, 0.0], np.float32),
                                 cm.quat_inverse(rot_z90)),
        }
        self.render_models = {
            ROLE_HMD: "generic_hmd",
            ROLE_CONTROLLER_LEFT: "vive_controller",
            ROLE_CONTROLLER_RIGHT: "vive_controller",
            ROLE_TRACKER_ROOT: "tracker_vive_0",
            ROLE_TRACKER_LEFT: "tracker_vive_1",
            ROLE_TRACKER_RIGHT: "tracker_vive_2",
        }
        order = list(SIX_ROLES)
        if permutation is not None:
            order = [order[i] for i in permutation]
        self._table_order = order

    @staticmethod
    def _erect_pos(p: np.ndarray) -> np.ndarray:
        """(x, y, z)_bvh → (−x, z, y)_world."""
        p = np.asarray(p, np.float32)
        return np.stack([-p[..., 0], p[..., 2], p[..., 1]], axis=-1)

    @staticmethod
    def _erect_rot(q: np.ndarray) -> np.ndarray:
        """Conjugation of a wxyz rotation by the det=−1 position map:
        (w, x, y, z) → (w, x, −z, −y)."""
        q = np.asarray(q, np.float32)
        return np.stack([q[..., 0], q[..., 1], -q[..., 3], -q[..., 2]],
                        axis=-1)

    def joint_world(self, frame: int):
        """Erected-frame world pose of every joint at ``frame``."""
        pos_py, rot_py = self._fk_world(self.parents, self._offsets,
                                        self._rots[frame],
                                        self._root_pos[frame])
        return self._erect_pos(pos_py), self._erect_rot(rot_py)

    def device_pose(self, role: str,
                    frame: int) -> Tuple[np.ndarray, np.ndarray]:
        """World pose of the physical device mounted on ``role``'s joint."""
        pos, rot = self.joint_world(frame)
        j = ROLE_JOINT[role]
        mpos, mrot = self.mounts[role]
        dpos = pos[j] + cm.quat_mul_vec(rot[j], mpos)
        drot = cm.quat_mul(rot[j], mrot)
        return dpos.astype(np.float32), drot.astype(np.float32)

    def poll(self) -> List[TrackedDevice]:
        out = []
        for slot, role in enumerate(self._table_order):
            dpos, drot = self.device_pose(role, self.frame)
            out.append(TrackedDevice(index=slot,
                                     render_model=self.render_models[role],
                                     tracking_ok=True, position=dpos,
                                     rotation=drot))
        return out

    def trigger_down(self) -> bool:
        return self.frame in self._trigger_frames

    def advance(self, n: int = 1):
        self.frame = min(self.frame + n, self.n_frames - 1)


# ---------------------------------------------------------------------------
# VRIK rig — the six-role application layer
# ---------------------------------------------------------------------------

class VRIKRig:
    """Port of ``Applications/VRIK.cs``: six devices drive six end
    effectors with live per-device dropout toggles.

    * ``calibrate()`` (VRIK.cs:172-206): per role, record a child rotation
      ``ee_rot · joint_rot⁻¹`` so that afterwards the device joint maps onto
      the retargeter's tracker frame exactly where it was at calibration.
    * ``before_retarget()`` (VRIK.cs:64-113): write active devices' joint
      poses into the retargeter trackers, and the active flags + weights
      into the driver's mask/weights (hips 10, rest 5) — the engine's dense
      masks make per-frame dropout toggles recompile-free.
    """

    def __init__(self, driver):
        self.driver = driver
        self.active: Dict[str, bool] = {r: True for r in SIX_ROLES}
        self.joint_offsets: Dict[str, JointOffset] = {}
        self.child_rot: Dict[str, np.ndarray] = {}
        self.is_calibrated = False

    def set_joint_offsets(self, offsets: Dict[str, JointOffset]):
        self.joint_offsets = offsets

    def _joint_world(self, role: str, device_pose):
        off = self.joint_offsets.get(role)
        if off is None:
            return device_pose
        return off.world(*device_pose)

    def calibrate(self, device_poses: Dict[str, Tuple[np.ndarray,
                                                      np.ndarray]]):
        """Record per-role child rotations against the retargeter's current
        tracker transforms (which sit at the T-pose before any updates)."""
        for role in SIX_ROLES:
            if role not in device_poses:
                continue
            jpos, jrot = self._joint_world(role, device_poses[role])
            joint = ROLE_JOINT[role]
            # the EE is the retargeter's tracker transform, still at its
            # T-pose placement at calibration time (VRIK.cs:127-166)
            ee_rot = self.driver.retargeter.tracker_rot[joint]
            self.child_rot[role] = cm.quat_mul(ee_rot, cm.quat_inverse(jrot))
        self.is_calibrated = True

    def before_retarget(self, device_poses: Dict[str, Tuple[np.ndarray,
                                                            np.ndarray]]):
        """One frame of VRIK.OnBeforeRetargetTrackers."""
        if not self.is_calibrated:
            return
        for role in SIX_ROLES:
            joint = ROLE_JOINT[role]
            if self.active.get(role) and role in device_poses:
                jpos, jrot = self._joint_world(role, device_poses[role])
                rot = cm.quat_mul(jrot, self.child_rot[role])
                self.driver.retargeter.set_tracker(joint, jpos, rot)
                self.driver.mask[joint] = 1.0
                self.driver.weights[joint, 0] = ROLE_POS_WEIGHT[role]
            else:
                self.driver.mask[joint] = 0.0


# ---------------------------------------------------------------------------
# Setup state machine (VRController.Update)
# ---------------------------------------------------------------------------

class VRSetupFlow:
    """The trigger-driven VR setup sequence (``VRController.cs:130-175``):

    1. ``detecting`` — poll until ≥2 controllers and ≥3 trackers are
       connected; show counts on the display.
    2. ``identify_wait`` — user stands in a T-pose, presses trigger →
       plane-fit role identification (failure messages shown; like the
       reference, the flow proceeds on the provisional assignment if
       identification fails — ``Update`` ignores ``IdentifyDevices``'s
       return value, :144-151).
    3. ``avatar_wait`` — the walk-in avatar is shown; user matches its
       T-pose, presses trigger → ``setup_joints`` calibration.  (Where the
       reference left a ``TODO: CALIBRATE HERE`` stub, :168-170, this flow
       completes the calibration by wiring the offsets into the
       :class:`VRIKRig`.)
    4. ``done``.

    A 0.5 s cooldown separates stages (:132-135).  ``avatar_bones`` supplies
    the walk-in avatar's T-pose bone positions per role (the reference reads
    them off a humanoid prefab's Animator, :179-185).
    """

    def __init__(self, provider: DeviceProvider,
                 avatar_bones: Dict[str, np.ndarray],
                 rig: Optional[VRIKRig] = None,
                 display: Optional[StatusDisplay] = None,
                 clock: Callable[[], float] = time.monotonic,
                 compute_offsets_hands: bool = False):
        self.provider = provider
        self.avatar_bones = avatar_bones
        self.rig = rig
        self.display = display or StatusDisplay(clock)
        self._clock = clock
        self.compute_offsets_hands = compute_offsets_hands
        self.state = "detecting"
        self.roles: Dict[str, int] = {}
        self.joint_offsets: Dict[str, JointOffset] = {}
        self._cooldown_until = -float("inf")

    # -- helpers -----------------------------------------------------------
    def _poses(self) -> Dict[int, Tuple[np.ndarray, np.ndarray]]:
        return {d.index: (d.position, d.rotation)
                for d in self.provider.poll()}

    def role_poses(self) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
        poses = self._poses()
        return {r: poses[i] for r, i in self.roles.items() if i in poses}

    # -- the Update() body --------------------------------------------------
    def update(self):
        self.display.tick()
        now = self._clock()
        if now < self._cooldown_until:
            return
        if self.state == "detecting":
            det = detect_devices(self.provider.poll())
            if det.ok:
                self.roles = assign_device_indices(det)
                self.display.show_text_again(
                    det.message, _WHITE, 2,
                    "Setting up device indices and taking some measures... "
                    "Please, stand on a T-pose. Press TRIGGER when ready!",
                    _WHITE, 0)
                self.state = "identify_wait"
            else:
                self.display.show_text(det.message, _RED, 0)
            return
        if self.state == "identify_wait":
            if not self.provider.trigger_down():
                return
            try:
                self.roles = identify_devices(self.roles, self._poses())
                self.display.clean_text()
            except IdentifyError as e:
                # reference behavior: the message is shown but Update()
                # ignores the failure and proceeds (VRController.cs:144-151)
                self.display.show_text(e.message, _RED, 2)
            self.display.show_text_again(
                "Measures were correctly captured!", _GREEN, 2,
                "Setting up root... Please, stand on a T-pose inside the "
                "avatar shown. Press TRIGGER when ready!", _WHITE, 0)
            self.state = "avatar_wait"
            self._cooldown_until = now + SETUP_COOLDOWN_S
            return
        if self.state == "avatar_wait":
            if not self.provider.trigger_down():
                return
            self.joint_offsets = setup_joints(
                self.role_poses(), self.avatar_bones,
                self.compute_offsets_hands)
            if self.rig is not None:
                self.rig.set_joint_offsets(self.joint_offsets)
                self.rig.calibrate(self.role_poses())
            self.display.clean_text()
            self.state = "done"
            self._cooldown_until = now + SETUP_COOLDOWN_S
