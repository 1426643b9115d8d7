"""Seeded synthetic motion on the decoder's manifold, in plain PyTorch.

A clip is a smooth random walk in the VAE's latent, decoded by the
reference decoder (:mod:`benchmark.reference.model`) into root-space joint
rotations, with a smoothly turning root yaw and a smooth root path on the
example skeleton (z up).  From it come the two inputs the program takes: the
offline evaluator's encoded features (normalized root-space dual
quaternions, global root position and rotation, heights) and a VR client's
tracker readings (world positions and rotations of the tracked joints).

Nothing here calls the program, so the inputs do not move with it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from benchmark.reference.model import Skeleton, Vae, fk, qinv, qmul, qrotate

FRAME_TIME = 1.0 / 60.0
# The 22-joint rig of the example model: pelvis, legs, spine, head, arms.
PARENTS = np.array([0, 0, 1, 2, 3, 0, 5, 6, 7, 0, 9, 10, 11, 12, 11, 14, 15,
                    16, 11, 18, 19, 20], dtype=np.int64)
JOINT_NAMES = (
    "pelvis", "l_hip", "l_knee", "l_ankle", "l_foot", "r_hip", "r_knee",
    "r_ankle", "r_foot", "spine1", "spine2", "spine3", "neck", "head",
    "l_collar", "l_shoulder", "l_elbow", "l_wrist", "r_collar", "r_shoulder",
    "r_elbow", "r_wrist")
# bone offsets in metres (x lateral, y forward, z up)
BASE_OFFSETS = np.array([
    [0, 0, 0], [0.09, 0, -0.06], [0, 0, -0.40], [0, 0, -0.40],
    [0, 0.12, -0.06], [-0.09, 0, -0.06], [0, 0, -0.40], [0, 0, -0.40],
    [0, 0.12, -0.06], [0, 0, 0.10], [0, 0, 0.13], [0, 0, 0.06],
    [0, 0, 0.20], [0, 0.02, 0.10], [0.07, 0, 0.12], [0.10, 0, 0],
    [0.26, 0, 0], [0.25, 0, 0], [-0.07, 0, 0.12], [-0.10, 0, 0],
    [-0.26, 0, 0], [-0.25, 0, 0]])


def skeleton_offsets(rng: np.random.Generator) -> np.ndarray:
    """The rig with seeded bone lengths (±5%), to the 6 decimals a BVH file
    keeps, so that a skeleton read back from one is the same."""
    off = BASE_OFFSETS * (1.0 + 0.05 * rng.normal(size=(len(PARENTS), 1)))
    off = np.round(off, 6)
    off[0] = 0.0
    return off.astype(np.float32)


@dataclass
class Clip:
    """Tensors of a clip of T frames, on the device."""

    rootspace: torch.Tensor   # (T, J, 4) slot 0 = world root rotation
    root_pos: torch.Tensor    # (T, 3)


def clips(vae: Vae, rng: np.random.Generator, n: int, frames: int,
          device) -> list:
    """``n`` clips of ``frames`` frames."""
    L = vae.dec[0][0].shape[1]
    t = np.arange(frames) * FRAME_TIME
    out = []
    for _ in range(n):
        z = np.zeros((frames, L))
        z[0] = rng.normal(size=L) * 0.5
        noise = rng.normal(size=(frames, L)) * 0.08
        for i in range(1, frames):
            z[i] = 0.98 * z[i - 1] + noise[i]
        kernel = np.ones(9) / 9.0
        z = np.stack([np.convolve(np.pad(z[:, i], 4, mode="edge"), kernel,
                                  mode="valid") for i in range(L)], axis=1)
        yaw = rng.uniform(-np.pi, np.pi) + 0.4 * np.sin(0.7 * t) + 0.2 * t
        root = np.stack([np.cos(yaw / 2), 0 * yaw, 0 * yaw, np.sin(yaw / 2)],
                        -1)
        speed = 0.6 + 0.3 * np.sin(0.5 * t)
        heading = yaw + 0.3 * np.sin(0.9 * t)
        path = np.zeros((frames, 3))
        path[:, 0] = np.cumsum(speed * np.cos(heading)) * FRAME_TIME
        path[:, 1] = np.cumsum(speed * np.sin(heading)) * FRAME_TIME
        path[:, 2] = 0.95 + 0.02 * np.sin(2 * np.pi * 1.5 * t)
        f32 = lambda a: torch.as_tensor(a, dtype=torch.float32,  # noqa: E731
                                        device=device)
        with torch.no_grad():
            pose_n, _ = vae.decode(f32(z))
            q = vae.quats(pose_n)
        q[:, 0] = f32(root)
        out.append(Clip(rootspace=q, root_pos=f32(path)))
    return out


def unroll_signs(real):
    """Signs (T, J) that keep consecutive quaternions (T, J, 4) within 90°."""
    d = (real[1:] * real[:-1]).sum(-1)
    flips = torch.where(d < 0, -1.0, 1.0)
    return torch.cat((torch.ones_like(flips[:1]), torch.cumprod(flips, 0)))


@dataclass
class Features:
    """A clip as the offline evaluator encodes a motion file."""

    dqs: torch.Tensor         # (T, J*8) root-space dual quaternions
    global_pos: torch.Tensor  # (T, 3)
    global_rot: torch.Tensor  # (T, 4)
    heights: torch.Tensor     # (T, H) world height (component 1)


def features(clip: Clip, skeleton: Skeleton, height_indices) -> Features:
    """Root-space dual quaternions: every joint's root-space rotation and
    root-frame position (the root at the origin, unrotated); the root's slot
    holds its rotation since the previous frame, its displacement in its own
    frame, and 0.  Signs unrolled along time."""
    rs = clip.rootspace.clone()
    root = rs[:, 0].clone()
    rs[:, 0] = torch.tensor([1.0, 0, 0, 0], device=rs.device)
    pos, _ = fk(skeleton, rs, torch.zeros_like(clip.root_pos))
    tq = torch.cat((torch.zeros_like(pos[..., :1]), pos), -1)
    dq = torch.cat((rs, 0.5 * qmul(tq, rs)), -1)
    incr = qmul(qinv(root[:-1]), root[1:])
    dq[:, 0, :4] = torch.cat((rs[:1, 0], incr))
    dq = dq * unroll_signs(dq[..., :4])[..., None]
    step = torch.cat((torch.zeros_like(clip.root_pos[:1]),
                      clip.root_pos[1:] - clip.root_pos[:-1]))
    dq[:, 0, 4:7] = qrotate(qinv(root), step)
    dq[:, 0, 7] = 0.0
    world = qrotate(root[:, None], pos) + clip.root_pos[:, None]
    return Features(dqs=dq.flatten(1), global_pos=clip.root_pos,
                    global_rot=root,
                    heights=world[:, list(height_indices), 1])


def trackers(clip: Clip, skeleton: Skeleton):
    """World positions (T, J, 3) and rotations (T, J, 4) of every joint: what
    a tracker on each reads."""
    return fk(skeleton, clip.rootspace, clip.root_pos)


def write_bvh(path: str, offsets: np.ndarray) -> None:
    """The rig as a one-frame BVH file (rest pose), joints depth first in
    index order, so that a reader's joint order is this one."""
    children = [[] for _ in PARENTS]
    for j in range(1, len(PARENTS)):
        children[int(PARENTS[j])].append(j)
    lines = ["HIERARCHY"]

    def emit(j, depth):
        pad = "\t" * depth
        lines.append(f"{pad}{'ROOT' if j == 0 else 'JOINT'} {JOINT_NAMES[j]}")
        lines.append(pad + "{")
        o = offsets[j]
        lines.append(f"{pad}\tOFFSET {o[0]:.6f} {o[1]:.6f} {o[2]:.6f}")
        lines.append(f"{pad}\tCHANNELS 6 Xposition Yposition Zposition "
                     "Zrotation Yrotation Xrotation" if j == 0 else
                     f"{pad}\tCHANNELS 3 Zrotation Yrotation Xrotation")
        for c in children[j]:
            emit(c, depth + 1)
        if not children[j]:
            lines.extend([f"{pad}\tEnd Site", pad + "\t{",
                          f"{pad}\t\tOFFSET 0.000000 0.000000 0.000000",
                          pad + "\t}"])
        lines.append(pad + "}")

    emit(0, 0)
    values = " ".join(["0.000000"] * (6 + 3 * (len(PARENTS) - 1)))
    lines += ["MOTION", "Frames: 1", f"Frame Time: {FRAME_TIME:.6f}", values]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
