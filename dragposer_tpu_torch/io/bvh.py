"""BVH motion-capture reader/writer (host-side NumPy).

The port's own copy of ``dragposer_tpu/io/bvh.py``.

Self-contained replacement for the capability the reference gets from
``pymotion.io.bvh`` (consumed at ``python/src/train.py:322-341,484-508``).
The data model mirrors what the pipeline needs:

* ``names``       — joint names, depth-first order as in the file
* ``parents``     — int array, ``parents[0] == 0`` (root points at itself)
* ``offsets``     — (J, 3) float
* ``rot_order``   — (J, 3) array of 'x'/'y'/'z' channel order per joint
* ``positions``   — (F, J, 3); joints without position channels carry their
  static offset each frame (only ``positions[:, 0]`` is ever consumed)
* ``rotations``   — (F, J, 3) Euler angles in **degrees**, channel order
* ``frame_time``  — seconds per frame
* ``end_sites``   — list of (parent_joint_index, offset) preserved for writing
"""

from __future__ import annotations

import numpy as np

_AXIS_OF_CHANNEL = {
    "Xrotation": "x",
    "Yrotation": "y",
    "Zrotation": "z",
}
_POS_CHANNELS = ("Xposition", "Yposition", "Zposition")


class BVH:
    def __init__(self):
        self.names: list[str] = []
        self.parents: np.ndarray | None = None
        self.offsets: np.ndarray | None = None
        self.rot_order: np.ndarray | None = None
        self.positions: np.ndarray | None = None
        self.rotations: np.ndarray | None = None
        self.frame_time: float = 1.0 / 60.0
        self.end_sites: list[tuple[int, np.ndarray]] = []
        self._channel_layout: list[tuple[int, list[str]]] = []

    # ------------------------------------------------------------------
    # Parsing
    # ------------------------------------------------------------------
    def load(self, path: str) -> "BVH":
        with open(path, "r") as f:
            text = f.read()
        tokens = text.replace("\t", " ").split("\n")
        lines = [ln.strip() for ln in tokens if ln.strip()]

        names: list[str] = []
        parents: list[int] = []
        offsets: list[np.ndarray] = []
        rot_orders: list[list[str]] = []
        layout: list[tuple[int, list[str]]] = []
        end_sites: list[tuple[int, np.ndarray]] = []

        stack: list[int] = []
        i = 0
        in_end_site = False
        motion_line = None
        while i < len(lines):
            ln = lines[i]
            upper = ln.upper()
            if upper.startswith("HIERARCHY"):
                pass
            elif upper.startswith("ROOT") or upper.startswith("JOINT"):
                name = ln.split(None, 1)[1].strip()
                parent = stack[-1] if stack else 0
                idx = len(names)
                names.append(name)
                parents.append(parent)
                offsets.append(np.zeros(3))
                rot_orders.append(["x", "y", "z"])
                layout.append((idx, []))
                stack.append(idx)
            elif upper.startswith("END SITE") or upper.startswith("END "):
                in_end_site = True
            elif ln.startswith("{"):
                pass
            elif ln.startswith("}"):
                if in_end_site:
                    in_end_site = False
                elif stack:
                    stack.pop()
            elif upper.startswith("OFFSET"):
                vals = np.array([float(x) for x in ln.split()[1:4]])
                if in_end_site:
                    end_sites.append((stack[-1], vals))
                else:
                    offsets[stack[-1]] = vals
            elif upper.startswith("CHANNELS"):
                parts = ln.split()
                chans = parts[2 : 2 + int(parts[1])]
                j = stack[-1]
                layout[j] = (j, chans)
                rot = [_AXIS_OF_CHANNEL[c] for c in chans if c in _AXIS_OF_CHANNEL]
                if len(rot) == 3:
                    rot_orders[j] = rot
            elif upper.startswith("MOTION"):
                motion_line = i
                break
            i += 1

        if motion_line is None:
            raise ValueError(f"no MOTION section in {path}")
        n_frames = int(lines[motion_line + 1].split()[-1])
        self.frame_time = float(lines[motion_line + 2].split()[-1])
        frame_lines = lines[motion_line + 3 : motion_line + 3 + n_frames]
        values = np.array(
            [np.fromstring(ln, sep=" ") for ln in frame_lines], dtype=np.float64
        )

        n_joints = len(names)
        self.names = names
        self.parents = np.array(parents, dtype=np.int64)
        self.parents[0] = 0
        self.offsets = np.stack(offsets).astype(np.float64)
        self.rot_order = np.array(rot_orders)
        self.end_sites = end_sites
        self._channel_layout = layout

        positions = np.tile(self.offsets[None, :, :], (n_frames, 1, 1))
        rotations = np.zeros((n_frames, n_joints, 3), dtype=np.float64)
        col = 0
        for j, chans in layout:
            rot_col = 0
            for ch in chans:
                if ch in _POS_CHANNELS:
                    positions[:, j, _POS_CHANNELS.index(ch)] = values[:, col]
                else:
                    rotations[:, j, rot_col] = values[:, col]
                    rot_col += 1
                col += 1
        self.positions = positions
        self.rotations = rotations
        return self

    # ------------------------------------------------------------------
    # Writing
    # ------------------------------------------------------------------
    def save(self, path: str) -> None:
        children: list[list[int]] = [[] for _ in self.names]
        for j in range(1, len(self.names)):
            children[int(self.parents[j])].append(j)
        ends: dict[int, list[np.ndarray]] = {}
        for j, off in self.end_sites:
            ends.setdefault(int(j), []).append(off)

        out: list[str] = ["HIERARCHY"]

        def fmt3(v):
            return f"{v[0]:.6f} {v[1]:.6f} {v[2]:.6f}"

        def rot_channels(j):
            return " ".join(f"{c.upper()}rotation" for c in self.rot_order[j])

        def emit(j: int, depth: int):
            pad = "\t" * depth
            tag = "ROOT" if j == 0 else "JOINT"
            out.append(f"{pad}{tag} {self.names[j]}")
            out.append(pad + "{")
            out.append(f"{pad}\tOFFSET {fmt3(self.offsets[j])}")
            if j == 0:
                out.append(
                    f"{pad}\tCHANNELS 6 Xposition Yposition Zposition {rot_channels(j)}"
                )
            else:
                out.append(f"{pad}\tCHANNELS 3 {rot_channels(j)}")
            for c in children[j]:
                emit(c, depth + 1)
            if not children[j]:
                site = ends.get(j, [np.zeros(3)])[0]
                out.append(f"{pad}\tEnd Site")
                out.append(pad + "\t{")
                out.append(f"{pad}\t\tOFFSET {fmt3(site)}")
                out.append(pad + "\t}")
            out.append(pad + "}")

        emit(0, 0)
        n_frames = self.rotations.shape[0]
        out.append("MOTION")
        out.append(f"Frames: {n_frames}")
        out.append(f"Frame Time: {self.frame_time:.6f}")
        rows = np.concatenate(
            (
                self.positions[:, 0, :],
                self.rotations.reshape(n_frames, -1),
            ),
            axis=1,
        )
        for row in rows:
            out.append(" ".join(f"{v:.6f}" for v in row))
        with open(path, "w") as f:
            f.write("\n".join(out) + "\n")
