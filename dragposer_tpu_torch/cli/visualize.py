"""Render reconstructed motion next to ground truth (demo visualizer; port
of ``dragposer_tpu/cli/visualize.py``, its FK on the port's ``ops/fk``).

Produces an animated GIF of the two skeletons side by side — the headless
stand-in for the reference's Unity desktop demo (``Applications/FBIK.cs``).

Usage::

    python -m dragposer_tpu_torch.cli.visualize <gt.bvh> <eval.bvh> out.gif
        [--start N] [--frames N] [--stride N] [--device cuda|cpu]

The forward kinematics run on ``--device`` (``cuda`` unless ``cpu`` is
given; without a card and without ``cpu`` it raises), the drawing on the
host.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from dragposer_tpu_torch._device import resolve_device
from dragposer_tpu_torch.data import encoding
from dragposer_tpu_torch.io.bvh import BVH
from dragposer_tpu_torch.ops import fk
from dragposer_tpu_torch.ops.topology import Skeleton


def world_positions(bvh: BVH, start: int, frames: int, stride: int,
                    device=None) -> np.ndarray:
    """World joint positions (frames, J, 3) of every ``stride``-th frame
    from ``start``, root at the origin (FK on ``device``), and the
    parents."""
    dev = resolve_device(device)
    rots, pos, parents, offsets, _ = encoding.info_from_bvh(bvh)
    sel = slice(start, start + frames, stride)
    sk = Skeleton.build(parents, offsets, bvh.names)
    r = torch.as_tensor(rots[sel], device=dev)
    p, _ = fk.fk_local(r, torch.zeros((r.shape[0], 3), dtype=r.dtype,
                                      device=dev), sk)
    return p.cpu().numpy(), sk.parents


def render(gt_path: str, eval_path: str, out_path: str, *, start: int = 0,
           frames: int = 240, stride: int = 2, fps: int = 30,
           device=None) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.animation as animation
    import matplotlib.pyplot as plt

    gt, parents = world_positions(BVH().load(gt_path), start, frames, stride,
                                  device)
    ev, _ = world_positions(BVH().load(eval_path), start, frames, stride,
                            device)
    n = min(len(gt), len(ev))
    gt, ev = gt[:n], ev[:n]
    ev = ev + np.array([1.5, 0.0, 0.0])  # draw side by side

    fig = plt.figure(figsize=(8, 6))
    ax = fig.add_subplot(projection="3d")
    lines = []
    for _ in range(len(parents) - 1):
        lines.append(ax.plot([], [], [], "o-", color="tab:blue", ms=2, lw=1.5)[0])
    for _ in range(len(parents) - 1):
        lines.append(ax.plot([], [], [], "o-", color="tab:orange", ms=2, lw=1.5)[0])
    both = np.concatenate((gt, ev), axis=1)
    lo, hi = both.min(axis=(0, 1)), both.max(axis=(0, 1))
    mid, span = (lo + hi) / 2, (hi - lo).max() / 2 + 0.1
    ax.set_xlim(mid[0] - span, mid[0] + span)
    ax.set_ylim(mid[1] - span, mid[1] + span)
    ax.set_zlim(mid[2] - span, mid[2] + span)
    ax.set_title("ground truth (blue) vs reconstruction (orange)")
    ax.view_init(elev=15, azim=-70)

    bones = [(j, int(parents[j])) for j in range(1, len(parents))]

    def update(f):
        for li, (j, p) in enumerate(bones):
            seg = gt[f][[p, j]]
            lines[li].set_data(seg[:, 0], seg[:, 1])
            lines[li].set_3d_properties(seg[:, 2])
        for li, (j, p) in enumerate(bones):
            seg = ev[f][[p, j]]
            lines[len(bones) + li].set_data(seg[:, 0], seg[:, 1])
            lines[len(bones) + li].set_3d_properties(seg[:, 2])
        return lines

    anim = animation.FuncAnimation(fig, update, frames=n, blit=True)
    anim.save(out_path, writer=animation.PillowWriter(fps=fps))
    plt.close(fig)
    print(f"wrote {out_path} ({n} frames)")


def main(argv=None):
    parser = argparse.ArgumentParser(description="Visualize GT vs reconstruction")
    parser.add_argument("gt_bvh", type=str)
    parser.add_argument("eval_bvh", type=str)
    parser.add_argument("out", type=str, help="output .gif path")
    parser.add_argument("--start", type=int, default=0)
    parser.add_argument("--frames", type=int, default=240)
    parser.add_argument("--stride", type=int, default=2)
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    render(args.gt_bvh, args.eval_bvh, args.out,
           start=args.start, frames=args.frames, stride=args.stride,
           device=args.device)


if __name__ == "__main__":
    main()
