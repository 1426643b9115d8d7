"""Built-in "constraints as losses" for the drag optimizer (port of
``dragposer_tpu/drag/constraints.py``).

The reference documents four extra drag-loss terms as commented-out code
(``drag_pose.py:129-183``): feet on the floor, head and hips facing alike,
head over hips, hips over feet.  Each factory returns a function
``ConstraintContext -> (B,)`` for ``DragHyper.constraints``, whose weighted
sum joins the objective in ``engine._drag_loss``::

    hyper = hyper._replace(constraints=(
        (constraints.feet_floor(), 1.0),
        (constraints.head_hips_colinear(), 0.5),
    ))

The context is batched (leaves lead with the lane axis B), so each term is
one value a lane.  The reference's conventions hold: the up axis is index
1, joint indices default to the 22-joint DanceDB skeleton (feet 4/8, head
13, hips 0), and world positions are ``positions + global_pos``.  Branches
are selects with guarded denominators, so every term differentiates.
"""

from __future__ import annotations

import torch

from dragposer_tpu_torch.ops import quat

_EPS = 1e-8


def _ground(v, up_axis: int):
    """``v`` (..., 3) with its up component set to 0."""
    keep = torch.ones(3, dtype=v.dtype, device=v.device)
    keep[up_axis] = 0.0
    return v * keep


def feet_floor(feet=(4, 8), floor_level: float = 0.0, up_axis: int = 1):
    """Penalize feet leaving the floor plane (``drag_pose.py:132-134``):
    mean squared world height of the foot joints above ``floor_level``."""
    feet = list(feet)

    def loss(ctx):
        h = ctx.global_pos[:, up_axis, None] + (
            ctx.positions[:, feet, up_axis] - floor_level)
        return torch.mean(h ** 2, dim=-1)

    return loss


def head_hips_forward(head: int = 13, hips: int = 0, up_axis: int = 1,
                      slack: float = 0.2):
    """Keep the head facing within the hips' forward cone
    (``drag_pose.py:136-154``): squared hinge on the ground-projected
    forward-vector dot product, off when the head looks straight up or
    down (projected norm <= 0.5, the reference's guard)."""

    def loss(ctx):
        fwd = ctx.world_quats.new_tensor([0.0, 0.0, 1.0])
        fwd_head = _ground(quat.mul_vec(ctx.world_quats[:, head], fwd),
                           up_axis)
        fwd_hips = _ground(quat.mul_vec(ctx.world_quats[:, hips], fwd),
                           up_axis)
        n_head = torch.linalg.norm(fwd_head, dim=-1)
        n_hips = torch.linalg.norm(fwd_hips, dim=-1)
        cos = torch.sum(fwd_head * fwd_hips, dim=-1) / torch.clamp(
            n_head * n_hips, min=_EPS)
        term = (1.0 - torch.clamp(cos + slack, max=1.0)) ** 2
        return torch.where(n_head > 0.5, term, 0.0)

    return loss


def head_hips_colinear(head: int = 13, hips: int = 0, up_axis: int = 1):
    """Keep the head vertically over the hips (``drag_pose.py:156-162``):
    squared ground-plane distance between the two positions."""

    def loss(ctx):
        d = _ground(ctx.positions[:, head] - ctx.positions[:, hips], up_axis)
        return torch.sum(d ** 2, dim=-1)

    return loss


def hips_feet_colinear(hips: int = 0, feet=(4, 8), radius: float = 0.2,
                       up_axis: int = 1):
    """Keep the hips over the support polygon (``drag_pose.py:164-176``):
    hinge on the squared ground-plane hips→foot distance beyond ``radius``."""
    feet = tuple(feet)

    def loss(ctx):
        total = 0.0
        for f in feet:
            d = _ground(ctx.positions[:, hips] - ctx.positions[:, f], up_axis)
            total = total + torch.clamp(
                torch.sum(d ** 2, dim=-1) - radius * radius, min=0.0)
        return total

    return loss


_BY_NAME = {
    "feet_floor": feet_floor,
    "head_hips_forward": head_hips_forward,
    "head_hips_colinear": head_hips_colinear,
    "hips_feet_colinear": hips_feet_colinear,
}


def parse_spec(spec: str):
    """``'feet_floor:0.5,head_hips_colinear:0.1'`` → ``DragHyper.constraints``
    (the form of a config JSON's ``"constraints"`` and of ``eval_drag
    --constraints``).  An empty or blank spec is ``()``; a name without a
    weight weighs 1."""
    spec = (spec or "").strip()
    if not spec:
        return ()
    out = []
    for item in spec.split(","):
        name, _, w = item.partition(":")
        name = name.strip()
        if name not in _BY_NAME:
            raise ValueError(
                f"unknown constraint {name!r}; choose from {sorted(_BY_NAME)}")
        out.append((_BY_NAME[name](), float(w) if w else 1.0))
    return tuple(out)


#: the reference's full commented-out bundle (``drag_pose.py:178-183``),
#: all weights 1 as in the reference's sum
REFERENCE_BUNDLE = (
    (feet_floor(), 1.0),
    (head_hips_forward(), 1.0),
    (head_hips_colinear(), 1.0),
    (hips_feet_colinear(), 1.0),
)
