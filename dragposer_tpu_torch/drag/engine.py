"""The drag runtime (port of ``dragposer_tpu/drag/engine.py``): the types,
the per-lane *anchor* path (``_drag_loss`` → ``_opt_body`` → ``frame_step``
→ ``run_sequence``, the ``DragEngine`` methods ``run``, ``run_batch``,
``step`` and ``step_realtime``) and the building blocks the pipelined path
(``drag/pipeline.py``) shares with it.

Every function here works on a batch: leaves lead with the lane axis
``B`` (the JAX package writes them per lane and ``vmap``s them).  The
reference behaviours the JAX module lists hold here too:

* a fresh Adam state every frame;
* the stop rule ``(loss_pos > εp or loss_rot > εr) and iters < max_iter and
  loss_incr > min_incr`` on the previous iteration's values; a lane whose
  rule is false keeps its carry (the masking of a ``while_loop`` under
  ``vmap``);
* the ring buffers record the latent *before* the final Adam step;
* the temporal rollout's mask is a per-step *visibility* mask (all rows see
  columns ≤ k), not a causal mask;
* the rollout "upsample" is a constant hold (:func:`_hold_index`);
* the joint adjustment moves the root toward the target end effector and
  adds the same world-space correction to the root-space displacement;
* heights add the already-advanced global position to FK positions that
  are relative to the previous root (component index 1).

The anchor takes its gradient with ``torch.autograd`` (the JAX anchor's
``jax.value_and_grad``), never through kernel K1 or its twin
``fast_iter``: that independence makes it the oracle of the fast path.  Its
rollout is kernel K2 on a CUDA tensor (``temporal_fused.forward``).  A
frame's phases, the anchor's iterations and the rollout are spans of a
profiler's trace (``tracing.span``), and ``ROLLOUTS`` logs each rollout
while a profiler records.
"""

from __future__ import annotations

import copy

from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch

from dragposer_tpu_torch import _build
from dragposer_tpu_torch._device import resolve_device
from dragposer_tpu_torch.models import loading, vae
from dragposer_tpu_torch.ops import fk, quat, temporal_fused
from dragposer_tpu_torch.ops.topology import Skeleton
from dragposer_tpu_torch.parallel.mesh import map_tree
from dragposer_tpu_torch.tracing import span

# the rollouts :func:`_rollout_where_needed` runs; while a profiler records,
# each one's lanes run and the masks its needed lanes are reduced from
ROLLOUTS = _build.KernelCounts(log_name="rollout")


class DragHyper(NamedTuple):
    max_iter: int = 100
    stop_eps_pos: float = 1e-4
    stop_eps_rot: float = 1e-2
    min_loss_incr: float = 1e-5
    learning_rate: float = 1e-2
    lambda_rot: float = 1.0
    lambda_temporal: float = 0.02
    temporal_future_window: int = 0          # 0 → re-predict every frame
    sample_step: int = 4
    past_frames: Tuple[int, ...] = tuple(range(0, 60, 4))
    height_indices: Tuple[int, ...] = (0, 4, 8, 13, 17, 21)
    use_temporal: bool = True
    joint_adjustment: Optional[Tuple[int, int]] = (0, 0)  # (joint, ee joint)
    joint_adjustment_weight: float = 1.0
    # ``(fn, weight)`` pairs, ``fn``: ConstraintContext → (B,); the weighted
    # sum joins the drag objective (``drag/constraints.py``)
    constraints: Tuple[Tuple[Any, float], ...] = ()


class DragModel(NamedTuple):
    """Model bundle.  In a :class:`DragEngine` the decoder is folded
    (``{"ws", "bs"}``) and ``temporal`` holds K2's packed weights."""

    decoder: Any
    encoder: Any
    temporal: Any
    mean_dqs: Any       # (J*8,)
    std_dqs: Any
    mean_disp: Any      # (3,)
    std_disp: Any
    means_latent: Any   # (L,)
    stds_latent: Any
    mask: Any           # (J,) or per lane (B, J), float 0/1
    weights: Any        # (J, 2) or per lane (B, J, 2) [pos, rot]


class FrameOutput(NamedTuple):
    pose: torch.Tensor        # (..., J*4) normalized, root = world rotation
    global_pos: torch.Tensor  # (..., 3)
    iterations: torch.Tensor  # (...) int32
    loss_pos: torch.Tensor
    loss_rot: torch.Tensor    # λ_rot applied
    latent: torch.Tensor      # (..., L) the latent the frame decoded from


class DragState(NamedTuple):
    """Recurrent state, batched: every leaf leads with B."""

    latent: torch.Tensor               # (B, L)
    global_pos: torch.Tensor           # (B, 3)
    global_rot: torch.Tensor           # (B, 4)
    latent_buffer: torch.Tensor        # (B, P, L)
    displacement_buffer: torch.Tensor  # (B, P, 3)
    heights_buffer: torch.Tensor       # (B, P, H)
    target_buffer: torch.Tensor        # (B, W+1, L)
    current_index: torch.Tensor        # (B,) int32


class _LossAux(NamedTuple):
    loss_pos: torch.Tensor
    loss_rot: torch.Tensor            # λ_rot applied
    world_displacement: torch.Tensor  # (B, 3)
    displacement: torch.Tensor        # (B, 3) root-space
    world_rotation: torch.Tensor      # (B, 4)
    positions: torch.Tensor           # (B, J, 3) relative to previous root
    pose: torch.Tensor                # (B, J*4) normalized decoder output


class _OptCarry(NamedTuple):
    latent: torch.Tensor
    m: torch.Tensor
    v: torch.Tensor
    t: torch.Tensor            # (B,) int32
    prev_loss: torch.Tensor
    loss_pos: torch.Tensor
    loss_rot: torch.Tensor
    loss_incr: torch.Tensor
    decoded_latent: torch.Tensor   # latent that produced `aux` (pre-step)
    aux: _LossAux


_ADAM_B1, _ADAM_B2, _ADAM_EPS = 0.9, 0.999, 1e-8


def _quat_stats(model: DragModel):
    return vae.quat_stats(model.mean_dqs, model.std_dqs)


def init_state(model: DragModel, statics: vae.VAEStatics, hyper: DragHyper,
               generator: torch.Generator, initial_pose, initial_global_pos,
               initial_global_rot, initial_heights, noise=None) -> DragState:
    """Encode the initial poses (B, J*8, T) to seed the latents and tile the
    ring buffers (reference ``drag_pose.py:47-64``).  ``noise`` (B, L)
    replaces the draw from ``generator`` when given."""
    mu, logvar = vae.encode(model.encoder, statics, initial_pose)
    latent = vae.reparameterize(generator, mu, logvar, noise)
    B, L = latent.shape
    past_size = hyper.past_frames[-1] + hyper.sample_step
    zeros = lambda *s: torch.zeros(s, device=latent.device)  # noqa: E731
    return DragState(
        latent=latent,
        global_pos=initial_global_pos,
        global_rot=initial_global_rot,
        latent_buffer=latent[:, None].repeat(1, past_size, 1),
        displacement_buffer=zeros(B, past_size, 3),
        heights_buffer=initial_heights[:, None].repeat(1, past_size, 1),
        target_buffer=zeros(B, hyper.temporal_future_window + 1, L),
        current_index=torch.zeros(B, dtype=torch.int32, device=latent.device),
    )


# ---------------------------------------------------------------------------
# Temporal rollout
# ---------------------------------------------------------------------------

def _hold_index(window: int, step: int) -> np.ndarray:
    """Target-buffer slot → rollout prediction index (constant hold):
    slot ``k`` holds prediction ``min(k//step + 1, window//step)``."""
    if window == 0:
        return np.zeros(1, dtype=np.int64)
    return np.minimum(np.arange(window + 1) // step + 1, window // step)


def _temporal_rollout_core_T(model: DragModel, hyper: DragHyper, tparam,
                             lat, disp_acc, heights, token0):
    """Autoregressive prediction of the next ``window+1`` latents, whole
    batch.  ``lat`` (B, P-1, L) raw buffer rows, ``disp_acc`` (B, P-1, 3),
    ``heights`` (B, P-1, H), ``token0`` (B, L) → (B, W+1, L).  Each
    autoregressive step is one call of K2 (``temporal_fused.forward``)."""
    step = hyper.sample_step
    B, latent_dim = token0.shape
    lat = (lat - model.means_latent) / model.stds_latent
    enc_in = torch.cat((lat, disp_acc, heights), dim=-1).contiguous()
    n_steps = hyper.temporal_future_window // step + 1
    longest = temporal_fused.max_sequence(model.temporal)
    if n_steps > longest:
        raise ValueError(
            f"temporal_future_window {hyper.temporal_future_window} takes "
            f"{n_steps} decoder steps; the temporal model's positional "
            f"encoding has {longest} rows (window ≤ {longest * step - 1})")
    tokens = torch.zeros(B, n_steps, latent_dim, device=token0.device)
    tokens[:, 0] = (token0 - model.means_latent) / model.stds_latent
    outs = torch.zeros_like(tokens)
    cols = torch.arange(n_steps, device=token0.device)
    for k in range(n_steps):
        mask = torch.where(cols <= k, 0.0, float("-inf"))[None].contiguous()
        pred = temporal_fused.forward(model.temporal, tparam, enc_in,
                                      tokens, mask)
        out_k = pred[:, k]
        if k + 1 < n_steps:
            tokens[:, k + 1] = out_k
        outs[:, k] = out_k
    outs = outs * model.stds_latent + model.means_latent
    hold = torch.as_tensor(_hold_index(hyper.temporal_future_window, step),
                           device=token0.device)
    return outs[:, hold]


def rollout_lane_budget(batch: int, window: int) -> int:
    """Sub-batch size above which :func:`_rollout_where_needed` runs the
    whole batch: ~B/W lanes cross a window boundary per frame, 2× that
    rounded up to 8.  window ≤ 1 returns ``batch``."""
    per_frame = max(1, (batch * 2 + window - 1) // max(window, 1))
    r = ((per_frame + 7) // 8) * 8
    return min(batch, max(r, 8))


def _rollout_where_needed(model: DragModel, hyper: DragHyper, tparam,
                          lat, disp_acc, heights, token0, need,
                          target_buffer, frame=None, limit=None):
    """Run the rollout only where ``need`` and return ``target_buffer`` with
    those lanes' rows replaced.  At window 0 the budget is the whole batch,
    so this is one full-batch rollout and a select, as in the JAX package.
    For windowed configs the needing lanes (≤ budget) are gathered into a
    sub-batch; the per-lane arithmetic of K2 does not depend on the other
    lanes, so the result equals the full-batch one.  ``frame`` and
    ``limit`` (B,), where given, are only logged (``ROLLOUTS``): a needing
    lane begins a real frame where ``frame < limit``."""
    B = token0.shape[0]
    r = rollout_lane_budget(B, hyper.temporal_future_window)
    if r < B:
        with span("dragposer.rollout.wait"):
            idx = torch.nonzero(need).flatten()
            n = int(idx.numel())
        if n == 0:
            return target_buffer
        if n <= r:
            with span("dragposer.rollout"):
                ROLLOUTS.launched(lanes=n, need=need, frame=frame,
                                  limit=limit)
                sub = _temporal_rollout_core_T(
                    model, hyper, tparam, lat[idx], disp_acc[idx],
                    heights[idx], token0[idx])
                out = target_buffer.clone()
                out[idx] = sub
                return out
    with span("dragposer.rollout"):
        ROLLOUTS.launched(lanes=B, need=need, frame=frame, limit=limit)
        new_buffer = _temporal_rollout_core_T(model, hyper, tparam, lat,
                                              disp_acc, heights, token0)
        return torch.where(need[:, None, None], new_buffer, target_buffer)


def _rollout_inputs(state: DragState, hyper: DragHyper):
    """The predictor's inputs from the (B, P, ·) ring buffers: sampled
    latents (B, P'-1, L), accumulated displacements (B, P'-1, 3), heights
    (B, P'-1, H) and the newest sampled latent (B, L)."""
    past = torch.as_tensor(hyper.past_frames, device=state.latent.device)
    step = hyper.sample_step
    latp = state.latent_buffer[:, past]
    acc = past[:-1, None] + torch.arange(step, device=past.device)[None]
    disp_acc = state.displacement_buffer[:, acc].sum(dim=2)
    heights = state.heights_buffer[:, past[:-1]]
    return latp[:, :-1], disp_acc, heights, latp[:, -1]


def _temporal_rollout(model: DragModel, hyper: DragHyper, tparam,
                      state: DragState):
    """The new target buffer (B, W+1, L) of every lane.  The JAX anchor's
    per-lane ``_temporal_rollout_core`` runs the rows forward; its batched
    counterpart here is :func:`_temporal_rollout_core_T`, K2 on a CUDA
    tensor, with the same visibility mask."""
    return _temporal_rollout_core_T(model, hyper, tparam,
                                    *_rollout_inputs(state, hyper))


def _begin_frame(model: DragModel, hyper: DragHyper, tparam,
                 state: DragState):
    """Start-of-frame work (reference ``drag_pose.py:256-295``): the
    rollout for the lanes at a window boundary (``current_index == 0``;
    every frame at window 0), then each lane's temporal target.  Returns
    ``(target_buffer (B, W+1, L), target_latent (B, L))``.  For windowed
    configs a frame where no lane is at a boundary runs no rollout (a host
    check, as the JAX anchor's ``lax.cond``)."""
    if not hyper.use_temporal:
        return state.target_buffer, torch.zeros_like(state.latent)
    with span("dragposer.frame.begin"):
        need = state.current_index == 0
        run = hyper.temporal_future_window == 0
        if not run:
            with span("dragposer.frame.begin.wait"):
                run = bool(need.any())
        if run:
            target_buffer = _rollout_where_needed(
                model, hyper, tparam, *_rollout_inputs(state, hyper), need,
                state.target_buffer)
        else:
            target_buffer = state.target_buffer
        ar = torch.arange(state.latent.shape[0], device=state.latent.device)
        return target_buffer, target_buffer[ar, state.current_index.long()]


# ---------------------------------------------------------------------------
# The per-frame loss (differentiated with respect to the latent)
# ---------------------------------------------------------------------------

class ConstraintContext(NamedTuple):
    """What a constraint loss may read, batched.  ``positions``/``rotmats``
    are world-oriented with the previous frame's root as origin;
    ``positions + global_pos[:, None]`` is world space."""

    latent: torch.Tensor       # (B, L) the optimized variable
    pose: torch.Tensor         # (B, J*4) normalized decoder output
    positions: torch.Tensor    # (B, J, 3) FK positions, previous root = origin
    world_quats: torch.Tensor  # (B, J, 4) world joint rotations
    rotmats: torch.Tensor      # (B, J, 3, 3)
    global_pos: torch.Tensor   # (B, 3) previous frame's global root position
    world_displacement: torch.Tensor  # (B, 3) this frame's root displacement


def _is_folded(decoder) -> bool:
    return isinstance(decoder, dict) and "ws" in decoder


def _decode(model: DragModel, statics, latent):
    """latent (..., L) → (pose_n (..., J*4), normalized displacement
    (..., 3)) through the folded decoder, or the unfolded one
    (``vae.decode``) when the model carries its parameter tree."""
    if _is_folded(model.decoder):
        return vae.decode_folded_flat(model.decoder, latent, model.mean_dqs,
                                      model.std_dqs)
    lead = latent.shape[:-1]
    pose_n, disp_n = vae.decode(model.decoder, statics,
                                latent.reshape(-1, latent.shape[-1]),
                                model.mean_dqs, model.std_dqs)
    return (pose_n[..., 0].reshape(lead + (-1,)),
            disp_n[..., 0].reshape(lead + (-1,)))


def _drag_loss(latent, model: DragModel, statics, skeleton: Skeleton,
               hyper: DragHyper, global_pos, global_rot, target_ee_pos,
               target_ee_rot, target_latent):
    """Reference ``DragPose.loss`` (``drag_pose.py:66-194``), dense-masked,
    per lane: latent (B, L), global_pos (B, 3), global_rot (B, 4), targets
    (B, J, 3) and (B, J, 3, 3), target_latent (B, L) → (total (B,),
    :class:`_LossAux`).  Lanes are independent, so the gradient of
    ``total.sum()`` is each lane's own."""
    mean_q, std_q = _quat_stats(model)
    pose_n, disp_n = _decode(model, statics, latent)
    disp = disp_n * model.std_disp + model.mean_disp
    qs = (pose_n * std_q + mean_q).unflatten(-1, (-1, 4))

    world_rotation = quat.mul(global_rot, qs[:, 0])     # incremental → world
    rs = torch.cat((world_rotation[:, None], qs[:, 1:]), dim=1)
    world_displacement = quat.mul_vec(world_rotation, disp)
    positions, world_quats = fk.fk_root_space(rs, world_displacement,
                                              skeleton)
    rotmats = quat.to_matrix(world_quats)

    mask = model.mask                                   # (J,) or (B, J)
    n_ee = torch.clamp(mask.sum(dim=-1), min=1.0)
    w_pos = mask * model.weights[..., 0]
    w_rot = mask * model.weights[..., 1]
    loss_pos = torch.sum(w_pos[..., None] * (positions - target_ee_pos) ** 2,
                         dim=(-2, -1)) / (n_ee * 3.0)
    loss_rot = torch.sum(w_rot[..., None, None]
                         * (rotmats - target_ee_rot) ** 2,
                         dim=(-3, -2, -1)) / (n_ee * 9.0)
    loss_temporal = torch.mean((latent - target_latent) ** 2, dim=-1)

    loss_rot = loss_rot * hyper.lambda_rot
    lam_t = hyper.lambda_temporal if hyper.use_temporal else 0.0
    total = loss_pos + loss_rot + loss_temporal * lam_t
    if hyper.constraints:
        ctx = ConstraintContext(
            latent=latent, pose=pose_n, positions=positions,
            world_quats=world_quats, rotmats=rotmats, global_pos=global_pos,
            world_displacement=world_displacement)
        for fn, weight in hyper.constraints:
            total = total + weight * fn(ctx)
    aux = _LossAux(loss_pos=loss_pos, loss_rot=loss_rot,
                   world_displacement=world_displacement, displacement=disp,
                   world_rotation=world_rotation, positions=positions,
                   pose=pose_n)
    return total, aux


# ---------------------------------------------------------------------------
# Optimizer bookkeeping and the end of a frame
# ---------------------------------------------------------------------------

def _select(mask, new, old):
    """Per-lane select over NamedTuples whose leaves lead with B."""
    def sel(n, o):
        if isinstance(n, tuple):
            return type(n)(*[sel(a, b) for a, b in zip(n, o)])
        return torch.where(mask.reshape(mask.shape + (1,) * (n.dim() - 1)),
                           n, o)
    return sel(new, old)


def _opt_cond(c: _OptCarry, hyper: DragHyper):
    """The reference stop rule on the previous iteration's values."""
    return (((c.loss_pos > hyper.stop_eps_pos)
             | (c.loss_rot > hyper.stop_eps_rot))
            & (c.t < hyper.max_iter)
            & (c.loss_incr > hyper.min_loss_incr))


def _opt_init(latent0, n_joints: int) -> _OptCarry:
    """Fresh Adam state for a batch of frames (B, L)."""
    B = latent0.shape[0]
    dev = latent0.device
    full = lambda v: torch.full((B,), v, device=dev)  # noqa: E731
    zeros = lambda *s: torch.zeros((B,) + s, device=dev)  # noqa: E731
    world_rotation = zeros(4)
    world_rotation[:, 0] = 1.0
    return _OptCarry(
        latent=latent0, m=torch.zeros_like(latent0),
        v=torch.zeros_like(latent0),
        t=torch.zeros(B, dtype=torch.int32, device=dev),
        prev_loss=full(1e7), loss_pos=full(float("inf")),
        loss_rot=full(float("inf")), loss_incr=full(1.0),
        decoded_latent=latent0,
        aux=_LossAux(
            loss_pos=full(float("inf")), loss_rot=full(float("inf")),
            world_displacement=zeros(3), displacement=zeros(3),
            world_rotation=world_rotation,
            positions=zeros(n_joints, 3), pose=zeros(n_joints * 4)),
    )


def _opt_body(c: _OptCarry, model: DragModel, statics, skeleton: Skeleton,
              hyper: DragHyper, global_pos, global_rot, target_ee_pos,
              target_ee_rot, target_latent) -> _OptCarry:
    """One Adam iteration on every lane's latent (loss, autograd gradient,
    update); the caller masks the lanes whose stop rule is false."""
    with torch.enable_grad():
        z = c.latent.detach().requires_grad_(True)
        total, aux = _drag_loss(z, model, statics, skeleton, hyper,
                                global_pos, global_rot, target_ee_pos,
                                target_ee_rot, target_latent)
        (g,) = torch.autograd.grad(total.sum(), z)
    total = total.detach()
    aux = _LossAux(*[a.detach() for a in aux])
    t = c.t + 1
    m = _ADAM_B1 * c.m + (1.0 - _ADAM_B1) * g
    v = _ADAM_B2 * c.v + (1.0 - _ADAM_B2) * g * g
    tf = t.to(torch.float32)
    m_hat = m / (1.0 - _ADAM_B1 ** tf)[:, None]
    v_hat = v / (1.0 - _ADAM_B2 ** tf)[:, None]
    latent = c.latent - hyper.learning_rate * m_hat / (torch.sqrt(v_hat)
                                                       + _ADAM_EPS)
    return _OptCarry(latent=latent, m=m, v=v, t=t, prev_loss=total,
                     loss_pos=aux.loss_pos, loss_rot=aux.loss_rot,
                     loss_incr=c.prev_loss - total, decoded_latent=c.latent,
                     aux=aux)


def _optimize(latent0, model: DragModel, statics, skeleton: Skeleton,
              hyper: DragHyper, global_pos, global_rot, target_ee_pos,
              target_ee_rot, target_latent) -> _OptCarry:
    """Fresh Adam from ``latent0`` (B, L) until no lane's stop rule holds.
    Lanes whose rule is false keep their carry; the loop's end is a host
    check of the rule once per iteration."""
    c = _opt_init(latent0, skeleton.n_joints)
    while True:
        with span("dragposer.anchor.wait"):
            active = _opt_cond(c, hyper)
            if not bool(active.any()):
                return c
        with span("dragposer.anchor.step"):
            new = _opt_body(c, model, statics, skeleton, hyper, global_pos,
                            global_rot, target_ee_pos, target_ee_rot,
                            target_latent)
            c = _select(active, new, c)


def _advance_core(model: DragModel, hyper: DragHyper, state_global_pos,
                  state_current_index, final: _OptCarry, adj_target):
    """End-of-frame math (reference ``drag_pose.py:306-395``): global
    transform advance, joint adjustment, heights row, output pose.
    ``adj_target`` (B, 3) is the world target of the adjustment end
    effector.  Returns ``(global_pos, global_rot, displacement, heights,
    current_index, FrameOutput)``."""
    mean_q, std_q = _quat_stats(model)
    aux = final.aux
    global_pos = state_global_pos + aux.world_displacement
    global_rot = aux.world_rotation
    displacement = aux.displacement
    if hyper.joint_adjustment is not None:
        joint_idx, _ = hyper.joint_adjustment
        adjustment = ((adj_target - aux.positions[:, joint_idx])
                      * hyper.joint_adjustment_weight)
        global_pos = global_pos + adjustment
        displacement = displacement + adjustment
    hidx = torch.as_tensor(hyper.height_indices, device=global_pos.device)
    heights = (aux.positions + global_pos[:, None, :])[:, hidx, 1]
    if hyper.temporal_future_window == 0:
        current_index = torch.zeros_like(state_current_index)
    else:
        current_index = ((state_current_index + 1)
                         % hyper.temporal_future_window)
    pose_out = torch.cat(((global_rot - mean_q[:4]) / std_q[:4],
                          aux.pose[:, 4:]), dim=-1)
    out = FrameOutput(pose=pose_out, global_pos=global_pos,
                      iterations=final.t, loss_pos=final.loss_pos,
                      loss_rot=final.loss_rot, latent=final.decoded_latent)
    return global_pos, global_rot, displacement, heights, current_index, out


def _finish_frame(model: DragModel, hyper: DragHyper, state: DragState,
                  final: _OptCarry, target_buffer, target_ee_pos):
    """End-of-frame work on the (B, P, ·) ring buffers: advance, then
    shift each buffer by one row."""
    with span("dragposer.frame.finish"):
        B = state.latent.shape[0]
        adj = (target_ee_pos[:, hyper.joint_adjustment[1]]
               if hyper.joint_adjustment is not None
               else torch.zeros(B, 3, device=state.latent.device))
        global_pos, global_rot, displacement, heights, current_index, \
            out = _advance_core(model, hyper, state.global_pos,
                                state.current_index, final, adj)

        def shift(buf, row):
            return torch.cat((buf[:, 1:], row[:, None]), dim=1)

        new_state = DragState(
            latent=final.latent, global_pos=global_pos,
            global_rot=global_rot,
            latent_buffer=shift(state.latent_buffer, final.decoded_latent),
            displacement_buffer=shift(state.displacement_buffer,
                                      displacement),
            heights_buffer=shift(state.heights_buffer, heights),
            target_buffer=target_buffer, current_index=current_index)
        return new_state, out

def frame_step(model: DragModel, statics, skeleton: Skeleton,
               hyper: DragHyper, tparam, state: DragState, target_ee_pos,
               target_ee_rot):
    """One frame of drag optimization on every lane (reference
    ``DragPose.run``): targets (B, J, 3) (any value at inactive joints)
    and (B, J, 3, 3) → ``(new state, FrameOutput)``."""
    target_buffer, target_latent = _begin_frame(model, hyper, tparam, state)
    final = _optimize(state.latent, model, statics, skeleton, hyper,
                      state.global_pos, state.global_rot, target_ee_pos,
                      target_ee_rot, target_latent)
    return _finish_frame(model, hyper, state, final, target_buffer,
                         target_ee_pos)


def _eval_targets(model: DragModel, skeleton: Skeleton, state,
                  dqs_norm, gt_global_pos, gt_global_rot):
    """End-effector targets from ground truth (reference
    ``eval_drag.py:164-202``): dqs_norm (B, J*8), gt_global_pos (B, 3),
    gt_global_rot (B, 4) → ((B, J, 3), (B, J, 3, 3)).  Reads
    ``state.global_pos`` only."""
    mean_q, std_q = _quat_stats(model)
    B = dqs_norm.shape[0]
    qs = (dqs_norm.reshape(B, -1, 8)[..., :4] * std_q.reshape(-1, 4)
          + mean_q.reshape(-1, 4))
    rs = torch.cat((gt_global_rot[:, None], qs[:, 1:]), dim=1)
    positions, world_quats = fk.fk_root_space(
        rs, gt_global_pos - state.global_pos, skeleton)
    return positions, quat.to_matrix(world_quats)


def eval_frame_step(model, statics, skeleton, hyper, tparam, state,
                    frame_inputs):
    dqs_norm, gt_pos, gt_rot = frame_inputs
    tpos, trot = _eval_targets(model, skeleton, state, dqs_norm, gt_pos,
                               gt_rot)
    return frame_step(model, statics, skeleton, hyper, tparam, state, tpos,
                      trot)


def run_sequence(model, statics, skeleton, hyper: DragHyper, tparam,
                 state: DragState, dqs_norm, gt_pos, gt_rot):
    """Reconstruct every lane's sequence, frame by frame: dqs_norm
    (B, T, J*8), gt_pos (B, T, 3), gt_rot (B, T, 4) → (final state,
    FrameOutput with leaves (B, T, ...))."""
    outs = []
    for f in range(dqs_norm.shape[1]):
        state, out = eval_frame_step(
            model, statics, skeleton, hyper, tparam, state,
            (dqs_norm[:, f], gt_pos[:, f], gt_rot[:, f]))
        outs.append(out)
    return state, FrameOutput(*[torch.stack(x, dim=1) for x in zip(*outs)])


def to_host(out: FrameOutput) -> FrameOutput:
    """``out``'s leaves as numpy arrays (waits for the device)."""
    with span("dragposer.to_host"), span("dragposer.to_host.wait"):
        return FrameOutput(*[x.cpu().numpy() if torch.is_tensor(x) else x
                             for x in out])


def _lead(tree):
    """Add the lane axis to every leaf."""
    return type(tree)(*[x[None] for x in tree])


def _lane(tree):
    """Drop the lane axis (of size 1) from every leaf."""
    return type(tree)(*[x[0] for x in tree])


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------

def _on_device(model: DragModel, statics, tparam, device) -> DragModel:
    """Fold the decoder, pack the temporal weights for K2 and move every
    array to ``device`` (leaves may be numpy or the JAX package's arrays)."""
    dec = model.decoder
    if isinstance(dec, dict) and "ws" in dec:
        dec = loading.tree_to_torch(dec, device)
    else:
        dec = vae.fold_decoder(dec, statics, device)
    temporal = model.temporal
    if temporal is not None and "pe" not in temporal:
        temporal = temporal_fused.pack_params(temporal, tparam, device)
    arr = lambda a: loading.tree_to_torch(a, device)  # noqa: E731
    return DragModel(
        decoder=dec, encoder=arr(model.encoder), temporal=temporal,
        mean_dqs=arr(model.mean_dqs), std_dqs=arr(model.std_dqs),
        mean_disp=arr(model.mean_disp), std_disp=arr(model.std_disp),
        means_latent=arr(model.means_latent),
        stds_latent=arr(model.stds_latent),
        mask=arr(model.mask), weights=arr(model.weights),
    )


class DragEngine:
    """Drag runtime for a fixed (skeleton, hyper, temporal config) on one
    device (``cuda`` unless ``device="cpu"``).

    * ``init_state(generator, poses, gp, gr, heights)`` — batched encode;
    * ``run(state, dqs, gp, gr)`` — the anchor over one sequence: state
      leaves without the lane axis, inputs (T, ...);
    * ``run_batch(states, dqs, gp, gr)`` — the same on a batch (B, T, ...);
    * ``step(state, tpos, trot)`` — one frame of one lane from dense targets
      (J, 3) and (J, 3, 3);
    * ``step_realtime(state, tpos, trot_quats)`` — ``step`` from quaternion
      targets (J, 4), returning parent-local quaternions (J, 4) and the
      global root position (3,);
    * ``run_batch_pipelined(states, dqs, gp, gr, sync_k, lengths, fast)`` —
      the pipelined batched reconstruction (``drag/pipeline.py``).
    """

    def __init__(self, model: DragModel, statics, skeleton: Skeleton,
                 hyper: DragHyper, tparam, device=None):
        self.device = resolve_device(device)
        self.model = _on_device(model, statics, tparam, self.device)
        self.statics = statics
        self.skeleton = skeleton
        self.hyper = hyper
        self.tparam = tparam
        self._replica_models = {}

    def replica(self, device) -> "DragEngine":
        """The same engine on another device: every model tensor (the
        folded decoder, K2's packed weights, the statistics) copied there
        once for this engine's model, and kept; the hyperparameters are
        this engine's at the call.  The data-parallel eval runs one a
        device."""
        new = copy.copy(self)
        new.device = resolve_device(device)
        src, model = self._replica_models.get(new.device, (None, None))
        if src is not self.model:
            model = map_tree(lambda x: x.to(new.device) if torch.is_tensor(x)
                             else x, self.model)
            self._replica_models[new.device] = (self.model, model)
        new.model = model
        new._replica_models = {}
        return new

    def tensor(self, a, dtype=torch.float32):
        if torch.is_tensor(a):
            return a.to(device=self.device, dtype=dtype)
        return torch.as_tensor(np.array(a), dtype=dtype, device=self.device)

    def on_device(self, state: DragState) -> DragState:
        """``state``'s leaves (tensors, numpy or the JAX package's arrays)
        on this engine's device, floats as float32."""
        def leaf(a):
            a = a if torch.is_tensor(a) else torch.as_tensor(np.array(a))
            return a.to(self.device, torch.float32 if a.is_floating_point()
                        else a.dtype)
        return DragState(*[leaf(a) for a in state])

    def init_state(self, generator: torch.Generator, initial_pose,
                   initial_global_pos, initial_global_rot,
                   initial_heights, noise=None) -> DragState:
        t = self.tensor
        return init_state(self.model, self.statics, self.hyper, generator,
                          t(initial_pose), t(initial_global_pos),
                          t(initial_global_rot), t(initial_heights),
                          None if noise is None else t(noise))

    def run_batch(self, states: DragState, dqs_norm, gt_pos, gt_rot):
        t = self.tensor
        return run_sequence(self.model, self.statics, self.skeleton,
                            self.hyper, self.tparam, self.on_device(states),
                            t(dqs_norm), t(gt_pos), t(gt_rot))

    def run(self, state: DragState, dqs_norm, gt_pos, gt_rot):
        t = self.tensor
        new, out = self.run_batch(_lead(self.on_device(state)),
                                  t(dqs_norm)[None], t(gt_pos)[None],
                                  t(gt_rot)[None])
        return _lane(new), _lane(out)

    def step(self, state: DragState, target_ee_pos, target_ee_rot):
        t = self.tensor
        new, out = frame_step(self.model, self.statics, self.skeleton,
                              self.hyper, self.tparam,
                              _lead(self.on_device(state)),
                              t(target_ee_pos)[None], t(target_ee_rot)[None])
        return _lane(new), _lane(out)

    def step_realtime(self, state: DragState, target_ee_pos,
                      target_ee_rot_quats):
        new, out = self.step(state, target_ee_pos, quat.to_matrix(
            self.tensor(target_ee_rot_quats)))
        with span("dragposer.frame.reply"):
            mean_q, std_q = _quat_stats(self.model)
            rs = (out.pose * std_q + mean_q).reshape(-1, 4)
            return new, fk.from_root_quat(rs, self.skeleton), out.global_pos

    def run_batch_pipelined(self, states: DragState, dqs_norm, gt_pos,
                            gt_rot, sync_k: int = 24, lengths=None,
                            fast: Optional[bool] = None):
        from dragposer_tpu_torch.drag import pipeline

        t = self.tensor
        if lengths is not None:
            lengths = t(lengths, torch.int32)
        return pipeline.run_batch_pipelined(
            self.model, self.statics, self.skeleton, self.hyper, self.tparam,
            states, t(dqs_norm), t(gt_pos), t(gt_rot), sync_k=sync_k,
            lengths=lengths, fast=fast)
