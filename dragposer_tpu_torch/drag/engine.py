"""The drag runtime's types and per-frame building blocks, the parts the
batched pipelined path uses (port of ``dragposer_tpu/drag/engine.py``).

Every function here works on a batch: leaves lead with the lane axis
``B`` (the JAX package writes them per lane and ``vmap``s them).  The
reference behaviours the JAX module lists hold here too:

* a fresh Adam state every frame;
* the stop rule ``(loss_pos > εp or loss_rot > εr) and iters < max_iter and
  loss_incr > min_incr`` on the previous iteration's values;
* the ring buffers record the latent *before* the final Adam step;
* the temporal rollout's mask is a per-step *visibility* mask (all rows see
  columns ≤ k), not a causal mask;
* the rollout "upsample" is a constant hold (:func:`_hold_index`);
* the joint adjustment moves the root toward the target end effector and
  adds the same world-space correction to the root-space displacement;
* heights add the already-advanced global position to FK positions that
  are relative to the previous root (component index 1).

Not ported yet: the per-lane anchor (``_drag_loss``, ``_opt_body``,
``run_sequence``, ``step``) and constraints.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch

from dragposer_tpu_torch._device import resolve_device
from dragposer_tpu_torch.models import loading, vae
from dragposer_tpu_torch.ops import temporal_fused
from dragposer_tpu_torch.ops.topology import Skeleton


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
    constraints: Tuple[Tuple[Any, float], ...] = ()  # not ported: must be ()


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
               initial_global_rot, initial_heights) -> DragState:
    """Encode the initial poses (B, J*8, T) to seed the latents and tile the
    ring buffers (reference ``drag_pose.py:47-64``)."""
    mu, logvar = vae.encode(model.encoder, statics, initial_pose)
    latent = vae.reparameterize(generator, mu, logvar)
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
                          target_buffer):
    """Run the rollout only where ``need`` and return ``target_buffer`` with
    those lanes' rows replaced.  At window 0 the budget is the whole batch,
    so this is one full-batch rollout and a select, as in the JAX package.
    For windowed configs the needing lanes (≤ budget) are gathered into a
    sub-batch; the per-lane arithmetic of K2 does not depend on the other
    lanes, so the result equals the full-batch one."""
    B = token0.shape[0]
    r = rollout_lane_budget(B, hyper.temporal_future_window)
    if r < B:
        idx = torch.nonzero(need).flatten()
        n = int(idx.numel())
        if n == 0:
            return target_buffer
        if n <= r:
            sub = _temporal_rollout_core_T(model, hyper, tparam, lat[idx],
                                           disp_acc[idx], heights[idx],
                                           token0[idx])
            out = target_buffer.clone()
            out[idx] = sub
            return out
    new_buffer = _temporal_rollout_core_T(model, hyper, tparam, lat,
                                          disp_acc, heights, token0)
    return torch.where(need[:, None, None], new_buffer, target_buffer)


# ---------------------------------------------------------------------------
# Optimizer bookkeeping and the end of a frame
# ---------------------------------------------------------------------------

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
    * ``run_batch_pipelined(states, dqs, gp, gr, sync_k, lengths)`` — the
      pipelined batched reconstruction (``drag/pipeline.py``).
    """

    def __init__(self, model: DragModel, statics, skeleton: Skeleton,
                 hyper: DragHyper, tparam, device=None):
        self.device = resolve_device(device)
        self.model = _on_device(model, statics, tparam, self.device)
        self.statics = statics
        self.skeleton = skeleton
        self.hyper = hyper
        self.tparam = tparam

    def tensor(self, a, dtype=torch.float32):
        if torch.is_tensor(a):
            return a.to(device=self.device, dtype=dtype)
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    def init_state(self, generator: torch.Generator, initial_pose,
                   initial_global_pos, initial_global_rot,
                   initial_heights) -> DragState:
        t = self.tensor
        return init_state(self.model, self.statics, self.hyper, generator,
                          t(initial_pose), t(initial_global_pos),
                          t(initial_global_rot), t(initial_heights))

    def run_batch_pipelined(self, states: DragState, dqs_norm, gt_pos,
                            gt_rot, sync_k: int = 24, lengths=None):
        from dragposer_tpu_torch.drag import pipeline

        t = self.tensor
        if lengths is not None:
            lengths = t(lengths, torch.int32)
        return pipeline.run_batch_pipelined(
            self.model, self.statics, self.skeleton, self.hyper, self.tparam,
            states, t(dqs_norm), t(gt_pos), t(gt_rot), sync_k=sync_k,
            lengths=lengths)
