"""Pipelined batched drag reconstruction: sync-every-K decoupled lanes
(port of ``dragposer_tpu/drag/pipeline.py``).

One global iteration loop runs over the whole batch; each lane owns a frame
pointer.  Every ``sync_k`` Adam iterations (one launch of kernel K1), lanes
whose stop rule holds *finish* their frame (global-transform advance, ring
buffers, compact output write) and *begin* the next (temporal rollout with
kernel K2, ground-truth targets, fresh Adam).  A straggler frame in one
lane does not stall the others.  The pose is decoded once, after the loop,
from the stored per-frame latents.

The loop's ``any(frame < limit)`` is a host check once per block.  The
inner loop is K1 (the batch-in-lanes fast path) unless ``hyper.constraints``
is set or the decoder is unfolded: then each block runs up to ``sync_k``
masked iterations of the anchor's ``engine._opt_body`` (autograd, targets
per lane (B, J, ·)), ending early, by a host check an iteration, once no
lane is active (the JAX package's ``fast=False``).  K2 does the rollout in
both.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dragposer_tpu_torch.drag import engine as eng
from dragposer_tpu_torch.drag import fast_iter, iter_kernel


class _FlatState(NamedTuple):
    """``DragState`` with flattened ring buffers (B, P·C)."""

    latent: torch.Tensor
    global_pos: torch.Tensor
    global_rot: torch.Tensor
    latent_buffer: torch.Tensor
    displacement_buffer: torch.Tensor
    heights_buffer: torch.Tensor
    target_buffer: torch.Tensor
    current_index: torch.Tensor


def _flatten_state(s: eng.DragState) -> _FlatState:
    """Flat, contiguous copies (the kernels take contiguous inputs)."""
    B = s.latent.shape[0]
    c = lambda x: x.contiguous()  # noqa: E731
    return _FlatState(
        latent=c(s.latent), global_pos=c(s.global_pos),
        global_rot=c(s.global_rot),
        latent_buffer=c(s.latent_buffer.reshape(B, -1)),
        displacement_buffer=c(s.displacement_buffer.reshape(B, -1)),
        heights_buffer=c(s.heights_buffer.reshape(B, -1)),
        target_buffer=c(s.target_buffer),
        current_index=c(s.current_index))


def _unflatten_state(f: _FlatState, P: int) -> eng.DragState:
    B = f.latent.shape[0]
    return eng.DragState(
        latent=f.latent, global_pos=f.global_pos, global_rot=f.global_rot,
        latent_buffer=f.latent_buffer.reshape(B, P, -1),
        displacement_buffer=f.displacement_buffer.reshape(B, P, -1),
        heights_buffer=f.heights_buffer.reshape(B, P, -1),
        target_buffer=f.target_buffer, current_index=f.current_index)


def _write_rows(buf, frame, done, val):
    """``buf`` (B, T, ...) ← ``val`` (B, ...) at each lane's ``frame`` where
    ``done`` (a gather, a select and a scatter of B rows)."""
    ar = torch.arange(buf.shape[0], device=buf.device)
    m = done.reshape(done.shape + (1,) * (val.dim() - 1))
    buf[ar, frame] = torch.where(m, val.to(buf.dtype), buf[ar, frame])


def run_batch_pipelined(model: eng.DragModel, statics, skeleton,
                        hyper: eng.DragHyper, tparam,
                        states: eng.DragState, dqs_norm, gt_pos, gt_rot,
                        sync_k: int = 24, lengths=None,
                        fast: bool | None = None):
    """Batched reconstruction.  ``states`` batched; ``dqs_norm`` (B, T, J*8),
    ``gt_pos`` (B, T, 3), ``gt_rot`` (B, T, 4); ``lengths`` (B,) optional
    per-lane frame counts (lanes halt there; outputs beyond are zeros).
    ``fast`` picks the inner loop: K1 (``True``) or the per-lane anchor
    step (``False``); ``None`` takes K1 whenever it can (no constraints, a
    folded decoder), and ``True`` where it cannot raises.
    Returns (final states, FrameOutput with leaves (B, T, ...))."""
    eligible = not hyper.constraints and eng._is_folded(model.decoder)
    if fast is None:
        fast = eligible
    elif fast and not eligible:
        raise ValueError("the fast inner loop (K1) takes no constraints and "
                         "needs the folded decoder")
    dev = dqs_norm.device
    B, T = dqs_norm.shape[0], dqs_norm.shape[1]
    limit = torch.full((B,), T, dtype=torch.int32, device=dev)
    if lengths is not None:
        limit = torch.minimum(lengths.to(torch.int32), limit)
    if fast:
        ctx = fast_iter.make_context(model, skeleton, hyper)
        kctx = iter_kernel.make_kernel_context(ctx)
    L = states.latent.shape[-1]
    H = states.heights_buffer.shape[-1]
    P = states.latent_buffer.shape[1]
    ar = torch.arange(B, device=dev)

    # static gathers of the rollout inputs from the flat ring buffers
    past = np.asarray(hyper.past_frames)
    step = hyper.sample_step
    idx = lambda a: torch.as_tensor(np.asarray(a).ravel(), device=dev)  # noqa: E731
    idx_lat = idx(past[:, None] * L + np.arange(L)[None, :])
    acc = past[:-1, None] + np.arange(step)[None, :]
    idx_d = idx(acc[..., None] * 3 + np.arange(3))
    idx_h = idx(past[:-1, None] * H + np.arange(H)[None, :])

    def begin_all(s: _FlatState, began):
        if not hyper.use_temporal:
            return s.target_buffer, torch.zeros_like(s.latent)
        latp = s.latent_buffer[:, idx_lat].reshape(B, len(past), L)
        disp_acc = s.displacement_buffer[:, idx_d].reshape(
            B, len(past) - 1, step, 3).sum(dim=2)
        heights = s.heights_buffer[:, idx_h].reshape(B, len(past) - 1, H)
        tbuf = eng._rollout_where_needed(
            model, hyper, tparam, latp[:, :-1], disp_acc, heights,
            latp[:, -1], began & (s.current_index == 0), s.target_buffer)
        return tbuf, tbuf[ar, s.current_index.long()]

    def targets_all(s: _FlatState, f_idx):
        f = f_idx.long()
        frame_inputs = (dqs_norm[ar, f], gt_pos[ar, f], gt_rot[ar, f])
        if fast:    # planes (J, 3, B), (J, 3, 3, B)
            return fast_iter.eval_targets_T(ctx, hyper, s.global_pos,
                                            *frame_inputs)
        return eng._eval_targets(model, skeleton, s, *frame_inputs)

    def inner_loop(opt, lane_active, s: _FlatState, tpos, trot, tlat):
        if fast:
            return iter_kernel.run_block_fused(ctx, kctx, hyper, sync_k, opt,
                                               lane_active, s, tpos, trot,
                                               tlat)
        for _ in range(sync_k):
            active = eng._opt_cond(opt, hyper) & lane_active
            if not bool(active.any()):
                break
            new = eng._opt_body(opt, model, statics, skeleton, hyper,
                                s.global_pos, s.global_rot, tpos, trot, tlat)
            opt = eng._select(active, new, opt)
        return opt

    def finish(s: _FlatState, opt: eng._OptCarry, tbuf, adj):
        gp, gr, disp, heights, ci, _ = eng._advance_core(
            model, hyper, s.global_pos, s.current_index, opt, adj)
        return _FlatState(
            latent=opt.latent, global_pos=gp, global_rot=gr,
            latent_buffer=torch.cat((s.latent_buffer[:, L:],
                                     opt.decoded_latent), dim=1),
            displacement_buffer=torch.cat((s.displacement_buffer[:, 3:],
                                           disp), dim=1),
            heights_buffer=torch.cat((s.heights_buffer[:, H:], heights),
                                     dim=1),
            target_buffer=tbuf, current_index=ci)

    def adj_targets(tpos):
        if hyper.joint_adjustment is None:
            return torch.zeros(B, 3, device=dev)
        ee = hyper.joint_adjustment[1]
        return tpos[ee].T if fast else tpos[:, ee]

    # prologue: every lane begins frame 0
    state = _flatten_state(states)
    frame = torch.zeros(B, dtype=torch.int32, device=dev)
    tbuf, tlat = begin_all(state, torch.ones(B, dtype=torch.bool, device=dev))
    tpos, trot = targets_all(state, frame)
    opt = eng._opt_init(state.latent, skeleton.n_joints)
    outs = {
        "latent": torch.zeros(B, T, L, device=dev),
        "global_pos": torch.zeros(B, T, 3, device=dev),
        "global_rot": torch.zeros(B, T, 4, device=dev),
        "iterations": torch.zeros(B, T, dtype=torch.int32, device=dev),
        "loss_pos": torch.zeros(B, T, device=dev),
        "loss_rot": torch.zeros(B, T, device=dev),
    }

    # global loop: K masked Adam steps, then a sync point
    while bool((frame < limit).any()):
        lane_active = frame < limit
        opt = inner_loop(opt, lane_active, state, tpos, trot, tlat)
        done = ~eng._opt_cond(opt, hyper) & lane_active

        new_state = finish(state, opt, tbuf, adj_targets(tpos))
        state = eng._select(done, new_state, state)
        f_cl = torch.clamp(frame, max=T - 1).long()
        _write_rows(outs["latent"], f_cl, done, opt.decoded_latent)
        _write_rows(outs["global_pos"], f_cl, done, new_state.global_pos)
        _write_rows(outs["global_rot"], f_cl, done, new_state.global_rot)
        _write_rows(outs["iterations"], f_cl, done, opt.t)
        _write_rows(outs["loss_pos"], f_cl, done, opt.loss_pos)
        _write_rows(outs["loss_rot"], f_cl, done, opt.loss_rot)

        frame = frame + done.to(torch.int32)
        f_next = torch.clamp(frame, max=T - 1)
        # advanced lanes begin their next frame; others keep their values
        tbuf_new, tlat_new = begin_all(state, done)
        tbuf = eng._select(done, tbuf_new, tbuf)
        tlat = eng._select(done, tlat_new, tlat)
        tpos_new, trot_new = targets_all(state, f_next)
        if fast:    # the lane axis is the last
            tpos = torch.where(done[None, None, :], tpos_new, tpos)
            trot = torch.where(done[None, None, None, :], trot_new, trot)
        else:
            tpos = eng._select(done, tpos_new, tpos)
            trot = eng._select(done, trot_new, trot)
        opt = eng._select(done, eng._opt_init(state.latent,
                                              skeleton.n_joints), opt)

    # epilogue: one batched decode of the stored latents (plain matmuls)
    mean_q, std_q = eng._quat_stats(model)
    pose_n, _ = eng._decode(model, statics, outs["latent"].reshape(B * T, L))
    pose = pose_n.reshape(B, T, -1)
    root = (outs["global_rot"] - mean_q[:4]) / std_q[:4]
    pose = torch.cat((root, pose[..., 4:]), dim=-1)
    valid = (torch.arange(T, device=dev)[None, :] < limit[:, None])[..., None]
    out = eng.FrameOutput(
        pose=torch.where(valid, pose, 0.0),
        global_pos=outs["global_pos"], iterations=outs["iterations"],
        loss_pos=outs["loss_pos"], loss_rot=outs["loss_rot"],
        latent=torch.where(valid, outs["latent"], 0.0))
    return _unflatten_state(state, P), out
