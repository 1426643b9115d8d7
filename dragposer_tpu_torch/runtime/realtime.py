"""Embedded realtime API — the reference ``run_drag.RunDrag`` surface
(port of ``dragposer_tpu/runtime/realtime.py``).

Consumed by the socket server (``runtime/server.py``) and
``ClientDragPoser`` (``client/driver.py``).  Method for method as the
reference ``python/src/run_drag.py`` (same names, shapes and conventions):

* ``set_reference_skeleton(bvh_path) -> n_joints``
* ``load_models(model_dir)``
* ``set_mask_and_weights(mask (J,), weights (J,2)) -> n_end_effectors``
* ``init_drag_pose(initial_global_pos (1,3), initial_global_rot (1,4))``
* ``set_optim_params(stop_eps_pos, stop_eps_rot, max_iter, lr)``
* ``set_lambdas(lambda_rot, lambda_temporal, temporal_future_window)``
* ``set_global_pos(global_pos (1,3))``
* ``drag_pose(target_ee_pos (E,3), target_ee_rot (E,4), out_pose (J,4),
  out_global_pos (1,3))`` — writes parent-local wxyz quaternions.

A session runs on ``cuda`` unless it is given ``device="cpu"``.  Its frame
is ``DragEngine.step_realtime``: the per-lane anchor (autograd Adam), whose
temporal rollout is kernel K2 on the card.  On the card each Adam iteration
is one replay of the engine's CUDA graph of the iteration, captured in the
session's ``_prewarm``; on the CPU the anchor's eager loop runs
(``engine._optimize``).  The dense end-effector mask is data: a mask edit
writes the engine's mask tensors in place, seen by the next replay, and
only an actual change of the optimizer parameters or lambdas rebuilds the
engine (lazily, at the next frame), which captures anew.

:func:`make_batched_step` is the N-avatar frame of :class:`RealtimeBatch`
and of the daemon's coalesced ticks (:func:`make_coalesced_step`): the
rollout on K2 for the avatars at a window boundary, then the whole
optimizer budget in one launch of K1 (``iter_kernel.run_block_fused`` with
``sync_k = max_iter``).  On CPU tensors both run their plain twins.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from dragposer_tpu_torch import config as cfg
from dragposer_tpu_torch._device import resolve_device
from dragposer_tpu_torch.data import encoding
from dragposer_tpu_torch.drag import engine as eng
from dragposer_tpu_torch.drag import fast_iter, iter_kernel
from dragposer_tpu_torch.io.bvh import BVH
from dragposer_tpu_torch.models import loading, vae
from dragposer_tpu_torch.ops import fk, quat
from dragposer_tpu_torch.ops.topology import Skeleton
from dragposer_tpu_torch.tracing import span


class RealtimeSession:
    def __init__(self, log_path: Optional[str] = "log_python.txt",
                 device=None):
        self._log_path = log_path
        self.device = resolve_device(device)
        self.skeleton: Optional[Skeleton] = None
        self._engine: Optional[eng.DragEngine] = None
        self._engine_dirty = True
        self._state: Optional[eng.DragState] = None
        # realtime defaults (reference DragPoserDLL/main.cpp:28-29)
        self.stop_eps_pos = 1e-4
        self.stop_eps_rot = 0.01
        self.max_iter = 10
        self.learning_rate = 0.01
        self.lambda_rot = 1.0
        self.lambda_temporal = 0.02
        self.temporal_future_window = 60

    # ------------------------------------------------------------------
    def log(self, msg: str) -> None:
        if self._log_path:
            with open(self._log_path, "a") as f:
                f.write(f"[{time.strftime('%H:%M:%S')}] {msg}\n")

    # ------------------------------------------------------------------
    def set_reference_skeleton(self, bvh_path: str) -> int:
        bvh = BVH().load(bvh_path)
        _, _, parents, offsets, _ = encoding.info_from_bvh(bvh)
        self.skeleton = Skeleton.build(parents, offsets, bvh.names)
        self._skeleton_path = os.path.abspath(bvh_path)
        self._engine_dirty = True
        self.log(f"skeleton: {self.skeleton.n_joints} joints from {bvh_path}")
        return self.skeleton.n_joints

    def config_key(self):
        """Engine-configuration fingerprint: two sessions with equal keys run
        the same frame step and can be coalesced into one batched frame by
        the serving daemon (masks and weights are per-avatar data and not
        part of the key)."""
        return (getattr(self, "_skeleton_path", None),
                getattr(self, "_model_dir", None),
                self.stop_eps_pos, self.stop_eps_rot, self.max_iter,
                self.learning_rate, self.lambda_rot, self.lambda_temporal,
                self.temporal_future_window)

    def load_models(self, model_dir: str) -> None:
        if self.skeleton is None:
            raise RuntimeError("call set_reference_skeleton first")
        self._model_dir = os.path.abspath(model_dir)
        self._params, self._means, self._stds = loading.load_generator(
            model_dir, self.skeleton.parents, cfg.VAE_PARAM)
        temporal = loading.load_temporal(model_dir)
        if temporal is None:
            latent_dim = cfg.VAE_PARAM["latent_dim"]
            self._temporal = None
            self._means_latent = np.zeros(latent_dim, np.float32)
            self._stds_latent = np.ones(latent_dim, np.float32)
        else:
            self._temporal, self._means_latent, self._stds_latent = temporal
        self._statics = vae.build_statics(self.skeleton.parents, cfg.VAE_PARAM)
        self._engine_dirty = True
        self.log(f"models loaded from {model_dir} "
                 f"(temporal={'yes' if self._temporal is not None else 'no'})")

    def set_mask_and_weights(self, mask: np.ndarray, weights: np.ndarray) -> int:
        j = self.skeleton.n_joints
        mask = np.asarray(mask, np.float32).reshape(j)
        weights = np.asarray(weights, np.float32).reshape(j, 2)
        self._mask = mask
        self._weights = weights
        self._mask_indices = np.nonzero(mask)[0]
        # mask and weights are data: written into the built engine's
        # tensors in place, no rebuild
        if self._engine is not None and not self._engine_dirty:
            self._engine.model.mask.copy_(torch.as_tensor(mask))
            self._engine.model.weights.copy_(torch.as_tensor(weights))
        return int(len(self._mask_indices))

    def set_optim_params(self, stop_eps_pos: float, stop_eps_rot: float,
                         max_iter: int, lr: float) -> None:
        # Clients (reference DragPoser.cs:150-173) push params EVERY frame;
        # only an actual change may invalidate the engine.
        new = (float(stop_eps_pos), float(stop_eps_rot), int(max_iter),
               float(lr))
        old = (self.stop_eps_pos, self.stop_eps_rot, self.max_iter,
               self.learning_rate)
        (self.stop_eps_pos, self.stop_eps_rot, self.max_iter,
         self.learning_rate) = new
        if new != old:
            self._engine_dirty = True

    def set_lambdas(self, lambda_rot: float, lambda_temporal: float,
                    temporal_future_window: int) -> None:
        new = (float(lambda_rot), float(lambda_temporal),
               int(temporal_future_window))
        old = (self.lambda_rot, self.lambda_temporal,
               self.temporal_future_window)
        self.lambda_rot, self.lambda_temporal, self.temporal_future_window = new
        if new != old:
            self._engine_dirty = True

    # ------------------------------------------------------------------
    def _build_engine(self):
        model = eng.DragModel(
            decoder=self._params["decoder"],
            encoder=self._params["encoder"],
            temporal=self._temporal,
            mean_dqs=np.asarray(self._means["dqs"], np.float32),
            std_dqs=np.asarray(self._stds["dqs"], np.float32),
            mean_disp=np.asarray(self._means["displacement"], np.float32),
            std_disp=np.asarray(self._stds["displacement"], np.float32),
            means_latent=np.asarray(self._means_latent, np.float32),
            stds_latent=np.asarray(self._stds_latent, np.float32),
            mask=self._mask,
            weights=self._weights,
        )
        hyper = eng.DragHyper(
            max_iter=self.max_iter,
            stop_eps_pos=self.stop_eps_pos,
            stop_eps_rot=self.stop_eps_rot,
            learning_rate=self.learning_rate,
            lambda_rot=self.lambda_rot,
            lambda_temporal=self.lambda_temporal,
            temporal_future_window=self.temporal_future_window,
            sample_step=cfg.TEMPORAL_PARAM["sample_step"],
            past_frames=tuple(cfg.TEMPORAL_PARAM["past_frames"]),
            height_indices=tuple(cfg.HEIGHT_INDICES),
            use_temporal=self._temporal is not None,
            joint_adjustment=None,  # adjustment is done client-side (Unity)
        )
        self._engine = eng.DragEngine(model, self._statics, self.skeleton,
                                      hyper, cfg.TEMPORAL_PARAM,
                                      device=self.device)
        self._engine_dirty = False

    def _ensure_engine(self):
        if self._engine is None or self._engine_dirty:
            old_state = self._state
            self._build_engine()
            if old_state is not None:
                # resize the rollout buffer if the future window changed
                # (reference reallocates it to zeros, drag_pose.py:238-243)
                w = self.temporal_future_window + 1
                tb = old_state.target_buffer
                if tb.shape[0] != w:
                    tb = torch.zeros((w, tb.shape[1]), device=self.device)
                self._state = old_state._replace(
                    target_buffer=tb,
                    current_index=torch.zeros((), dtype=torch.int32,
                                              device=self.device))
                self._prewarm()

    # ------------------------------------------------------------------
    def init_drag_pose(self, initial_global_pos: np.ndarray,
                       initial_global_rot: np.ndarray,
                       seed: int = cfg.VAE_PARAM["seed"]) -> None:
        """Zero initial pose and heights, as the reference
        (run_drag.py:77-96).  ``seed`` seeds the ``torch.Generator`` of the
        initial-latent draw (its numbers differ from the JAX package's)."""
        self._ensure_engine()
        j = self.skeleton.n_joints
        initial_pose = np.zeros((1, j * 8, cfg.VAE_PARAM["window_size"]),
                                np.float32)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self._state = eng._lane(self._engine.init_state(
            gen, initial_pose,
            np.asarray(initial_global_pos, np.float32).reshape(1, 3),
            np.asarray(initial_global_rot, np.float32).reshape(1, 4),
            np.zeros((1, len(cfg.HEIGHT_INDICES)), np.float32)))
        self._prewarm()

    def _prewarm(self):
        """Run one whole ``drag_pose`` now and discard it, so that the
        client's first real frame runs at steady-state latency: kernel
        loading (and building, on a fresh checkout) and the capture of the
        anchor's graph land here.  The
        reference DLL sequence (main.cpp:10-41) calls init before the frame
        loop, so the pause lands where a model-load wait is expected."""
        j = self.skeleton.n_joints
        e = max(len(getattr(self, "_mask_indices", [0])), 1)
        t0 = time.time()
        saved = self._state
        try:
            rot = np.tile(np.asarray([1.0, 0, 0, 0], np.float32), (e, 1))
            self.drag_pose(np.zeros((e, 3), np.float32), rot,
                           np.zeros((j, 4), np.float32),
                           np.zeros((1, 3), np.float32))
        finally:
            self._state = saved
        self.log(f"prewarm: one frame in {time.time() - t0:.2f}s")

    def set_global_pos(self, global_pos: np.ndarray) -> None:
        self._state = self._state._replace(
            global_pos=self._engine.tensor(
                np.asarray(global_pos, np.float32).reshape(3)))

    def make_batch(self, n_avatars: int) -> "RealtimeBatch":
        """Promote this session's configuration to an N-avatar batch
        (shared skeleton, model and optimizer budget; per-avatar masks)."""
        self._ensure_engine()
        return RealtimeBatch(self, n_avatars)

    def dense_targets(self, target_ee_pos: np.ndarray,
                      target_ee_rot: np.ndarray):
        """Scatter sparse end-effector targets (E,3)/(E,4 wxyz) into dense
        (J,3)/(J,4) arrays per the session's mask (inactive joints get
        identity)."""
        j = self.skeleton.n_joints
        e = len(self._mask_indices)
        tpos = np.zeros((j, 3), np.float32)
        trot = np.zeros((j, 4), np.float32)
        trot[:, 0] = 1.0
        tpos[self._mask_indices] = np.asarray(
            target_ee_pos, np.float32).reshape(e, 3)
        trot[self._mask_indices] = np.asarray(
            target_ee_rot, np.float32).reshape(e, 4)
        return tpos, trot

    def drag_pose(self, target_ee_pos: np.ndarray, target_ee_rot: np.ndarray,
                  out_pose: np.ndarray, out_global_pos: np.ndarray) -> None:
        """One realtime frame.  target_ee_rot are wxyz quaternions (E, 4).
        The frame is ``DragEngine.step_realtime`` (quaternion targets in,
        parent-local quaternions out); one copy to the host at its end.
        The frame is the ``dragposer.frame`` span of a profiler's trace."""
        with span("dragposer.frame"):
            self._ensure_engine()
            j = self.skeleton.n_joints
            tpos, trot = self.dense_targets(target_ee_pos, target_ee_rot)
            self._state, local, global_pos = self._engine.step_realtime(
                self._state, tpos, trot)
            with span("dragposer.frame.reply"), \
                    span("dragposer.frame.reply.wait"):
                np.copyto(out_pose, local.cpu().numpy().reshape(j, 4))
                out_global_pos[0, :] = global_pos.cpu().numpy()


def make_batched_frame(engine: eng.DragEngine):
    """The N-avatar frame of ``engine``'s configuration:
    ``(model_b, state_b, tpos (N,J,3), trot_wxyz (N,J,4)) -> (new_state_b,
    FrameOutput, local (N,J,4))``, ``model_b`` carrying per-avatar masks
    (N,J) and weights (N,J,2).

    A frame: the rollout (K2) for the avatars at a window boundary, then
    ``hyper.max_iter`` masked Adam steps in one launch of K1 (the batch-in-
    lanes inner loop of the offline pipeline), then ``_finish_frame`` and
    the parent-local quaternions.  K1's packed weights are built here, once;
    each frame rebuilds only the loss weights of its masks."""
    hyper, tparam, skeleton = engine.hyper, engine.tparam, engine.skeleton
    base_ctx = fast_iter.make_context(engine.model, skeleton, hyper)
    base_kctx = iter_kernel.make_kernel_context(base_ctx)
    mean_q, std_q = eng._quat_stats(engine.model)

    def frame(model_b, state_b, tpos, trot_quats):
        # the kernels take contiguous leaves; the CPU twin's are transposes
        state_b = eng.DragState(*[x.contiguous() for x in state_b])
        n = state_b.latent.shape[0]
        trot = quat.to_matrix(trot_quats)
        tbuf, tlat = eng._begin_frame(model_b, hyper, tparam, state_b)
        ctx, kctx = iter_kernel.with_masks(base_ctx, base_kctx, model_b.mask,
                                           model_b.weights)
        opt0 = eng._opt_init(state_b.latent, skeleton.n_joints)
        opt = iter_kernel.run_block_fused(
            ctx, kctx, hyper, hyper.max_iter, opt0,
            torch.ones(n, dtype=torch.bool, device=tpos.device), state_b,
            tpos.permute(1, 2, 0).contiguous(),
            trot.permute(1, 2, 3, 0).contiguous(), tlat.contiguous())
        new_state, out = eng._finish_frame(model_b, hyper, state_b, opt,
                                           tbuf, tpos)
        rs = (out.pose * std_q + mean_q).reshape(n, -1, 4)
        return new_state, out, fk.from_root_quat(rs, skeleton)

    return frame


def make_batched_step(engine: eng.DragEngine):
    """:func:`make_batched_frame` as ``(model_b, state_b, tpos, trot_wxyz)
    -> (new_state_b, local (N,J,4), global_pos (N,3))``.  Used by
    :class:`RealtimeBatch` and by the serving daemon's coalescer
    (``runtime/server.py``)."""
    frame = make_batched_frame(engine)

    def step(model_b, state_b, tpos, trot_quats):
        new_state, out, local = frame(model_b, state_b, tpos, trot_quats)
        return new_state, local, out.global_pos

    return step


def make_coalesced_step(engine: eng.DragEngine, n_lanes: int):
    """Frame step over ``n_lanes`` independent session states:
    ``(model, masks (N,J), weights (N,J,2), states tuple[DragState]*N,
    tpos (N,J,3), trot_wxyz (N,J,4), active (N,) bool) ->
    (tuple[DragState]*N, local (N,J,4), global_pos (N,3))``.

    Stacks the per-session states, steps them as one batch
    (:func:`make_batched_step`), keeps each inactive (padding) lane's input
    state bit for bit, and unstacks.  Arrays may be numpy or tensors; the
    states are on ``engine``'s device."""
    inner = make_batched_step(engine)

    def step(model, masks, weights, states, tpos, trot, active):
        if len(states) != n_lanes:
            raise ValueError(f"{len(states)} states for {n_lanes} lanes")
        t = engine.tensor
        state_b = eng.DragState(*[torch.stack(leaves)
                                  for leaves in zip(*states)])
        model_b = model._replace(mask=t(masks), weights=t(weights))
        new_b, local, gp = inner(model_b, state_b, t(tpos), t(trot))
        new_b = eng._select(t(active, torch.bool), new_b, state_b)
        outs = tuple(eng.DragState(*[x[i] for x in new_b])
                     for i in range(n_lanes))
        return outs, local, gp

    return step


class RealtimeBatch:
    """N concurrent avatars stepped together, one frame for the crowd.

    All avatars share the skeleton, model weights and optimizer budget of a
    configured :class:`RealtimeSession`; each has its own dense end-effector
    mask and weights, recurrent drag state and targets.  Masks are data, so
    per-avatar tracker configurations and live mask edits change no code
    path: a crowd of 6-, 4- and 3-tracker users steps as one batch through
    K1 (the reference serves one user per embedded interpreter).

    Build via ``RealtimeSession.make_batch(n)`` after ``load_models``::

        s = RealtimeSession(); s.set_reference_skeleton(bvh); s.load_models(d)
        s.set_mask_and_weights(mask, weights)       # default for all avatars
        batch = s.make_batch(32)
        batch.set_mask_and_weights(3, mask3, weights3)   # avatar 3 differs
        batch.init_drag_pose(gp0 (N,3), gr0 (N,4))
        local, gp = batch.drag_pose(tpos (N,J,3), trot_wxyz (N,J,4))
    """

    def __init__(self, session: RealtimeSession, n_avatars: int):
        self.n_avatars = int(n_avatars)
        self.skeleton = session.skeleton
        engine = session._engine
        self._engine = engine
        n = self.n_avatars
        self._masks = engine.model.mask[None].repeat(n, 1)
        self._weights = engine.model.weights[None].repeat(n, 1, 1)
        self._step = make_batched_step(engine)
        self._state = None

    def _model_b(self):
        return self._engine.model._replace(mask=self._masks,
                                           weights=self._weights)

    def _stagger_fill(self, state_b: eng.DragState) -> eng.DragState:
        """Fill every avatar's prediction buffer with ONE init-time
        full-batch rollout, then spread their window phases evenly over
        [0, W).  A mass-spawned crowd otherwise steps in lockstep: all
        lanes hit ``current_index == 0`` on the same frame, so 1 frame in W
        pays the full-batch rollout (a latency spike that can blow the
        60 fps deadline even when the mean frame time is fine) while the
        other W-1 pay none.  Staggered phases put ~B/W lanes at a boundary
        each frame, inside :func:`engine.rollout_lane_budget`'s sub-batch,
        so every frame costs about the same.

        Spawn-time semantics: an avatar at phase k consumes the k-th step
        of its spawn-time prediction and re-predicts after W-k frames, a
        ≤ W-frame transient on the guidance term only; steady state is
        that of the unstaggered batch.  A no-op without the temporal model
        or at W ≤ 1."""
        hyper = self._engine.hyper
        n = state_b.latent.shape[0]
        w = hyper.temporal_future_window
        if not hyper.use_temporal or w <= 1:
            return state_b
        tbuf = eng._temporal_rollout(self._model_b(), hyper,
                                     self._engine.tparam, state_b)
        phases = ((torch.arange(n, device=tbuf.device) * w) // max(n, 1)) % w
        return state_b._replace(target_buffer=tbuf,
                                current_index=phases.to(torch.int32))

    # ------------------------------------------------------------------
    def set_mask_and_weights(self, avatar: int, mask, weights) -> int:
        """Live per-avatar tracker configuration."""
        j = self.skeleton.n_joints
        mask = np.asarray(mask, np.float32).reshape(j)
        self._masks[avatar] = torch.as_tensor(mask)
        self._weights[avatar] = torch.as_tensor(
            np.asarray(weights, np.float32).reshape(j, 2))
        return int(np.count_nonzero(mask))

    def init_drag_pose(self, initial_global_pos, initial_global_rot,
                       seed: int = cfg.VAE_PARAM["seed"],
                       stagger_phases: bool = False) -> None:
        """Reset all avatars (zero initial pose, as ``run_drag.py:77-96``).
        Every avatar starts from the same initial latent: one draw from a
        ``torch.Generator`` seeded with ``seed`` (the draw a session with
        that seed takes), shared by the crowd as the JAX package tiles one
        key over it.

        ``stagger_phases``: spread the avatars' temporal-window phases
        evenly so that each frame's rollout stays inside the sub-batch lane
        budget instead of the whole crowd re-predicting on the same frame
        every W frames (see ``_stagger_fill``).  Avatars that join an
        already running batch later (daemon coalescing) start at phase 0
        and are staggered by their join time; a burst of joiners on one
        frame rolls out all of them in that frame's sub-batch
        (``engine._rollout_where_needed``)."""
        engine = self._engine
        n, j = self.n_avatars, self.skeleton.n_joints
        latent_dim = cfg.VAE_PARAM["latent_dim"]
        gen = torch.Generator(device=engine.device).manual_seed(seed)
        noise = torch.randn((1, latent_dim), generator=gen,
                            device=engine.device).expand(n, latent_dim)
        self._state = engine.init_state(
            gen, np.zeros((n, j * 8, cfg.VAE_PARAM["window_size"]),
                          np.float32),
            np.asarray(initial_global_pos, np.float32).reshape(-1, 3),
            np.asarray(initial_global_rot, np.float32).reshape(-1, 4),
            np.zeros((n, len(cfg.HEIGHT_INDICES)), np.float32), noise=noise)
        if stagger_phases:
            self._state = self._stagger_fill(self._state)

    def drag_pose(self, target_ee_pos, target_ee_rot):
        """One frame for every avatar.  Dense targets: (N, J, 3) positions
        and (N, J, 4) wxyz quaternions (inactive joints ignored via the
        masks).  Returns (parent-local wxyz (N, J, 4), global_pos (N, 3))."""
        t = self._engine.tensor
        self._state, local, gp = self._step(
            self._model_b(), self._state, t(target_ee_pos), t(target_ee_rot))
        return local.cpu().numpy(), gp.cpu().numpy()
