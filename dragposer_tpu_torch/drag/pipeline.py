"""Pipelined batched drag reconstruction: sync-every-K decoupled lanes
(port of ``dragposer_tpu/drag/pipeline.py``).

One global iteration loop runs over the whole batch; each lane owns a frame
pointer.  Every ``sync_k`` Adam iterations (one launch of kernel K1), lanes
whose stop rule holds *finish* their frame (global-transform advance, ring
buffers, compact output write), take their next frame's ground-truth
*targets* and a fresh Adam state, and *begin* it (temporal rollout with
kernel K2).  A straggler frame in one lane does not stall the others.  The
pose is decoded once, after the loop, from the stored per-frame latents.

The loop's count of active lanes (``frame < limit``) is a host read once
per block, made at the end of the block before (the first in the
prologue); the block's rollout runs on at most that many lanes (the
lanes that finish a frame are among them).  The inner loop
is K1 (the batch-in-lanes fast path) unless ``hyper.constraints`` is set or
the decoder is unfolded: then each block runs up to ``sync_k`` masked
iterations of the anchor's ``engine._opt_body`` (autograd, targets per
lane (B, J, ·)), ending early, by a host check an iteration, once no lane
is active (the JAX package's ``fast=False``).  K2 does the rollout in
both.

A block is K1 (an eager launch), then its bookkeeping (``finish`` and
``targets``: fixed-shape ops over the batch), then ``begin`` (the rollout,
eager: its launches of K2 and, at a window, its host check), then the
loop's check.  Given an engine's ``_graphs.Holder`` and a graph-safe
block (CUDA tensors and K1), the bookkeeping is one replay of a CUDA graph
(:class:`_BlockGraph`) over buffers that K1's carry and ``begin``'s
targets are copied into; otherwise it runs eagerly (:class:`_EagerBlocks`).
Both run the phases of :class:`_Block` in the same order, so the two agree
bit for bit.  Each block and its phases are spans of a profiler's trace
(``tracing.span``: ``dragposer.block`` and ``dragposer.block.k1`` /
``.finish`` / ``.targets`` (eager) or ``.graph`` (a replay) / ``.begin`` /
``.wait``), inside ``dragposer.pipeline``; ``BLOCKS`` logs each block
while a profiler records.

The state keeps the anchor's layout, its ring buffers (B, P, ·), and the
anchor's helpers gather the rollout's inputs from them and shift them.
"""

from __future__ import annotations

import contextlib
import copy
import weakref
from typing import NamedTuple

import torch

from dragposer_tpu_torch import _build, _graphs, tracing
from dragposer_tpu_torch.drag import engine as eng
from dragposer_tpu_torch.drag import fast_iter, iter_kernel
from dragposer_tpu_torch.parallel.mesh import map_tree, tree_leaves
from dragposer_tpu_torch.tracing import span

# the pipeline's blocks: a replay of the block's graph, or its eager
# bookkeeping (``plain``); while a profiler records, each one's lanes and
# whether its graph was captured in that call (``capture``)
BLOCKS = _build.KernelCounts(log_name="block")


def _write_rows(buf, frame, done, val):
    """``buf`` (B, T, ...) ← ``val`` (B, ...) at each lane's ``frame`` where
    ``done`` (a gather, a select and a scatter of B rows)."""
    ar = torch.arange(buf.shape[0], device=buf.device)
    m = done.reshape(done.shape + (1,) * (val.dim() - 1))
    buf[ar, frame] = torch.where(m, val.to(buf.dtype), buf[ar, frame])


def _copy_leaves(dst, src) -> None:
    """Every leaf of ``src`` into the same leaf of ``dst`` (same shapes),
    one ``torch._foreach_copy_`` a dtype; a leaf that is its own source is
    left."""
    by_dtype = {}
    for d, s in zip(tree_leaves(dst), tree_leaves(src), strict=True):
        if d is not s:
            pair = by_dtype.setdefault(d.dtype, ([], []))
            pair[0].append(d)
            pair[1].append(s)
    for d, s in by_dtype.values():
        torch._foreach_copy_(d, s)


class _Carry(NamedTuple):
    """What one block hands the next: every leaf leads with the lanes,
    but K1's targets, which end with them."""

    state: eng.DragState
    opt: eng._OptCarry
    tpos: torch.Tensor         # (J, 3, B) for K1, else (B, J, 3)
    trot: torch.Tensor         # (J, 3, 3, B) for K1, else (B, J, 3, 3)
    tbuf: torch.Tensor         # (B, W+1, L) the frame's target buffer
    tlat: torch.Tensor         # (B, L) the frame's temporal target
    frame: torch.Tensor        # (B,) int32
    lane_active: torch.Tensor  # (B,) frame < limit
    done: torch.Tensor         # (B,) the lanes that finished a frame
    n_active: torch.Tensor     # () int64, the lanes of lane_active


class _Outs(NamedTuple):
    """The per-frame outputs (B, T, ...), written row by row in place."""

    latent: torch.Tensor
    global_pos: torch.Tensor
    global_rot: torch.Tensor
    iterations: torch.Tensor
    loss_pos: torch.Tensor
    loss_rot: torch.Tensor


class _Block:
    """One call's constants and the phases of a block over a
    :class:`_Carry`: ``start`` (the prologue), ``inner`` (K1, or the
    per-lane loop), ``finish``, ``targets`` and ``begin``."""

    def __init__(self, model, statics, skeleton, hyper: eng.DragHyper,
                 tparam, fast: bool, sync_k: int, states: eng.DragState,
                 dqs_norm, gt_pos, gt_rot, lengths):
        self.model, self.statics, self.skeleton = model, statics, skeleton
        self.hyper, self.tparam = hyper, tparam
        self.fast, self.sync_k = fast, sync_k
        self.inputs = (dqs_norm, gt_pos, gt_rot)
        dev = self.device = dqs_norm.device
        B, T = self.B, self.T = dqs_norm.shape[0], dqs_norm.shape[1]
        limit = torch.full((B,), T, dtype=torch.int32, device=dev)
        if lengths is not None:
            limit = torch.minimum(lengths.to(torch.int32), limit)
        self.limit = limit
        if fast:
            self.ctx = fast_iter.make_context(model, skeleton, hyper)
            self.kctx = iter_kernel.make_kernel_context(self.ctx)
        self.L = states.latent.shape[-1]
        self.ar = torch.arange(B, device=dev)

    def graphable(self) -> bool:
        """Whether the bookkeeping is fixed-shape and graph-safe: CUDA
        tensors and K1's inner loop (no constraint, the folded decoder)."""
        return self.fast and self.device.type == "cuda"

    def bound(self, **buffers) -> "_Block":
        """This block reading ``buffers`` (``ctx``, ``limit``, ``ar``) in
        place of its own."""
        new = copy.copy(self)
        new.__dict__.update(buffers)
        return new

    def _begin_all(self, s: eng.DragState, began, f_idx, lanes: int):
        if not self.hyper.use_temporal:
            return s.target_buffer, torch.zeros_like(s.latent)
        tbuf = eng._rollout_where_needed(
            self.model, self.hyper, self.tparam,
            *eng._rollout_inputs(s, self.hyper),
            began & (s.current_index == 0), s.target_buffer,
            frame=f_idx, limit=self.limit, lanes=lanes)
        return tbuf, tbuf[self.ar, s.current_index.long()]

    def _targets_all(self, s: eng.DragState, f_idx):
        f = f_idx.long()
        dqs_norm, gt_pos, gt_rot = self.inputs
        frame_inputs = (dqs_norm[self.ar, f], gt_pos[self.ar, f],
                        gt_rot[self.ar, f])
        if self.fast:    # planes (J, 3, B), (J, 3, 3, B)
            return fast_iter.eval_targets_T(self.ctx, self.hyper,
                                            s.global_pos, *frame_inputs)
        return eng._eval_targets(self.model, self.skeleton, s,
                                 *frame_inputs)

    def _adj_targets(self, tpos):
        if self.hyper.joint_adjustment is None:
            return torch.zeros(self.B, 3, device=self.device)
        ee = self.hyper.joint_adjustment[1]
        return tpos[ee].T if self.fast else tpos[:, ee]

    def start(self, states: eng.DragState) -> _Carry:
        """The prologue: every lane begins frame 0, from ``states``' leaves
        made contiguous (the kernels take contiguous inputs)."""
        state = eng.DragState(*[x.contiguous() for x in states])
        B, dev = self.B, self.device
        frame = torch.zeros(B, dtype=torch.int32, device=dev)
        tbuf, tlat = self._begin_all(
            state, torch.ones(B, dtype=torch.bool, device=dev), frame, B)
        tpos, trot = self._targets_all(state, frame)
        lane_active = frame < self.limit
        return _Carry(
            state=state, opt=eng._opt_init(state.latent,
                                           self.skeleton.n_joints),
            tpos=tpos, trot=trot, tbuf=tbuf, tlat=tlat, frame=frame,
            lane_active=lane_active,
            done=torch.zeros(B, dtype=torch.bool, device=dev),
            n_active=lane_active.sum())

    def new_outs(self) -> _Outs:
        z = lambda *s, dtype=torch.float32: torch.zeros(  # noqa: E731
            (self.B, self.T) + s, dtype=dtype, device=self.device)
        return _Outs(latent=z(self.L), global_pos=z(3), global_rot=z(4),
                     iterations=z(dtype=torch.int32), loss_pos=z(),
                     loss_rot=z())

    def inner(self, c: _Carry, opt: eng._OptCarry) -> eng._OptCarry:
        """``sync_k`` masked Adam steps from ``opt`` on ``c``'s targets."""
        if self.fast:
            return iter_kernel.run_block_fused(
                self.ctx, self.kctx, self.hyper, self.sync_k, opt,
                c.lane_active, c.state, c.tpos, c.trot, c.tlat)
        for _ in range(self.sync_k):
            with span("dragposer.anchor.wait"):
                active = eng._opt_cond(opt, self.hyper) & c.lane_active
                if not bool(active.any()):
                    break
            with span("dragposer.anchor.step"):
                new = eng._opt_body(opt, self.model, self.statics,
                                    self.skeleton, self.hyper,
                                    c.state.global_pos, c.state.global_rot,
                                    c.tpos, c.trot, c.tlat)
                opt = eng._select(active, new, opt)
        return opt

    def finish(self, c: _Carry, outs: _Outs) -> _Carry:
        """The lanes whose stop rule ended advance: state, output rows
        (written into ``outs``), frame."""
        s, opt = c.state, c.opt
        done = ~eng._opt_cond(opt, self.hyper) & c.lane_active
        gp, gr, disp, heights, ci, _ = eng._advance_core(
            self.model, self.hyper, s.global_pos, s.current_index, opt,
            self._adj_targets(c.tpos))
        state = eng._select(done, eng._next_state(s, opt, c.tbuf, gp, gr,
                                                  disp, heights, ci), s)
        f_cl = torch.clamp(c.frame, max=self.T - 1).long()
        for buf, val in zip(outs, (opt.decoded_latent, gp, gr, opt.t,
                                   opt.loss_pos, opt.loss_rot)):
            _write_rows(buf, f_cl, done, val)
        return c._replace(state=state, done=done,
                          frame=c.frame + done.to(torch.int32))

    def targets(self, c: _Carry) -> _Carry:
        """The advanced lanes' targets at their next frame and a fresh Adam
        state; the others keep theirs.  Then the lanes still active."""
        done = c.done
        tpos, trot = self._targets_all(
            c.state, torch.clamp(c.frame, max=self.T - 1))
        if self.fast:    # the lane axis is the last
            tpos = torch.where(done[None, None, :], tpos, c.tpos)
            trot = torch.where(done[None, None, None, :], trot, c.trot)
        else:
            tpos = eng._select(done, tpos, c.tpos)
            trot = eng._select(done, trot, c.trot)
        opt = eng._select(done, eng._opt_init(c.state.latent,
                                              self.skeleton.n_joints), c.opt)
        lane_active = c.frame < self.limit
        return c._replace(tpos=tpos, trot=trot, opt=opt,
                          lane_active=lane_active,
                          n_active=lane_active.sum())

    def begin(self, c: _Carry, frame, lanes: int) -> tuple:
        """The advanced lanes begin their frame (``frame``: the carry's, or
        a copy the rollout's record keeps; ``lanes``: the count of lanes
        active in the block, read before it, which bounds the advanced
        lanes): ``(tbuf, tlat)``."""
        tbuf, tlat = self._begin_all(c.state, c.done, frame, lanes)
        return (eng._select(c.done, tbuf, c.tbuf),
                eng._select(c.done, tlat, c.tlat))


class _EagerBlocks:
    """The blocks' bookkeeping as eager ops on a carry of their own (the
    CPU, the per-lane loop)."""

    plain, fresh = True, False

    def __init__(self, block: _Block, carry: _Carry):
        self.block, self.carry, self.outs = block, carry, block.new_outs()

    def put(self, **leaves) -> None:
        self.carry = self.carry._replace(**leaves)

    @staticmethod
    def kept(x):
        return x

    def settle(self) -> None:
        with span("dragposer.block.finish"):
            c = self.block.finish(self.carry, self.outs)
        with span("dragposer.block.targets"):
            self.carry = self.block.targets(c)

    def result(self) -> tuple:
        return self.carry.state, self.outs


class _Key:
    """What a block graph serves, the engine's holder's test of it: the
    model, statics and skeleton (by identity), the hyperparameters, sync_k,
    the lanes, frames and device, and the input tensors, by identity and
    held weakly (the graph gathers from their memory; a freed input matches
    nothing)."""

    def __init__(self, block: _Block):
        self.parts = (block.model, block.statics, block.skeleton)
        self.hyper, self.sync_k = block.hyper, block.sync_k
        self.shape = (block.B, block.T, block.device)
        self.inputs = tuple(weakref.ref(x) for x in block.inputs)

    def matches(self, block: _Block) -> bool:
        return (all(a is b for a, b in zip(
                    self.parts, (block.model, block.statics, block.skeleton)))
                and self.hyper == block.hyper and self.sync_k == block.sync_k
                and self.shape == (block.B, block.T, block.device)
                and all(r() is x for r, x in zip(self.inputs, block.inputs)))


class _BlockGraph:
    """A block's bookkeeping, ``finish`` then ``targets``, captured as one
    CUDA graph over buffers of its own (the carry, the outputs, ``limit``,
    K1's context and the lane index, which the targets read) for one
    :class:`_Key`.

    * ``start``: a call's ``limit``, context and prologue carry copied in,
      the outputs zeroed;
    * ``put``: K1's carry or ``begin``'s targets copied in;
    * ``settle``: one replay;
    * ``kept``: a copy of a buffer while a profiler records (the launch
      records keep it; a later replay overwrites the buffer);
    * ``result``: the state and outputs cloned out.

    The model's tensors and the inputs are read in place.  Captured by
    ``_graphs.capture``.  ``fresh`` until its first replay."""

    plain = False

    def __init__(self, block: _Block, carry: _Carry):
        self.key = _Key(block)
        self.ctx = map_tree(torch.clone, block.ctx)
        self.limit = block.limit.clone()
        self.ar = block.ar
        self.carry = map_tree(torch.clone, carry)
        self.outs = block.new_outs()
        own = block.bound(ctx=self.ctx, limit=self.limit, ar=self.ar)

        def settle():
            _copy_leaves(self.carry,
                         own.targets(own.finish(self.carry, self.outs)))

        self.graph, = _graphs.capture(block.device, settle)
        self.fresh = True

    def start(self, block: _Block, carry: _Carry) -> None:
        _copy_leaves((self.ctx, self.limit, self.carry),
                     (block.ctx, block.limit, carry))
        torch._foreach_zero_(list(self.outs))

    def put(self, **leaves) -> None:
        _copy_leaves([getattr(self.carry, k) for k in leaves],
                     list(leaves.values()))

    @staticmethod
    def kept(x):
        return x.clone() if tracing.recording() else x

    def settle(self) -> None:
        with span("dragposer.block.graph"):
            self.graph.replay()

    def result(self) -> tuple:
        return map_tree(torch.clone, (self.carry.state, self.outs))


def run_batch_pipelined(model: eng.DragModel, statics, skeleton,
                        hyper: eng.DragHyper, tparam,
                        states: eng.DragState, dqs_norm, gt_pos, gt_rot,
                        sync_k: int = 24, lengths=None,
                        fast: bool | None = None,
                        graphs: _graphs.Holder | None = None):
    """Batched reconstruction.  ``states`` batched; ``dqs_norm`` (B, T, J*8),
    ``gt_pos`` (B, T, 3), ``gt_rot`` (B, T, 4); ``lengths`` (B,) optional
    per-lane frame counts (lanes halt there; outputs beyond are zeros).
    ``fast`` picks the inner loop: K1 (``True``) or the per-lane anchor
    step (``False``); ``None`` takes K1 whenever it can (no constraints, a
    folded decoder), and ``True`` where it cannot raises.  ``graphs``: an
    engine's holder of its block graph (one slot, the last call's), whose
    graph runs each block's bookkeeping where the block is graph-safe
    (eager without it).
    Returns (final states, FrameOutput with leaves (B, T, ...))."""
    with span("dragposer.pipeline"):
        return _run(model, statics, skeleton, hyper, tparam, states,
                    dqs_norm, gt_pos, gt_rot, sync_k, lengths, fast, graphs)


def _run(model, statics, skeleton, hyper, tparam, states, dqs_norm, gt_pos,
         gt_rot, sync_k, lengths, fast, graphs):
    eligible = not hyper.constraints and eng._is_folded(model.decoder)
    if fast is None:
        fast = eligible
    elif fast and not eligible:
        raise ValueError("the fast inner loop (K1) takes no constraints and "
                         "needs the folded decoder")
    with contextlib.ExitStack() as stack:
        with span("dragposer.pipeline.prologue"):
            block = _Block(model, statics, skeleton, hyper, tparam, fast,
                           sync_k, states, dqs_norm, gt_pos, gt_rot,
                           lengths)
            carry = block.start(states)
            if graphs is not None and block.graphable():
                loop = stack.enter_context(graphs.hold(
                    block.device, "block", lambda g: g.key.matches(block),
                    lambda: _BlockGraph(block, carry)))
                loop.start(block, carry)
            else:
                loop = _EagerBlocks(block, carry)
        with span("dragposer.pipeline.wait"):
            active = int(loop.carry.n_active)

        # global loop: K masked Adam steps, the bookkeeping, the rollout on
        # at most the lanes active in the block, then a sync point (the
        # count of the lanes active in the next)
        while active:
            with span("dragposer.block"):
                BLOCKS.launched(plain=loop.plain, lanes=block.B,
                                capture=loop.fresh)
                loop.fresh = False
                with span("dragposer.block.k1"):
                    c = loop.carry
                    opt = c.opt._replace(t=loop.kept(c.opt.t))
                    loop.put(opt=block.inner(c, opt))
                loop.settle()
                with span("dragposer.block.begin"):
                    c = loop.carry
                    tbuf, tlat = block.begin(c, loop.kept(c.frame), active)
                    loop.put(tbuf=tbuf, tlat=tlat)
                with span("dragposer.block.wait"):
                    active = int(loop.carry.n_active)
        state, outs = loop.result()

    # epilogue: one batched decode of the stored latents (plain matmuls)
    with span("dragposer.pipeline.epilogue"):
        B, T, L = block.B, block.T, block.L
        mean_q, std_q = eng._quat_stats(model)
        pose_n, _ = eng._decode(model, statics, outs.latent.reshape(B * T, L))
        pose = pose_n.reshape(B, T, -1)
        root = (outs.global_rot - mean_q[:4]) / std_q[:4]
        pose = torch.cat((root, pose[..., 4:]), dim=-1)
        valid = (torch.arange(T, device=block.device)[None, :]
                 < block.limit[:, None])[..., None]
        out = eng.FrameOutput(
            pose=torch.where(valid, pose, 0.0),
            global_pos=outs.global_pos, iterations=outs.iterations,
            loss_pos=outs.loss_pos, loss_rot=outs.loss_rot,
            latent=torch.where(valid, outs.latent, 0.0))
    return state, out
