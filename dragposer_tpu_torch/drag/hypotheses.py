"""Sequential hypothesis beam for underconstrained tracker configs (port of
``dragposer_tpu/drag/hypotheses.py``).

R hypothesis lanes reconstruct the same sequence.  Every ``branch_every``
frames each lane's cumulative tracker-fit loss (position + rotation terms,
no ground truth) grows by the chunk's mean, weighted by the chunk's share
of the clip; the ``survivors`` best lineages continue, and every other lane
is re-seeded from one of them with ``z ← z_parent + σ · stds_latent · ε``.
Lanes ``j < survivors`` continue their parent exactly, so the beam never
loses its incumbents.  At the end the lineage with the lowest cumulative
loss is emitted.

:func:`run_hypotheses` (one file, ``eval_drag.evaluate_file``) runs its
chunks through the anchor (``DragEngine.run_batch``) and keeps its
bookkeeping on the host: it is the JAX package's beam, and its oracle
here.  :func:`run_hypotheses_batched` (many files, ``evaluate_batched``)
runs each chunk through the pipelined path (``run_batch_pipelined``: K1
and K2), on fixed chunk buffers of the engine's, so the pipeline's block
graph is captured once; the scores, the choice of survivors, the parents'
gather and the re-seeding stay on the device, each chunk's outputs stay
there with its table of parents (of a chunk followed by a selection, the
survivors' alone: no later lineage passes through another of its lanes),
and only each file's winning lineage, traced back through the tables, is
copied to the host.  With R = 1 either beam computes its path's
trajectory of the whole clip.

The draws come from a ``torch.Generator``: first the R initial latents'
noise, then one (R, L) draw a resampling point.  Both can be given instead
(``init_noise``, ``resample_noise``), as ``vae.reparameterize(noise=)``
takes its noise, so a test can hand the JAX package's draws to the port.

While a profiler records, the batched beam is the span ``dragposer.beam``;
in it ``.chunk`` (a chunk's inputs copied in and its pipelined run),
``.select`` (the scores to the next chunk's states) and ``.emit`` (the
back-trace and the copy out); :data:`BEAM` logs each chunk.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dragposer_tpu_torch import _build
from dragposer_tpu_torch.drag import engine as eng
from dragposer_tpu_torch.tracing import span

# the batched beam's chunks, logged at its emit while a profiler records:
# files, hypotheses, survivors, the chunk's frames [lo, hi) and the lanes
# whose frames of the chunk were copied to the host
BEAM = _build.KernelCounts(log_name="beam")


def _concat(chunks):
    """Per-chunk FrameOutputs (T_c, ...) → one (T, ...)."""
    return eng.FrameOutput(*[np.concatenate(x, axis=0) for x in zip(*chunks)])


def _stack(outs):
    return eng.FrameOutput(*[np.stack(x, axis=0) for x in zip(*outs)])


def _draw(generator, shape, device, given, i):
    """The ``i``-th resampling draw: ``given[i]`` or a normal draw."""
    if given is not None:
        return torch.as_tensor(np.asarray(given[i]), dtype=torch.float32,
                               device=device)
    return torch.randn(shape, generator=generator, device=device)


def _resample(engine, states, parent_flat, keep_flat, eps, sigma):
    """states[j] ← states[parent_flat[j]]; lanes not in ``keep_flat`` move
    by ``sigma · stds_latent · eps``."""
    idx = torch.as_tensor(parent_flat, device=engine.device)
    base = eng.DragState(*[x[idx] for x in states])
    keep = torch.as_tensor(keep_flat, device=engine.device)[:, None]
    eps = torch.where(keep, 0.0, eps)
    return base._replace(latent=base.latent
                         + sigma * engine.model.stds_latent * eps)


def run_hypotheses(engine: "eng.DragEngine", generator: torch.Generator,
                   n_hypotheses: int, dqs, gp, gr, heights0, initial_pose,
                   *, branch_every: int = 512, sigma: float = 0.25,
                   survivors: int = 8, return_all: bool = False,
                   init_noise=None, resample_noise=None):
    """Beam-drag one sequence: dqs/gp/gr (T, ...) normalized as for
    ``engine.run``; heights0 (H,), initial_pose (J*8, W) as for
    ``init_state``.  ``init_noise`` (R, L) and ``resample_noise``
    (n_chunks - 1, R, L) replace the generator's draws when given.

    Returns ``(out, parents, scores)``: the winning lineage's trajectory
    (a FrameOutput of numpy arrays (T, ...)), the resampling map per chunk
    (n_chunks, R) (``parents[c, j]`` is the lane of chunk ``c`` whose
    lineage lane ``j`` continues; the identity after the last chunk) and
    the per-chunk fit losses (n_chunks, R).
    With ``return_all=True`` ``out`` stacks every lineage (R, T, ...) and
    the final cumulative losses ``cum`` (R,) come fourth."""
    R = int(n_hypotheses)
    K = max(1, min(int(survivors), R))
    T = dqs.shape[0]
    t = engine.tensor
    rep = lambda a: t(a)[None].repeat((R,) + (1,) * np.ndim(a))  # noqa: E731
    states = engine.init_state(generator, rep(initial_pose), rep(gp[0]),
                               rep(gr[0]), rep(heights0), init_noise)
    hist = [[] for _ in range(R)]
    cum = np.zeros(R)
    parents_log, scores_log = [], []
    keep = np.arange(R) < K
    for ci, lo in enumerate(range(0, T, branch_every)):
        hi = min(lo + branch_every, T)
        states, out = engine.run_batch(
            states, rep(dqs[lo:hi]), rep(gp[lo:hi]), rep(gr[lo:hi]))
        out = eng.to_host(out)
        score = out.loss_pos.mean(axis=1) + out.loss_rot.mean(axis=1)
        cum = cum + score * ((hi - lo) / T)
        for j in range(R):
            hist[j].append(eng.FrameOutput(*[a[j] for a in out]))
        scores_log.append(score)
        if R > 1 and hi < T:
            surv = np.argsort(cum)[:K]   # best lineages first
            parent = np.asarray([surv[j % K] for j in range(R)])
            eps = _draw(generator, states.latent.shape, engine.device,
                        resample_noise, ci)
            states = _resample(engine, states, parent, keep, eps, sigma)
            hist = [list(hist[p]) for p in parent]
            cum = cum[parent]
            parents_log.append(parent)
        else:
            parents_log.append(np.arange(R))
    parents, scores = np.stack(parents_log), np.stack(scores_log)
    if return_all:
        return _stack([_concat(h) for h in hist]), parents, scores, cum
    return _concat(hist[int(np.argmin(cum))]), parents, scores


class Chunk(NamedTuple):
    """One chunk of the batched beam, as it stays on the device.  A chunk
    followed by a selection keeps the rows of its survivors alone (K a
    file, in their order of rank); the last keeps every lane's."""

    lo: int
    hi: int                   # the chunk's frames [lo, hi) of the clip
    start: eng.DragState      # the kept lanes' states at its start
                              # (resampled)
    end: eng.DragState        # their states at its end, before resampling
    out: eng.FrameOutput      # (kept lanes, the buffers' frames, ...),
                              # zeros past each lane's frames of the chunk
    row: torch.Tensor         # (F·R,) each lane's row of start, end and
                              # out; -1 where the lane was not kept
    score: torch.Tensor       # (F·R,) float64, each lane's fit loss
    parent: torch.Tensor      # (F·R,) the lane each lane of the next
                              # chunk continues (the identity at the last)


def run_hypotheses_batched(engine: "eng.DragEngine",
                           generator: torch.Generator, n_hypotheses: int,
                           dqs, gp, gr, heights0, initial_poses, *,
                           lengths=None, branch_every: int = 512,
                           sigma: float = 0.25, survivors: int = 8,
                           init_noise=None, resample_noise=None,
                           sync_k: int = 24, return_chunks: bool = False):
    """Beam-drag F sequences at once (the directory mode of
    :func:`run_hypotheses`): all F·R lanes (file-major) run each chunk as
    one ``run_batch_pipelined`` (``sync_k`` Adam steps a block) from the
    states the last chunk left, resampled; scores, lineages and resampling
    are per file, and frames at or past a file's length (``lengths`` (F,);
    padding) are neither run nor scored.  dqs/gp/gr (F, T, ...), heights0
    (F, H), initial_poses (F, J*8, W); ``init_noise`` (F·R, L),
    ``resample_noise`` (n_chunks - 1, F·R, L).  Every chunk runs on the
    engine's chunk buffers (F·R, ``branch_every``, ...), held by one call
    at a time (``_graphs.Holder``); the last is padded and cut by the
    lanes' lengths.  Past the inputs and one chunk's work, the device holds
    F·K lanes' outputs of each chunk run.

    Returns ``(out, cum)``: each file's winning lineage (a FrameOutput of
    numpy arrays (F, T, ...); zeros past a file's length) and the final
    cumulative losses (F, R), float64.  With ``return_chunks`` the list
    of :class:`Chunk` comes third."""
    with span("dragposer.beam"):
        return _run_batched(engine, generator, int(n_hypotheses), dqs, gp,
                            gr, heights0, initial_poses, lengths,
                            int(branch_every), sigma, int(survivors),
                            init_noise, resample_noise, sync_k,
                            return_chunks)


def _run_batched(engine, generator, R, dqs, gp, gr, heights0, initial_poses,
                 lengths, branch_every, sigma, survivors, init_noise,
                 resample_noise, sync_k, return_chunks):
    K = max(1, min(survivors, R))
    t, dev = engine.tensor, engine.device
    dqs, gp, gr = t(dqs), t(gp), t(gr)
    F, T = dqs.shape[:2]
    B, C = F * R, min(branch_every, T)
    shapes = [(B, C) + x.shape[2:] for x in (dqs, gp, gr)]
    with engine._beam_buffers.hold(
            dev, "beam", lambda held: [x.shape for x in held] == shapes,
            lambda: tuple(torch.zeros(s, device=dev) for s in shapes)) \
            as bufs:
        lane_len = (torch.full((F,), T, device=dev) if lengths is None
                    else t(lengths, torch.long)).repeat_interleave(R)
        rep = lambda x: t(x).repeat_interleave(R, dim=0)  # noqa: E731
        states = engine.init_state(generator, rep(initial_poses),
                                   rep(gp[:, 0]), rep(gr[:, 0]),
                                   rep(heights0), init_noise)
        n_lens = lane_len.double().clamp(min=1.0)
        cum = torch.zeros(B, dtype=torch.float64, device=dev)
        ar = torch.arange(B, device=dev)
        keep = ar % R < K
        first = ar[::R, None]                   # (F, 1) each file's lane 0
        pick = torch.arange(R, device=dev) % K  # lane j continues surv[j % K]
        frame = torch.arange(C, device=dev)[None]
        chunks = []
        for ci, lo in enumerate(range(0, T, C)):
            hi = min(lo + C, T)
            with span("dragposer.beam.chunk"):
                for buf, src in zip(bufs, (dqs, gp, gr)):
                    buf.unflatten(0, (F, R))[:, :, :hi - lo].copy_(
                        src[:, None, lo:hi])
                n = (lane_len - lo).clamp(0, hi - lo)
                start = states
                states, out = engine.run_batch_pipelined(
                    states, *bufs, sync_k=sync_k, lengths=n)
            with span("dragposer.beam.select"):
                w = (frame < n[:, None]).double()
                n_valid = w.sum(dim=1)
                score = ((out.loss_pos * w).sum(dim=1)
                         + (out.loss_rot * w).sum(dim=1)) \
                    / n_valid.clamp(min=1.0)
                cum = cum + score * (n_valid / n_lens)
                end, parent, row = states, ar, ar
                if R > 1 and hi < T:
                    order = torch.argsort(cum.view(F, R), dim=1, stable=True)
                    parent = (first + order[:, pick]).reshape(-1)
                    eps = _draw(generator, states.latent.shape, dev,
                                resample_noise, ci)
                    states = _resample(engine, states, parent, keep, eps,
                                       sigma)
                    cum = cum[parent]
                    # no later lineage passes through another lane
                    kept = (first + order[:, :K]).reshape(-1)
                    row = torch.full_like(ar, -1)
                    row[kept] = torch.arange(F * K, device=dev)
                    start, end, out = (type(x)(*[y[kept] for y in x])
                                       for x in (start, end, out))
            chunks.append(Chunk(lo, hi, start, end, out, row, score, parent))
        with span("dragposer.beam.emit"):
            lane = first[:, 0] + cum.view(F, R).argmin(dim=1)
            pieces = []
            for i, c in enumerate(reversed(chunks)):
                if i:   # the lanes of this chunk that the winners continue
                    lane = c.parent[lane]
                pieces.append([x[c.row[lane], :c.hi - c.lo] for x in c.out])
            won = eng.to_host(eng.FrameOutput(
                *[torch.cat(x[::-1], dim=1) for x in zip(*pieces)]))
            cum = cum.view(F, R).cpu().numpy()
    for c in chunks:
        BEAM.launched(files=F, hypotheses=R, survivors=K, lo=c.lo, hi=c.hi,
                      host_lanes=F)
    return (won, cum, chunks) if return_chunks else (won, cum)
