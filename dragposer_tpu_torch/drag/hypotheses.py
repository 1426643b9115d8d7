"""Sequential hypothesis beam for underconstrained tracker configs (port of
``dragposer_tpu/drag/hypotheses.py``).

R hypothesis lanes reconstruct the same sequence through the anchor
(``DragEngine.run_batch``).  Every ``branch_every`` frames each lane's
cumulative tracker-fit loss (position + rotation terms, no ground truth)
grows by the chunk's mean, weighted by the chunk's share of the clip; the
``survivors`` best lineages continue, and every other lane is re-seeded
from one of them with ``z ← z_parent + σ · stds_latent · ε``.  Lanes
``j < survivors`` continue their parent exactly, so the beam never loses
its incumbents.  At the end the lineage with the lowest cumulative loss is
emitted.  With R = 1 the beam computes ``engine.run``'s trajectory.

The draws come from a ``torch.Generator``: first the R initial latents'
noise, then one (R, L) draw a resampling point.  Both can be given instead
(``init_noise``, ``resample_noise``), as ``vae.reparameterize(noise=)``
takes its noise, so a test can hand the JAX package's draws to the port.
"""

from __future__ import annotations

import numpy as np
import torch

from dragposer_tpu_torch.drag import engine as eng


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


def run_hypotheses_batched(engine: "eng.DragEngine",
                           generator: torch.Generator, n_hypotheses: int,
                           dqs, gp, gr, heights0, initial_poses, *,
                           lengths=None, branch_every: int = 512,
                           sigma: float = 0.25, survivors: int = 8,
                           init_noise=None, resample_noise=None):
    """Beam-drag F sequences at once (the directory mode of
    :func:`run_hypotheses`): all F·R lanes run as one ``run_batch`` a
    chunk; scores, lineages and resampling are per file, and frames at or
    past a file's length (``lengths`` (F,); padding) are kept out of its
    scores.  dqs/gp/gr (F, T, ...), heights0 (F, H), initial_poses
    (F, J*8, W); ``init_noise`` (F·R, L), ``resample_noise``
    (n_chunks - 1, F·R, L).

    Returns ``(out, cum)``: each file's winning lineage (a FrameOutput of
    numpy arrays (F, T, ...)) and the final cumulative losses (F, R)."""
    R = int(n_hypotheses)
    K = max(1, min(int(survivors), R))
    F, T = dqs.shape[0], dqs.shape[1]
    lengths = np.full((F,), T) if lengths is None else np.asarray(lengths)
    t = engine.tensor

    def rep(x):  # (F, ...) → (F·R, ...), file-major
        x = t(x)
        return x.repeat_interleave(R, dim=0)

    states = engine.init_state(generator, rep(initial_poses), rep(gp[:, 0]),
                               rep(gr[:, 0]), rep(heights0), init_noise)
    hist = [[[] for _ in range(R)] for _ in range(F)]
    cum = np.zeros((F, R))
    keep = np.tile(np.arange(R) < K, F)
    n_lens = np.maximum(np.repeat(lengths, R).astype(np.float64), 1.0)
    for ci, lo in enumerate(range(0, T, branch_every)):
        hi = min(lo + branch_every, T)
        states, out = engine.run_batch(states, rep(dqs[:, lo:hi]),
                                       rep(gp[:, lo:hi]), rep(gr[:, lo:hi]))
        out = eng.to_host(out)
        valid = np.arange(lo, hi)[None] < lengths[:, None]        # (F, C)
        w = np.repeat(valid, R, axis=0).astype(np.float64)        # (F·R, C)
        n_valid = w.sum(axis=1)
        score = ((out.loss_pos * w).sum(axis=1)
                 + (out.loss_rot * w).sum(axis=1)) / np.maximum(n_valid, 1.0)
        cum = cum + (score * (n_valid / n_lens)).reshape(F, R)
        for f in range(F):
            for j in range(R):
                hist[f][j].append(
                    eng.FrameOutput(*[a[f * R + j] for a in out]))
        if R > 1 and hi < T:
            order = np.argsort(cum, axis=1)        # best first
            parent = np.stack([order[:, j % K] for j in range(R)], axis=1)
            parent_flat = (np.arange(F)[:, None] * R + parent).reshape(-1)
            eps = _draw(generator, states.latent.shape, engine.device,
                        resample_noise, ci)
            states = _resample(engine, states, parent_flat, keep, eps, sigma)
            hist = [[list(hist[f][p]) for p in parent[f]] for f in range(F)]
            cum = np.take_along_axis(cum, parent, axis=1)
    best = cum.argmin(axis=1)
    return _stack([_concat(hist[f][int(best[f])]) for f in range(F)]), cum
