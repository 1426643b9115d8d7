"""Holds the program's hypothesis beam against the plain reference.

The beam runs R lanes a file in chunks; after each chunk but the last it
keeps the ``K`` lineages with the lowest cumulative fit loss (``loss_pos +
loss_rot`` over a chunk's real frames, weighted by the chunk's share of the
file), lane ``j`` continuing survivor ``j % K``, lanes ``j ≥ K`` moved by
``σ · stds_latent · ε``, and at the end it emits each file's lineage of
least loss.  What the program keeps of a pass, its record, is all this
judge reads of it: per chunk the lanes' fit losses and parent tables, the
outputs and the states at its start and end of the lanes it kept
(``kept``: a chunk followed by a selection keeps its survivors alone, the
last chunk every lane; NaN, or -1, at a lane it dropped), and the emitted
lineages.  A number read where the program kept nothing is infinite.

* The lineages are followed frame by frame as :func:`judge.follow_offline`
  follows the offline batch's lanes, from the program's own stored state,
  across the chunks; at a chunk's first frame the start latent moves by the
  re-seeding the reference expects (``σ · stds_latent · ε``, ε drawn again
  from the run's seed).
* ``score_gap``: each chunk's fit loss of every kept lane of the checked
  files, read by the reference at the program's stored latents (forward
  only, along the lane's lineage), against the program's, relative.
* ``selection_break_share``: the survivors at each resampling point, and
  the winner at the end, that are not among the ``K`` (the 1) lowest of
  the cumulative losses (the reference's reading where the lane was kept,
  the program's where not), beyond :data:`SELECT_REL`, over all such
  choices.
* ``resample_gap``: every leaf of each kept lane's state at a chunk's
  start against its parent's at the last chunk's end, the latent moved by
  ``σ · stds_latent · ε`` (lanes ``j ≥ K``), the widest gap.
* ``emit_gap``: each checked file's emitted frames against its stored
  lineage of least (program) loss, traced back through the parent tables:
  the same numbers, so nought.
"""

from __future__ import annotations

import types

import torch

from benchmark.reference import judge
from benchmark.reference.drag import Frame

# A survivor whose reference cumulative loss passes the K-th lowest by more
# than this (relative) is a wrong choice: the reference reads the program's
# fit losses to ~1e-6 (``score_gap``), so a closer pair is a tie that
# rounding may order either way.
SELECT_REL = 1e-4

LEAVES = ("latent", "global_pos", "pose", "iterations", "loss_pos",
          "loss_rot")


class _Jumping(judge._Lanes):
    """``judge._Lanes`` whose lanes begin frame ``f`` at their start latent
    moved by ``jump[lane, f]``: the first start is every lane's frame 0,
    each later start of a lane its next frame (as ``follow_offline``
    starts them)."""

    def __init__(self, jump, *args):
        super().__init__(*args)
        self.jump, self.at = jump, None

    def start(self, rows, z0, inputs: dict) -> None:
        if self.at is None:
            self.at = torch.zeros(self.jump.shape[0], dtype=torch.long,
                                  device=self.jump.device)
        else:
            self.at[rows] += 1
        super().start(rows, z0 + self.jump[rows, self.at[rows]], inputs)


def follow_jumping(frame: Frame, inp: dict, out: dict, jump) -> dict:
    """:func:`judge.follow_offline` with each lane's start latent of frame
    ``f`` moved by ``jump`` (B, T, L)."""
    names = dict(vars(judge), _Lanes=lambda *a: _Jumping(jump, *a))
    fn = judge.follow_offline
    return types.FunctionType(fn.__code__, names, fn.__name__,
                              fn.__defaults__)(frame, inp, out)


def lineage(record: dict, f, last) -> torch.Tensor:
    """The lanes (N, chunks) that lineages ending at lanes ``last`` (N,) of
    the last chunk of files ``f`` (N,) took, chunk by chunk."""
    lanes = [last]
    for c in record["chunks"][-2::-1]:
        lanes.append(c["parent"][f, lanes[-1]])
    return torch.stack(lanes[::-1], dim=1)


def _along(record: dict, f, lanes, upto: int) -> dict:
    """The stored outputs of lineages (files ``f``, lanes (N, ·) a chunk)
    over the first ``upto`` chunks: each leaf (N, frames, ...)."""
    return {k: torch.cat([c["out"][k][f, lanes[:, i], :c["hi"] - c["lo"]]
                          for i, c in enumerate(record["chunks"][:upto])],
                         dim=1) for k in LEAVES}


def _inputs(record: dict, f, lane0, frames: int) -> dict:
    return dict(dqs=record["dqs"][f, :frames],
                global_pos=record["global_pos"][f, :frames],
                global_rot=record["global_rot"][f, :frames],
                heights0=record["heights0"][f],
                noise=record["noise"][f, lane0],
                lengths=record["lengths"][f].clamp(max=frames))


def _widest(x) -> float:
    """The largest ``|x|``; infinite where ``x`` holds a NaN (a number
    read where the program kept nothing)."""
    x = x.abs()
    if not x.numel():
        return 0.0
    return float("inf") if bool(x.isnan().any()) else float(x.max())


def fit_losses(frame: Frame, inp: dict, out: dict):
    """(B, T) loss_pos + loss_rot the reference reads at each frame's
    stored latent, each frame's targets and root from the stored outputs
    of the frame before (as ``follow_offline`` builds them)."""
    vae = frame.vae
    B, T = inp["dqs"].shape[:2]
    rot = out["pose"][..., :4] * vae.std_q[:4] + vae.mean_q[:4]
    first = lambda a, b: torch.cat((a[:, None], b[:, :-1]), dim=1)  # noqa: E731
    pos_prev = first(inp["global_pos"][:, 0], out["global_pos"])
    rot_prev = first(inp["global_rot"][:, 0], rot)
    ff = lambda a: a.flatten(0, 1)  # noqa: E731
    with torch.no_grad():
        tpos, trot = frame.targets_from_motion(
            ff(inp["dqs"]), ff(inp["global_pos"]), ff(inp["global_rot"]),
            ff(pos_prev))
        dec = ff(out["latent"])
        _, aux = frame.loss(dec, ff(rot_prev), tpos, trot, dec)
    return (aux["loss_pos"] + aux["loss_rot"]).unflatten(0, (B, T))


def _jump(record: dict, f, lanes, frames: int, sigma: float, K: int,
          std) -> torch.Tensor:
    """(N, frames, L): the re-seeding each lineage takes at each chunk's
    first frame, from the draws of the record."""
    N, L = lanes.shape[0], std.shape[0]
    jump = torch.zeros(N, frames, L, device=std.device)
    for i, c in enumerate(record["chunks"][1:], start=1):
        moved = (lanes[:, i] >= K)[:, None]
        eps = record["eps"][i - 1][f, lanes[:, i]]
        jump[:, c["lo"]] = torch.where(moved, sigma * std * eps, 0.0)
    return jump


def follow_lineages(frame: Frame, record: dict, f, last, sigma: float,
                    K: int) -> tuple:
    """(inputs, outputs, jump) of the lineages ending at lanes ``last`` of
    files ``f``, over the whole clip, as :func:`follow_jumping` takes
    them."""
    lanes = lineage(record, f, last)
    frames = record["chunks"][-1]["hi"]
    inp = _inputs(record, f, lanes[:, 0], frames)
    got = _along(record, f, lanes, len(record["chunks"]))
    got["initial_latent"] = record["chunks"][0]["start"]["latent"][
        f, lanes[:, 0]]
    return inp, got, _jump(record, f, lanes, frames, sigma, K, frame.tr.std)


def chunk_scores(frame: Frame, record: dict, files) -> list:
    """Per chunk, (n, R) float64: each lane's fit loss of the chunk (the
    mean of ``loss_pos + loss_rot`` over its real frames) that the
    reference reads at the stored latents along the lane's lineage, for
    the record's files ``files``."""
    chunks = record["chunks"]
    R = chunks[0]["score"].shape[1]
    dev = record["dqs"].device
    files = torch.as_tensor(files, device=dev)
    f = files.repeat_interleave(R)
    every = torch.arange(R, device=dev).repeat(files.shape[0])
    out = []
    for c_i, c in enumerate(chunks):
        sub = dict(record, chunks=chunks[:c_i + 1])
        lanes = lineage(sub, f, every)
        loss = fit_losses(frame, _inputs(record, f, lanes[:, 0], c["hi"]),
                          _along(record, f, lanes, c_i + 1))
        loss = loss[:, c["lo"]:].double()
        valid = (torch.arange(c["lo"], c["hi"], device=dev)[None]
                 < record["lengths"][f][:, None]).double()
        out.append(((loss * valid).sum(1) / valid.sum(1).clamp(min=1.0))
                   .view(-1, R))
    return out


def check_beam(frame: Frame, record: dict, files, sigma: float,
               K: int) -> dict:
    """``score_gap``, ``selection_break_share``, ``resample_gap`` and
    ``emit_gap`` over the record's files ``files`` (all their lanes)."""
    chunks = record["chunks"]
    R = chunks[0]["score"].shape[1]
    dev = record["dqs"].device
    files = torch.as_tensor(files, device=dev)
    n = files.shape[0]
    lengths = record["lengths"][files]
    cum = torch.zeros(n, R, dtype=torch.float64, device=dev)
    score_gap, breaks, choices, resample_gap = 0.0, 0, 0, 0.0
    std = frame.tr.std
    for c_i, (c, ref) in enumerate(zip(chunks, chunk_scores(frame, record,
                                                            files))):
        mine, kept = c["score"][files], c["kept"][files]
        score_gap = max(score_gap, _widest(
            ((ref - mine) / mine.abs().clamp(min=1e-12))[kept]))
        n_valid = (lengths - c["lo"]).clamp(0, c["hi"] - c["lo"])
        cum = cum + torch.where(kept, ref, mine) \
            * (n_valid / lengths.clamp(min=1)).double()[:, None]
        if c_i + 1 == len(chunks):
            break
        parent = c["parent"][files]                    # (n, R) local lanes
        kth = cum.sort(dim=1).values[:, K - 1:K]
        surv = cum.gather(1, parent[:, :K])
        breaks += int((~(surv <= kth * (1 + SELECT_REL))).sum())
        choices += surv.numel()
        nxt = chunks[c_i + 1]
        moved = (torch.arange(R, device=dev) >= K)[None, :, None]
        eps = record["eps"][c_i][files]
        for k, end in c["end"].items():
            want = end[files[:, None], parent]
            if k == "latent":
                want = want + torch.where(moved, sigma * std * eps, 0.0)
            resample_gap = max(resample_gap, _widest(
                (nxt["start"][k][files] - want)[nxt["kept"][files]]))
        cum = cum.gather(1, parent)
    won = torch.as_tensor(record["cum"], device=dev)[files].argmin(1)
    best = cum.min(dim=1).values
    breaks += int((~(cum.gather(1, won[:, None])[:, 0]
                     <= best * (1 + SELECT_REL))).sum())
    choices += n
    stored = _along(record, files, lineage(record, files, won), len(chunks))
    emit_gap = max(_widest(record["emitted"][k][files].to(stored[k].dtype)
                           - stored[k]) for k in LEAVES)
    return dict(score_gap=score_gap,
                selection_break_share=breaks / max(choices, 1),
                resample_gap=resample_gap, emit_gap=emit_gap)


def follow_beam(frame: Frame, record: dict, check_files, lineages,
                sigma: float, K: int) -> dict:
    """The offline numbers of :func:`judge.follow_offline` over the
    lineages ``lineages`` ((file, last lane) pairs: the checked files'
    winners and lanes drawn across the beam), and :func:`check_beam`'s
    over the files ``check_files``."""
    dev = record["dqs"].device
    f = torch.as_tensor([x[0] for x in lineages], device=dev)
    last = torch.as_tensor([x[1] for x in lineages], device=dev)
    res = follow_jumping(frame, *follow_lineages(frame, record, f, last,
                                                 sigma, K))
    res.update(check_beam(frame, record, check_files, sigma, K))
    return res
