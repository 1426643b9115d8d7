"""Holds what the program produced against the plain reference.

A lane's frames form a chain: each frame starts from the latent the last one
ended on, and its stop rule has knife edges, where rounding alone changes
the count of Adam steps and, after it, every later frame.  So the reference
follows the program frame by frame from the program's own state, and judges
each frame by itself:

* offline: the program's outputs of frame f-1 (stored latent, root position
  and rotation; the start latent is the stored one moved by the reference's
  own last Adam step, as the program keeps no other); the
  program's count of Adam steps must be one the stop rule allows up to
  rounding, and the frame's outputs at that count are compared; the
  epilogue's pose is compared with the reference's decode of the
  program's stored latent;
* session: the program's whole state after frame f-1; every count the stop
  rule allows is a candidate, and the closest is compared.

Offline, the numbers are the widest gap of the first latent (the encoder)
and of the epilogue's pose; the share of the sound frames whose stored
latent the reference does not reproduce to :data:`REPRODUCED`; the share
of the reproduced frames whose count of steps the stop rule does not allow
(a frame that is not reproduced is counted by the share before); and, by
the fit that the stored latent gives, the loss the reference reads there
over the loss of its own latent after as many steps, less 1: its median
in the worst lane, and the size of its median over the frames of the last
quarter of the longest lane's length (the ragged tail's late blocks, where
only the long lanes live).  Rounding turns the sign of Adam's step in a component whose
gradient is all but nought, so a few frames in a hundred, and their next
few, take another path, by up to ~2 lr in a flat direction: their latent is
not reproduced, but their fit is the reference's to a few parts in 1e4.

In a session, the frames are sampled alike from every slot of the window;
the numbers are the 90th percentile over the frames of each frame's widest
gap of the latent, the local rotations and the root, the same gaps' median
in the worst slot (a fault confined to one slot shows there; the widest
swings with a rare frame whose Adam steps rounding turns), and the widest
gap of the rollout.  Frames where Adam's direction
in some component was set by rounding (``drag.KNIFE_G``) are left out of
the numbers that follow Adam (offline the latent's and the stop rule's; in
a session all but the rollout's).
"""

from __future__ import annotations

import torch

from benchmark.reference.drag import (ADAM, FIRST_PREV_LOSS, KNIFE_G, Frame,
                                       decision)
from benchmark.reference.model import qmatrix, qmul, to_local


# A frame whose stored latent the reference reproduces to this is one whose
# stop decisions it can judge: past it, the frame's late Adam steps have
# taken another path (long optimizations amplify rounding).
REPRODUCED = 1e-3


def _gap(a, b, rows=None):
    d = (a - b).abs().flatten(1).amax(1)
    return d if rows is None else torch.where(rows, d, 0.0)


class _Lanes:
    """Adam over every lane at once, each lane on its own frame, taking the
    program's count of steps on that frame: the reference's own pipeline.
    One call of :meth:`step` is one Adam step of every lane that has steps
    left; it updates the carry in place, without a host sync, so that on
    the card it can be captured once as a CUDA graph and replayed."""

    CARRY = ("z", "m", "v", "k", "prev", "l_pos", "l_rot", "incr", "dec",
             "knife", "ok")

    def __init__(self, frame: Frame, B: int, L: int, J: int, device):
        self.frame = frame
        z = lambda *s: torch.zeros((B,) + s, device=device)  # noqa: E731
        self.c = dict(z=z(L), m=z(L), v=z(L), k=z(), prev=z(), l_pos=z(),
                      l_rot=z(), incr=z(), dec=z(L),
                      knife=z().bool(), ok=z().bool())
        self.x = dict(rot=z(4), tpos=z(J, 3), trot=z(J, 3, 3), tlat=z(L),
                      n=z(), live=z().bool())

    def start(self, rows, z0, inputs: dict) -> None:
        """Lanes ``rows`` begin a frame from ``z0`` with ``inputs``."""
        c, x = self.c, self.x
        for k, v in inputs.items():
            x[k][rows] = v
        c["z"][rows] = z0
        c["dec"][rows] = z0
        for k in ("m", "v", "k"):
            c[k][rows] = 0.0
        c["prev"][rows] = FIRST_PREV_LOSS
        c["l_pos"][rows] = float("inf")
        c["l_rot"][rows] = float("inf")
        c["incr"][rows] = 1.0
        c["knife"][rows] = False
        c["ok"][rows] = True

    def step(self) -> None:
        c, x, fr = self.c, self.x, self.frame
        h = fr.h
        b1, b2, eps = ADAM
        may_go, may_stop = decision(h, c["k"], c["l_pos"], c["l_rot"],
                                    c["incr"], c["prev"])
        run = x["live"] & (c["k"] < x["n"])
        at_end = x["live"] & (c["k"] == x["n"])
        c["ok"].copy_(c["ok"] & ~(at_end & ~may_stop) & ~(run & ~may_go))
        with torch.enable_grad():
            zg = c["z"].detach().requires_grad_(True)
            total, aux = fr.loss(zg, x["rot"], x["tpos"], x["trot"],
                                 x["tlat"])
            (g,) = torch.autograd.grad(total.sum(), zg)
        total = total.detach()
        t = c["k"][:, None] + 1.0
        m = b1 * c["m"] + (1 - b1) * g
        v = b2 * c["v"] + (1 - b2) * g * g
        root_v = torch.sqrt(v / (1 - b2 ** t))
        z = c["z"] - h.lr * (m / (1 - b1 ** t)) / (root_v + eps)
        r = run[:, None]
        c["knife"].copy_(c["knife"] | (run & (root_v < KNIFE_G).any(-1)))
        c["dec"].copy_(torch.where(r, c["z"], c["dec"]))
        c["z"].copy_(torch.where(r, z, c["z"]))
        c["m"].copy_(torch.where(r, m, c["m"]))
        c["v"].copy_(torch.where(r, v, c["v"]))
        c["k"].copy_(c["k"] + run.float())
        c["incr"].copy_(torch.where(run, c["prev"] - total, c["incr"]))
        c["l_pos"].copy_(torch.where(run, aux["loss_pos"].detach(),
                                     c["l_pos"]))
        c["l_rot"].copy_(torch.where(run, aux["loss_rot"].detach(),
                                     c["l_rot"]))
        c["prev"].copy_(torch.where(run, total, c["prev"]))


def _runner(lanes: _Lanes, device):
    """``lanes.step`` as a callable: a replayed CUDA graph on the card."""
    if torch.device(device).type != "cuda":
        return lanes.step
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    saved = {k: v.clone() for k, v in lanes.c.items()}
    with torch.cuda.stream(side):
        for _ in range(2):
            lanes.step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        lanes.step()
    for k, v in saved.items():
        lanes.c[k].copy_(v)
    return graph.replay


def follow_offline(frame: Frame, inp: dict, out: dict,
                   sync_every: int = 4) -> dict:
    """``inp``: the lanes' inputs, ``dqs`` (B, T, J*8), ``global_pos``
    (B, T, 3), ``global_rot`` (B, T, 4), ``heights0`` (B, H), ``noise``
    (B, L), ``lengths`` (B,).  ``out``: the program's outputs for those
    lanes, ``latent`` (B, T, L), ``global_pos`` (B, T, 3), ``pose``
    (B, T, J*4), ``iterations`` (B, T), and ``initial_latent`` (B, L).

    A frame's state comes from the program's stored outputs of the frame
    before: the ring buffers, the root, and so each frame's targets and
    rollout, worked out again for all frames at once.  The start latent,
    which the program does not store, is its stored latent moved by the
    reference's own last Adam step of the frame before, so each lane runs
    its frames in order."""
    h, vae = frame.h, frame.vae
    dev = inp["dqs"].device
    B, T = inp["dqs"].shape[:2]
    L, J = out["latent"].shape[-1], frame.sk.n_joints
    P = h.buffer_rows
    lengths = inp["lengths"]
    valid = torch.arange(T, device=dev)[None] < lengths[:, None]
    z0 = frame.initial_latent(inp["dqs"][:, 0], inp["noise"])
    res = dict(initial_latent_gap=float(_gap(out["initial_latent"], z0)
                                        .max()))
    dec = out["latent"]
    rot = out["pose"][..., :4] * vae.std_q[:4] + vae.mean_q[:4]
    first = lambda a, b: torch.cat((a[:, None], b[:, :-1]), dim=1)  # noqa: E731
    pos_prev = first(inp["global_pos"][:, 0], out["global_pos"])
    rot_prev = first(inp["global_rot"][:, 0], rot)
    ff = lambda a: a.flatten(0, 1)  # noqa: E731
    tpos, trot = frame.targets_from_motion(
        ff(inp["dqs"]), ff(inp["global_pos"]), ff(inp["global_rot"]),
        ff(pos_prev))
    with torch.no_grad():
        _, aux = frame.loss(ff(dec), ff(rot_prev), tpos, trot, ff(dec))
        _, _, disp, heights = frame.finish(ff(pos_prev), aux, tpos)
    bt = lambda a: a.unflatten(0, (B, T))  # noqa: E731
    seq = lambda fill, a: torch.cat((fill[:, None].expand(  # noqa: E731
        (B, P) + fill.shape[1:]), a), dim=1)
    lat_seq = seq(z0, dec)
    disp_seq = seq(torch.zeros(B, 3, device=dev), bt(disp))
    h_seq = seq(inp["heights0"], bt(heights))
    f = torch.arange(T, device=dev)
    slot = f % h.window if h.window else torch.zeros_like(f)
    starts = torch.unique(f - slot)
    win = starts[:, None] + torch.arange(P, device=dev)[None]
    tbuf = frame.rollout(ff(lat_seq[:, win]), ff(disp_seq[:, win]),
                         ff(h_seq[:, win])).unflatten(0, (B, len(starts)))
    tlat = tbuf[:, torch.searchsorted(starts, f - slot), slot]
    inputs = dict(rot=rot_prev, tpos=bt(tpos), trot=bt(trot), tlat=tlat,
                  n=out["iterations"].float(), live=valid)

    lanes = _Lanes(frame, B, L, J, dev)
    at = torch.zeros(B, dtype=torch.long, device=dev)
    every = torch.arange(B, device=dev)
    lanes.start(every, z0, {k: v[:, 0] for k, v in inputs.items()})
    step = _runner(lanes, dev)
    lat_gap = torch.zeros(B, T, device=dev)
    knife = torch.zeros(B, T, dtype=torch.bool, device=dev)
    ok = torch.ones(B, T, dtype=torch.bool, device=dev)
    excess = torch.zeros(B, T, device=dev)
    c, x = lanes.c, lanes.x
    while bool(x["live"].any()):
        for _ in range(sync_every):
            step()
        done = (x["live"] & (c["k"] == x["n"])).nonzero()[:, 0]
        if not len(done):
            continue
        fd = at[done]
        lat_gap[done, fd] = _gap(dec[done, fd], c["dec"][done])
        knife[done, fd] = c["knife"][done]
        ok[done, fd] = c["ok"][done]
        with torch.no_grad():
            mine, _ = frame.loss(dec[done, fd], x["rot"][done],
                                 x["tpos"][done], x["trot"][done],
                                 x["tlat"][done])
        # ``prev`` is the reference's loss at its own latent before its
        # last step: the one the program stores
        excess[done, fd] = mine / c["prev"][done].clamp(min=1e-12) - 1.0
        nxt = fd + 1
        z_next = dec[done, fd] + c["z"][done] - c["dec"][done]
        at[done] = nxt
        more = nxt < lengths[done]
        x["live"][done[~more]] = False
        rows, nf = done[more], nxt[more]
        if len(rows):
            lanes.start(rows, z_next[more], {k: v[rows, nf]
                                             for k, v in inputs.items()})

    pose_n, _ = vae.decode(ff(dec))
    root = qmul(ff(rot_prev), vae.quats(pose_n)[:, 0])
    pose = bt(torch.cat((frame.root_pose(root), pose_n[:, 4:]), dim=-1))
    sound = valid & ~knife
    reproduced = sound & (lat_gap <= REPRODUCED)
    tail = sound & (torch.arange(T, device=dev)[None]
                    >= (3 * int(lengths.max())) // 4)
    res.update(unreproduced_share=int((sound & ~reproduced).sum()) / max(
                   int(sound.sum()), 1),
               lane_loss_excess_max=max(
                   float(excess[b][sound[b]].median())
                   for b in range(B) if bool(sound[b].any())),
               tail_loss_excess=abs(float(excess[tail].median())),
               stop_rule_break_share=int((reproduced & ~ok).sum()) / max(
                   int(reproduced.sum()), 1),
               pose_gap=float(_gap(out["pose"][valid], pose[valid]).max()),
               latent_gap_p90=float(torch.quantile(lat_gap[sound], 0.9)),
               stop_rule_break_share_all=int((sound & ~ok).sum()) / max(
                   int(sound.sum()), 1),
               frames_checked=int(valid.sum()),
               knife_frames=int((valid & knife).sum()),
               reproduced_frames=int(reproduced.sum()))
    return res


def follow_session(frame: Frame, before: dict, targets: dict,
                   after: dict) -> dict:
    """One realtime frame per row: the program's state ``before`` it
    (``latent``, ``global_pos``, ``global_rot``, ``latent_buffer``,
    ``displacement_buffer``, ``heights_buffer``, ``target_buffer``,
    ``current_index``), the dense targets (``pos`` (N, J, 3) and ``rot``
    (N, J, 4)), and what the program gave (``local`` (N, J, 4),
    ``root`` (N, 3)) and kept (``latent``, ``target_buffer``)."""
    h = frame.h
    n = before["latent"].shape[0]
    dev = before["latent"].device
    boundary = (before["current_index"] == 0) if h.window else \
        torch.ones(n, dtype=torch.bool, device=dev)
    tbuf = before["target_buffer"].clone()
    rollout_gap = 0.0
    if bool(boundary.any()):
        rows = boundary.nonzero().flatten()
        fresh = frame.rollout(before["latent_buffer"][rows],
                              before["displacement_buffer"][rows],
                              before["heights_buffer"][rows])
        tbuf[rows] = fresh
        rollout_gap = float(_gap(after["target_buffer"][rows], fresh).max())
    slot = before["current_index"].long()
    tlat = tbuf[torch.arange(n, device=dev), slot]
    trot = qmatrix(targets["rot"])
    live = torch.ones(n, dtype=torch.bool, device=dev)
    r = frame.optimize(before["latent"], before["global_rot"], targets["pos"],
                       trot, tlat, live, candidates=True)
    best = torch.full((n,), float("inf"), device=dev)
    picked = {k: torch.full((n,), float("inf"), device=dev)
              for k in ("latent_gap", "local_quat_gap", "root_gap_m")}
    for _, ok, z_k, dec, aux in r["candidates"]:
        pos, _, _, _ = frame.finish(before["global_pos"], aux, targets["pos"])
        q = frame.vae.quats(aux["pose_n"])
        q = torch.cat((aux["world_rot"][:, None], q[:, 1:]), dim=1)
        local = to_local(frame.sk, q)
        g = dict(latent_gap=_gap(after["latent"], z_k),
                 local_quat_gap=_gap(after["local"], local),
                 root_gap_m=_gap(after["root"], pos))
        score = torch.stack(list(g.values())).amax(0)
        better = ok & (score < best)
        best = torch.where(better, score, best)
        picked = {k: torch.where(better, g[k], picked[k]) for k in picked}
    sound = ~r["knife"]
    slots = slot[sound].unique()
    gaps = {}
    for k, v in picked.items():
        v = v[sound] if bool(sound.any()) else torch.zeros(1, device=dev)
        gaps[k + "_p90"] = float(torch.quantile(v, 0.9))
        gaps[k + "_max"] = float(v.max())
        gaps[k + "_slot_median_max"] = max(
            (float(picked[k][sound & (slot == s)].median()) for s in slots),
            default=0.0)
    gaps["rollout_gap"] = rollout_gap
    gaps["frames_checked"] = n
    gaps["knife_frames"] = int(r["knife"].sum())
    return gaps
