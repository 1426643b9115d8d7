"""Plain reference of one DragPoser frame, for a batch of independent lanes.

A frame, as the DragPoser paper and its reference code define it:

1. at a window boundary (every frame for window 0) the temporal transformer
   predicts the next ``window + 1`` latents autoregressively from the ring
   buffers of past latents, accumulated root displacements and heights;
2. fresh Adam (lr, 0.9, 0.999, 1e-8) moves the latent to fit the trackers:
   the decoded pose's root-space FK against the tracker positions and
   rotation matrices, plus ``lambda_temporal`` times the squared distance to
   the predicted latent;
3. the stop rule, on the values of the previous iteration:
   ``(loss_pos > eps_pos or loss_rot > eps_rot) and t < max_iter and
   loss_incr > min_incr``;
4. the frame ends: the root advances by the decoded displacement (and, with
   the joint adjustment, is pulled to the tracked root), the ring buffers
   take the latent *before* the last Adam step.

The gradient is ``torch.autograd``'s.  Nothing of the program is imported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from benchmark.reference.model import Skeleton, Transformer, Vae, fk, qmatrix
from benchmark.reference.model import qmul, qrotate

ADAM = (0.9, 0.999, 1e-8)
FIRST_PREV_LOSS = 1e7
# A stop decision whose inputs lie this close to a threshold may go either
# way under rounding: relative to the threshold for the two losses, relative
# to the frame's loss for the loss decrease.
KNIFE_REL = 1e-3
# Adam divides by the root of its second moment: while a component's
# gradients have all been this small (100 times Adam's epsilon), rounding
# sets the sign of a step of up to ``lr`` in it.
KNIFE_G = 1e-6


@dataclass(frozen=True)
class Hyper:
    mask: Tuple[float, ...]
    weights: Tuple[Tuple[float, float], ...]
    lambda_rot: float
    lambda_temporal: float
    window: int
    sample_step: int
    past_frames: Tuple[int, ...]
    height_indices: Tuple[int, ...]
    adjustment: Optional[Tuple[int, int]]    # (joint, end-effector joint)
    adjustment_weight: float
    max_iter: int
    eps_pos: float
    eps_rot: float
    min_incr: float
    lr: float

    @property
    def buffer_rows(self) -> int:
        return self.past_frames[-1] + self.sample_step


class Frame:
    """The frame's arithmetic on lanes (B, ...) on one device."""

    def __init__(self, vae: Vae, transformer: Transformer,
                 skeleton: Skeleton, hyper: Hyper):
        self.vae, self.tr, self.sk, self.h = vae, transformer, skeleton, hyper
        dev = vae.mean_q.device
        self.mask = torch.tensor(hyper.mask, dtype=torch.float32, device=dev)
        w = torch.tensor(hyper.weights, dtype=torch.float32, device=dev)
        self.w_pos, self.w_rot = self.mask * w[:, 0], self.mask * w[:, 1]
        self.n_ee = max(float(sum(hyper.mask)), 1.0)
        self.height_idx = list(hyper.height_indices)

    # -- the start of a lane ------------------------------------------------
    def initial_latent(self, dqs_norm0, noise):
        """Normalized dual quaternions (B, J*8) of the first frame and a
        standard normal draw (B, L) → the first latent."""
        mu, logvar = self.vae.encode(dqs_norm0)
        return mu + noise * torch.exp(0.5 * logvar)

    def initial_buffers(self, latent, heights0):
        B, rows = latent.shape[0], self.h.buffer_rows
        return (latent[:, None].repeat(1, rows, 1),
                torch.zeros(B, rows, 3, device=latent.device),
                heights0[:, None].repeat(1, rows, 1))

    # -- 1. the rollout -----------------------------------------------------
    def rollout(self, lat_buf, disp_buf, height_buf):
        """Ring buffers (B, P, ·), oldest row first → predicted latents for
        the window's slots (B, W+1, L)."""
        h, tr = self.h, self.tr
        past = list(h.past_frames)
        lat = lat_buf[:, past]
        disp = torch.stack([disp_buf[:, p:p + h.sample_step].sum(1)
                            for p in past[:-1]], dim=1)
        enc = torch.cat(((lat[:, :-1] - tr.mean) / tr.std, disp,
                         height_buf[:, past[:-1]]), dim=-1)
        steps = h.window // h.sample_step + 1
        tokens = torch.zeros(lat.shape[0], steps, lat.shape[-1],
                             device=lat.device)
        tokens[:, 0] = (lat[:, -1] - tr.mean) / tr.std
        outs = torch.zeros_like(tokens)
        cols = torch.arange(steps, device=lat.device)
        for k in range(steps):
            mask = torch.where(cols <= k, 0.0, float("-inf"))[None]
            out = tr(enc, tokens, mask)[:, k]
            outs[:, k] = out
            if k + 1 < steps:
                tokens[:, k + 1] = out
        outs = outs * tr.std + tr.mean
        if h.window == 0:
            return outs[:, :1]
        hold = np.minimum(np.arange(h.window + 1) // h.sample_step + 1,
                          h.window // h.sample_step)
        return outs[:, hold]

    # -- 2. targets and the loss --------------------------------------------
    def targets_from_motion(self, dqs_norm, gt_pos, gt_rot, prev_pos):
        """Tracker targets of a recorded frame: its pose's root-space FK from
        the previous root position → ((B, J, 3), (B, J, 3, 3))."""
        q = self.vae.quats(dqs_norm.unflatten(-1, (-1, 8))[..., :4]
                           .flatten(-2))
        rs = torch.cat((gt_rot[:, None], q[:, 1:]), dim=1)
        pos, world = fk(self.sk, rs, gt_pos - prev_pos)
        return pos, qmatrix(world)

    def loss(self, z, global_rot, tpos, trot, tlat):
        pose_n, disp_n = self.vae.decode(z)
        q = self.vae.quats(pose_n)
        disp = disp_n * self.vae.std_disp + self.vae.mean_disp
        world_rot = qmul(global_rot, q[:, 0])
        world_disp = qrotate(world_rot, disp)
        rs = torch.cat((world_rot[:, None], q[:, 1:]), dim=1)
        pos, world = fk(self.sk, rs, world_disp)
        l_pos = (self.w_pos[:, None] * (pos - tpos) ** 2).sum((-2, -1)) \
            / (self.n_ee * 3.0)
        l_rot = (self.w_rot[:, None, None] * (qmatrix(world) - trot) ** 2
                 ).sum((-3, -2, -1)) / (self.n_ee * 9.0) * self.h.lambda_rot
        l_t = ((z - tlat) ** 2).mean(-1) * self.h.lambda_temporal
        aux = dict(loss_pos=l_pos, loss_rot=l_rot, pose_n=pose_n, disp=disp,
                   world_rot=world_rot, world_disp=world_disp, pos=pos)
        return l_pos + l_rot + l_t, aux

    # -- 3. Adam and the stop rule ------------------------------------------
    def _exact_continue(self, k, l_pos, l_rot, incr):
        h = self.h
        if k == 0:
            return torch.ones_like(l_pos, dtype=torch.bool)
        return (((l_pos > h.eps_pos) | (l_rot > h.eps_rot))
                & (k < h.max_iter) & (incr > h.min_incr))

    def optimize(self, z0, global_rot, tpos, trot, tlat, live,
                 candidates: bool = False):
        """Fresh Adam from ``z0`` on the lanes where ``live``, each lane
        stopping by the stop rule, exactly.  Returns a dict: ``steps``;
        ``latent`` the latent after the last step; ``decoded`` the latent
        before it, with the loss terms of that latent (``aux``); ``knife``,
        whether some step's direction in some component was set by rounding
        (:data:`KNIFE_G`).  With
        ``candidates``, each lane runs on while the rule may continue up to
        rounding, and ``candidates`` lists, for every k after which the rule
        may stop, (k, the lanes that may stop there, the latent after k
        steps, the latent before, its loss terms)."""
        h = self.h
        b1, b2, eps = ADAM
        B = z0.shape[0]
        dev = z0.device
        z, m, v = z0.clone(), torch.zeros_like(z0), torch.zeros_like(z0)
        prev_total = torch.full((B,), FIRST_PREV_LOSS, device=dev)
        l_pos = torch.full((B,), float("inf"), device=dev)
        l_rot = l_pos.clone()
        incr = torch.ones(B, device=dev)
        running = live.clone()
        taken = torch.zeros(B, dtype=torch.long, device=dev)
        knife = torch.zeros(B, dtype=torch.bool, device=dev)
        out_z, out_dec, out_aux = z0.clone(), z0.clone(), None
        found = []
        k = 0
        while True:
            if candidates:
                may_go, may_stop = decision(
                    h, torch.full_like(prev_total, float(k)), l_pos, l_rot,
                    incr, prev_total)
                if k > 0 and bool((running & may_stop).any()):
                    found.append((k, running & may_stop, z.clone(),
                                  out_dec.clone(),
                                  {a: t.clone() for a, t in out_aux.items()}))
                running = running & may_go
            else:
                running = running & self._exact_continue(k, l_pos, l_rot,
                                                         incr)
            if not bool(running.any()):
                break
            with torch.enable_grad():
                zg = z.detach().requires_grad_(True)
                total, aux = self.loss(zg, global_rot, tpos, trot, tlat)
                (g,) = torch.autograd.grad(total.sum(), zg)
            total = total.detach()
            aux = {a: t.detach() for a, t in aux.items()}
            k += 1
            t = torch.tensor(float(k), device=dev)
            m_new = b1 * m + (1 - b1) * g
            v_new = b2 * v + (1 - b2) * g * g
            root_v = torch.sqrt(v_new / (1 - b2 ** t))
            z_new = z - h.lr * (m_new / (1 - b1 ** t)) / (root_v + eps)
            r = running[:, None]
            knife |= running & (root_v < KNIFE_G).any(-1)
            out_dec = torch.where(r, z, out_dec)
            if out_aux is None:
                out_aux = aux
            out_aux = {a: torch.where(running.reshape((B,) + (1,) * (
                t_.dim() - 1)), t_, out_aux[a]) for a, t_ in aux.items()}
            z = torch.where(r, z_new, z)
            m = torch.where(r, m_new, m)
            v = torch.where(r, v_new, v)
            out_z = z
            taken = taken + running.long()
            incr = torch.where(running, prev_total - total, incr)
            l_pos = torch.where(running, aux["loss_pos"], l_pos)
            l_rot = torch.where(running, aux["loss_rot"], l_rot)
            prev_total = torch.where(running, total, prev_total)
        return dict(steps=taken, latent=out_z, decoded=out_dec, aux=out_aux,
                    knife=knife, candidates=found)

    # -- 4. the end of a frame ----------------------------------------------
    def finish(self, prev_pos, aux, tpos):
        """(global position, global rotation, buffer displacement, buffer
        heights) of the frame from the loss terms of its decoded latent."""
        pos = prev_pos + aux["world_disp"]
        disp = aux["disp"]
        if self.h.adjustment is not None:
            joint, ee = self.h.adjustment
            adj = (tpos[:, ee] - aux["pos"][:, joint]) \
                * self.h.adjustment_weight
            pos, disp = pos + adj, disp + adj
        heights = (aux["pos"] + pos[:, None])[:, self.height_idx, 1]
        return pos, aux["world_rot"], disp, heights

    def root_pose(self, world_rot):
        """The output pose's root slot: the world rotation, normalized."""
        return (world_rot - self.vae.mean_q[:4]) / self.vae.std_q[:4]


def decision(h: Hyper, k, l_pos, l_rot, incr, total):
    """(may continue, may stop) after ``k`` steps (a tensor, per lane),
    allowing for rounding at each threshold (:data:`KNIFE_REL`): the stop
    rule's values after ``k`` steps are those of the latent before the
    k-th."""
    r = KNIFE_REL
    tol = r * total.abs()
    sure = (((l_pos > h.eps_pos * (1 + r)) | (l_rot > h.eps_rot * (1 + r)))
            & (incr > h.min_incr + tol))
    maybe = (((l_pos > h.eps_pos * (1 - r)) | (l_rot > h.eps_rot * (1 - r)))
             & (incr > h.min_incr - tol))
    first, last = k == 0, k >= h.max_iter
    return (first | (maybe & ~last)), (last | (~sure & ~first))


def shift(buf, row):
    return torch.cat((buf[:, 1:], row[:, None]), dim=1)
