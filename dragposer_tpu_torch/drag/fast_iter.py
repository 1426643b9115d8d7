"""Batch-in-lanes drag iteration (port of ``dragposer_tpu/drag/fast_iter.py``).

The drag loss is evaluated on per-joint *component planes* of shape (J, B)
with the batch last, as in the JAX module, so the port's public functions
take the same layouts.  :func:`run_block` is the plain PyTorch twin of
kernel K1 (``iter_kernel.run_block_fused``): ``sync_k`` masked Adam steps
whose gradient comes from ``torch.autograd``.  ``COUNTS.plain`` counts its
calls, ``COUNTS.aux`` its aux rebuilds.

Semantics mirror ``engine._drag_loss`` / ``_opt_body`` / ``_opt_cond``
(formula-level; reductions associate differently, so results are
fp-equivalent, not bitwise).  Constraints are not supported.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from dragposer_tpu_torch import _build
from dragposer_tpu_torch.drag import engine as eng
from dragposer_tpu_torch.models import skeleton_nn
from dragposer_tpu_torch.ops.topology import Skeleton


class _Counts(_build.KernelCounts):
    """K1's launch counts, its twin's, and the aux rebuilds by the plain
    forward (:func:`aux_at`), which only the twin makes."""

    def __init__(self):
        super().__init__("K1")
        self.aux = 0

    def reset(self):
        super().reset()
        self.aux = 0


COUNTS = _Counts()


class FastContext(NamedTuple):
    """Loop-invariant constants in transposed, component-major layout."""

    W1: Any        # (H1, L)
    b1: Any        # (H1, 1)
    W2: Any        # (H2, H1)
    b2: Any        # (H2, 1)
    W3p: Any       # (4J+3, H2) quat rows component-major, then disp
    b3p: Any       # (4J+3, 1)
    sq: Any        # (4, J, 1) quat stds, component-major
    mq: Any        # (4, J, 1)
    sd: Any        # (3, 1)
    md: Any        # (3, 1)
    parents: Any   # (J,) long
    A: Any         # (J, J) ancestor matrix
    offs: Any      # (3, J, 1) bone offsets, component planes
    w_pos: Any     # (J, 1) or per lane (J, B)
    w_rot: Any     # (J, 1) or per lane (J, B)
    n_ee: Any      # () or per lane (B,)
    unperm: Any    # (4J,) component-major → interleaved wxyz
    dq_perm: Any   # (4J,) quat channels of a (B, J*8) dual-quat row


def mask_planes(mask, weights):
    """The loss weights of :class:`FastContext`: ``w_pos``, ``w_rot``
    (J, 1) and ``n_ee`` () from a mask (J,) and weights (J, 2), or per lane
    (J, B) and (B,) from (B, J) and (B, J, 2)."""
    if mask.dim() == 2:
        return ((mask * weights[..., 0]).T, (mask * weights[..., 1]).T,
                torch.clamp(mask.sum(dim=-1), min=1.0))
    return ((mask * weights[:, 0])[:, None], (mask * weights[:, 1])[:, None],
            torch.clamp(mask.sum(), min=1.0))


def make_context(model: eng.DragModel, skeleton: Skeleton,
                 hyper: eng.DragHyper) -> FastContext:
    folded = model.decoder
    if not (isinstance(folded, dict) and "ws" in folded):
        raise NotImplementedError("the fast path needs the folded decoder")
    dev = folded["ws"][0].device
    J = skeleton.n_joints
    perm = np.concatenate([np.arange(J) * 4 + c for c in range(4)])
    dq_perm = np.concatenate([np.arange(J) * 8 + c for c in range(4)])
    idx = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    W3, b3 = folded["ws"][2], folded["bs"][2]
    W3p = torch.cat((W3[: 4 * J][idx(perm)], W3[4 * J: 4 * J + 3]))
    b3p = torch.cat((b3[: 4 * J][idx(perm)], b3[4 * J: 4 * J + 3]))[:, None]
    mean_q, std_q = eng._quat_stats(model)
    w_pos, w_rot, n_ee = mask_planes(model.mask, model.weights)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    return FastContext(
        W1=folded["ws"][0], b1=folded["bs"][0][:, None],
        W2=folded["ws"][1], b2=folded["bs"][1][:, None],
        W3p=W3p, b3p=b3p,
        sq=std_q[idx(perm)].reshape(4, J, 1),
        mq=mean_q[idx(perm)].reshape(4, J, 1),
        sd=model.std_disp[:, None], md=model.mean_disp[:, None],
        parents=idx(np.asarray(skeleton.parents, np.int64)),
        A=f32(skeleton.ancestors),
        offs=f32(np.asarray(skeleton.offsets).T[:, :, None]),
        w_pos=w_pos, w_rot=w_rot, n_ee=n_ee,
        unperm=idx(np.argsort(perm)), dq_perm=idx(dq_perm),
    )


def _qmul(aw, ax, ay, az, bw, bx, by, bz):
    """Hamilton product on component planes (``quat.mul``)."""
    return (aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw)


def _qrot(qw, qx, qy, qz, vx, vy, vz):
    """Rotate vector planes by unit-quat planes (``quat.mul_vec``)."""
    cx1 = qy * vz - qz * vy
    cy1 = qz * vx - qx * vz
    cz1 = qx * vy - qy * vx
    cx2 = qy * cz1 - qz * cy1
    cy2 = qz * cx1 - qx * cz1
    cz2 = qx * cy1 - qy * cx1
    return (vx + 2.0 * (qw * cx1 + cx2),
            vy + 2.0 * (qw * cy1 + cy2),
            vz + 2.0 * (qw * cz1 + cz2))


def _rotmat_planes(ww, wx, wy, wz):
    x2, y2, z2 = wx + wx, wy + wy, wz + wz
    xx, yy, zz = wx * x2, wy * y2, wz * z2
    wx_, wy_, wz_ = ww * x2, ww * y2, ww * z2
    xy, xz, yz = wx * y2, wx * z2, wy * z2
    return (1.0 - (yy + zz), xy - wz_, xz + wy_,
            xy + wz_, 1.0 - (xx + zz), yz - wx_,
            xz - wy_, yz + wx_, 1.0 - (xx + yy))


def _fk_planes(ctx: FastContext, ww, wx, wy, wz, rootx, rooty, rootz):
    """Positions (J, B) planes: root + A @ rotate(world[parent], offset)."""
    par = ctx.parents
    cx, cy, cz = _qrot(ww[par], wx[par], wy[par], wz[par],
                       ctx.offs[0], ctx.offs[1], ctx.offs[2])
    return (ctx.A @ cx + rootx[None], ctx.A @ cy + rooty[None],
            ctx.A @ cz + rootz[None])


class ForwardT(NamedTuple):
    total: Any      # (B,)
    loss_pos: Any   # (B,)
    loss_rot: Any   # (B,) λ_rot applied
    pose_cm: Any    # (4J, B) normalized pose, component-major
    disp: Any       # (3, B) denormalized root displacement
    wr: Any         # (4, B) world rotation
    wd: Any         # (3, B) world displacement
    pos: Any        # (J, 3, B) FK positions (previous root = origin)


def forward_T(ctx: FastContext, hyper: eng.DragHyper, zT, grT, tposT, trotT,
              tlatT) -> ForwardT:
    """Transposed ``engine._drag_loss``: zT (L, B), grT (4, B), tposT
    (J, 3, B), trotT (J, 3, 3, B), tlatT (L, B).  LeakyReLU slope 0.2."""
    h = skeleton_nn.leaky_relu(ctx.W1 @ zT + ctx.b1)
    h = skeleton_nn.leaky_relu(ctx.W2 @ h + ctx.b2)
    h = ctx.W3p @ h + ctx.b3p                          # (4J+3, B)
    return loss_from_decoded(ctx, hyper, h, zT, grT, tposT, trotT, tlatT)


def loss_from_decoded(ctx: FastContext, hyper: eng.DragHyper, h, zT, grT,
                      tposT, trotT, tlatT) -> ForwardT:
    """The rest of :func:`forward_T` after the decoder: ``h`` (4J+3, B) is
    the decoder's output for the latent ``zT`` (L, B)."""
    J = ctx.parents.shape[0]
    x = h[: 4 * J].reshape(4, J, -1) * ctx.sq + ctx.mq
    u = x / torch.sqrt(torch.sum(x * x, dim=0))[None]  # unit quats (4, J, B)
    pose_cm = ((u - ctx.mq) / ctx.sq).reshape(4 * J, -1)
    disp = h[4 * J: 4 * J + 3] * ctx.sd + ctx.md       # (3, B)

    Ww, Wx, Wy, Wz = _qmul(grT[0], grT[1], grT[2], grT[3],
                           u[0, 0], u[1, 0], u[2, 0], u[3, 0])
    ww, wx, wy, wz = _qmul(Ww[None], Wx[None], Wy[None], Wz[None],
                           u[0], u[1], u[2], u[3])
    row0 = (torch.arange(J, device=zT.device) == 0)[:, None]
    ww = torch.where(row0, Ww[None], ww)
    wx = torch.where(row0, Wx[None], wx)
    wy = torch.where(row0, Wy[None], wy)
    wz = torch.where(row0, Wz[None], wz)
    wdx, wdy, wdz = _qrot(Ww, Wx, Wy, Wz, disp[0], disp[1], disp[2])
    posx, posy, posz = _fk_planes(ctx, ww, wx, wy, wz, wdx, wdy, wdz)

    dx = posx - tposT[:, 0]
    dy = posy - tposT[:, 1]
    dz = posz - tposT[:, 2]
    loss_pos = torch.sum(ctx.w_pos * (dx * dx + dy * dy + dz * dz), dim=0) \
        / (ctx.n_ee * 3.0)
    lr_acc = 0.0
    for k, m in enumerate(_rotmat_planes(ww, wx, wy, wz)):
        d = m - trotT[:, k // 3, k % 3]
        lr_acc = lr_acc + ctx.w_rot * (d * d)
    loss_rot = torch.sum(lr_acc, dim=0) / (ctx.n_ee * 9.0) * hyper.lambda_rot
    loss_temporal = torch.mean((zT - tlatT) ** 2, dim=0)
    lam_t = hyper.lambda_temporal if hyper.use_temporal else 0.0
    total = loss_pos + loss_rot + loss_temporal * lam_t
    return ForwardT(total=total, loss_pos=loss_pos, loss_rot=loss_rot,
                    pose_cm=pose_cm, disp=disp,
                    wr=torch.stack((Ww, Wx, Wy, Wz)),
                    wd=torch.stack((wdx, wdy, wdz)),
                    pos=torch.stack((posx, posy, posz), dim=1))


def eval_targets_T(ctx: FastContext, hyper: eng.DragHyper, global_pos_b,
                   dqs_f, gt_pos, gt_rot):
    """Per-frame end-effector targets from ground truth, whole batch
    (``engine._eval_targets`` on planes).  ``global_pos_b`` (B, 3),
    ``dqs_f`` (B, J*8) normalized, ``gt_pos`` (B, 3), ``gt_rot`` (B, 4) →
    ``(tposT (J, 3, B), trotT (J, 3, 3, B))``."""
    J = ctx.parents.shape[0]
    q = dqs_f[:, ctx.dq_perm].T.reshape(4, J, -1) * ctx.sq + ctx.mq
    grT = gt_rot.T
    row0 = (torch.arange(J, device=dqs_f.device) == 0)[:, None]
    rs = [torch.where(row0, grT[c][None], q[c]) for c in range(4)]
    ww, wx, wy, wz = _qmul(grT[0][None], grT[1][None], grT[2][None],
                           grT[3][None], rs[0], rs[1], rs[2], rs[3])
    ww = torch.where(row0, grT[0][None], ww)
    wx = torch.where(row0, grT[1][None], wx)
    wy = torch.where(row0, grT[2][None], wy)
    wz = torch.where(row0, grT[3][None], wz)
    disp = (gt_pos - global_pos_b).T
    posx, posy, posz = _fk_planes(ctx, ww, wx, wy, wz, disp[0], disp[1],
                                  disp[2])
    tposT = torch.stack((posx, posy, posz), dim=1)
    ms = _rotmat_planes(ww, wx, wy, wz)
    trotT = torch.stack([torch.stack(ms[3 * r: 3 * r + 3], dim=1)
                         for r in range(3)], dim=1)   # (J, 3, 3, B)
    return tposT, trotT


def aux_at(ctx: FastContext, hyper: eng.DragHyper, decT, grT, tposT, trotT,
           tlatT) -> eng._LossAux:
    """``_LossAux`` rebuilt at the decoded latent (L, B) (counted in
    ``COUNTS.aux``)."""
    COUNTS.aux += 1
    with torch.no_grad():
        f = forward_T(ctx, hyper, decT, grT, tposT, trotT, tlatT)
    c = lambda x: x.contiguous()  # noqa: E731
    return eng._LossAux(
        loss_pos=f.loss_pos, loss_rot=f.loss_rot,
        world_displacement=c(f.wd.T), displacement=c(f.disp.T),
        world_rotation=c(f.wr.T), positions=c(f.pos.permute(2, 0, 1)),
        pose=c(f.pose_cm[ctx.unperm].T))


def run_block(ctx: FastContext, hyper: eng.DragHyper, sync_k: int,
              opt: eng._OptCarry, lane_active, state, tposT, trotT,
              target_latent):
    """``sync_k`` masked Adam iterations in transposed layout → updated
    ``_OptCarry`` (aux recomputed at the decoded latent).  K1's plain twin.
    Targets arrive transposed: ``tposT`` (J, 3, B), ``trotT`` (J, 3, 3, B).
    (The JAX function's ``model``/``statics``/``skeleton`` arguments serve
    constraints, which take the pipeline's per-lane loop here.)"""
    grT = state.global_rot.T
    tlatT = target_latent.T
    z, m, v, dec = opt.latent.T, opt.m.T, opt.v.T, opt.decoded_latent.T
    t, prev = opt.t, opt.prev_loss
    lp, lr, li = opt.loss_pos, opt.loss_rot, opt.loss_incr
    for _ in range(sync_k):
        active = (((lp > hyper.stop_eps_pos) | (lr > hyper.stop_eps_rot))
                  & (t < hyper.max_iter) & (li > hyper.min_loss_incr)
                  & lane_active)
        with torch.enable_grad():
            zg = z.detach().requires_grad_(True)
            f = forward_T(ctx, hyper, zg, grT, tposT, trotT, tlatT)
            (g,) = torch.autograd.grad(f.total.sum(), zg)
        total = f.total.detach()
        t_n = t + 1
        m_n = eng._ADAM_B1 * m + (1.0 - eng._ADAM_B1) * g
        v_n = eng._ADAM_B2 * v + (1.0 - eng._ADAM_B2) * g * g
        tf = t_n.to(torch.float32)
        m_hat = m_n / (1.0 - eng._ADAM_B1 ** tf)
        v_hat = v_n / (1.0 - eng._ADAM_B2 ** tf)
        z_n = z - hyper.learning_rate * m_hat / (torch.sqrt(v_hat)
                                                 + eng._ADAM_EPS)
        a_r = active[None]
        z, m, v, dec = (torch.where(a_r, z_n, z), torch.where(a_r, m_n, m),
                        torch.where(a_r, v_n, v), torch.where(a_r, z, dec))
        t = torch.where(active, t_n, t)
        li = torch.where(active, prev - total, li)
        prev = torch.where(active, total, prev)
        lp = torch.where(active, f.loss_pos.detach(), lp)
        lr = torch.where(active, f.loss_rot.detach(), lr)
    aux = aux_at(ctx, hyper, dec, grT, tposT, trotT, tlatT)
    COUNTS.launched(plain=True, lanes=z.shape[1], t0=opt.t, t1=t)
    return eng._OptCarry(
        latent=z.T, m=m.T, v=v.T, t=t, prev_loss=prev, loss_pos=lp,
        loss_rot=lr, loss_incr=li, decoded_latent=dec.T, aux=aux)
