"""K1: the drag-iteration block as one CUDA kernel (port of
``dragposer_tpu/drag/iter_kernel.py``).

:func:`run_block_fused` is the drop-in for ``fast_iter.run_block``: same
inputs, same ``_OptCarry`` out.  On CUDA tensors it launches
``csrc/iter_block.cu`` (one warp per lane, the sync_k loop inside the
kernel, the gradient written by hand); on CPU tensors it runs the plain
twin ``fast_iter.run_block``.  Either way the aux is then rebuilt by the
plain ``fast_iter.forward_T`` at the decoded latent, as the JAX module does
in XLA (``iter_kernel.py:359-368``).  ``COUNTS`` (shared with
``fast_iter``) counts kernel launches and plain calls.
"""

from __future__ import annotations

import ctypes
from typing import Any, NamedTuple

import numpy as np
import torch

from dragposer_tpu_torch import _build
from dragposer_tpu_torch.drag import engine as eng
from dragposer_tpu_torch.drag import fast_iter

COUNTS = fast_iter.COUNTS
MAX_JOINTS = 32
MAX_LATENT = 32
MAX_HIDDEN = 64


class KernelContext(NamedTuple):
    """Contiguous constants in the layout the kernel reads."""

    W1: Any        # (H1, L)
    b1: Any        # (H1,)
    W2: Any        # (H2, H1)
    b2: Any        # (H2,)
    W3: Any        # (4J+3, H2) component-major quat rows, then disp
    b3: Any        # (4J+3,)
    sq: Any        # (4, J)
    mq: Any        # (4, J)
    sd: Any        # (3,)
    md: Any        # (3,)
    offs: Any      # (J, 3)
    parents: Any   # (J,) int32, parents[j] < j
    w_pos: Any     # (J, 1) or (J, B)
    w_rot: Any     # (J, 1) or (J, B)
    n_ee: Any      # (1,) or (B,)


def make_kernel_context(ctx: fast_iter.FastContext) -> KernelContext:
    J = ctx.parents.shape[0]
    parents = ctx.parents.cpu().numpy()
    if parents[0] != 0 or np.any(parents[1:] >= np.arange(1, J)):
        raise ValueError("K1 needs parents in topological order "
                         "(parents[j] < j)")
    c = lambda a: a.contiguous().to(torch.float32)  # noqa: E731
    return KernelContext(
        W1=c(ctx.W1), b1=c(ctx.b1[:, 0]), W2=c(ctx.W2), b2=c(ctx.b2[:, 0]),
        W3=c(ctx.W3p), b3=c(ctx.b3p[:, 0]),
        sq=c(ctx.sq[..., 0]), mq=c(ctx.mq[..., 0]),
        sd=c(ctx.sd[:, 0]), md=c(ctx.md[:, 0]),
        offs=c(ctx.offs[..., 0].T), parents=ctx.parents.to(torch.int32),
        w_pos=c(ctx.w_pos), w_rot=c(ctx.w_rot), n_ee=c(ctx.n_ee.reshape(-1)),
    )


_P = ctypes.c_void_p


class _Params(ctypes.Structure):
    """Mirror of ``struct Params`` in ``csrc/iter_block.cu``."""

    _fields_ = (
        [(n, _P) for n in ("W1", "b1", "W2", "b2", "W3", "b3", "sq", "mq",
                           "sd", "md", "offs", "parents", "w_pos", "w_rot",
                           "n_ee")]
        + [(n, ctypes.c_int) for n in ("w_lane_stride", "w_row_stride",
                                       "n_ee_stride")]
        + [(n, _P) for n in ("gr", "tpos", "trot", "tlat", "lane_act", "z0",
                             "m0", "v0", "d0", "t0", "pl0", "lp0", "lr0",
                             "li0", "z", "m", "v", "dec", "t", "prev", "lp",
                             "lr", "li")]
        + [(n, ctypes.c_int) for n in ("B", "J", "L", "H1", "H2", "H3",
                                       "sync_k", "max_iter")]
        + [(n, ctypes.c_float) for n in ("eps_pos", "eps_rot", "min_incr",
                                         "lr_adam", "lambda_rot",
                                         "lambda_t")]
    )


def _declare(lib):
    lib.iter_block.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.iter_block.restype = ctypes.c_int
    lib.iter_block_params_size.restype = ctypes.c_int
    if lib.iter_block_params_size() != ctypes.sizeof(_Params):
        raise RuntimeError("iter_block Params layout does not match")


def _library():
    return _build.load("iter_block", _declare)


def _check_inputs(kctx: KernelContext, opt: eng._OptCarry, lane_active,
                  global_rot, tposT, trotT, target_latent) -> None:
    """What the kernel takes; checked on every device, so the CPU tests
    hold the callers to it too."""
    B, L = opt.latent.shape
    J = kctx.parents.shape[0]
    H1, H2 = kctx.W1.shape[0], kctx.W2.shape[0]
    if J > MAX_JOINTS or L > MAX_LATENT or max(H1, H2) > MAX_HIDDEN:
        raise ValueError(f"K1 takes J ≤ {MAX_JOINTS}, L ≤ {MAX_LATENT}, "
                         f"hidden ≤ {MAX_HIDDEN}; got {J}, {L}, {H1}/{H2}")
    if kctx.W3.shape[0] != 4 * J + 3:
        raise ValueError("W3 must have 4J+3 rows")
    dev = opt.latent.device
    f32, i32 = torch.float32, torch.int32
    for name in ("W1", "b1", "W2", "b2", "W3", "b3", "sq", "mq", "sd", "md",
                 "offs", "w_pos", "w_rot", "n_ee"):
        x = getattr(kctx, name)
        _build.check_tensor(name, x, x.shape, dev, f32)
    _build.check_tensor("parents", kctx.parents, (J,), dev, i32)
    if kctx.w_pos.shape[1] not in (1, B) or kctx.w_pos.shape != (
            kctx.w_rot.shape) or kctx.w_pos.shape[0] != J:
        raise ValueError("w_pos/w_rot must be (J, 1) or (J, B)")
    if kctx.n_ee.shape[0] not in (1, B):
        raise ValueError("n_ee must be () or (B,)")
    _build.check_tensor("lane_active", lane_active, (B,), dev, torch.bool)
    _build.check_tensor("global_rot", global_rot, (B, 4), dev, f32)
    _build.check_tensor("tposT", tposT, (J, 3, B), dev, f32)
    _build.check_tensor("trotT", trotT, (J, 3, 3, B), dev, f32)
    _build.check_tensor("target_latent", target_latent, (B, L), dev, f32)
    for name in ("latent", "m", "v", "decoded_latent"):
        _build.check_tensor(name, getattr(opt, name), (B, L), dev, f32)
    _build.check_tensor("t", opt.t, (B,), dev, i32)
    for name in ("prev_loss", "loss_pos", "loss_rot", "loss_incr"):
        _build.check_tensor(name, getattr(opt, name), (B,), dev, f32)


def _launch(kctx: KernelContext, hyper: eng.DragHyper, sync_k: int,
            opt: eng._OptCarry, lane_active, global_rot, tposT, trotT,
            target_latent):
    """Fill ``Params`` (inputs already checked) and launch on the current
    stream."""
    B, L = opt.latent.shape
    J = kctx.parents.shape[0]
    H1, H2, H3 = kctx.W1.shape[0], kctx.W2.shape[0], kctx.W3.shape[0]
    dev = opt.latent.device
    p = _Params()
    for name in ("W1", "b1", "W2", "b2", "W3", "b3", "sq", "mq", "sd", "md",
                 "offs", "parents", "w_pos", "w_rot", "n_ee"):
        setattr(p, name, getattr(kctx, name).data_ptr())
    per_lane = kctx.w_pos.shape[1] != 1
    p.w_lane_stride, p.w_row_stride = (1, B) if per_lane else (0, 1)
    p.n_ee_stride = 0 if kctx.n_ee.shape[0] == 1 else 1
    act = lane_active.to(torch.uint8)
    for name, x in (("gr", global_rot), ("tpos", tposT), ("trot", trotT),
                    ("tlat", target_latent), ("lane_act", act),
                    ("z0", opt.latent), ("m0", opt.m), ("v0", opt.v),
                    ("d0", opt.decoded_latent), ("t0", opt.t),
                    ("pl0", opt.prev_loss), ("lp0", opt.loss_pos),
                    ("lr0", opt.loss_rot), ("li0", opt.loss_incr)):
        setattr(p, name, x.data_ptr())
    out = {n: torch.empty((B, L), dtype=torch.float32, device=dev)
           for n in ("z", "m", "v", "dec")}
    out["t"] = torch.empty((B,), dtype=torch.int32, device=dev)
    for n in ("prev", "lp", "lr", "li"):
        out[n] = torch.empty((B,), dtype=torch.float32, device=dev)
    for n, x in out.items():
        setattr(p, n, x.data_ptr())

    p.B, p.J, p.L, p.H1, p.H2, p.H3 = B, J, L, H1, H2, H3
    p.sync_k, p.max_iter = int(sync_k), int(hyper.max_iter)
    p.eps_pos, p.eps_rot = hyper.stop_eps_pos, hyper.stop_eps_rot
    p.min_incr, p.lr_adam = hyper.min_loss_incr, hyper.learning_rate
    p.lambda_rot = hyper.lambda_rot
    p.lambda_t = hyper.lambda_temporal if hyper.use_temporal else 0.0

    err = _library().iter_block(ctypes.addressof(p),
                                torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "iter_block")
    COUNTS.kernel += 1
    return out


def run_block_fused(ctx: fast_iter.FastContext, kctx: KernelContext,
                    hyper: eng.DragHyper, sync_k: int, opt: eng._OptCarry,
                    lane_active, state, tposT, trotT, target_latent):
    """Drop-in for ``fast_iter.run_block`` running the whole sync-K block in
    one kernel launch (CUDA) or in the plain twin (CPU)."""
    _check_inputs(kctx, opt, lane_active, state.global_rot, tposT, trotT,
                  target_latent)
    if not opt.latent.is_cuda:
        return fast_iter.run_block(ctx, hyper, sync_k, opt, lane_active,
                                   state, tposT, trotT, target_latent)
    o = _launch(kctx, hyper, sync_k, opt, lane_active, state.global_rot,
                tposT, trotT, target_latent)
    aux = fast_iter.aux_at(ctx, hyper, o["dec"].T, state.global_rot.T,
                           tposT, trotT, target_latent.T)
    return eng._OptCarry(
        latent=o["z"], m=o["m"], v=o["v"], t=o["t"], prev_loss=o["prev"],
        loss_pos=o["lp"], loss_rot=o["lr"], loss_incr=o["li"],
        decoded_latent=o["dec"], aux=aux)
