"""K4a / K4b: the lanes-layout attention core (port of
``dragposer_tpu/ops/attn_fused.py:attn_core_lanes``).

``softmax(q·kᵀ/√dh + mask)·v`` per head and lane on q (Sq, h, dh, B) and
k, v (Sk, h, dh, B), with an additive (Sq, Sk) mask (None means zeros).
:func:`attn_core_lanes` is a ``torch.autograd.Function``: on CUDA tensors
the forward launches K4a and the backward K4b (``csrc/attn_lanes.cu``); on
CPU tensors both run the plain twins :func:`forward_plain` and
:func:`backward_plain`, the mul-reduce formulation of
``models/temporal._attn_T``.  ``COUNTS_FWD`` and ``COUNTS_BWD`` count both.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from dragposer_tpu_torch import _build

DH = 12
SMAX = 16

COUNTS_FWD = _build.KernelCounts()
COUNTS_BWD = _build.KernelCounts()


def _scale(dh: int) -> float:
    return float(np.float32(1.0 / math.sqrt(dh)))


# ---------------------------------------------------------------------------
# Plain PyTorch twins
# ---------------------------------------------------------------------------

def _probs(q, k, mask):
    s = (q[:, None] * k[None, :]).sum(dim=3) * _scale(q.shape[2])
    s = s + mask[:, :, None, None]                      # (Sq, Sk, h, B)
    return torch.softmax(s, dim=1)


def forward_plain(q, k, v, mask):
    """K4a's plain twin."""
    COUNTS_FWD.plain += 1
    a = _probs(q, k, mask)
    return (a[:, :, :, None] * v[None]).sum(dim=1)


def backward_plain(q, k, v, mask, g):
    """K4b's plain twin: (dq, dk, dv), the probabilities recomputed."""
    COUNTS_BWD.plain += 1
    a = _probs(q, k, mask)                              # (Sq, Sk, h, B)
    da = (g[:, None] * v[None]).sum(dim=3)
    r = (a * da).sum(dim=1, keepdim=True)
    ds = a * (da - r) * _scale(q.shape[2])
    dq = (ds[:, :, :, None] * k[None]).sum(dim=1)
    dk = (ds[:, :, :, None] * q[:, None]).sum(dim=0)
    dv = (a[:, :, :, None] * g[:, None]).sum(dim=0)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# The kernels
# ---------------------------------------------------------------------------

def _declare(lib):
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.attn_lanes_forward.argtypes = [p] * 5 + [i] * 5 + [f, p]
    lib.attn_lanes_backward.argtypes = [p] * 8 + [i] * 5 + [f, p]
    lib.attn_lanes_forward_timed.argtypes = [p] * 5 + [i] * 5 + [f, p, p]
    lib.attn_lanes_backward_timed.argtypes = [p] * 8 + [i] * 5 + [f, p, p]
    for entry in (lib.attn_lanes_forward, lib.attn_lanes_backward,
                  lib.attn_lanes_forward_timed,
                  lib.attn_lanes_backward_timed):
        entry.restype = i


def _library():
    return _build.load("attn_lanes", _declare)


def _check_call(q, k, v, mask):
    """What the kernels take; checked on every device."""
    if q.dim() != 4 or q.shape[2] != DH:
        raise ValueError(f"q: (Sq, h, {DH}, B) expected, got "
                         f"{tuple(q.shape)}")
    sq, h, _, b = q.shape
    sk = k.shape[0]
    if not (1 <= sq <= SMAX and 1 <= sk <= SMAX):
        raise ValueError(f"sequence lengths {sq}, {sk} outside 1..{SMAX}")
    dev = q.device
    _build.check_tensor("q", q, q.shape, dev)
    _build.check_tensor("k", k, (sk, h, DH, b), dev)
    _build.check_tensor("v", v, (sk, h, DH, b), dev)
    _build.check_tensor("mask", mask, (sq, sk), dev)


def forward_kernel(q, k, v, mask):
    """Launch K4a on the current stream (inputs checked by the caller)."""
    sq, h, dh, b = q.shape
    o = torch.empty_like(q)
    err = _library().attn_lanes_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
        o.data_ptr(), sq, k.shape[0], h, dh, b, _scale(dh),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "attn_lanes_forward")
    COUNTS_FWD.kernel += 1
    return o


def backward_kernel(q, k, v, mask, g):
    """Launch K4b on the current stream: (dq, dk, dv)."""
    sq, h, dh, b = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    err = _library().attn_lanes_backward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
        g.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), sq,
        k.shape[0], h, dh, b, _scale(dh),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "attn_lanes_backward")
    COUNTS_BWD.kernel += 1
    return dq, dk, dv


# The timed builds' clock slots a warp (csrc/attn_lanes.cu CLOCKS_FWD,
# CLOCKS_BWD): the stage, the warp's own work, the rest (barrier waits and
# the stores).
FWD_PHASES = ("stage", "compute", "rest")
BWD_PHASES = ("stage", "phase1", "phase2", "rest")
_WARPS = 16     # a block's warps, one per token


def phase_cycles(q, k, v, mask, g) -> dict:
    """Where K4a's and K4b's time goes: one launch of each timed build (the
    SM clock read at each phase boundary; CUDA tensors only, not counted),
    as the mean and the largest cycles of each phase over the warps of the
    tokens that exist (queries for the forward, queries or keys for the
    backward)."""
    _check_call(q, k, v, mask)
    _build.check_tensor("g", g, q.shape, q.device)
    sq, h, dh, b = q.shape
    sk = k.shape[0]
    blocks = -(-b // 8) * h
    lib, stream = _library(), torch.cuda.current_stream(q.device).cuda_stream
    o, dq, dk, dv = (torch.empty_like(t) for t in (q, q, k, v))
    ptr = [t.data_ptr() for t in (q, k, v, mask)]
    res = {}
    for name, phases, tokens, run in (
            ("forward", FWD_PHASES, sq, lambda c: lib.attn_lanes_forward_timed(
                *ptr, o.data_ptr(), sq, sk, h, dh, b, _scale(dh), c, stream)),
            ("backward", BWD_PHASES, max(sq, sk),
             lambda c: lib.attn_lanes_backward_timed(
                 *ptr, g.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), sq, sk, h, dh, b, _scale(dh), c, stream))):
        clocks = torch.zeros((blocks, _WARPS, len(phases)), dtype=torch.int64,
                             device=q.device)
        _build.check(run(clocks.data_ptr()), f"attn_lanes_{name}_timed")
        c = clocks[:, :tokens].double().cpu().reshape(-1, len(phases))
        res[name] = {ph: {"mean": float(c[:, j].mean()),
                          "max": float(c[:, j].max())}
                     for j, ph in enumerate(phases)}
    return res


class _AttnCoreLanes(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mask):
        _check_call(q, k, v, mask)
        ctx.save_for_backward(q, k, v, mask)
        run = forward_kernel if q.is_cuda else forward_plain
        return run(q, k, v, mask)

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask = ctx.saved_tensors
        g = g.contiguous()
        _build.check_tensor("g", g, q.shape, q.device)
        run = backward_kernel if q.is_cuda else backward_plain
        return (*run(q, k, v, mask, g), torch.zeros_like(mask))


def attn_core_lanes(q, k, v, mask=None):
    """softmax(q·kᵀ/√dh + mask)·v on lanes-layout heads: q (Sq, h, dh, B),
    k and v (Sk, h, dh, B), mask additive (Sq, Sk) or None.  Returns
    (Sq, h, dh, B); differentiable in q, k and v."""
    sq, sk = q.shape[0], k.shape[0]
    if mask is None:
        mask = torch.zeros((sq, sk), dtype=torch.float32, device=q.device)
    else:
        mask = mask.to(torch.float32).expand(sq, sk).contiguous()
    return _AttnCoreLanes.apply(q, k, v, mask)
