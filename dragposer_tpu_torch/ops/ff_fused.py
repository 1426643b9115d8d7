"""The fused feed-forward with counter-hash dropout (port of
``dragposer_tpu/ops/ff_fused.py``), in both of its layouts.

``y = drop(relu(W1 · x + b1)) · W2 + b2`` per token, with the parameter
tree's own ``ff1["w"]`` (F, D) and ``ff2["w"]`` (D, F).  The dropout masks
are the TPU kernels' bit for bit:

* lanes, K3c/K3d, x (S, D, B): element (token s, hidden row f, lane b) is
  kept iff ``fmix32(f·tile + b % tile + seed·0x9E3779B1 + (s·nb + b //
  tile)·0x7FEB352D) >= threshold(rate)``, with ``tile = min(256, max(128,
  B))`` and ``nb = ceil(B / tile)``;
* rows, K3a/K3b, x (M, D) (any (..., D) reshaped in C order): element
  (row m, hidden column f) is kept iff ``fmix32((m % 256)·F + f +
  seed·0x9E3779B1 + (m // 256)·0x7FEB352D) >= threshold(rate)``, the TPU
  kernel's 256-row tiles.

:func:`ff_dropout_lanes` and :func:`ff_dropout_seeded` (rows) go through
``torch.autograd.Function`` classes: on CUDA tensors the forward launches K3c
or K3a and the backward K3d or K3b (``csrc/ff_lanes.cu``,
``csrc/ff_rows.cu``; both form every product, the pre-activation
included, on the tensor cores as 3xTF32, whose plain form is the twins with
``mm=temporal_fused.matmul_3xtf32``); on CPU tensors both directions run
the plain twins
(:func:`forward_plain` / :func:`backward_plain`, :func:`forward_plain_rows`
/ :func:`backward_plain_rows`).  ``COUNTS_FWD`` / ``COUNTS_BWD`` (lanes) and
``COUNTS_FWD_ROWS`` / ``COUNTS_BWD_ROWS`` count both.  The port has no
threefry, so JAX's ``ff_dropout(key)`` has no counterpart: callers pass the
int seed, as to ``ff_dropout_seeded``.
"""

from __future__ import annotations

import ctypes

import torch

from dragposer_tpu_torch import _build
from dragposer_tpu_torch.ops import hash_dropout

D = 48
FC = 64            # the kernel's hidden chunk: F must be a multiple
TILE_B = 256
TILE_M = 256       # the rows kernel's TPU row tile
TILE_MIX = 0x7FEB352D

COUNTS_FWD = _build.KernelCounts()
COUNTS_BWD = _build.KernelCounts()
COUNTS_FWD_ROWS = _build.KernelCounts()
COUNTS_BWD_ROWS = _build.KernelCounts()


def lane_tile(b: int) -> int:
    """The TPU kernel's lane tile for batch ``b``."""
    return min(TILE_B, max(128, b))


def keep_mask_lanes(s: int, f: int, b: int, rate: float, seed: int,
                    device="cpu"):
    """(S, F, B) boolean keep mask of the hidden, as the kernels draw it."""
    tile = lane_tile(b)
    nb = (b + tile - 1) // tile
    si = torch.arange(s, dtype=torch.int64, device=device)[:, None, None]
    fi = torch.arange(f, dtype=torch.int64, device=device)[None, :, None]
    bi = torch.arange(b, dtype=torch.int64, device=device)[None, None, :]
    tile_id = si * nb + bi // tile
    pos = fi * tile + bi % tile
    seedmix = (int(seed) * hash_dropout.GOLDEN) & hash_dropout.M32
    h = (pos + seedmix + hash_dropout._mul32(tile_id, TILE_MIX)) \
        & hash_dropout.M32
    return hash_dropout.fmix32(h) >= hash_dropout.threshold(rate)


# ---------------------------------------------------------------------------
# Plain PyTorch twins
# ---------------------------------------------------------------------------

def _hidden(x, w1, b1, rate, seed, mm):
    pre = mm(w1, x) + b1[None, :, None]
    h = torch.relu(pre)
    keep = None
    if rate > 0.0:
        keep = keep_mask_lanes(x.shape[0], w1.shape[0], x.shape[2], rate,
                               seed, x.device)
        h = torch.where(keep, h * hash_dropout.keep_scale(rate),
                        torch.zeros((), device=x.device))
    return pre, h, keep


def forward_plain(x, w1, b1, w2, b2, rate: float, seed: int,
                  mm=torch.matmul):
    """K3c's plain twin; ``mm(a, b)`` forms both products (W1·x and
    W2·h)."""
    COUNTS_FWD.plain += 1
    _, h, _ = _hidden(x, w1, b1, rate, seed, mm)
    return mm(w2, h) + b2[None, :, None]


def _columns(t):
    """(S, n, B) → (n, S·B): one column per (token, lane)."""
    return t.transpose(0, 1).reshape(t.shape[1], -1)


def backward_plain(x, w1, b1, w2, g, rate: float, seed: int,
                   mm=torch.matmul):
    """K3d's plain twin: (dx, dW1, db1, dW2, db2), the hidden recomputed.
    ``mm(a, b)`` forms the recomputed pre-activation W1·x, as the forward
    does, and the four gradient products (W2ᵀg, W1ᵀdpre, dW1, dW2)."""
    COUNTS_BWD.plain += 1
    pre, hd, keep = _hidden(x, w1, b1, rate, seed, mm)
    dh = mm(w2.T, g)
    if keep is not None:
        dh = torch.where(keep, dh * hash_dropout.keep_scale(rate),
                         torch.zeros((), device=x.device))
    dpre = torch.where(pre > 0, dh, torch.zeros((), device=x.device))
    dx = mm(w1.T, dpre)
    dw1 = mm(_columns(dpre), _columns(x).T)
    dw2 = mm(_columns(g), _columns(hd).T)
    return dx, dw1, dpre.sum(dim=(0, 2)), dw2, g.sum(dim=(0, 2))


# ---------------------------------------------------------------------------
# The kernels
# ---------------------------------------------------------------------------

def _declare(lib):
    p, i, u, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32,
                  ctypes.c_float)
    lib.ff_lanes_forward.argtypes = [p] * 6 + [i, i, i, u, u, f, i, p]
    lib.ff_lanes_forward.restype = i
    lib.ff_lanes_backward.argtypes = [p] * 11 + [i, i, i, u, u, f, i, p]
    lib.ff_lanes_backward.restype = i
    lib.ff_lanes_backward_workspace_floats.argtypes = [i, i, i]
    lib.ff_lanes_backward_workspace_floats.restype = ctypes.c_longlong


def _library():
    return _build.load("ff_lanes", _declare)


def _check_call(x, w1, b1, w2, b2, rate, rows: bool = False):
    """What the kernels take; checked on every device, so the CPU tests
    hold the callers to it too.  x is (S, D, B), or (M, D) with ``rows``."""
    if rows and (x.dim() != 2 or x.shape[1] != D):
        raise ValueError(f"x: (M, {D}) expected, got {tuple(x.shape)}")
    if not rows and (x.dim() != 3 or x.shape[1] != D):
        raise ValueError(f"x: (S, {D}, B) expected, got {tuple(x.shape)}")
    f = w1.shape[0]
    if f % FC or f < FC:
        raise ValueError(f"hidden width {f} is not a multiple of {FC}")
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate {rate} outside [0, 1)")
    dev = x.device
    _build.check_tensor("x", x, x.shape, dev)
    _build.check_tensor("ff1.w", w1, (f, D), dev)
    _build.check_tensor("ff1.b", b1, (f,), dev)
    _build.check_tensor("ff2.w", w2, (D, f), dev)
    if b2 is not None:
        _build.check_tensor("ff2.b", b2, (D,), dev)


def _mask_args(rate, seed):
    seedmix = (int(seed) * hash_dropout.GOLDEN) & hash_dropout.M32
    return (seedmix, hash_dropout.threshold(rate),
            hash_dropout.keep_scale(rate) if rate > 0 else 1.0,
            int(rate > 0.0))


def forward_kernel(x, w1, b1, w2, b2, rate: float, seed: int):
    """Launch K3c on the current stream (inputs checked by the caller)."""
    s, _, b = x.shape
    y = torch.empty_like(x)
    err = _library().ff_lanes_forward(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), y.data_ptr(), s, b, w1.shape[0],
        *_mask_args(rate, seed), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "ff_lanes_forward")
    COUNTS_FWD.kernel += 1
    return y


def backward_kernel(x, w1, b1, w2, g, rate: float, seed: int):
    """Launch K3d on the current stream: (dx, dW1, db1, dW2, db2)."""
    s, _, b = x.shape
    f = w1.shape[0]
    lib = _library()
    ws = torch.empty(lib.ff_lanes_backward_workspace_floats(s, b, f),
                     dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    dw1, db1 = torch.empty_like(w1), torch.empty_like(b1)
    dw2 = torch.empty_like(w2)
    db2 = torch.empty(D, dtype=torch.float32, device=x.device)
    err = lib.ff_lanes_backward(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        g.data_ptr(), dx.data_ptr(), dw1.data_ptr(), db1.data_ptr(),
        dw2.data_ptr(), db2.data_ptr(), ws.data_ptr(), s, b, f,
        *_mask_args(rate, seed), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "ff_lanes_backward")
    COUNTS_BWD.kernel += 1
    return dx, dw1, db1, dw2, db2


class _FFDropoutLanes(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, rate, seed):
        _check_call(x, w1, b1, w2, b2, rate)
        ctx.save_for_backward(x, w1, b1, w2)
        ctx.rate, ctx.seed = rate, seed
        run = forward_kernel if x.is_cuda else forward_plain
        return run(x, w1, b1, w2, b2, rate, seed)

    @staticmethod
    def backward(ctx, g):
        x, w1, b1, w2 = ctx.saved_tensors
        g = g.contiguous()
        _build.check_tensor("g", g, x.shape, x.device)
        run = backward_kernel if x.is_cuda else backward_plain
        return (*run(x, w1, b1, w2, g, ctx.rate, ctx.seed), None, None)


def ff_dropout_lanes(x, ff1, ff2, rate: float, seed: int):
    """Fused feed-forward with dropout on (S, D, B) activations; ``ff1`` and
    ``ff2`` are ``{"w", "b"}`` dicts in the (out, in) convention, ``seed`` a
    non-negative int.  Differentiable in x and all four weights."""
    return _FFDropoutLanes.apply(x, ff1["w"], ff1["b"], ff2["w"], ff2["b"],
                                 float(rate), int(seed))


# ---------------------------------------------------------------------------
# Rows layout (M, D): K3a / K3b
# ---------------------------------------------------------------------------

def keep_mask_rows(m: int, f: int, rate: float, seed: int, device="cpu"):
    """(M, F) boolean keep mask of the hidden, as the kernels draw it."""
    mi = torch.arange(m, dtype=torch.int64, device=device)[:, None]
    fi = torch.arange(f, dtype=torch.int64, device=device)[None, :]
    seedmix = (int(seed) * hash_dropout.GOLDEN) & hash_dropout.M32
    h = ((mi % TILE_M) * f + fi + seedmix
         + hash_dropout._mul32(mi // TILE_M, TILE_MIX)) & hash_dropout.M32
    return hash_dropout.fmix32(h) >= hash_dropout.threshold(rate)


def _hidden_rows(x, w1, b1, rate, seed, mm):
    pre = mm(x, w1.T) + b1
    h = torch.relu(pre)
    keep = None
    if rate > 0.0:
        keep = keep_mask_rows(x.shape[0], w1.shape[0], rate, seed, x.device)
        h = torch.where(keep, h * hash_dropout.keep_scale(rate),
                        torch.zeros((), device=x.device))
    return pre, h, keep


def forward_plain_rows(x, w1, b1, w2, b2, rate: float, seed: int,
                       mm=torch.matmul):
    """K3a's plain twin; ``mm`` as in :func:`forward_plain`."""
    COUNTS_FWD_ROWS.plain += 1
    _, h, _ = _hidden_rows(x, w1, b1, rate, seed, mm)
    return mm(h, w2.T) + b2


def backward_plain_rows(x, w1, b1, w2, g, rate: float, seed: int,
                        mm=torch.matmul):
    """K3b's plain twin: (dx, dW1, db1, dW2, db2), the hidden recomputed;
    ``mm`` as in :func:`backward_plain`."""
    COUNTS_BWD_ROWS.plain += 1
    pre, hd, keep = _hidden_rows(x, w1, b1, rate, seed, mm)
    dh = mm(g, w2)
    if keep is not None:
        dh = torch.where(keep, dh * hash_dropout.keep_scale(rate),
                         torch.zeros((), device=x.device))
    dpre = torch.where(pre > 0, dh, torch.zeros((), device=x.device))
    return (mm(dpre, w1), mm(dpre.T, x), dpre.sum(dim=0), mm(g.T, hd),
            g.sum(dim=0))


def _declare_rows(lib):
    p, i, u, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32,
                  ctypes.c_float)
    lib.ff_rows_forward.argtypes = [p] * 6 + [i, i, u, u, f, i, p]
    lib.ff_rows_forward.restype = i
    lib.ff_rows_backward.argtypes = [p] * 11 + [i, i, u, u, f, i, p]
    lib.ff_rows_backward.restype = i
    lib.ff_rows_backward_workspace_floats.argtypes = [i, i]
    lib.ff_rows_backward_workspace_floats.restype = ctypes.c_longlong


def _library_rows():
    return _build.load("ff_rows", _declare_rows)


def forward_kernel_rows(x, w1, b1, w2, b2, rate: float, seed: int):
    """Launch K3a on the current stream (inputs checked by the caller)."""
    m, f = x.shape[0], w1.shape[0]
    y = torch.empty_like(x)
    err = _library_rows().ff_rows_forward(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), y.data_ptr(), m, f,
        *_mask_args(rate, seed), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "ff_rows_forward")
    COUNTS_FWD_ROWS.kernel += 1
    return y


def backward_kernel_rows(x, w1, b1, w2, g, rate: float, seed: int):
    """Launch K3b on the current stream: (dx, dW1, db1, dW2, db2)."""
    m, f = x.shape[0], w1.shape[0]
    lib = _library_rows()
    ws = torch.empty(lib.ff_rows_backward_workspace_floats(m, f),
                     dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    dw1, db1 = torch.empty_like(w1), torch.empty_like(b1)
    dw2 = torch.empty_like(w2)
    db2 = torch.empty(D, dtype=torch.float32, device=x.device)
    err = lib.ff_rows_backward(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        g.data_ptr(), dx.data_ptr(), dw1.data_ptr(), db1.data_ptr(),
        dw2.data_ptr(), db2.data_ptr(), ws.data_ptr(), m, f,
        *_mask_args(rate, seed), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "ff_rows_backward")
    COUNTS_BWD_ROWS.kernel += 1
    return dx, dw1, db1, dw2, db2


class _FFDropoutRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, rate, seed):
        _check_call(x, w1, b1, w2, b2, rate, rows=True)
        ctx.save_for_backward(x, w1, b1, w2)
        ctx.rate, ctx.seed = rate, seed
        run = forward_kernel_rows if x.is_cuda else forward_plain_rows
        return run(x, w1, b1, w2, b2, rate, seed)

    @staticmethod
    def backward(ctx, g):
        x, w1, b1, w2 = ctx.saved_tensors
        g = g.contiguous()
        _build.check_tensor("g", g, x.shape, x.device)
        run = backward_kernel_rows if x.is_cuda else backward_plain_rows
        return (*run(x, w1, b1, w2, g, ctx.rate, ctx.seed), None, None)


def ff_dropout_seeded(x, ff1, ff2, rate: float, seed: int):
    """Fused feed-forward with dropout on (..., D) activations, rows in C
    order (row m = b·S + s for (B, S, D)); ``ff1``/``ff2`` are ``{"w",
    "b"}`` dicts in the (out, in) convention, ``seed`` a non-negative int.
    Differentiable in x and all four weights."""
    y = _FFDropoutRows.apply(x.reshape(-1, x.shape[-1]).contiguous(),
                             ff1["w"], ff1["b"], ff2["w"], ff2["b"],
                             float(rate), int(seed))
    return y.reshape(x.shape)
