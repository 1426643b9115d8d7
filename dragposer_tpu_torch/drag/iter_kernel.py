"""K1: the drag-iteration block as one CUDA kernel (port of
``dragposer_tpu/drag/iter_kernel.py``).

:func:`run_block_fused` is the drop-in for ``fast_iter.run_block``: same
inputs, same ``_OptCarry`` out.  On CUDA tensors it launches
``csrc/iter_block.cu`` (tiles of 16 lanes, 4 warps a tile, the decoder and
its transpose on the tensor cores in 3xTF32, the sync_k loop inside the
kernel, the gradient written by hand), which also writes the aux of each
lane's last forward: no plain code runs.  The kernel has two builds: the
narrow one (``NARROW``: J, L, H1/H2 up to 32, 32, 64, its weights split in
shared memory) wherever a model fits it, else the general one
(``GENERAL``: up to 128, 128, 272, its weights packed whole and split in
registers) in the layout :func:`general_layout` picks for the batch:
"resident" (the weights in shared memory, several teams a block) or
"streamed4" / "streamed2" / "streamed1" (read from device memory, a team
a block, built for the blocks an SM it gets); past the limits the
wrapper raises before any launch.  On CPU tensors it runs the plain twin
``fast_iter.run_block`` at any shape, which rebuilds the aux with
``fast_iter.aux_at`` as the JAX module does in XLA
(``iter_kernel.py:359-368``).  ``COUNTS`` (shared with ``fast_iter``)
counts the narrow build's launches, plain calls and aux rebuilds;
``GENERAL_COUNTS`` the general build's launches, ``LAYOUT_COUNTS`` them
by layout; while a profiler records, ``COUNTS.log`` and
``GENERAL_COUNTS.log`` keep each launch's lanes and its ``t`` before and
after (lane-steps taken: ``t1 - t0``).
"""

from __future__ import annotations

import ctypes
from typing import Any, NamedTuple

import numpy as np
import torch

from dragposer_tpu_torch import _build
from dragposer_tpu_torch.drag import engine as eng
from dragposer_tpu_torch.drag import fast_iter
from dragposer_tpu_torch.ops.temporal_fused import split_tf32

COUNTS = fast_iter.COUNTS
GENERAL_COUNTS = _build.KernelCounts("K1_general")
LAYOUTS = ("resident", "streamed4", "streamed2", "streamed1")
LAYOUT_COUNTS = {name: _build.KernelCounts(f"K1_general_{name}")
                 for name in LAYOUTS}
NARROW = (32, 32, 64)      # the narrow build's J, L, H1/H2 limits
GENERAL = (128, 128, 272)  # the general build's
TILE_LANES = 16    # lanes of a tile (the M of mma.m16n8k8)
TEAM_WARPS = 4     # warps that share a tile's work
MAX_TEAMS_SM = 4   # the general build's teams an SM: 128 registers a thread


class KernelContext(NamedTuple):
    """Contiguous constants in the layout the kernel reads."""

    W1: Any        # (H1, L)
    b1: Any        # (H1,)
    W2: Any        # (H2, H1)
    b2: Any        # (H2,)
    W3: Any        # (4J+3, H2) component-major quat rows, then disp
    b3: Any        # (4J+3,)
    frags: Any     # W1, W2, W3 packed for the build the sizes take:
                   # pack_fragments (narrow), pack_weights (general)
    sq: Any        # (4, J)
    mq: Any        # (4, J)
    sd: Any        # (3,)
    md: Any        # (3,)
    offs: Any      # (J, 3)
    topo: Any      # (1 + 3W, J) int32: parents (parents[j] < j), then
                   # the ancestor, descendant and child masks, W words each
    w_pos: Any     # (J, 1) or (J, B)
    w_rot: Any     # (J, 1) or (J, B)
    n_ee: Any      # (1,) or (B,)


def fragment_position(f):
    """Where fragment lane ``f`` (0..31) sits in a packed block: swizzled so
    that the kernel's float4 reads (forward) and float2 reads (transposed)
    are both free of shared-memory bank conflicts."""
    return f ^ ((f >> 3) << 1)


def pack_fragments(w: torch.Tensor) -> torch.Tensor:
    """A weight ``w`` (O, I) of ``Y = X wᵀ`` as the kernel's B fragments of
    ``mma.m16n8k8.tf32``, split: O and I padded with zeros to multiples of
    8; block (n, k) of 32 × 4 floats for each out tile n and in tile k; in
    it, fragment lane f = 4g + t at position ``fragment_position(f)`` holds
    {hi, lo of w[8n + g, 8k + 2t]; hi, lo of w[8n + g, 8k + 2t + 1]} — the
    contraction index numbered so that an accumulator fragment is the next
    A fragment.  Shape (O8/8, I8/8, 32, 4)."""
    O, I = w.shape
    o8, i8 = -(-O // 8) * 8, -(-I // 8) * 8
    padded = torch.zeros((o8, i8), dtype=torch.float32, device=w.device)
    padded[:O, :I] = w
    hi, lo = split_tf32(padded)
    f = torch.arange(32, device=w.device)
    rows = torch.arange(o8 // 8, device=w.device)[:, None, None] * 8 + f // 4
    cols = torch.arange(i8 // 8, device=w.device)[None, :, None] * 8 \
        + 2 * (f % 4)
    vals = torch.stack([hi[rows, cols], lo[rows, cols], hi[rows, cols + 1],
                        lo[rows, cols + 1]], dim=-1)   # (n, k, f, 4)
    out = torch.empty_like(vals)
    out[:, :, fragment_position(f)] = vals
    return out.contiguous()


def pair_position(p):
    """Where weight pair ``p`` (0..31) sits in a whole-weight block: swizzled
    so that the general build's forward (float2) and transposed (two
    floats) reads are both free of shared-memory bank conflicts."""
    return p ^ ((p >> 4) << 2)


def pack_weights(w: torch.Tensor) -> torch.Tensor:
    """A weight ``w`` (O, I) of ``Y = X wᵀ`` whole, as the general build
    reads it: O and I padded with zeros to multiples of 8; block (n, k) of
    32 × 2 floats for each out tile n and in tile k; in it, pair p = 4g + t
    at position ``pair_position(p)`` holds w[8n + g, 8k + 2t] and w[8n + g,
    8k + 2t + 1].  The kernel splits each into the hi and lo that
    :func:`pack_fragments` stores.  Shape (O8/8, I8/8, 32, 2)."""
    O, I = w.shape
    o8, i8 = -(-O // 8) * 8, -(-I // 8) * 8
    padded = torch.zeros((o8, i8), dtype=torch.float32, device=w.device)
    padded[:O, :I] = w
    p = torch.arange(32, device=w.device)
    rows = torch.arange(o8 // 8, device=w.device)[:, None, None] * 8 + p // 4
    cols = torch.arange(i8 // 8, device=w.device)[None, :, None] * 8 \
        + 2 * (p % 4)
    vals = torch.stack([padded[rows, cols], padded[rows, cols + 1]], dim=-1)
    out = torch.empty_like(vals)
    out[:, :, pair_position(p)] = vals
    return out.contiguous()


def _fits(limits: tuple, J: int, L: int, H1: int, H2: int) -> bool:
    mj, ml, mh = limits
    return J <= mj and L <= ml and max(H1, H2) <= mh


def _packs_whole(J: int, L: int, H1: int, H2: int) -> bool:
    """Whether these sizes take the general build (weights packed whole)."""
    return not _fits(NARROW, J, L, H1, H2)


def topology_masks(parents) -> np.ndarray:
    """(3W, J) bit masks of joints, W = ceil(J / 32) 32-bit words a mask
    (joint a is bit a % 32 of word a // 32): rows 0..W-1 the ancestors of j
    (root excluded, j included: row j of the ancestor matrix A), rows
    W..2W-1 its descendants (j included: column j of A), rows 2W..3W-1 its
    children other than the root.  At J ≤ 32, the rows anc, desc, child."""
    parents = np.asarray(parents, np.int64)
    J = len(parents)
    anc = np.zeros((J, J), bool)
    for j in range(1, J):
        anc[j] = anc[parents[j]]
        anc[j, j] = True
    child = np.zeros((J, J), bool)
    child[parents[1:], np.arange(1, J)] = True
    W = -(-J // 32)
    pad = np.zeros((J, 32 * W - J), bool)
    weights = np.uint64(1) << np.arange(32, dtype=np.uint64)

    def words(m):   # (J, J) bool, row j the joints in j's mask → (W, J)
        bits = np.concatenate((m, pad), axis=1).reshape(J, W, 32)
        return np.ascontiguousarray((bits * weights).sum(-1).astype(
            np.uint32).T)

    return np.concatenate((words(anc), words(anc.T), words(child)))


def make_kernel_context(ctx: fast_iter.FastContext) -> KernelContext:
    J = ctx.parents.shape[0]
    parents = ctx.parents.cpu().numpy()
    if parents[0] != 0 or np.any(parents[1:] >= np.arange(1, J)):
        raise ValueError("K1 needs parents in topological order "
                         "(parents[j] < j)")
    dev = ctx.W1.device
    c = lambda a: a.contiguous().to(torch.float32)  # noqa: E731
    W1, W2, W3 = c(ctx.W1), c(ctx.W2), c(ctx.W3p)
    topo = np.concatenate((parents[None].astype(np.int32),
                           topology_masks(parents).view(np.int32)))
    pack = pack_weights if _packs_whole(J, W1.shape[1], W1.shape[0],
                                        W2.shape[0]) else pack_fragments
    return KernelContext(
        W1=W1, b1=c(ctx.b1[:, 0]), W2=W2, b2=c(ctx.b2[:, 0]),
        W3=W3, b3=c(ctx.b3p[:, 0]),
        frags=torch.cat([pack(w).reshape(-1) for w in (W1, W2, W3)]),
        sq=c(ctx.sq[..., 0]), mq=c(ctx.mq[..., 0]),
        sd=c(ctx.sd[:, 0]), md=c(ctx.md[:, 0]),
        offs=c(ctx.offs[..., 0].T),
        topo=torch.as_tensor(topo, device=dev),
        w_pos=c(ctx.w_pos), w_rot=c(ctx.w_rot), n_ee=c(ctx.n_ee.reshape(-1)),
    )


def with_masks(ctx: fast_iter.FastContext, kctx: KernelContext, mask,
               weights):
    """``ctx`` and ``kctx`` for other masks (J,) / (B, J) and weights
    (J, 2) / (B, J, 2): only the loss weights and the end-effector count are
    rebuilt, the packed weights are kept (the realtime paths change masks
    every frame)."""
    w_pos, w_rot, n_ee = fast_iter.mask_planes(mask, weights)
    c = lambda a: a.contiguous().to(torch.float32)  # noqa: E731
    return (ctx._replace(w_pos=w_pos, w_rot=w_rot, n_ee=n_ee),
            kctx._replace(w_pos=c(w_pos), w_rot=c(w_rot),
                          n_ee=c(n_ee.reshape(-1))))


_P = ctypes.c_void_p


class _Params(ctypes.Structure):
    """Mirror of ``struct Params`` in ``csrc/iter_block.cu``."""

    _fields_ = (
        [(n, _P) for n in ("frags", "b1", "b2", "b3", "sq", "mq", "sd", "md",
                           "offs", "topo", "w_pos", "w_rot", "n_ee")]
        + [(n, ctypes.c_int) for n in ("w_lane_stride", "w_row_stride",
                                       "n_ee_stride")]
        + [(n, _P) for n in ("gr", "tpos", "trot", "tlat", "lane_act", "z0",
                             "m0", "v0", "d0", "t0", "pl0", "lp0", "lr0",
                             "li0", "z", "m", "v", "dec", "t", "prev", "lp",
                             "lr", "li", "a_lp", "a_lr", "a_wd", "a_disp",
                             "a_wr", "a_pos", "a_pose", "clocks")]
        + [(n, ctypes.c_int) for n in ("B", "J", "L", "H1", "H2", "H3",
                                       "sync_k", "max_iter")]
        + [(n, ctypes.c_float) for n in ("eps_pos", "eps_rot", "min_incr",
                                         "lr_adam", "lambda_rot",
                                         "lambda_t")]
    )


_ENTRIES = ("iter_block", "iter_block_tf32", "iter_block_timed")


def _entry(entry: str, build: str) -> str:
    """The C entry of ``entry`` (an ``_ENTRIES`` name) for a build or a
    general layout: ``iter_block_resident_tf32`` and the like."""
    return entry if build == "narrow" else entry.replace("block",
                                                         f"block_{build}")


def _declare(lib):
    for build in ("narrow", *LAYOUTS):
        for name in _ENTRIES:
            entry = getattr(lib, _entry(name, build))
            entry.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            entry.restype = ctypes.c_int
        config = getattr(lib, _entry("iter_block", build) + "_config")
        config.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        config.restype = ctypes.c_int
    lib.iter_block_device_limits.argtypes = [ctypes.c_void_p]
    lib.iter_block_device_limits.restype = ctypes.c_int
    lib.iter_block_params_size.restype = ctypes.c_int
    lib.iter_block_tile_lanes.restype = ctypes.c_int
    lib.iter_block_limits.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.iter_block_limits.restype = None
    if lib.iter_block_params_size() != ctypes.sizeof(_Params):
        raise RuntimeError("iter_block Params layout does not match")
    if lib.iter_block_tile_lanes() != TILE_LANES:
        raise RuntimeError("iter_block tile width does not match")
    for general, want in ((0, NARROW), (1, GENERAL)):
        got = (ctypes.c_int * 3)()
        lib.iter_block_limits(general, got)
        if tuple(got) != want:
            raise RuntimeError(f"iter_block limits {tuple(got)} != {want}")


def _library():
    return _build.load("iter_block", _declare)


def build_for(J: int, L: int, H1: int, H2: int) -> str:
    """The build a kernel launch takes at these sizes: ``"narrow"`` where
    they fit ``NARROW``, else ``"general"`` where they fit ``GENERAL``;
    past that a ``ValueError`` naming the limit (the plain twin on the CPU
    takes any size)."""
    for name, limits in (("narrow", NARROW), ("general", GENERAL)):
        if _fits(limits, J, L, H1, H2):
            return name
    mj, ml, mh = GENERAL
    raise ValueError(f"K1 takes J ≤ {mj}, L ≤ {ml}, hidden ≤ {mh} (its "
                     f"general build's limits); got {J}, {L}, {H1}/{H2}")


def _build_of(kctx: KernelContext, opt: eng._OptCarry) -> str:
    return build_for(kctx.topo.shape[1], opt.latent.shape[1],
                     kctx.W1.shape[0], kctx.W2.shape[0])


def _stride(n: int, r: int) -> int:
    """The row stride ≥ n with stride ≡ r (mod 32) (``stride`` in
    ``csrc/iter_block.cu``)."""
    return n + (r - n) % 32


def smem_floats(J: int, L: int, H1: int, H2: int, block: int) -> tuple:
    """K1's shared memory in floats as ``make_layout`` lays it out:
    (the packed weights at ``block`` floats an 8 × 8 block, the constants,
    one team's scratch)."""
    ks1, nt1, nt2, nt3 = (-(-n // 8) for n in (L, H1, H2, 4 * J + 3))
    weights = (nt1 * ks1 + nt2 * nt1 + nt3 * nt2) * block
    consts = 8 * (nt1 + nt2 + nt3) + 11 * J + 8 + (1 + 3 * -(-J // 32)) * J
    ldz, ldh = 8 * ks1, _stride(8 * nt3, 2)
    acts = TILE_LANES * (_stride(8 * nt1, 8) + _stride(8 * nt2, 8))
    team = (TILE_LANES * (5 * ldz + ldh) + TEAM_WARPS * 6 * TILE_LANES
            + max(16 * J * TILE_LANES, acts))
    return weights, consts, team


class Layout(NamedTuple):
    """A launch of the general build: its layout, teams (tiles of 16
    lanes) a block, blocks an SM holds and shared-memory bytes a block."""

    name: str
    teams: int
    blocks_per_sm: int
    smem_bytes: int


RESERVED_SMEM = 1024   # shared memory the card reserves for each block


def general_layout(J: int, L: int, H1: int, H2: int, B: int, sms: int,
                   smem_block: int, smem_sm: int, prefer: str = None
                   ) -> Layout:
    """The layout of the general build for B lanes on a card of ``sms``
    SMs with ``smem_block`` bytes of shared memory a block may opt in to
    and ``smem_sm`` an SM has.  "resident": the weights in shared memory
    once a block, read by as many teams as fit beside them (at most
    ``MAX_TEAMS_SM`` and as many as give each SM a block, as
    ``make_layout`` picks), 128 registers a thread; "streamed<N>": a team
    a block, its weights read from device memory, built for the N blocks
    an SM its shared memory allows (4 where it holds 3 or more, at 128
    registers a thread; 2 or 1 at 255, with more tiles a pass at 1; see
    ``Build`` in ``csrc/iter_block.cu``).  The weights are resident where
    that block holds two teams (or every team the batch needs) and puts no
    fewer teams to work on an SM than the streamed layout would.
    ``prefer`` names a layout to take wherever it fits (to time one
    against the other)."""
    weights, consts, team = smem_floats(J, L, H1, H2, 64)
    tiles = -(-B // TILE_LANES)
    need = max(1, min(MAX_TEAMS_SM, -(-tiles // sms)))   # teams an SM

    def fit(base: int, teams: int) -> int:
        while teams and 4 * (base + teams * team) > smem_block:
            teams -= 1
        return teams

    def layout(name: str, base: int, teams: int, regs_blocks: int):
        smem = 4 * (base + teams * team)
        return Layout(name, teams, min(smem_sm // (smem + RESERVED_SMEM),
                                       regs_blocks), smem)

    base = -(-consts // 4) * 4
    fits = dict.fromkeys(LAYOUTS)
    streamed = None
    if fit(base, 1):
        for n in (4, 2, 1):
            fits[f"streamed{n}"] = layout(f"streamed{n}", base, 1, n)
        blocks = fits["streamed4"].blocks_per_sm
        streamed = fits[f"streamed{4 if blocks >= 3 else blocks}"]
    rbase = -(-(weights + consts) // 4) * 4
    teams = fit(rbase, need)
    if teams:
        fits["resident"] = layout("resident", rbase, teams,
                                  MAX_TEAMS_SM // teams)
    if prefer is not None and fits[prefer] is not None:
        return fits[prefer]
    resident = fits["resident"]
    if resident and teams >= min(2, need) and (
            streamed is None or min(teams * resident.blocks_per_sm, need)
            >= min(streamed.blocks_per_sm, need)):
        return resident
    if streamed is None:
        raise ValueError(f"K1's general build does not fit {smem_block} "
                         f"bytes of shared memory at J={J}, L={L}")
    return streamed


_DEVICE_LIMITS: dict = {}


def device_limits(device: torch.device) -> tuple:
    """(SMs, shared memory a block may opt in to, shared memory an SM) of
    a CUDA device, read once."""
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    if index not in _DEVICE_LIMITS:
        out = (ctypes.c_int * 3)()
        with torch.cuda.device(index):
            _build.check(_library().iter_block_device_limits(out),
                         "iter_block_device_limits")
        _DEVICE_LIMITS[index] = tuple(out)
    return _DEVICE_LIMITS[index]


def launch_build(kctx: KernelContext, opt: eng._OptCarry) -> str:
    """The kernel a launch on CUDA tensors takes: "narrow", or the general
    build's layout (one of ``LAYOUTS``); raises past the limits."""
    if _build_of(kctx, opt) == "narrow":
        return "narrow"
    B, L = opt.latent.shape
    return general_layout(kctx.topo.shape[1], L, kctx.W1.shape[0],
                          kctx.W2.shape[0], B,
                          *device_limits(opt.latent.device)).name


def launch_config(kctx: KernelContext, opt: eng._OptCarry) -> dict:
    """What the launch for these inputs takes, as the card reports it
    (CUDA only): its kernel (:func:`launch_build`), registers a thread
    (``cudaFuncGetAttributes``), threads and shared-memory bytes a block,
    blocks an SM (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``) and
    blocks."""
    build = launch_build(kctx, opt)
    p = _Params()
    p.B, p.L = opt.latent.shape
    p.J = kctx.topo.shape[1]
    p.H1, p.H2, p.H3 = kctx.W1.shape[0], kctx.W2.shape[0], kctx.W3.shape[0]
    out = (ctypes.c_int * 5)()
    entry = _entry("iter_block", build) + "_config"
    with torch.cuda.device(opt.latent.device):
        _build.check(getattr(_library(), entry)(ctypes.addressof(p), out),
                     entry)
    return {"kernel": build, **dict(zip(
        ("registers", "threads", "shared_bytes", "blocks_per_sm", "blocks"),
        out))}


def _check_inputs(kctx: KernelContext, opt: eng._OptCarry, lane_active,
                  global_rot, tposT, trotT, target_latent) -> None:
    """The layouts the kernel takes; checked on every device, so the CPU
    tests hold the callers to them too (the size limits are checked only
    where a kernel launches: :func:`build_for`)."""
    B, L = opt.latent.shape
    J = kctx.topo.shape[1]
    if kctx.W3.shape[0] != 4 * J + 3:
        raise ValueError("W3 must have 4J+3 rows")
    dev = opt.latent.device
    f32, i32 = torch.float32, torch.int32
    for name in ("W1", "b1", "W2", "b2", "W3", "b3", "frags", "sq", "mq",
                 "sd", "md", "offs", "w_pos", "w_rot", "n_ee"):
        x = getattr(kctx, name)
        _build.check_tensor(name, x, x.shape, dev, f32)
    whole = _packs_whole(J, L, kctx.W1.shape[0], kctx.W2.shape[0])
    n_frags = sum((64 if whole else 128) * (-(-w.shape[0] // 8))
                  * (-(-w.shape[1] // 8)) for w in (kctx.W1, kctx.W2, kctx.W3))
    if kctx.frags.shape != (n_frags,):
        raise ValueError("frags must be "
                         + ("pack_weights" if whole else "pack_fragments")
                         + " of W1, W2, W3")
    _build.check_tensor("topo", kctx.topo, (1 + 3 * -(-J // 32), J), dev,
                        i32)
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


def _launch(entry: str, kctx: KernelContext, hyper: eng.DragHyper,
            sync_k: int, opt: eng._OptCarry, lane_active, global_rot, tposT,
            trotT, target_latent, clocks=None) -> tuple:
    """Fill ``Params`` (inputs already checked), launch ``entry`` of the
    kernel the sizes take (:func:`launch_build`; raises past its limits)
    on the current stream; returns that kernel's name and the new carry
    with the kernel's aux."""
    build = launch_build(kctx, opt)
    entry = _entry(entry, build)
    B, L = opt.latent.shape
    J = kctx.topo.shape[1]
    H1, H2, H3 = kctx.W1.shape[0], kctx.W2.shape[0], kctx.W3.shape[0]
    dev = opt.latent.device
    p = _Params()
    for name in ("frags", "b1", "b2", "b3", "sq", "mq", "sd", "md", "offs",
                 "topo", "w_pos", "w_rot", "n_ee"):
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
    f32 = lambda *s: torch.empty(s, dtype=torch.float32, device=dev)  # noqa: E731
    out = {n: f32(B, L) for n in ("z", "m", "v", "dec")}
    out["t"] = torch.empty((B,), dtype=torch.int32, device=dev)
    for n in ("prev", "lp", "lr", "li", "a_lp", "a_lr"):
        out[n] = f32(B)
    out.update(a_wd=f32(B, 3), a_disp=f32(B, 3), a_wr=f32(B, 4),
               a_pos=f32(B, J, 3), a_pose=f32(B, 4 * J))
    for n, x in out.items():
        setattr(p, n, x.data_ptr())
    p.clocks = None if clocks is None else clocks.data_ptr()

    p.B, p.J, p.L, p.H1, p.H2, p.H3 = B, J, L, H1, H2, H3
    p.sync_k, p.max_iter = int(sync_k), int(hyper.max_iter)
    p.eps_pos, p.eps_rot = hyper.stop_eps_pos, hyper.stop_eps_rot
    p.min_incr, p.lr_adam = hyper.min_loss_incr, hyper.learning_rate
    p.lambda_rot = hyper.lambda_rot
    p.lambda_t = hyper.lambda_temporal if hyper.use_temporal else 0.0

    err = getattr(_library(), entry)(
        ctypes.addressof(p), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, entry)
    aux = eng._LossAux(
        loss_pos=out["a_lp"], loss_rot=out["a_lr"],
        world_displacement=out["a_wd"], displacement=out["a_disp"],
        world_rotation=out["a_wr"], positions=out["a_pos"],
        pose=out["a_pose"])
    return build, eng._OptCarry(
        latent=out["z"], m=out["m"], v=out["v"], t=out["t"],
        prev_loss=out["prev"], loss_pos=out["lp"], loss_rot=out["lr"],
        loss_incr=out["li"], decoded_latent=out["dec"], aux=aux)


def run_block_fused(ctx: fast_iter.FastContext, kctx: KernelContext,
                    hyper: eng.DragHyper, sync_k: int, opt: eng._OptCarry,
                    lane_active, state, tposT, trotT, target_latent):
    """Drop-in for ``fast_iter.run_block`` running the whole sync-K block in
    one kernel launch, aux included (CUDA), or in the plain twin (CPU)."""
    _check_inputs(kctx, opt, lane_active, state.global_rot, tposT, trotT,
                  target_latent)
    if not opt.latent.is_cuda:
        return fast_iter.run_block(ctx, hyper, sync_k, opt, lane_active,
                                   state, tposT, trotT, target_latent)
    build, out = _launch("iter_block", kctx, hyper, sync_k, opt,
                         lane_active, state.global_rot, tposT, trotT,
                         target_latent)
    record = dict(lanes=opt.latent.shape[0], t0=opt.t, t1=out.t)
    if build == "narrow":
        COUNTS.launched(**record)
    else:
        GENERAL_COUNTS.launched(**record)
        LAYOUT_COUNTS[build].kernel += 1
    return out


def run_block_tf32(ctx: fast_iter.FastContext, kctx: KernelContext,
                   hyper: eng.DragHyper, sync_k: int, opt: eng._OptCarry,
                   lane_active, state, tposT, trotT, target_latent):
    """K1 with its decoder products in one TF32 pass: the control that
    ``chip_smoke.K1_TOL`` must refuse (CUDA only; never on the main path,
    and not counted)."""
    _check_inputs(kctx, opt, lane_active, state.global_rot, tposT, trotT,
                  target_latent)
    if not opt.latent.is_cuda:
        raise ValueError("the TF32 control is a CUDA kernel")
    return _launch("iter_block_tf32", kctx, hyper, sync_k, opt, lane_active,
                   state.global_rot, tposT, trotT, target_latent)[1]


PHASES = ("decoder forward", "world quats", "FK terms", "positions and loss",
          "per-lane sums", "aux", "descendant sums", "quat grads",
          "decoder backward", "adam")   # csrc/iter_block.cu, enum PH_*
_CLOCK_SLOTS = 16


def phase_cycles(ctx: fast_iter.FastContext, kctx: KernelContext,
                 hyper: eng.DragHyper, sync_k: int, opt: eng._OptCarry,
                 lane_active, state, tposT, trotT, target_latent) -> dict:
    """Where K1's time goes: one launch of its timed build (the SM clock
    read after each phase of each step; CUDA only, not counted), as mean
    cycles per warp-step of each phase over the warps that ran."""
    _check_inputs(kctx, opt, lane_active, state.global_rot, tposT, trotT,
                  target_latent)
    B = opt.latent.shape[0]
    warps = -(-B // TILE_LANES) * TEAM_WARPS
    clocks = torch.zeros((warps, _CLOCK_SLOTS), dtype=torch.int64,
                         device=opt.latent.device)
    build = _launch("iter_block_timed", kctx, hyper, sync_k, opt,
                    lane_active, state.global_rot, tposT, trotT,
                    target_latent, clocks)[0]
    c = clocks.double().cpu()
    steps = float(c[:, -1].sum())
    return {"kernel": build, "warp_steps": steps,
            "cycles_per_warp_step": {name: float(c[:, i].sum()) / steps
                                     for i, name in enumerate(PHASES)}}
