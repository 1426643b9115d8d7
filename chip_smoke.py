"""GPU smoke run of the PyTorch/CUDA port (``dragposer_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA GPU, ``nvcc`` and the repository checkout.  Phases, each
printing its own line (any failure exits nonzero):

1. the card's name and power limit (``nvidia-smi``);
2. build the five kernel sources from ``dragposer_tpu_torch/csrc``
   (one ``nvcc`` each, all started together), and count the tensor-core
   instructions (``HMMA``/``HGMMA``) in the SASS of K1, K2 and each of the
   four feed-forward kernels K3a-K3d (0 fails); K1's narrow build held to
   the SASS the build before the general one compiled to
   (``K1_NARROW_SASS``, where the same nvcc release builds it);
3. K1 (drag-iteration block, 3xTF32 on the tensor cores) against its
   plain twin on the card, the carry and the aux, with a control at
   sync_k = 1 that must fail the same tolerance (K1's products in one
   TF32 pass); K1 timed by its own device time, with the wrapper's device
   time and CUDA events around a call beside it, and its timed build's
   clock cycles by phase; then K1's general build (the models past the
   narrow build's J ≤ 32, L ≤ 32, hidden ≤ 64) the same way at the
   example skeleton with latent 48, at chains of 33 and 64 joints and at
   its limits, a 128-joint chain at latent 128 (random seeded
   generators): at sync_k = 1 only first-step knife lanes
   (``k1_knife_lanes``) over the tolerance, at most B // 1000 lanes over
   it at sync_k = 24 and the 1e-2 latent cap on every other lane, its
   TF32 control refused at sync_k = 1; at each shape the layout
   ``iter_kernel.general_layout`` picks (weights resident in shared
   memory or streamed from device memory) must be the one that launched
   (teams a block, shared memory, blocks an SM from the profiler's
   trace), with its timed build's cycles by phase;
4. K2 (temporal-transformer forward, 3xTF32 on the tensor cores) against
   its float32 plain twin at S_dec = 5, 1 (the main path, timed beside
   ``PERF.md``'s figure), 16 (a rollout at the realtime window 60) and 30
   (the longest the positional encoding allows: its build for 32 steps),
   with a control that must fail the same tolerance (the twin with TF32
   matmuls), and ``torch.nn.Transformer`` timed beside it as a yardstick
   only, with TF32 off and on;
5. the serving path: ``build_engine`` on ``models/model_dancedb_example``
   with the 6-tracker config, then ``DragEngine.run_batch_pipelined`` on
   B = 8192 lanes × 240 frames of synthetic motion (mean iterations, lane
   0's MPJPE and the mean of the first 64 lanes' held to the recorded
   results), with both kernels'
   launch counts (plain counts and K1's aux rebuilds must stay 0) and
   K1's tile efficiency (lane-steps taken over those its 16-lane tiles
   issue, each running to its slowest lane); the device time of its first
   frames by kernel under ``torch.profiler``, with K1's and K2's launches
   in that window (device ms per launch); a small run held against the
   same path on the CPU (plain twins) in lockstep at one Adam step a frame
   and, at five, K2 held to its float32 twin's distance, which K2 in one
   TF32 pass must exceed; the 4-tracker (windowed) path held the same way
   at one step a frame on 24 lanes with staggered window phases, which
   must roll K2 out on sub-batches;
6. K3c/K3d (lanes feed-forward with hash dropout, both 3xTF32 on the
   tensor cores) against their plain twins at S = 15, B = 512 and 4096
   (rates 0.1 and 0), timed by their own device time, the kernel's own
   dropout mask extracted and held against the hash bit for bit, with
   controls that must fail the same tolerance (each twin with its products
   in one TF32 pass); the gate probe: K3d's ReLU gates on knife-edge
   pre-activations equal to K3c's bit for bit;
7. K4a/K4b (lanes attention core) against their plain twins at the
   training path's shapes and at a scattered non-causal mask, a fully
   masked query row (NaN where the twin has NaN), one query, one lane and
   a ragged lane count, ``scaled_dot_product_attention`` timed beside
   them as a yardstick only, and their timed builds' SM cycles by phase;
8. the temporal trainer in the lanes layout: ``train.temporal.train`` at
   the recipe's width and batch (B = 512) on a seeded synthetic corpus, a
   few epochs at dropout 0.1 (K3c/K3d only: attention with dropout takes
   the plain path, the JAX package's rule) and at dropout 0 (K3c/K3d and
   K4), launch counts set to 0 just before each run and read just after;
   then the steady-state step rate over 3 × 50 steps and the device time
   of a few steps by kernel under ``torch.profiler``;
9. one lanes training step on the card against the same step on the CPU
   given the card kernel's ReLU gates, with the gate flips counted, and a
   control (the kernels on bfloat16 operands) that the check must refuse;
10. K3a/K3b (rows feed-forward) against their plain twins at M = 15 × 512
    and 15 × 4096 (rates 0.1 and 0), the kernel's mask against the hash,
    the TF32 controls and the gate probe, as in 6;
11. the pose-VAE trainer: ``train.vae.train(use_fk=True)`` for one epoch
    of the corpus at the recipe's batch of 64 pairs (pairs/s, loss terms,
    eval MPJPE/MPEEPE, peak memory, the checkpoint read back); the step
    alone over 50 steps and under ``torch.profiler``; one VAE step (the
    example generator) on the card against the CPU;
12. the temporal trainer in the rows layout (K3a/K3b) on the latents of
    the generator just trained, as in 8;
13. one rows training step on the card against the CPU, as in 9;
14. the trained generator and rows-trained predictor through
    ``build_engine`` and ``run_batch_pipelined`` (B = 64 × 48 frames,
    K1 and K2 launched, MPJPE printed but not gated);
15. the anchor path: ``DragEngine.run`` (autograd Adam, K2 rollout) on
    the card against the CPU on 1 lane × 48 frames at 6 and 4 trackers in
    lockstep at one Adam step a frame (K2 launched, no plain K2 call, no
    K1); ``run_batch`` against ``run_batch_pipelined`` (K1 + K2) on 8
    lanes × 24 frames, in lockstep and at the full stop rule by statistics
    (``ANCHOR_ITER_REL``, ``ANCHOR_MPJPE_M``); the offline CLI through
    ``cli.eval_drag.main`` (one file, ``--batch`` with restarts, the
    3-tracker beam, ``--batch`` with constraints: finite MPJPE and jitter,
    launches per run); the anchor's frames/s and device idle share, not
    gated;
16. a ``RealtimeSession`` (6 trackers) on the card: one frame at one
    Adam step against the CPU from the same state, then 120 frames at the
    realtime defaults (max_iter 10, window 60: K2 at S_dec 16) with frame
    latency p50/p99 (K2 launched, its twin and K1 never);
17. a ``RealtimeBatch`` of 64 avatars at 6/4/3 trackers: one frame on the
    card (K1 + K2) against the CPU's twins under K1's gate, then 120
    frames with the window phases in lockstep and staggered, latency
    p50/p99 each;
18. the serving daemon on the card, a process of its own: four raw-socket
    clients step 60 frames each (coalesced: ``OP_STATS``), one
    ``OP_EVAL_BATCH`` while a client keeps stepping, and the native smoke
    client (``native/``, built with ``g++``) through
    ``DRAGPOSER_NO_SPAWN``;
19. the pipelined path at latent 48 (K1's general build, its weights
    resident) and on chains of 33 and 64 joints at latent 24 and of 128
    joints at latent 128 (streamed, built for 4, 2 and 1 blocks an SM) on
    B = 8192 × 240 frames each (2048 at 128 joints, cut for time), with
    launch counts (the general build launched in the layout the wrapper
    picks, no plain K1 call, no aux rebuild), frames/s and the tile
    efficiency of K1's launches, then 8 lanes × 24 frames on the card
    against the CPU at one Adam step a frame;
20. ``eval_drag --batch`` on two synthetic clips without and with
    ``--mesh 1`` (in turns): equal metrics and exported files, frames/s;
    the sharded path (``eval_drag._run_sharded``: replica, stream, thread)
    on the one card against the one-card path at one Adam step a frame
    (``mesh_lockstep``; on N cards, ``mesh_lockstep(N)`` and
    ``mesh_cli_runs(mesh=N)``);
21. the reference's ``.pt`` files of the example model: imported by
    ``cli.import_checkpoint`` to ``.npz`` files equal to the example's,
    and an engine built from the ``.pt`` directory computing the example
    engine's pipelined batch exactly;
22. the port's native layer (``dragposer_tpu_torch/native/``, built with
    ``g++``): a host like Unity's (``native/probe.cpp``, the library opened
    ``RTLD_LOCAL``) through the embedded ABI on the card over 120 frames of
    the main clip, held to ``runtime.capi`` in this process (1e-5), with
    K2's library removed first so that the host process builds it; the
    session's device, the card and K2's launches read in the embedded
    interpreter; frame latency beside [16]'s; then the socket client with
    no daemon listening, which starts the port's daemon (its command line
    read from ``/proc``), held to the same, the daemon ended here;
23. the B = 4096 timings, a ``kernels`` JSON line (K1's and K2's launches
    summed over [5], [15], [16]-[18] and (K2) [22], the general build's
    by layout from [19]); the last line is the ``ok`` JSON.  SM and memory
    clocks are sampled beside every timed phase.

The synthetic clip generator here (:func:`synthetic_bvh`) is shared with the
CPU tests; importing this module has no side effects.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
MODEL_DIR = os.path.join(HERE, "models", "model_dancedb_example")

# 22-joint skeleton of the example model (the JAX tests' EXAMPLE_PARENTS)
EXAMPLE_PARENTS = np.array(
    [0, 0, 1, 2, 3, 0, 5, 6, 7, 0, 9, 10, 11, 12, 11, 14, 15, 16, 11, 18, 19,
     20], dtype=np.int64)
JOINT_NAMES = (
    "pelvis", "l_hip", "l_knee", "l_ankle", "l_foot", "r_hip", "r_knee",
    "r_ankle", "r_foot", "spine1", "spine2", "spine3", "neck", "head",
    "l_collar", "l_shoulder", "l_elbow", "l_wrist", "r_collar", "r_shoulder",
    "r_elbow", "r_wrist")
# humanoid z-up bone offsets in meters (x lateral, y forward, z up)
_BASE_OFFSETS = np.array([
    [0, 0, 0], [0.09, 0, -0.06], [0, 0, -0.40], [0, 0, -0.40],
    [0, 0.12, -0.06], [-0.09, 0, -0.06], [0, 0, -0.40], [0, 0, -0.40],
    [0, 0.12, -0.06], [0, 0, 0.10], [0, 0, 0.13], [0, 0, 0.06],
    [0, 0, 0.20], [0, 0.02, 0.10], [0.07, 0, 0.12], [0.10, 0, 0],
    [0.26, 0, 0], [0.25, 0, 0], [-0.07, 0, 0.12], [-0.10, 0, 0],
    [-0.26, 0, 0], [-0.25, 0, 0]], dtype=np.float64)
FRAME_TIME = 1.0 / 60.0


def synthetic_bvh(n_frames: int, seed: int, model_dir: str = MODEL_DIR):
    """A seeded synthetic clip as a port ``BVH``: the example skeleton with
    seeded bone lengths, poses from a smooth random walk in the VAE latent
    decoded by the example decoder (on-manifold targets, as with mocap),
    a smoothly turning root yaw and a smooth root path."""
    import torch

    from dragposer_tpu_torch import config as cfg
    from dragposer_tpu_torch.io.bvh import BVH
    from dragposer_tpu_torch.models import loading, vae
    from dragposer_tpu_torch.ops import fk, quat
    from dragposer_tpu_torch.ops.topology import Skeleton

    rng = np.random.default_rng(seed)
    J = len(EXAMPLE_PARENTS)
    offsets = _BASE_OFFSETS * (1.0 + 0.05 * rng.normal(size=(J, 1)))
    skeleton = Skeleton.build(EXAMPLE_PARENTS, offsets, JOINT_NAMES)

    params, means, stds = loading.load_generator(model_dir)
    statics = vae.build_statics(EXAMPLE_PARENTS, cfg.VAE_PARAM)
    folded = vae.fold_decoder(params["decoder"], statics, "cpu")
    L = cfg.VAE_PARAM["latent_dim"]
    z = np.zeros((n_frames, L))
    z[0] = rng.normal(size=L) * 0.5
    for t in range(1, n_frames):
        z[t] = 0.98 * z[t - 1] + 0.08 * rng.normal(size=L)
    kernel = np.ones(9) / 9.0
    z = np.stack([np.convolve(np.pad(z[:, i], 4, mode="edge"), kernel,
                              mode="valid") for i in range(L)], axis=1)
    mean_dqs = torch.as_tensor(means["dqs"])
    std_dqs = torch.as_tensor(stds["dqs"])
    pose_n, _ = vae.decode_folded_flat(
        folded, torch.as_tensor(z, dtype=torch.float32), mean_dqs, std_dqs)
    mean_q, std_q = vae.quat_stats(mean_dqs, std_dqs)
    qs = (pose_n * std_q + mean_q).reshape(n_frames, J, 4)

    t = np.arange(n_frames) * FRAME_TIME
    yaw = rng.uniform(-np.pi, np.pi) + 0.4 * np.sin(0.7 * t) + 0.2 * t
    root = np.stack([np.cos(yaw / 2), 0 * yaw, 0 * yaw, np.sin(yaw / 2)], -1)
    qs[:, 0] = torch.as_tensor(root, dtype=torch.float32)
    local = fk.from_root_quat(qs, skeleton)
    order = np.array([["z", "y", "x"]] * J)
    angles = quat.to_euler(local, torch.as_tensor(
        quat.order_to_indices(order))[None])

    speed = 0.6 + 0.3 * np.sin(0.5 * t)
    heading = yaw + 0.3 * np.sin(0.9 * t)
    path = np.zeros((n_frames, 3))
    path[:, 0] = np.cumsum(speed * np.cos(heading)) * FRAME_TIME
    path[:, 1] = np.cumsum(speed * np.sin(heading)) * FRAME_TIME
    path[:, 2] = 0.95 + 0.02 * np.sin(2 * np.pi * 1.5 * t)

    bvh = BVH()
    bvh.names = list(JOINT_NAMES)
    bvh.parents = EXAMPLE_PARENTS.copy()
    bvh.offsets = offsets.copy()
    bvh.rot_order = order
    bvh.positions = np.tile(offsets[None], (n_frames, 1, 1))
    bvh.positions[:, 0] = path
    bvh.rotations = np.degrees(angles.numpy().astype(np.float64))
    bvh.frame_time = FRAME_TIME
    return bvh


def write_synthetic_clips(directory: str, n_frames, seed: int):
    """Write one synthetic clip per entry of ``n_frames`` (seeds seed,
    seed+1, ...) as ``synthetic_<i>.bvh``; returns their paths."""
    paths = []
    for i, n in enumerate(n_frames):
        path = os.path.join(directory, f"synthetic_{i}.bvh")
        synthetic_bvh(int(n), seed + i).save(path)
        paths.append(path)
    return paths


def chain_parents(n_joints: int) -> np.ndarray:
    """A chain skeleton: joint j's parent is j - 1."""
    return np.maximum(np.arange(n_joints) - 1, 0)


def _numpy_tree(tree):
    """A parameter tree of tensors as the same tree of numpy arrays."""
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_numpy_tree(v) for v in tree)
    return tree.detach().cpu().numpy()


def wide_generator(parents, latent_dim: int, seed: int = 2222):
    """A random generator for ``parents`` at ``latent_dim`` (the port's
    ``vae.init_params`` drawn from a seeded ``torch.Generator``), with the
    example model's means and stds, joint j taking joint j % 22's: (numpy
    parameter tree, means, stds, VAE param).  K1's general build runs such
    models: their folded decoders are wider than its narrow build."""
    import torch

    from dragposer_tpu_torch import config as cfg
    from dragposer_tpu_torch.models import loading, vae

    param = dict(cfg.VAE_PARAM, latent_dim=int(latent_dim))
    gen = torch.Generator().manual_seed(seed)
    params = vae.init_params(gen, np.asarray(parents), param)
    params = _numpy_tree(params)
    _, means, stds = loading.load_generator(MODEL_DIR)
    J = len(parents)
    rows = np.arange(J) % len(EXAMPLE_PARENTS)

    def tile(d):
        return {"dqs": d["dqs"].reshape(-1, 8)[rows].reshape(-1),
                "displacement": d["displacement"]}

    return params, tile(means), tile(stds), param


def write_wide_model(model_dir: str, latent_dim: int, seed: int = 2222
                     ) -> str:
    """A model directory (``generator.npz`` + ``parameters.json``, no
    temporal model) of :func:`wide_generator` on the example skeleton."""
    from dragposer_tpu_torch.models import checkpoint

    params, means, stds, param = wide_generator(EXAMPLE_PARENTS, latent_dim,
                                                seed)
    os.makedirs(model_dir, exist_ok=True)
    checkpoint.save(os.path.join(model_dir, "generator.npz"), params,
                    extra={"means": means, "stds": stds})
    checkpoint.save_hparams(model_dir, param)
    return model_dir


def chain_tracker_mask(n_joints: int):
    """Six trackers spread along a skeleton of ``n_joints`` (the root and
    five more) and their loss weights, as ``_BASE_WEIGHTS`` weighs the
    example's: (mask (J,), weights (J, 2))."""
    idx = np.linspace(0, n_joints - 1, 6).round().astype(int)
    mask = np.zeros(n_joints, np.float32)
    mask[idx] = 1.0
    weights = np.tile(np.float32([1.0, 0.01]), (n_joints, 1))
    weights[idx] = (5.0, 0.01)
    weights[0] = (10.0, 10.0)
    return mask, weights


def wide_engine(n_joints: int, latent_dim: int, device="cuda",
                seed: int = 2222):
    """A ``DragEngine`` on a chain of ``n_joints`` (seeded 5-15 cm bones)
    with :func:`wide_generator`'s weights, six trackers
    (:func:`chain_tracker_mask`) and no temporal model, at the offline
    eval's optimizer settings: (engine, parents, offsets)."""
    from dragposer_tpu_torch.cli import eval_drag as ev
    from dragposer_tpu_torch.drag.engine import (DragEngine, DragHyper,
                                                 DragModel)
    from dragposer_tpu_torch.models import vae
    from dragposer_tpu_torch.ops.topology import Skeleton

    parents = chain_parents(n_joints)
    rng = np.random.default_rng(seed)
    offsets = np.zeros((n_joints, 3))
    offsets[1:, 2] = rng.uniform(0.05, 0.15, n_joints - 1)
    offsets[1:, :2] = rng.normal(0, 0.02, (n_joints - 1, 2))
    skeleton = Skeleton.build(parents, offsets,
                              [f"j{j}" for j in range(n_joints)])
    params, means, stds, param = wide_generator(parents, latent_dim, seed)
    mask, weights = chain_tracker_mask(n_joints)
    model = DragModel(
        decoder=params["decoder"], encoder=params["encoder"], temporal=None,
        mean_dqs=means["dqs"], std_dqs=stds["dqs"],
        mean_disp=means["displacement"], std_disp=stds["displacement"],
        means_latent=np.zeros(latent_dim, np.float32),
        stds_latent=np.ones(latent_dim, np.float32),
        mask=mask, weights=weights)
    hyper = DragHyper(
        max_iter=ev.EVAL_MAX_ITER, stop_eps_pos=ev.EVAL_STOP_EPS_POS,
        stop_eps_rot=ev.EVAL_STOP_EPS_ROT,
        min_loss_incr=ev.EVAL_MIN_LOSS_INCR, learning_rate=ev.EVAL_LR,
        lambda_rot=ev.EVAL_LAMBDA_ROT, use_temporal=False,
        joint_adjustment=None)
    engine = DragEngine(model, vae.build_statics(parents, param), skeleton,
                        hyper, None, device=device)
    return engine, parents, offsets


def synthetic_chain_bvh(n_joints: int, n_frames: int, seed: int = 2222):
    """A seeded clip of :func:`wide_engine`'s chain skeleton (the same
    bones for the same seed): each joint bends by a smooth random walk of
    up to ~25° about every axis, the root turns and walks a smooth path."""
    from dragposer_tpu_torch.io.bvh import BVH

    rng = np.random.default_rng(seed)
    offsets = np.zeros((n_joints, 3))
    offsets[1:, 2] = rng.uniform(0.05, 0.15, n_joints - 1)
    offsets[1:, :2] = rng.normal(0, 0.02, (n_joints - 1, 2))
    walk = np.cumsum(rng.normal(0, 1.5, (n_frames, n_joints, 3)), axis=0)
    angles = 25.0 * np.tanh(walk / 25.0)
    t = np.arange(n_frames) * FRAME_TIME
    angles[:, 0, 0] = np.degrees(0.3 * t)
    bvh = BVH()
    bvh.names = [f"j{j}" for j in range(n_joints)]
    bvh.parents = chain_parents(n_joints)
    bvh.offsets = offsets.copy()
    bvh.rot_order = np.array([["z", "y", "x"]] * n_joints)
    bvh.positions = np.tile(offsets[None], (n_frames, 1, 1))
    bvh.positions[:, 0] = np.stack([0.5 * t, 0.1 * np.sin(t),
                                    0.9 + 0 * t], axis=-1)
    bvh.rotations = angles
    bvh.frame_time = FRAME_TIME
    return bvh


def clip_trackers(bvh):
    """World positions (T, J, 3) and wxyz rotations (T, J, 4) of every joint
    of a clip: what a tracker on each joint reads.  A realtime frame's
    targets are a mask's rows, positions less the session's root."""
    import torch

    from dragposer_tpu_torch.data import encoding
    from dragposer_tpu_torch.ops import fk
    from dragposer_tpu_torch.ops.topology import Skeleton

    rots, pos, parents, offsets, _ = encoding.info_from_bvh(bvh)
    skeleton = Skeleton.build(parents, offsets, bvh.names)
    p, q = fk.fk_local(torch.as_tensor(rots), torch.as_tensor(pos[:, 0]),
                       skeleton)
    return p.numpy(), q.numpy()


# ---------------------------------------------------------------------------
# Kernel checks (also used by tests/test_torch_cuda.py at small sizes)
# ---------------------------------------------------------------------------

F32_PEAK = 67e12        # H100 SXM float32 FLOP/s outside the tensor cores
TF32_PEAK = 495e12      # H100 SXM dense TF32 FLOP/s on the tensor cores
HBM_BYTES_PER_S = 3.35e12
K1_TOL = dict(rtol=5e-4, atol_per_step=5e-5)   # tests/test_iter_kernel.py
K2_TOL = dict(rtol=1e-4, atol=1e-5)            # tests/test_temporal_fused.py


def cuda_ms(fn, reps: int = 5) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs, CUDA events."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound_ms(flops: float, nbytes: float) -> tuple:
    t_ops, t_bytes = flops / F32_PEAK, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def k1_flops_split(J: int, L: int, H1: int, H2: int) -> tuple:
    """Operations of one drag step for one lane, counted from the code:
    the decoder forward and its transposed backward, 2 FLOP per
    multiply-add (K1's tensor-core work), and the rest on CUDA cores: ~350
    per joint for quaternions, FK, the loss and their reverse, ~15 per
    latent dim for the loss term and Adam."""
    macs = L * H1 + H1 * H2 + H2 * (4 * J + 3)
    return 2 * 2 * macs, 350 * J + 15 * L


def k2_flops_split(s_enc: int, s_dec: int, d=48, ff=2048, heads=4,
                   layers=3, d_enc=33, d_lat=24) -> tuple:
    """Operations of the temporal forward for one lane (2 per MAC): the
    weight products (K2's tensor-core work) and the attention scores and
    values (its CUDA-core work)."""
    dh = d // heads

    def proj(sq, kv_rows):
        return 2 * (sq * d * d + kv_rows * d * 2 * d + sq * d * d)

    def core(sq, sk):
        return 2 * 2 * heads * sq * sk * dh                   # QK and AV

    def ffn(rows):
        return 2 * rows * d * ff * 2

    products = (2 * s_enc * d_enc * d + 2 * s_dec * d_lat * d
                + 2 * s_dec * d * d_lat
                + layers * (proj(s_enc, s_enc) + ffn(s_enc)
                            + proj(s_dec, s_dec) + proj(s_dec, s_enc)
                            + ffn(s_dec)))
    attention = layers * (core(s_enc, s_enc) + core(s_dec, s_dec)
                          + core(s_dec, s_enc))
    return products, attention


def k1_inputs(engine, B: int, seed: int = 0, per_lane: bool = False):
    """Random block inputs in the pattern of tests/test_iter_kernel.py, on
    the engine's device: (ctx, kctx, opt, active, state, tposT, trotT,
    target_latent)."""
    import torch

    from dragposer_tpu_torch.drag import engine as eng
    from dragposer_tpu_torch.drag import fast_iter, iter_kernel
    from dragposer_tpu_torch.ops import quat

    dev = engine.device
    J = engine.skeleton.n_joints
    L = engine.model.decoder["ws"][0].shape[1]
    g = torch.Generator(device="cpu").manual_seed(seed)
    rn = lambda *s: torch.randn(s, generator=g).to(dev)  # noqa: E731
    model = engine.model
    if per_lane:
        mask = (torch.rand((B, J), generator=g) < 0.4).float().to(dev)
        model = model._replace(mask=mask, weights=model.weights.expand(
            B, J, 2).contiguous())
    ctx = fast_iter.make_context(model, engine.skeleton, engine.hyper)
    kctx = iter_kernel.make_kernel_context(ctx)
    opt = eng._opt_init((rn(B, L) * 0.7).contiguous(), J)
    gr = quat.normalize(rn(B, 4)).contiguous()
    tposT = (rn(J, 3, B) * 0.3).contiguous()
    trotT = quat.to_matrix(quat.normalize(rn(B, J, 4))).permute(
        1, 2, 3, 0).contiguous()
    tlat = (rn(B, L) * 0.2).contiguous()
    active = (torch.arange(B, device=dev) % 5) != 3

    class State:
        global_rot = gr

    return ctx, kctx, opt, active, State, tposT, trotT, tlat


K1_OPT = ("latent", "m", "v", "decoded_latent", "prev_loss", "loss_pos",
          "loss_rot", "loss_incr")
K1_AUX = ("loss_pos", "loss_rot", "world_displacement", "displacement",
          "world_rotation", "positions", "pose")


def k1_agreement(got, ref, B: int, sync_k: int, pose_std=None,
                 knife=None) -> dict:
    """K1_TOL per lane over the carry and every aux field.  Lanes whose
    iteration count differs (a stop-rule knife edge flipped by
    reassociation) are counted and left out of the value comparison.

    With ``pose_std`` (the quat stds in the pose's order, 4J), the pose is
    held as pose · std = u − mean, the unit quaternions' offsets: the
    normalized pose divides them by stds as small as ~6e-4, so one ulp of
    a quaternion component moves it by ~1e-4, and two float32 evaluations
    of the plain twin (on the card and on the CPU) already differ there by
    more than K1_TOL.  The raw pose's error is reported beside it.

    With ``knife`` (K1's general build, on random wide generators: a
    boolean per lane, :func:`k1_knife_lanes`), the lanes whose first Adam
    step divides a cancelling gradient component are exempt where nothing
    bounds them: Adam's first update is lr·g/(|g| + eps), which moves by
    lr·eps·δg/(|g| + eps)² on a change δg of g; at |g| ~ 1e-7 against
    eps 1e-8 a 1e-9 change (float32 rounding in another order) moves the
    latent past K1_TOL, and over 24 steps such a lane may drift past the
    1e-2 cap.  At sync_k = 1 only knife lanes may be over the tolerance
    (at most B // 1000 of them); at longer blocks at most B // 1000 lanes
    are over it and the 1e-2 cap holds on every lane but the knife
    lanes.  Each over-tolerance lane's first-step |g| at its worst latent
    entry is reported (``first_step_grad``, from the twin's first moment:
    m = 0.1·g after one step from m = 0)."""
    import torch

    same_t = got.t == ref.t
    atol = K1_TOL["atol_per_step"] * sync_k
    over = torch.zeros_like(same_t)
    worst = {"opt": 0.0, "aux": 0.0}
    pose_raw = (got.aux.pose - ref.aux.pose).abs()
    scaled = {} if pose_std is None else {
        "pose": (got.aux.pose * pose_std, ref.aux.pose * pose_std)}
    pairs = ([("opt", getattr(got, n), getattr(ref, n)) for n in K1_OPT]
             + [("aux", *scaled.get(n, (getattr(got.aux, n),
                                        getattr(ref.aux, n))))
                for n in K1_AUX])
    # the carry's losses start at +inf: only the latent and the aux must
    # be finite
    finite = bool(torch.isfinite(got.latent).all())
    by_field = {}
    for (kind, a, b), name in zip(pairs, K1_OPT + K1_AUX):
        err = (a - b).abs()
        bad = ~((a == b) | (err <= atol + K1_TOL["rtol"] * b.abs()))
        lanes = bad.reshape(B, -1).any(dim=1)
        over |= lanes
        if bool((lanes & same_t).any()):
            by_field[f"{kind}.{name}"] = int((lanes & same_t).sum())
        if kind == "aux":
            finite = finite and bool(torch.isfinite(a).all())
        if bool(same_t.any()):
            worst[kind] = max(worst[kind], float(
                err.reshape(B, -1)[same_t].max()))
    # sync_k = 1: every lane within the tolerance.  Over many steps Adam's
    # sign-like first-moment normalization lets a few lanes' ulp-level
    # differences grow chaotically; a formula error would show in every
    # lane at sync_k = 1, so longer blocks allow 0.1% of lanes over the
    # tolerance and cap the worst latent error at 1e-2.
    n_over = int((over & same_t).sum())
    general = knife is not None
    if not general:
        knife = torch.zeros_like(same_t)
    capped = same_t & ~knife
    lane_err = (got.latent - ref.latent).abs().amax(dim=1)
    latent_err = float(lane_err[same_t].max()) if bool(same_t.any()) else 0.0
    capped_err = float(lane_err[capped].max()) if bool(capped.any()) else 0.0
    over_capped = int((over & capped).sum())
    if sync_k == 1:
        ok = over_capped == 0 and n_over <= (B // 1000 if general else 0)
    else:
        ok = n_over <= B // 1000
    ok = ok and capped_err <= 1e-2
    res = {"max_abs_err": latent_err, "opt_max_abs_err": worst["opt"],
           "aux_max_abs_err": worst["aux"],
           "pose_raw_max_abs_err": float(pose_raw.max()),
           "t_mismatch": int((~same_t).sum()), "lanes_over_tol": n_over,
           "lanes_over_tol_by_field": by_field, "ok": ok and finite}
    if general:
        err = (got.latent - ref.latent).abs()
        lanes = torch.nonzero(over & same_t).flatten().tolist()[:16]
        res.update(
            knife_lanes=int(knife.sum()), lanes_over_tol_not_knife=over_capped,
            max_abs_err_not_knife=capped_err,
            over_tol_lanes={lane: {"knife": bool(knife[lane]),
                                   "latent_err": float(lane_err[lane])}
                            for lane in lanes})
        if sync_k == 1:
            res["first_step_grad"] = {
                lane: float(ref.m[lane, int(err[lane].argmax())] / 0.1)
                for lane in lanes}
    return res


KNIFE_G = 1e-6      # 100 × Adam's eps: first-step |g| of a knife-edge lane


def k1_knife_lanes(engine, B: int):
    """The lanes of :func:`k1_inputs` (B lanes) whose first Adam step (the
    plain twin's, at sync_k = 1) meets a gradient component below
    ``KNIFE_G`` (|g| from the first moment, m = 0.1·g): a bool per lane."""
    from dragposer_tpu_torch.drag import fast_iter

    ctx, _, opt, active, state, tposT, trotT, tlat = k1_inputs(engine, B)
    first = fast_iter.run_block(ctx, engine.hyper, 1, opt, active, state,
                                tposT, trotT, tlat)
    g = (first.m / 0.1).abs().amin(dim=1)
    return (first.t > opt.t) & (g < KNIFE_G)


def check_k1(engine, B: int, sync_k: int, per_lane: bool = False,
             reps: int = 5, timed: bool = True, control: bool = False,
             calls: int = 20, knife=None, plain_calls: int = 2) -> dict:
    """K1 against its plain twin on the card, the carry and the aux.  With
    ``control``, K1 with its products in one TF32 pass must fail the same
    check, or the check fails: K1_TOL has to tell 3xTF32 from TF32.
    Timed: ``ms`` is K1's own device time per call (the profiler's self
    time of ``iter_block_kernel`` over ``calls`` calls), beside the
    wrapper's device time per call and CUDA events around a call (which
    also time the host between launches).  ``knife``: see
    :func:`k1_agreement`; ``build`` names the build the shapes take.
    The twin's device time comes from ``plain_calls`` profiled calls
    (~5,000 launches each at sync_k = 24, seconds of trace to read; 0:
    not timed)."""
    import torch

    from dragposer_tpu_torch.drag import fast_iter, iter_kernel

    ctx, kctx, opt, active, state, tposT, trotT, tlat = k1_inputs(
        engine, B, per_lane=per_lane)
    hyper = engine.hyper
    args = (opt, active, state, tposT, trotT, tlat)
    run_k = lambda: iter_kernel.run_block_fused(  # noqa: E731
        ctx, kctx, hyper, sync_k, *args)
    run_p = lambda: fast_iter.run_block(  # noqa: E731
        ctx, hyper, sync_k, *args)
    got, ref = run_k(), run_p()
    torch.cuda.synchronize()
    pose_std = kctx.sq.T.reshape(-1)
    res = k1_agreement(got, ref, B, sync_k, pose_std, knife)
    res["steps"] = int((got.t - opt.t).sum())
    res["build"] = iter_kernel.build_for(
        engine.skeleton.n_joints, opt.latent.shape[1], kctx.W1.shape[0],
        kctx.W2.shape[0])
    if hasattr(iter_kernel, "launch_build"):   # not in a parent's package
        res["kernel"] = iter_kernel.launch_build(kctx, opt)
    if control:
        tf32 = iter_kernel.run_block_tf32(ctx, kctx, hyper, sync_k, *args)
        torch.cuda.synchronize()
        c = k1_agreement(tf32, ref, B, sync_k, pose_std, knife)
        res["tf32_control"] = {k: c[k] for k in (
            "max_abs_err", "opt_max_abs_err", "aux_max_abs_err",
            "lanes_over_tol")}
        res["tf32_control_refused"] = not c["ok"]
        res["ok"] = res["ok"] and res["tf32_control_refused"]
    if timed:
        run_k()
        prof = profile_device_time(lambda: [run_k() for _ in range(calls)],
                                   {"K1": "iter_block_kernel"})
        res["ms"] = prof["device_ms"]["K1"] / calls
        res["wrapper_device_ms"] = prof["device_busy_ms"] / calls
        res["event_ms"] = cuda_ms(run_k, reps)
        res["plain_ms"] = (device_ms(run_p, calls=plain_calls)
                           if plain_calls else None)
        L = opt.latent.shape[1]
        # each input read once, each output written once: z, m, v, decoded,
        # target latent (in) and z, m, v, decoded (out); 5 scalars in and
        # out; the lane flag; global rotation and the targets; the aux
        # (4J pose, 3J positions, 3 + 3 + 4 + 2 of the root and losses)
        J = engine.skeleton.n_joints
        nbytes = 4 * B * (9 * L + 10 + 4 + 7 * J + 12) + B + 4 * (
            tposT.numel() + trotT.numel())
        products, rest = k1_flops_split(J, L, kctx.W1.shape[0],
                                        kctx.W2.shape[0])
        steps = res["steps"]
        # the products in 3 TF32 passes on the tensor cores, the rest on
        # CUDA cores; the two units run concurrently, so the larger bounds
        t_ops = max(3 * steps * products / TF32_PEAK, steps * rest / F32_PEAK)
        t_bytes = nbytes / HBM_BYTES_PER_S
        res["bound_ms"] = max(t_ops, t_bytes) * 1e3
        res["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
        res["bound_f32_cuda_core_ms"] = bound_ms(
            steps * (products + rest), nbytes)[0]
    return res


def k1_twin_card_vs_cpu(engine, B: int, sync_k: int = 1) -> dict:
    """K1's plain twin on the card against the same twin on the CPU, on
    check_k1's inputs: the carry and the aux with the raw pose, and with
    the pose as pose · std (``k1_agreement``) — how far two float32
    evaluations of the reference already differ."""
    import torch

    from dragposer_tpu_torch.drag import fast_iter

    ctx, kctx, opt, active, state, tposT, trotT, tlat = k1_inputs(engine, B)

    def cpu(x):
        if isinstance(x, tuple):
            return type(x)(*[cpu(y) for y in x])
        return x.cpu() if torch.is_tensor(x) else x

    class CpuState:
        global_rot = state.global_rot.cpu()

    card = fast_iter.run_block(ctx, engine.hyper, sync_k, opt, active, state,
                               tposT, trotT, tlat)
    host = fast_iter.run_block(cpu(ctx), engine.hyper, sync_k, cpu(opt),
                               active.cpu(), CpuState, tposT.cpu(),
                               trotT.cpu(), tlat.cpu())
    card = cpu(card)
    keys = ("lanes_over_tol", "lanes_over_tol_by_field", "aux_max_abs_err")
    raw = k1_agreement(card, host, B, sync_k)
    scaled = k1_agreement(card, host, B, sync_k, kctx.sq.T.reshape(-1).cpu())
    return {"raw_pose": {k: raw[k] for k in keys},
            "pose_times_std": {k: scaled[k] for k in keys}}


def _library_transformer(tparams, device):
    """torch.nn.Transformer with the checkpoint's weights (a yardstick for
    K2; the port never calls it)."""
    import torch

    tr = torch.nn.Transformer(d_model=48, nhead=4, num_encoder_layers=3,
                              num_decoder_layers=3, dim_feedforward=2048,
                              dropout=0.0, batch_first=True).to(device).eval()

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                               device=device)

    def attn(mod, p):
        mod.in_proj_weight.copy_(t(p["in_w"]))
        mod.in_proj_bias.copy_(t(p["in_b"]))
        mod.out_proj.weight.copy_(t(p["out_w"]))
        mod.out_proj.bias.copy_(t(p["out_b"]))

    def lin(mod, p):
        mod.weight.copy_(t(p["w"]))
        mod.bias.copy_(t(p["b"]))

    def ln(mod, p):
        mod.weight.copy_(t(p["g"]))
        mod.bias.copy_(t(p["b"]))

    with torch.no_grad():
        for layer, p in zip(tr.encoder.layers, tparams["enc_layers"]):
            attn(layer.self_attn, p["self_attn"])
            lin(layer.linear1, p["ff1"])
            lin(layer.linear2, p["ff2"])
            ln(layer.norm1, p["ln1"])
            ln(layer.norm2, p["ln2"])
        for layer, p in zip(tr.decoder.layers, tparams["dec_layers"]):
            attn(layer.self_attn, p["self_attn"])
            attn(layer.multihead_attn, p["cross_attn"])
            lin(layer.linear1, p["ff1"])
            lin(layer.linear2, p["ff2"])
            ln(layer.norm1, p["ln1"])
            ln(layer.norm2, p["ln2"])
            ln(layer.norm3, p["ln3"])
        ln(tr.encoder.norm, tparams["enc_norm"])
        ln(tr.decoder.norm, tparams["dec_norm"])
    return tr


@contextlib.contextmanager
def tf32_matmuls():
    """TF32 float32 matmuls inside the block only (the port runs with them
    off, ``_device.resolve_device``)."""
    import torch

    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def k2_tol_ratio(got, ref) -> float:
    """The largest error over its allowance under K2_TOL (≤ 1 passes)."""
    err = (got - ref).abs()
    return float((err / (K2_TOL["atol"] + K2_TOL["rtol"] * ref.abs())).max())


def within_k2_tol(got, ref) -> bool:
    """``got`` finite and within K2_TOL of ``ref``."""
    import torch

    return k2_tol_ratio(got, ref) <= 1.0 and bool(torch.isfinite(got).all())


def check_k2(engine, B: int, s_dec: int, mask_kind: str = "row",
             reps: int = 5, timed: bool = True, library: bool = False,
             control: bool = False, s_enc: int = 14) -> dict:
    """K2 against its plain twin on the card (and, with ``library``,
    ``torch.nn.Transformer`` as a timed yardstick, in float32 and with TF32
    matmuls).  With ``control``, the plain twin with TF32 matmuls on must
    fail the same tolerance, or the check fails: K2_TOL has to tell the
    kernel's 3xTF32 from a single TF32 pass."""
    import torch

    from dragposer_tpu_torch import config as cfg
    from dragposer_tpu_torch.models import loading
    from dragposer_tpu_torch.ops import temporal_fused

    dev = engine.device
    packed = engine.model.temporal
    g = torch.Generator(device="cpu").manual_seed(s_dec)
    enc = torch.randn((B, s_enc, 33), generator=g).to(dev)
    dec = torch.randn((B, s_dec, 24), generator=g).to(dev)
    cols = torch.arange(s_dec, device=dev)
    if mask_kind == "row":
        mask = torch.where(cols <= s_dec // 2, 0.0, float("-inf"))[None]
    else:
        mask = torch.where(cols[None, :] <= cols[:, None], 0.0, float("-inf"))
    mask = mask.contiguous()
    param = cfg.TEMPORAL_PARAM
    run_k = lambda: temporal_fused.forward(packed, param, enc, dec,  # noqa: E731
                                           mask)
    run_p = lambda: temporal_fused.forward_plain(packed, enc, dec,  # noqa: E731
                                                 mask)
    got, ref = run_k(), run_p()
    torch.cuda.synchronize()
    res = {"max_abs_err": float((got - ref).abs().max()),
           "tol_ratio": k2_tol_ratio(got, ref),
           "ok": within_k2_tol(got, ref),
           "lanes_per_block": temporal_fused.lanes_per_block(s_enc, s_dec)}
    if control:
        with tf32_matmuls():
            tf32 = run_p()
        torch.cuda.synchronize()
        res["tf32_control_err"] = float((tf32 - ref).abs().max())
        res["tf32_control_refused"] = not within_k2_tol(tf32, ref)
        res["ok"] = res["ok"] and res["tf32_control_refused"]
    if timed:
        res["ms"] = cuda_ms(run_k, reps)
        res["plain_ms"] = cuda_ms(run_p, reps)
        # each input read once: the float32 weights, not the kernel's split
        nbytes = (enc.numel() + dec.numel() + got.numel()) * 4 + sum(
            p.numel() * 4 for _, p in temporal_fused._weights(packed))
        products, attention = k2_flops_split(s_enc, s_dec)
        # 3 tensor-core passes for the products, the attention core on CUDA
        # cores; the two units run concurrently, so the larger time bounds
        t_ops = max(3 * B * products / TF32_PEAK, B * attention / F32_PEAK)
        t_bytes = nbytes / HBM_BYTES_PER_S
        res["bound_ms"] = max(t_ops, t_bytes) * 1e3
        res["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
        res["bound_f32_cuda_core_ms"] = bound_ms(
            B * (products + attention), nbytes)[0]
    if library:
        tparams = loading.load_temporal(MODEL_DIR)[0]
        tr = _library_transformer(tparams, dev)
        w = {k: torch.as_tensor(np.asarray(tparams[k]["w"]), device=dev)
             for k in ("in_proj_enc", "in_proj_dec", "out_proj")}
        b = {k: torch.as_tensor(np.asarray(tparams[k]["b"]), device=dev)
             for k in ("in_proj_enc", "in_proj_dec", "out_proj")}
        pe = packed["pe"]

        def run_lib():
            with torch.no_grad():
                src = enc @ w["in_proj_enc"].T + b["in_proj_enc"] \
                    + pe[:s_enc]
                tgt = dec @ w["in_proj_dec"].T + b["in_proj_dec"] \
                    + pe[:s_dec]
                h = tr(src, tgt, tgt_mask=mask if mask.shape[0] > 1
                       else mask.expand(s_dec, s_dec))
                return h @ w["out_proj"].T + b["out_proj"]

        def run_lib_tf32():
            with tf32_matmuls():
                return run_lib()

        res["library_err"] = float((run_lib() - ref).abs().max())
        if timed:
            res["library_ms"] = cuda_ms(run_lib, reps)
            res["library_tf32_ms"] = cuda_ms(run_lib_tf32, reps)
    return res


# K3: tolerances of the kernels against their plain twins on the card.  The
# inputs are quantized (x to 2^-8, W1 and b1 to 2^-10) so that every
# pre-activation is exact in float32 in any summation order: the ReLU gates
# of kernel and twin then agree exactly, and what is left is the rounding
# of the 2048-term (y, dx) and S·B-term (dW, db) sums.
K3_TOL = dict(rtol=1e-4, atol_rel=2e-6)
K4_TOL = dict(rtol=1e-4, atol=1e-5)   # tests/test_attn_fused.py


# The two layouts of the fused feed-forward: the ops/ff_fused functions of
# each (kernel launches, plain twins, the keep mask, the autograd entry),
# the shape of its activations for S tokens × B lanes, and its kernels'
# symbols in a profile (every ff_common.cuh kernel is a template on the
# layout struct).
K3_LAYOUTS = {
    "lanes": dict(fwd="forward_kernel", bwd="backward_kernel",
                  fwd_plain="forward_plain", bwd_plain="backward_plain",
                  entry="ff_dropout_lanes", names=("K3c", "K3d"),
                  symbol="LanesLayout", shape=lambda S, B: (S, 48, B)),
    "rows": dict(fwd="forward_kernel_rows", bwd="backward_kernel_rows",
                 fwd_plain="forward_plain_rows",
                 bwd_plain="backward_plain_rows", entry="ff_dropout_seeded",
                 names=("K3a", "K3b"), symbol="RowsLayout",
                 shape=lambda S, B: (S * B, 48)),
}


def k3_fn(layout: str, role: str):
    """ops/ff_fused's function ``role`` of ``layout`` (looked up at call
    time, so that a swapped attribute is seen)."""
    from dragposer_tpu_torch.ops import ff_fused

    return getattr(ff_fused, K3_LAYOUTS[layout][role])


def k3_keep_mask(layout: str, S: int, B: int, rate: float, seed: int,
                 F: int = 2048, device="cpu"):
    """The hash's keep mask of the hidden: (S, F, B) or (S·B, F)."""
    from dragposer_tpu_torch.ops import ff_fused

    if layout == "rows":
        return ff_fused.keep_mask_rows(S * B, F, rate, seed, device)
    return ff_fused.keep_mask_lanes(S, F, B, rate, seed, device)


def k3_inputs(S: int, B: int, seed: int, F: int = 2048, D: int = 48,
              device="cuda", layout: str = "lanes"):
    import torch

    g = torch.Generator().manual_seed(seed)

    def q(t, step):
        return torch.round(t / step) * step

    shape = K3_LAYOUTS[layout]["shape"](S, B)
    bound = float(np.sqrt(6.0 / (F + D)))
    uni = lambda *s: torch.rand(s, generator=g) * 2 - 1  # noqa: E731
    x = q(torch.randn(shape, generator=g).clamp(-4, 4), 2.0 ** -8)
    w1 = q(uni(F, D) * bound, 2.0 ** -10)
    b1 = q(uni(F) / np.sqrt(D), 2.0 ** -10)
    w2 = uni(D, F) * bound
    b2 = uni(D) / np.sqrt(F)
    gy = torch.randn(shape, generator=g)
    return [t.to(device).contiguous() for t in (x, w1, b1, w2, b2, gy)]


def k3_flops(S: int, B: int, F: int = 2048, D: int = 48) -> int:
    """K3a/K3c over S·B tokens: FF1 and FF2, 2 FLOP per multiply-add."""
    return 2 * S * B * 2 * D * F


def k3_hidden_from_kernel(x, w1, b1, rate: float, seed: int,
                          layout: str = "lanes"):
    """The forward kernel's own hidden drop(relu(W1·x + b1)), (S, F, B) or
    (M, F) (the feature axis is dim 1 in both layouts): W2 selects D hidden
    rows per launch and b2 = 0, so y holds them as the kernel's 3xTF32 FF2
    carries them, hi + lo: about 22 of float32's 24 bits, not exactly.  Its
    zero pattern and signs are the kernel's own (a normal h > 0 keeps a hi
    > 0), so the ReLU gates and the keep mask read from it are exact; a use
    that compares hidden values must allow ~2^-21 relative."""
    import torch

    D, F = x.shape[1], w1.shape[0]
    fwd = k3_fn(layout, "fwd")
    b2 = torch.zeros(D, device=x.device)
    hidden = torch.empty((x.shape[0], F) + tuple(x.shape[2:]),
                         device=x.device)
    rows = torch.arange(D, device=x.device)
    for f0 in range(0, F, D):
        f0 = min(f0, F - D)
        w2 = torch.zeros((D, F), device=x.device)
        w2[rows, f0 + rows] = 1.0
        hidden[:, f0:f0 + D] = fwd(x, w1, b1, w2, b2, rate, seed)
    return hidden


def k3_mask_from_kernel(S: int, B: int, rate: float, seed: int,
                        F: int = 2048, D: int = 48, device="cuda",
                        layout: str = "lanes"):
    """The kernel's own keep mask, (S, F, B) or (S·B, F): W1 = 0 and b1 = 1
    make the hidden keep · scale."""
    import torch

    dev = torch.device(device)
    hidden = k3_hidden_from_kernel(
        torch.zeros(K3_LAYOUTS[layout]["shape"](S, B), device=dev),
        torch.zeros((F, D), device=dev), torch.ones(F, device=dev), rate,
        seed, layout)
    return hidden > 0.5


def k3_within_tol(got, ref) -> tuple:
    """(max abs error by name, every output within K3_TOL and finite) of
    (y, dx, dW1, db1, dW2, db2), of the five gradients alone or of (y,)."""
    import torch

    names = ("y", "dx", "dw1", "db1", "dw2", "db2")
    errs, ok = {}, True
    for name, a, r in zip(names[:1] if len(got) == 1 else names[-len(got):],
                          got, ref):
        err = (a - r).abs()
        tol = K3_TOL["atol_rel"] * float(r.abs().max()) \
            + K3_TOL["rtol"] * r.abs()
        errs[name] = float(err.max())
        ok &= bool((err <= tol).all()) and bool(torch.isfinite(a).all())
    return errs, ok


def k3_fwd_bound_ms(S: int, B: int, nbytes: float) -> tuple:
    """K3a/K3c's bound: both products in 3 TF32 passes on the tensor
    cores; or the bytes."""
    t_ops = 3 * k3_flops(S, B) / TF32_PEAK
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def k3_bwd_bound_ms(S: int, B: int, nbytes: float) -> tuple:
    """K3b/K3d's bound: the recomputed pre-activation and the four
    gradient products, five products in 3 TF32 passes on the tensor cores;
    or the bytes."""
    t_ops = 3 * 5 * (k3_flops(S, B) / 2) / TF32_PEAK
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def check_k3(S: int, B: int, rate: float, seed: int = 4242,
             reps: int = 5, timed: bool = True, device="cuda",
             layout: str = "lanes") -> dict:
    """The feed-forward kernels of ``layout`` (K3c/K3d, or K3a/K3b on the
    S·B rows) against their plain twins on the card: y, the hidden's zero
    pattern (extracted from the kernel) and all five gradients; and the
    controls, the float32 twins with their products in one TF32 pass
    (forward: W1·x and W2·h; backward: pre and the four gradient products),
    which K3_TOL must refuse."""
    import torch

    from dragposer_tpu_torch.ops.temporal_fused import matmul_tf32

    x, w1, b1, w2, b2, gy = k3_inputs(S, B, seed, device=device,
                                      layout=layout)
    fwd_k = lambda: k3_fn(layout, "fwd")(  # noqa: E731
        x, w1, b1, w2, b2, rate, seed)
    fwd_p = lambda: k3_fn(layout, "fwd_plain")(  # noqa: E731
        x, w1, b1, w2, b2, rate, seed)
    bwd_k = lambda: k3_fn(layout, "bwd")(  # noqa: E731
        x, w1, b1, w2, gy, rate, seed)
    bwd_p = lambda: k3_fn(layout, "bwd_plain")(  # noqa: E731
        x, w1, b1, w2, gy, rate, seed)
    y, y_ref = fwd_k(), fwd_p()
    grads, grads_ref = bwd_k(), bwd_p()
    if device == "cuda":
        torch.cuda.synchronize()
    control = k3_fn(layout, "bwd_plain")(x, w1, b1, w2, gy, rate, seed,
                                         mm=matmul_tf32)
    fwd_control = k3_fn(layout, "fwd_plain")(x, w1, b1, w2, b2, rate, seed,
                                             mm=matmul_tf32)
    errs, ok = k3_within_tol((y, *grads), (y_ref, *grads_ref))
    control_errs, control_ok = k3_within_tol(control, grads_ref)
    fwd_control_errs, fwd_control_ok = k3_within_tol((fwd_control,),
                                                     (y_ref,))
    res = {"max_abs_err": errs, "bwd_tf32_control_max_abs_err": control_errs,
           "bwd_tf32_control_refused": not control_ok,
           "fwd_tf32_control_max_abs_err": fwd_control_errs["y"],
           "fwd_tf32_control_refused": not fwd_control_ok}
    res["ok"] = ok and not control_ok and not fwd_control_ok
    if rate > 0:
        got = k3_mask_from_kernel(S, B, rate, seed, device=device,
                                  layout=layout)
        ref = k3_keep_mask(layout, S, B, rate, seed, device=got.device)
        res["mask_mismatch"] = int((got != ref).sum())
        res["keep_share"] = float(got.float().mean())
        res["ok"] = res["ok"] and res["mask_mismatch"] == 0
    if timed:
        res["fwd_ms"], res["fwd_plain_ms"] = cuda_ms(fwd_k, reps), \
            cuda_ms(fwd_p, reps)
        res["bwd_ms"], res["bwd_plain_ms"] = cuda_ms(bwd_k, reps), \
            cuda_ms(bwd_p, reps)
        res["fwd_device_ms"] = device_ms(fwd_k)
        res["bwd_device_ms"] = device_ms(bwd_k)
        wbytes = 4 * (w1.numel() + b1.numel() + w2.numel() + b2.numel())
        act = 4 * x.numel()
        flops = k3_flops(S, B)
        res["fwd_bound_ms"], res["fwd_bound_by"] = k3_fwd_bound_ms(
            S, B, 2 * act + wbytes)
        res["fwd_bound_f32_cuda_core_ms"] = bound_ms(flops,
                                                     2 * act + wbytes)[0]
        # in x, g and the weights; out dx and the weight gradients
        nbytes = 3 * act + 2 * wbytes
        res["bwd_bound_ms"], res["bwd_bound_by"] = k3_bwd_bound_ms(S, B,
                                                                   nbytes)
        # the recomputed FF1, W2ᵀg, W1ᵀdpre, dW1 and dW2 all in float32 on
        # CUDA cores
        res["bwd_bound_f32_cuda_core_ms"] = bound_ms(2.5 * flops, nbytes)[0]
    return res


def k3_gate_probe(layout: str, rate: float, n: int = 64, seed: int = 77,
                  device="cuda") -> dict:
    """Whether the backward's ReLU gate is the forward's bit for bit, on
    ``n`` single columns whose pre-activations W1·x + b1 lie a few ulps
    from 0: b1 cancels W1·x in float64 and is then rounded to float32, so
    any other summation of pre than the forward's flips gates.  W2's row 0
    is ones and g = e₀, so db1 = gate · keep · scale exactly; it must equal
    the forward kernel's hidden > 0 (``k3_hidden_from_kernel``) times the
    keep scale."""
    import torch

    from dragposer_tpu_torch.ops import hash_dropout

    F, D = 2048, 48
    rng = np.random.default_rng(seed)
    bound = np.sqrt(6.0 / (F + D))
    w1 = (rng.uniform(-1, 1, (F, D)) * bound).astype(np.float32)
    w2 = (rng.uniform(-1, 1, (D, F)) * bound).astype(np.float32)
    w2[0] = 1.0
    shape = K3_LAYOUTS[layout]["shape"](1, 1)
    g = np.zeros(shape, np.float32)
    g.reshape(-1)[0] = 1.0          # feature 0 of the one column
    scale = hash_dropout.keep_scale(rate) if rate > 0 else 1.0
    t = lambda a: torch.as_tensor(a).to(device).contiguous()  # noqa: E731
    mismatch = opened = 0
    for c in range(n):
        x = rng.normal(size=D).astype(np.float32)
        b1 = (-(w1.astype(np.float64) @ x.astype(np.float64))).astype(
            np.float32)
        xs = t(x.reshape(shape))
        gate = k3_hidden_from_kernel(xs, t(w1), t(b1), rate, c,
                                     layout).reshape(-1) > 0
        db1 = k3_fn(layout, "bwd")(xs, t(w1), t(b1), t(w2), t(g), rate,
                                   c)[2]
        want = torch.where(gate, torch.tensor(scale, device=gate.device),
                           torch.tensor(0.0, device=gate.device))
        mismatch += int((db1 != want).sum())
        opened += int(gate.sum())
    return {"layout": layout, "rate": rate, "columns": n,
            "gates_open": opened, "gates": n * F, "mismatch": mismatch,
            "ok": mismatch == 0}


def k4_flops(pairs: int, B: int, h: int = 4, dh: int = 12) -> tuple:
    """(forward, backward) operations over ``pairs`` live (query, key)
    pairs (what the kernels compute: a key masked by -inf is skipped): QK
    and AV 2·dh each, ~5 a score for the softmax; the backward recomputes
    QK and the softmax and adds g·v, dq, dk and dv (2·dh each) and ~5 a
    score."""
    per = pairs * h * B
    return per * (4 * dh + 5), per * (10 * dh + 10)


# the additive masks K4 is held at (k4_mask)
K4_MASKS = ("zero", "causal", "scattered", "dead_row")


def k4_mask(kind: str, sq: int, sk: int, seed: int = 0):
    """An additive (Sq, Sk) float32 mask of ``kind``: ``zero``; ``causal``
    (query i sees keys ≤ i); ``scattered``: seeded finite values with ~40%
    of the entries -inf, not causal, every row keeping a live key;
    ``dead_row``: causal with query row min(3, Sq - 1) all -inf, whose
    softmax is 0/0, NaN, in the plain twin and the JAX kernel."""
    import torch

    if kind not in K4_MASKS:
        raise ValueError(f"mask kind {kind!r} not in {K4_MASKS}")
    m = np.zeros((sq, sk), np.float32)
    if kind in ("causal", "dead_row"):
        m = np.where(np.tri(sq, sk, dtype=bool), 0.0, -np.inf)
    if kind == "dead_row":
        m[min(3, sq - 1)] = -np.inf
    if kind == "scattered":
        rng = np.random.default_rng(seed)
        m = rng.normal(scale=0.5, size=(sq, sk))
        m[rng.random((sq, sk)) < 0.4] = -np.inf
        m[np.arange(sq), np.arange(sq) * 7 % sk] = 0.25
    return torch.as_tensor(m.astype(np.float32))


def k4_live_pairs(mask) -> int:
    """(query, key) pairs the kernels compute: the keys not masked by -inf,
    every key of a row that has none."""
    import torch

    live = (mask != float("-inf")).sum(dim=1)
    return int(torch.where(live == 0, mask.shape[1], live).sum())


def check_k4(sq: int, sk: int, B: int, mask: str = "zero", reps: int = 5,
             timed: bool = True, library: bool = False,
             device="cuda") -> dict:
    """K4a and K4b against their plain twins on the card, with an additive
    mask of kind ``mask`` (:func:`k4_mask`), at ``K4_TOL``: every output
    finite, except with ``dead_row``, whose NaN positions must equal the
    twin's and whose finite entries hold the tolerance.  With ``library``,
    scaled_dot_product_attention timed as a yardstick."""
    import torch

    from dragposer_tpu_torch.ops import attn_fused

    dev = torch.device(device)
    g = torch.Generator().manual_seed(sq * 100 + sk)
    q, k, v, gy = [torch.randn(s, generator=g).to(dev) for s in (
        (sq, 4, 12, B), (sk, 4, 12, B), (sk, 4, 12, B), (sq, 4, 12, B))]
    kind, mask = mask, k4_mask(mask, sq, sk, seed=sq * 100 + sk).to(dev)
    fwd_k = lambda: attn_fused.forward_kernel(q, k, v, mask)  # noqa: E731
    fwd_p = lambda: attn_fused.forward_plain(q, k, v, mask)  # noqa: E731
    bwd_k = lambda: attn_fused.backward_kernel(q, k, v, mask, gy)  # noqa: E731
    bwd_p = lambda: attn_fused.backward_plain(q, k, v, mask, gy)  # noqa: E731
    o, o_ref = fwd_k(), fwd_p()
    grads, grads_ref = bwd_k(), bwd_p()
    if device == "cuda":
        torch.cuda.synchronize()
    errs, nans, ok = {}, {}, True
    for name, a, r in zip(("o", "dq", "dk", "dv"), (o, *grads),
                          (o_ref, *grads_ref)):
        if kind == "dead_row":
            nan_ref = torch.isnan(r)
            nans[name] = {"twin": int(nan_ref.sum()),
                          "equal": bool(torch.equal(torch.isnan(a),
                                                    nan_ref))}
            ok &= nans[name]["equal"]
            a, r = a[~nan_ref], r[~nan_ref]
        else:
            ok &= bool(torch.isfinite(a).all())
        err = (a - r).abs()
        errs[name] = float(err.max()) if err.numel() else 0.0
        ok &= bool((err <= K4_TOL["atol"] + K4_TOL["rtol"] * r.abs()).all())
    res = {"mask": kind, "max_abs_err": errs, "ok": ok}
    if nans:
        res["nan_positions"] = nans
    if timed:
        # a K4 launch is shorter than the host's share of its call, so
        # events around one call time the host: every time here is device
        # time per call (all kernels of the call summed, torch.profiler),
        # with the kernels' event times beside them
        res["fwd_ms"], res["fwd_plain_ms"] = device_ms(fwd_k), \
            device_ms(fwd_p)
        res["bwd_ms"], res["bwd_plain_ms"] = device_ms(bwd_k), \
            device_ms(bwd_p)
        res["fwd_event_ms"], res["bwd_event_ms"] = cuda_ms(fwd_k, reps), \
            cuda_ms(bwd_k, reps)
        # SM cycles a warp by phase, from the kernels' timed builds
        res["phase_cycles"] = attn_fused.phase_cycles(q, k, v, mask, gy)
        res["live_pairs"] = k4_live_pairs(mask)
        f_fwd, f_bwd = k4_flops(res["live_pairs"], B)
        io = 4 * (q.numel() + k.numel() + v.numel())
        # forward: q, k, v and the mask in, o out; backward: q, k, v, the
        # mask and g in, dq, dk and dv out
        res["fwd_bound_ms"], res["fwd_bound_by"] = bound_ms(
            f_fwd, io + 4 * (mask.numel() + o.numel()))
        res["bwd_bound_ms"], res["bwd_bound_by"] = bound_ms(
            f_bwd, 2 * io + 4 * (mask.numel() + gy.numel()))
    if library:
        # the same function as one PyTorch call, batch-first heads
        sd = lambda t: t.permute(3, 1, 0, 2).contiguous()  # noqa: E731
        ql, kl, vl = (sd(t).requires_grad_(True) for t in (q, k, v))
        gl = sd(gy)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib_fwd = lambda: sdpa(ql, kl, vl, attn_mask=mask)  # noqa: E731
        out = lib_fwd()
        res["library_err"] = float((out.detach().permute(2, 1, 3, 0)
                                    - o_ref).abs().max())
        if timed:
            res["library_fwd_ms"] = device_ms(lib_fwd)
            res["library_bwd_ms"] = device_ms(lambda: torch.autograd.grad(
                out, (ql, kl, vl), gl, retain_graph=True))
    return res


def sass_mma_count(name: str, function: str = None) -> int:
    """Tensor-core instructions (``HMMA``, ``HGMMA``) in the SASS of the
    built ``csrc/<name>.cu`` library (``cuobjdump -sass``); with
    ``function``, only in the kernels whose (mangled) name contains it."""
    from dragposer_tpu_torch import _build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(_build.library_path(name))],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    if function is not None:
        parts = re.split(r"^\s*Function\s*:\s*(\S+)", sass, flags=re.M)
        sass = "".join(body for fn, body in zip(parts[1::2], parts[2::2])
                       if function in fn)
    return len(re.findall(r"\bHG?MMA\b", sass))


def sass_functions(library: str) -> dict:
    """The SASS of every kernel in a built library (``cuobjdump -sass``):
    {mangled name: [instruction text]}, addresses and encodings left
    out."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", library], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    parts = re.split(r"^\s*Function\s*:\s*(\S+)", sass, flags=re.M)
    return {fn: [m.group(1).strip() for m in
                 re.finditer(r"/\*[0-9a-f]+\*/\s*([^;]*);", body)]
            for fn, body in zip(parts[1::2], parts[2::2])}


def k2_short_build_matches(parent_library: str) -> dict:
    """This checkout's K2 build for 16 steps against another checkout's
    built ``temporal_forward`` library (one kernel, 16 steps): their SASS
    instruction by instruction, and the 32-step build's length."""
    from dragposer_tpu_torch import _build

    mine = sass_functions(str(_build.library_path("temporal_forward")))
    theirs = sass_functions(parent_library)

    def kernel(fns, tag):
        return next(v for k, v in fns.items()
                    if "temporal_forward_kernel" + tag in k)

    old, short, long_ = (kernel(theirs, ""), kernel(mine, "ILi16"),
                         kernel(mine, "ILi32"))
    return {"parent_instructions": len(old),
            "short_build_instructions": len(short),
            "differing": sum(a != b for a, b in zip(old, short))
            + abs(len(old) - len(short)),
            "long_build_instructions": len(long_)}


def k1_kernel_key(fn: str):
    """(build, passes, timed) of a K1 kernel's mangled name, else None.
    The build is "narrow" (``Build<32, 32, 64, ...>``; in a library from
    before the general build, the kernel that took no build parameter),
    else by where its weights sit: "resident" (shared memory) or
    "streamed<N>" (device memory, at most N blocks an SM; the general
    build of a library from before its layouts reads as "streamed2")."""
    m = re.search(r"iter_block_kernelI(?:.*?BuildI((?:Li\d+E)+)Lb(\d)E+)?"
                  r"Li(\d)ELb(\d)E", fn)
    if m is None:
        return None
    if not m.group(1) or m.group(1).startswith("Li32ELi32ELi64E"):
        build = "narrow"
    elif m.group(2) == "1":
        build = "resident"
    else:   # Build<J, L, H, teams, blocks an SM, ...>
        blocks = re.findall(r"Li(\d+)E", m.group(1))[4]
        build = f"streamed{blocks}"
    return build, int(m.group(3)), bool(int(m.group(4)))


def k1_kernels(library: str) -> dict:
    """K1's kernels in a built ``iter_block`` library by build: {(build,
    passes, timed): [instruction text]} (:func:`k1_kernel_key`)."""
    out = {}
    for fn, body in sass_functions(library).items():
        key = k1_kernel_key(fn)
        if key is not None:
            out[key] = body
    return out


def k1_short_build_matches(parent_library: str) -> dict:
    """This checkout's narrow K1 build against another checkout's built
    ``iter_block`` library: the SASS of each of its kernels (3xTF32, the
    TF32 control, the timed build) instruction by instruction."""
    from dragposer_tpu_torch import _build

    mine = k1_kernels(str(_build.library_path("iter_block")))
    theirs = k1_kernels(parent_library)
    res = {}
    for passes, timed in ((3, False), (1, False), (3, True)):
        old, new = theirs[("narrow", passes, timed)], mine[("narrow", passes,
                                                             timed)]
        res[f"passes{passes}{'_timed' if timed else ''}"] = {
            "parent_instructions": len(old),
            "narrow_build_instructions": len(new),
            "differing": sum(a != b for a, b in zip(old, new))
            + abs(len(old) - len(new)),
            "first_differences": [(i, a, b) for i, (a, b) in enumerate(
                zip(old, new)) if a != b][:8]}
    res["general_build_instructions"] = {
        build: len(body) for (build, passes, timed), body in mine.items()
        if build != "narrow" and passes == 3 and not timed}
    res["differing"] = sum(r["differing"] for r in res.values()
                           if isinstance(r, dict))
    return res


def k1_narrow_sass_digest(library: str = None) -> dict:
    """The narrow K1 build's 3xTF32 kernel as built here (or in another
    built ``iter_block`` library): its instruction count and the sha256 of
    its SASS text (``k1_kernels``), beside the nvcc release here."""
    import hashlib

    from dragposer_tpu_torch import _build

    body = k1_kernels(library or str(_build.library_path("iter_block")))[
        ("narrow", 3, False)]
    release = subprocess.run([_build._nvcc(), "--version"],
                             capture_output=True, text=True,
                             timeout=60).stdout.strip().splitlines()[-1]
    return {"nvcc": release, "instructions": len(body),
            "sha256": hashlib.sha256("\n".join(body).encode()).hexdigest()}


def device_ms(fn, calls: int = 20) -> float:
    """Device time of one call of ``fn``: the self time of every kernel it
    launches, summed, from ``torch.profiler`` over ``calls`` calls (host
    time between launches left out)."""
    fn()
    res = profile_device_time(lambda: [fn() for _ in range(calls)], {})
    return res["device_busy_ms"] / calls


def gpu_clocks() -> str:
    """SM and memory clocks now, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# The main path
# ---------------------------------------------------------------------------

B_MAIN = 8192
B_TWIN_CPU = 2048   # [3]'s twin card-vs-CPU diagnostic, cut from 8192
T_MAIN = 240
T_PROFILE = 48
SYNC_K = 24
SEED = 2222
WORK_DIR = os.path.join(HERE, "build", "chip_smoke")
B_TRAIN = 512       # the recipe's batch (config.TEMPORAL_PARAM)
B_PROFILED = 4096   # the batch the JAX package profiled its step at
# every lane runs max_iter Adam steps a frame (tests/test_torch_pipeline.py)
KNIFE_FREE = dict(stop_eps_pos=0.0, stop_eps_rot=0.0, min_loss_incr=-1e9,
                  max_iter=5)
# at five steps a frame, K2's card-vs-CPU latent distance over that of its
# float32 twin on the card (check_against_cpu)
FIVE_STEPS_FACTOR = 2.0
# the main path's results on this seed with K2 in float32 on CUDA cores;
# K2's 3xTF32 must leave them within 1e-4 m and 1%
MAIN_MPJPE_M = 0.019117
MAIN_MEAN_ITERATIONS = 9.689
# and the mean MPJPE of the first 64 lanes with K1's first, float32 design
# (its chip run in this tree's parent/change comparison), within 1e-4 m: a
# single lane follows the stop rule's knife edges (K1's plain twin with its
# products in 3xTF32 moves lane 0 by 1.1e-4 m, the mean of 64 by 7e-6,
# ``k1_mpjpe_sensitivity``), the mean of many does not
MAIN_MPJPE_LANES = 64
# K2's time at B = 8192, S_dec = 1 as PERF.md §6 records it before the
# realtime slice, printed beside this run's
K2_PERF_MD_MS = 3.56
MAIN_MEAN_MPJPE_M = 0.02056798


def clip_path(seed: int) -> str:
    """Where :func:`load_clip` writes the clip of ``seed``."""
    return os.path.join(WORK_DIR, f"clip_{seed}.bvh")


def load_clip(n_frames: int, seed: int):
    """Write the synthetic clip as BVH, read it back with the port's reader
    and encode it the way ``evaluate_batched`` does."""
    from dragposer_tpu_torch.io.bvh import BVH

    os.makedirs(WORK_DIR, exist_ok=True)
    path = clip_path(seed)
    synthetic_bvh(n_frames, seed).save(path)
    return BVH().load(path)


def lane_batch(engine, bvh, means, stds, B: int, T: int):
    """B lanes × T frames of the clip, lane i starting i frames in
    (wrapping), as ``bench.py`` builds its batch; initial states drawn from
    a seeded ``torch.Generator``."""
    import torch

    from dragposer_tpu_torch import config as cfg
    from dragposer_tpu_torch.data import encoding

    rots, pos, _, offsets, _ = encoding.info_from_bvh(bvh)
    motion = encoding.encode_motion(offsets, pos[:T, 0], rots[:T],
                                    engine.skeleton,
                                    height_indices=cfg.HEIGHT_INDICES)
    norm = encoding.normalize(motion, means, stds)
    dev = engine.device
    idx = ((torch.arange(T)[None, :] + torch.arange(B)[:, None]) % T).to(dev)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    dqs, gp, gr = t(norm.dqs)[idx], t(norm.global_pos)[idx], \
        t(norm.global_rot)[idx]
    h0 = t(motion.heights)[idx[:, 0]]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    states = engine.init_state(gen, dqs[:, 0][:, :, None], gp[:, 0],
                               gr[:, 0], h0)
    return states, dqs, gp, gr


def lane_mpjpe(out, bvh, means, stds, skeleton, T: int, lane: int = 0
               ) -> float:
    """MPJPE of one lane against the clip: lane i starts at frame i and
    wraps at T (``lane_batch``)."""
    from dragposer_tpu_torch import export, metrics

    rec = export.result_to_bvh(out.pose[lane].cpu().numpy(), means, stds,
                               bvh, skeleton,
                               global_pos=out.global_pos[lane].cpu().numpy(),
                               are_root_rot_incr=False)
    gt = copy.deepcopy(bvh)
    frames = (np.arange(T) + lane) % T
    gt.rotations, gt.positions = bvh.rotations[frames], bvh.positions[frames]
    return metrics.positional_error(gt, rec)[0]


def mean_mpjpe(out, bvh, means, stds, skeleton, T: int) -> float:
    """Mean MPJPE of the first ``MAIN_MPJPE_LANES`` lanes."""
    return float(np.mean([lane_mpjpe(out, bvh, means, stds, skeleton, T, i)
                          for i in range(MAIN_MPJPE_LANES)]))


@contextlib.contextmanager
def k2_plain(mm):
    """``temporal_fused.forward`` replaced by its plain twin, its weight
    products formed by ``mm``, inside the block, on whatever device the
    inputs lie (the engine calls it through the module)."""
    from dragposer_tpu_torch.ops import temporal_fused

    forward = temporal_fused.forward
    temporal_fused.forward = (lambda packed, tparam, *args:
                              temporal_fused.forward_plain(packed, *args,
                                                           mm=mm))
    try:
        yield
    finally:
        temporal_fused.forward = forward


@contextlib.contextmanager
def hyper_override(engine, **hyper):
    """``engine.hyper`` under ``hyper`` overrides inside the block."""
    saved = engine.hyper
    engine.hyper = saved._replace(**hyper)
    try:
        yield engine
    finally:
        engine.hyper = saved


def _cpu_output(out):
    from dragposer_tpu_torch.drag import engine as eng

    return eng.FrameOutput(*[x.cpu() for x in out])


def _run_pipelined(engine, args, hyper: dict):
    """``run_batch_pipelined`` under ``hyper`` overrides; outputs on the
    CPU."""
    with hyper_override(engine, **hyper):
        _, o = engine.run_batch_pipelined(*args, sync_k=SYNC_K)
    return _cpu_output(o)


def _card_and_cpu_args(gpu_engine, states, dqs, gp, gr):
    """The same initial states and targets for the card run and the CPU
    run."""
    from dragposer_tpu_torch.drag import engine as eng

    to_gpu = lambda x: x.to(gpu_engine.device)  # noqa: E731
    gstates = eng.DragState(*[to_gpu(x) for x in states])
    return ((gstates, to_gpu(dqs), to_gpu(gp), to_gpu(gr)),
            (states, dqs, gp, gr))


def _latent_err(a, b) -> float:
    return float((a.latent - b.latent).abs().max())


def one_step_lockstep(g, c) -> dict:
    """The card's and the CPU's outputs at one Adam step a frame: equal
    iteration counts, latents to 1e-4, root positions to 1e-5 and
    normalized poses to rtol 1e-3 / atol 2e-3
    (tests/test_torch_pipeline.py's tolerances)."""
    import torch

    res = {"lockstep_iters_equal": bool(torch.equal(g.iterations,
                                                    c.iterations)),
           "lockstep_latent_err": _latent_err(g, c)}
    res["one_step_ok"] = (
        res["lockstep_iters_equal"]
        and res["lockstep_latent_err"] <= 1e-4
        and bool(torch.allclose(g.global_pos, c.global_pos, rtol=0,
                                atol=1e-5))
        and bool(torch.allclose(g.pose, c.pose, rtol=1e-3, atol=2e-3)))
    return res


def check_against_cpu(gpu_engine, cpu_engine, bvh, means, stds, B=8, T=24):
    """The main path on the card (kernels) against the same path on the CPU
    (plain twins), from the same initial states: knife-edge-free lockstep
    (equal iteration counts; values to the tolerance of
    tests/test_torch_pipeline.py) and, under the real stop rule, mean
    iterations within 10%.

    The lockstep takes one Adam step a frame (``max_iter=1``, the JAX
    package's own lockstep mode, tests/test_pipeline.py): a 1e-7..1e-5
    relative change in K2's outputs moves its latents by ~1e-6.  At five
    steps a frame the second and later steps divide small, cancelling
    gradients by their running scale, and a 1e-7 change already moves the
    latents by 3e-5..7e-5 in 24 frames: float32 rounding decides a fixed
    1e-4 there.  So at five steps K2's distance from the CPU may be at most
    ``FIVE_STEPS_FACTOR`` times that of its float32 twin on the card, and
    the twin with its products in one TF32 pass must exceed that, or the
    check cannot tell 3xTF32 from TF32
    (tests/test_torch_lockstep_conditioning.py)."""
    import torch

    from dragposer_tpu_torch.ops import temporal_fused

    gargs, cargs = _card_and_cpu_args(
        gpu_engine, *lane_batch(cpu_engine, bvh, means, stds, B, T))
    run = _run_pipelined
    lockstep = dict(KNIFE_FREE, max_iter=1)
    res = one_step_lockstep(run(gpu_engine, gargs, lockstep),
                            run(cpu_engine, cargs, lockstep))
    one_step_ok = res.pop("one_step_ok")
    c5 = run(cpu_engine, cargs, KNIFE_FREE)
    five = {"K2": _latent_err(run(gpu_engine, gargs, KNIFE_FREE), c5)}
    for name, mm in (("plain", torch.matmul),
                     ("plain_tf32", temporal_fused.matmul_tf32)):
        with k2_plain(mm):
            five[name] = _latent_err(run(gpu_engine, gargs, KNIFE_FREE), c5)
    allowed = FIVE_STEPS_FACTOR * five["plain"]
    res["five_steps_latent_err"] = five
    res["five_steps_ok"] = five["K2"] <= allowed
    res["five_steps_tf32_refused"] = five["plain_tf32"] > allowed
    res["lockstep_ok"] = (one_step_ok and res["five_steps_ok"]
                          and res["five_steps_tf32_refused"])
    mg = float(run(gpu_engine, gargs, {}).iterations.float().mean())
    mc = float(run(cpu_engine, cargs, {}).iterations.float().mean())
    res["stop_rule_mean_iters"] = (mg, mc)
    res["stop_rule_ok"] = abs(mg - mc) <= 0.1 * mc
    return res


@contextlib.contextmanager
def k2_lanes_recorded():
    """While inside, every ``temporal_fused.forward`` call appends its lane
    count (the rollout's batch) to the yielded list."""
    from dragposer_tpu_torch.ops import temporal_fused

    lanes, forward = [], temporal_fused.forward

    def spy(packed, tparam, enc, *rest):
        lanes.append(int(enc.shape[0]))
        return forward(packed, tparam, enc, *rest)

    temporal_fused.forward = spy
    try:
        yield lanes
    finally:
        temporal_fused.forward = forward


def _windowed_setup(config: str, bvh, B: int, T: int):
    """``config``'s engine on the card and on the CPU, and the same initial
    states and targets for both: B lanes × T frames of the clip, lane b at
    window phase ``b % window`` (for a windowed config)."""
    import torch

    from dragposer_tpu_torch.cli.eval_drag import build_engine, resolve_config
    from dragposer_tpu_torch.data import encoding
    from dragposer_tpu_torch.ops.topology import Skeleton

    _, _, parents, offsets, _ = encoding.info_from_bvh(bvh)
    skeleton = Skeleton.build(parents, offsets, bvh.names)
    gpu_engine, means, stds = build_engine(MODEL_DIR, parents,
                                           resolve_config(config),
                                           skeleton=skeleton)
    cpu_engine, _, _ = build_engine(MODEL_DIR, parents,
                                    resolve_config(config),
                                    skeleton=skeleton, device="cpu")
    window = cpu_engine.hyper.temporal_future_window
    states, dqs, gp, gr = lane_batch(cpu_engine, bvh, means, stds, B, T)
    if window:
        states = states._replace(current_index=(
            torch.arange(B, dtype=torch.int32) % window).contiguous())
    return (gpu_engine, cpu_engine,
            *_card_and_cpu_args(gpu_engine, states, dqs, gp, gr))


def windowed_lockstep_sensitivity(config: str, bvh, B: int = 24,
                                  T: int = 24) -> dict:
    """How far float32 rounding alone moves the lockstep of
    :func:`check_windowed_against_cpu` (largest latent distance from the
    CPU run): the card with the kernels, the card with K1's and K2's
    float32 twins, and the CPU run from itself with its initial latents
    scaled by 1 + 1e-7."""
    import torch

    gpu_engine, cpu_engine, gargs, cargs = _windowed_setup(config, bvh, B, T)
    lockstep = dict(KNIFE_FREE, max_iter=1)
    ref = _run_pipelined(cpu_engine, cargs, lockstep)
    res = {"config": config,
           "kernels": _latent_err(_run_pipelined(gpu_engine, gargs,
                                                 lockstep), ref)}
    with k1_plain(), k2_plain(torch.matmul):
        res["float32_twins"] = _latent_err(
            _run_pipelined(gpu_engine, gargs, lockstep), ref)
    states = cargs[0]
    moved = (states._replace(latent=states.latent * (1 + 1e-7)), *cargs[1:])
    res["cpu_latents_scaled_1e-7"] = _latent_err(
        _run_pipelined(cpu_engine, moved, lockstep), ref)
    return res


def check_windowed_against_cpu(config: str, bvh, B: int = 24, T: int = 24
                               ) -> dict:
    """A windowed config (``config`` with a temporal future window: the
    rollout runs only for the lanes at a window boundary, gathered into a
    sub-batch by ``engine._rollout_where_needed``) on the card against the
    same path on the CPU, in lockstep at one Adam step a frame, lane b
    starting at window phase ``b % window`` (as
    tests/test_torch_pipeline.py staggers them), held by the one-step gate
    of :func:`check_against_cpu`.  Every K2 launch of the card run is
    recorded with its lane count: the run must launch K2, run none of its
    plain twin, and roll out at least one sub-batch of fewer than ``B``
    lanes and at most the lanes that ``engine.rollout_lane_budget(B,
    window)`` needing lanes take (:func:`rollout_lanes`)."""
    import collections

    from dragposer_tpu_torch.drag import engine as eng
    from dragposer_tpu_torch.ops import temporal_fused

    gpu_engine, cpu_engine, gargs, cargs = _windowed_setup(config, bvh, B, T)
    window = cpu_engine.hyper.temporal_future_window
    lockstep = dict(KNIFE_FREE, max_iter=1)
    before = (temporal_fused.COUNTS.kernel, temporal_fused.COUNTS.plain)
    with k2_lanes_recorded() as lanes:
        g = _run_pipelined(gpu_engine, gargs, lockstep)
    launches = temporal_fused.COUNTS.kernel - before[0]
    plain = temporal_fused.COUNTS.plain - before[1]
    res = {"config": config, "window": window, "B": B, "T": T,
           **one_step_lockstep(g, _run_pipelined(cpu_engine, cargs,
                                                 lockstep))}
    budget = eng.rollout_lane_budget(B, window)
    res.update({"k2_launches": launches, "k2_plain_on_card": plain,
                "k2_launches_by_lanes": dict(sorted(
                    collections.Counter(lanes).items())),
                "lane_budget": budget,
                "sub_batch_launches": sum(
                    1 for n in lanes
                    if n <= rollout_lanes(gpu_engine, B, budget) and n < B)})
    res["ok"] = (res.pop("one_step_ok") and launches == len(lanes) > 0
                 and plain == 0 and res["sub_batch_launches"] > 0)
    return res


def rollout_lanes(engine, B: int, n: int) -> int:
    """K2's lanes in a rollout of ``n`` needing lanes of ``B`` on
    ``engine`` (``engine._sub_batch``: ``n`` in whole blocks of K2, then
    the batch's partial block; or the whole batch)."""
    import torch

    from dragposer_tpu_torch.drag import engine as eng
    from dragposer_tpu_torch.ops import temporal_fused

    h = engine.hyper
    need = torch.zeros(B, dtype=torch.bool)
    need[:n] = True
    idx = eng._sub_batch(need, n, temporal_fused.lanes_per_block(
        len(h.past_frames) - 1, eng._decoder_steps(h)))
    return B if idx is None else int(idx.numel())


@contextlib.contextmanager
def k1_steps_recorded():
    """While inside, every ``iter_kernel.run_block_fused`` call records its
    lanes' steps (``t`` after minus ``t`` before, on the device, no sync)
    into the yielded list."""
    from dragposer_tpu_torch.drag import iter_kernel

    steps = []
    run = iter_kernel.run_block_fused

    def recording(ctx, kctx, hyper, sync_k, opt, *rest):
        out = run(ctx, kctx, hyper, sync_k, opt, *rest)
        steps.append(out.t - opt.t)
        return out

    iter_kernel.run_block_fused = recording
    try:
        yield steps
    finally:
        iter_kernel.run_block_fused = run


def tile_efficiency(steps, tile: int) -> dict:
    """Lane-steps taken over lane-steps issued when each tile of ``tile``
    consecutive lanes runs to its slowest lane, over the recorded
    launches."""
    import torch

    taken = issued = 0
    for s in steps:
        B = s.shape[0]
        pad = torch.zeros(-B % tile, dtype=s.dtype, device=s.device)
        per_tile = torch.cat((s, pad)).reshape(-1, tile)
        taken += int(s.sum())
        issued += int(per_tile.max(dim=1).values.sum()) * tile
    return {"tile_lanes": tile, "launches": len(steps),
            "lane_steps": taken, "issued_lane_steps": issued,
            "efficiency": taken / issued if issued else None}


def profile_main_path(engine, states, dqs, gp, gr, T: int) -> dict:
    """Where the device time of the main path goes: the first ``T`` frames
    of the same batch under ``torch.profiler``, device time summed by
    kernel (self time, so nothing is counted twice) and the device's idle
    share of the profiled wall time.  The profiler's own overhead inflates
    the wall time, so the idle share is an upper bound.  K1's and K2's
    launches in the window are counted, for device ms per launch."""
    from dragposer_tpu_torch.drag import fast_iter
    from dragposer_tpu_torch.ops import temporal_fused

    counts = {"K1": fast_iter.COUNTS, "K2": temporal_fused.COUNTS}
    for c in counts.values():
        c.reset()
    res = profile_device_time(
        lambda: engine.run_batch_pipelined(states, dqs[:, :T], gp[:, :T],
                                           gr[:, :T], sync_k=SYNC_K),
        {"K1": "iter_block_kernel", "K2": "temporal_forward_kernel"})
    launches = {k: c.kernel for k, c in counts.items()}
    per_launch = {k: res["device_ms"][k] / n if n else None
                  for k, n in launches.items()}
    return {"T": T, **res, "launches": launches,
            "device_ms_per_launch": per_launch}


@contextlib.contextmanager
def k1_plain(mm=None):
    """``iter_kernel.run_block_fused`` replaced by K1's plain twin inside
    the block, its decoder products formed by ``mm(a, b)`` (differentiable)
    if given, else by float32 matmuls."""
    from dragposer_tpu_torch.drag import fast_iter, iter_kernel
    from dragposer_tpu_torch.models import skeleton_nn

    run, forward = iter_kernel.run_block_fused, fast_iter.forward_T

    def twin(ctx, kctx, hyper, sync_k, opt, *rest):
        return fast_iter.run_block(ctx, hyper, sync_k, opt, *rest)

    def forward_mm(ctx, hyper, zT, *rest):
        h = skeleton_nn.leaky_relu(mm(ctx.W1, zT) + ctx.b1)
        h = skeleton_nn.leaky_relu(mm(ctx.W2, h) + ctx.b2)
        h = mm(ctx.W3p, h) + ctx.b3p
        return fast_iter.loss_from_decoded(ctx, hyper, h, zT, *rest)

    iter_kernel.run_block_fused = twin
    if mm is not None:
        fast_iter.forward_T = forward_mm
    try:
        yield
    finally:
        iter_kernel.run_block_fused, fast_iter.forward_T = run, forward


def matmul_3xtf32_grad(a, b):
    """a @ b as 3xTF32 (``temporal_fused.matmul_3xtf32``), its gradients
    formed the same way."""
    import torch

    from dragposer_tpu_torch.ops.temporal_fused import matmul_3xtf32

    class Product(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, y):
            ctx.save_for_backward(x, y)
            return matmul_3xtf32(x, y)

        @staticmethod
        def backward(ctx, g):
            x, y = ctx.saved_tensors
            return matmul_3xtf32(g, y.T), matmul_3xtf32(x.T, g)

    return Product.apply(a, b)


def main_path_results(engine, bvh, means, stds, skeleton, B: int = B_MAIN,
                      T: int = T_MAIN) -> dict:
    """The main path's results: mean iterations, lane 0's MPJPE and the
    mean of the first ``MAIN_MPJPE_LANES`` lanes."""
    import torch

    states, dqs, gp, gr = lane_batch(engine, bvh, means, stds, B, T)
    _, out = engine.run_batch_pipelined(states, dqs, gp, gr, sync_k=SYNC_K)
    torch.cuda.synchronize()
    return {"mean_iterations": float(out.iterations.float().mean()),
            "lane0_mpjpe_m": lane_mpjpe(out, bvh, means, stds, skeleton, T),
            f"mean_mpjpe_m_first_{MAIN_MPJPE_LANES}_lanes": mean_mpjpe(
                out, bvh, means, stds, skeleton, T)}


def k1_mpjpe_sensitivity(engine, bvh, means, stds, skeleton) -> dict:
    """The main path's results with K1, with its plain twin in float32, and
    with the twin's decoder products in 3xTF32: how far a change of K1's
    rounding alone moves lane 0 and the mean of many lanes."""
    res = {"kernel": main_path_results(engine, bvh, means, stds, skeleton)}
    for name, mm in (("twin_float32", None),
                     ("twin_3xtf32", matmul_3xtf32_grad)):
        with k1_plain(mm):
            res[name] = main_path_results(engine, bvh, means, stds, skeleton)
    return res


def k1_figures(B: int = B_MAIN) -> dict:
    """K1's numbers for a parent/change comparison, from whatever
    ``dragposer_tpu_torch`` is first on the path: the card, K1 alone at
    B, sync_k = 24 (``check_k1``), its device ms per launch in the
    profiled first frames of the main path with the 16-lane tile
    efficiency of those launches, and the main path's results."""
    import torch

    from dragposer_tpu_torch.cli.eval_drag import build_engine, resolve_config
    from dragposer_tpu_torch.data import encoding
    from dragposer_tpu_torch.ops.topology import Skeleton

    bvh = load_clip(T_MAIN, SEED)
    _, _, parents, offsets, _ = encoding.info_from_bvh(bvh)
    skeleton = Skeleton.build(parents, offsets, bvh.names)
    engine, means, stds = build_engine(MODEL_DIR, parents,
                                       resolve_config("6_trackers"),
                                       skeleton=skeleton)
    res = {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), "clocks": [gpu_clocks()]}
    res["isolated"] = check_k1(engine, B, SYNC_K)
    states, dqs, gp, gr = lane_batch(engine, bvh, means, stds, B, T_MAIN)
    torch.cuda.synchronize()
    with k1_steps_recorded() as steps:
        prof = profile_main_path(engine, states, dqs, gp, gr, T_PROFILE)
    res["main_path_profile"] = {k: prof[k] for k in (
        "T", "wall_ms", "device_ms", "device_busy_ms", "launches",
        "device_ms_per_launch")}
    res["tile_efficiency"] = tile_efficiency(steps, 16)
    res["main_path"] = main_path_results(engine, bvh, means, stds, skeleton,
                                         B)
    res["clocks"].append(gpu_clocks())
    return res


def k2_figures(B: int = B_MAIN, calls: int = 20) -> dict:
    """K2's numbers for a parent/change comparison, from whatever
    ``dragposer_tpu_torch`` is first on the path: the card, and at the
    main path's shapes (S_enc 14, S_dec 1 and 5, B random lanes) its own
    device time a call (:func:`device_ms`) and CUDA events around a call
    (:func:`cuda_ms`)."""
    import torch

    from dragposer_tpu_torch import config as cfg
    from dragposer_tpu_torch.models import loading
    from dragposer_tpu_torch.ops import temporal_fused

    packed = temporal_fused.pack_params(loading.load_temporal(MODEL_DIR)[0],
                                        cfg.TEMPORAL_PARAM, "cuda")
    res = {"clocks": [gpu_clocks()]}
    for s_dec in (1, 5):
        g = torch.Generator().manual_seed(s_dec)
        enc = torch.randn((B, 14, 33), generator=g).cuda()
        dec = torch.randn((B, s_dec, 24), generator=g).cuda()
        mask = torch.zeros((1, s_dec), device="cuda")

        def run():
            return temporal_fused.forward(packed, cfg.TEMPORAL_PARAM, enc,
                                          dec, mask)

        res[f"S_dec {s_dec}"] = {"device_ms": device_ms(run, calls),
                                 "event_ms": cuda_ms(run, calls)}
    res["clocks"].append(gpu_clocks())
    return res


def k3_figures(calls: int = 20) -> dict:
    """K3a-K3d's numbers for a parent/change comparison, from whatever
    ``dragposer_tpu_torch`` is first on the path: the card; each forward's
    and each backward's own device time per call (every kernel a call
    launches, summed, ``torch.profiler``) and its kernel launches per call,
    at S = 15 × B = 512 and 4096, rate 0.1; then, per layout, one epoch of
    the temporal trainer at dropout 0.1 and the device time per step of 3
    profiled steps by kernel (``profile_training_steps``)."""
    import torch

    res = {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), "clocks": [gpu_clocks()]}
    for layout in ("rows", "lanes"):
        fwd_name, bwd_name = K3_LAYOUTS[layout]["names"]
        for B in (B_TRAIN, B_PROFILED):
            x, w1, b1, w2, b2, gy = k3_inputs(15, B, 4242, layout=layout)
            fwd, bwd = k3_fn(layout, "fwd"), k3_fn(layout, "bwd")
            for name, call in (
                    (fwd_name, lambda: fwd(x, w1, b1, w2, b2, 0.1, 4242)),
                    (bwd_name, lambda: bwd(x, w1, b1, w2, gy, 0.1, 4242))):
                call()
                prof = profile_device_time(
                    lambda: [call() for _ in range(calls)], {})
                res[f"{name}_15x{B}"] = {
                    "device_ms": prof["device_busy_ms"] / calls,
                    "launches_per_call": prof["kernel_launches"] / calls,
                    "event_ms": cuda_ms(call)}
            del x, w1, b1, w2, b2, gy
            torch.cuda.empty_cache()
    res["clocks"].append(gpu_clocks())
    data_dir = write_training_corpus()
    for layout in ("lanes", "rows"):
        run_training(data_dir, 0.1, 1, layout=layout)
        prof = profile_training_steps(data_dir, 0.1, timed_steps=10,
                                      repeats=1, layout=layout)
        n = prof["profiled_steps"]
        res[f"train_{layout}"] = {
            "step_ms": prof["step_ms"],
            "device_ms_per_step": {k: v / n for k, v in
                                   prof["device_ms"].items()},
            "device_busy_ms_per_step": prof["device_busy_ms"] / n,
            "idle_share": prof["idle_share"]}
    res["clocks"].append(gpu_clocks())
    return res


def k4_figures(calls: int = 20) -> dict:
    """K4a/K4b's numbers for a parent/change comparison, from whatever
    ``dragposer_tpu_torch`` is first on the path: the card and its clocks;
    each kernel's own device time per call (every kernel a call launches,
    summed, ``torch.profiler`` over ``calls`` calls) and its kernel launches
    per call at 15 × 15 causal, B = 512 and 4096, CUDA events beside; then
    one epoch of the lanes trainer at dropout 0 and the device time per
    step of 3 profiled steps by kernel (``profile_training_steps``)."""
    import torch

    from dragposer_tpu_torch.ops import attn_fused

    res = {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), "clocks": [gpu_clocks()]}
    for B in (B_TRAIN, B_PROFILED):
        g = torch.Generator().manual_seed(B)
        q, k, v, gy = [torch.randn((15, 4, 12, B), generator=g).cuda()
                       for _ in range(4)]
        mask = k4_mask("causal", 15, 15).cuda()
        for name, call in (
                ("K4a", lambda: attn_fused.forward_kernel(q, k, v, mask)),
                ("K4b", lambda: attn_fused.backward_kernel(q, k, v, mask,
                                                           gy))):
            call()
            prof = profile_device_time(
                lambda: [call() for _ in range(calls)], {})
            res[f"{name}_15x{B}"] = {
                "device_ms": prof["device_busy_ms"] / calls,
                "launches_per_call": prof["kernel_launches"] / calls,
                "event_ms": cuda_ms(call)}
    res["clocks"].append(gpu_clocks())
    data_dir = write_training_corpus()
    run_training(data_dir, 0.0, 1)
    prof = profile_training_steps(data_dir, 0.0, timed_steps=10, repeats=1)
    n = prof["profiled_steps"]
    res["train_lanes_dropout_0"] = {
        "step_ms": prof["step_ms"],
        "device_ms_per_step": {k: v / n for k, v in
                               prof["device_ms"].items()},
        "device_busy_ms_per_step": prof["device_busy_ms"] / n,
        "idle_share": prof["idle_share"]}
    res["clocks"].append(gpu_clocks())
    return res


def profile_device_time(fn, kernels: dict) -> dict:
    """Run ``fn`` once under ``torch.profiler`` and sum the device self time
    by kernel: ``kernels`` maps a name to a substring of the CUDA kernel's
    symbol, or to a tuple of substrings that must all occur (the first
    name that matches takes the kernel), everything else is "other".  The
    idle share is of the profiled wall time, which the profiler's overhead
    inflates: an upper bound."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    groups = dict.fromkeys([*kernels, "other"], 0.0)
    top, launches = [], 0
    for e in prof.key_averages():
        # device-side kernels only: a CPU operator's entry repeats the time
        # of the kernels it launched, and a user annotation on the device
        # timeline (``Optimizer.step#Adam.step``) spans them
        if (e.device_type != DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us <= 0:
            continue
        key = next((k for k, sym in kernels.items()
                    if all(part in e.key for part in (
                        (sym,) if isinstance(sym, str) else sym))), "other")
        groups[key] += us / 1e3
        launches += e.count
        top.append((us / 1e3, e.key[:60]))
    busy = sum(groups.values())
    top.sort(reverse=True)
    return {"wall_ms": wall_ms, "device_ms": groups,
            "device_busy_ms": busy, "kernel_launches": launches,
            "idle_share": (1.0 - busy / wall_ms) if busy else None,
            "top_device_ms": [[round(t, 3), k] for t, k in top[:8]]}


# ---------------------------------------------------------------------------
# The training path
# ---------------------------------------------------------------------------

TRAIN_CLIPS = (16, 1200)     # train clips × frames: ~1,000 windows
EVAL_CLIPS = (2, 480)
TRAIN_EPOCHS = {0.1: 4, 0.0: 2}
TRAIN_DIR = os.path.join(WORK_DIR, "train_data")


def write_training_corpus(root: str = TRAIN_DIR, seed: int = SEED) -> str:
    """Seeded synthetic clips in ``root/train`` and ``root/eval``."""
    for sub, (n, frames), s in (("train", TRAIN_CLIPS, seed),
                                ("eval", EVAL_CLIPS, seed + 100)):
        d = os.path.join(root, sub)
        os.makedirs(d, exist_ok=True)
        write_synthetic_clips(d, (frames,) * n, s)
    return root


def fresh_model_dir(name: str, generator_dir: str = MODEL_DIR) -> str:
    """A model directory holding a copy of a generator (by default the
    example's)."""
    import shutil

    d = os.path.join(WORK_DIR, name)
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    for f in ("generator.npz", "parameters.json"):
        shutil.copy(os.path.join(generator_dir, f), d)
    return d


def training_counts():
    from dragposer_tpu_torch.ops import attn_fused, ff_fused

    return {"K3a": ff_fused.COUNTS_FWD_ROWS, "K3b": ff_fused.COUNTS_BWD_ROWS,
            "K3c": ff_fused.COUNTS_FWD, "K3d": ff_fused.COUNTS_BWD,
            "K4a": attn_fused.COUNTS_FWD, "K4b": attn_fused.COUNTS_BWD}


def training_kernels(layout: str) -> dict:
    """Profile groups of a training step's kernels (see
    :func:`profile_device_time`)."""
    lay = K3_LAYOUTS[layout]
    fwd, bwd = lay["names"]
    groups = {fwd: ("ff_fwd_", lay["symbol"]), bwd: ("ff_bwd_", lay["symbol"])}
    if layout == "lanes":
        groups.update({"K4a": "attn_fwd_kernel", "K4b": "attn_bwd_kernel"})
    return groups


def train_model_dir(layout: str, rate: float) -> str:
    return os.path.join(WORK_DIR, f"train_model_{layout}_{rate}")


def run_training(data_dir: str, rate: float, epochs: int, device="cuda",
                 layout: str = "lanes",
                 generator_dir: str = MODEL_DIR) -> dict:
    """The port's trainer on the card at the recipe's width and batch
    (d 48, 4 heads, FF 2048, 3+3 layers, B 512) at dropout ``rate`` in
    ``layout``, on the latents of the generator in ``generator_dir``, with
    every launch count set to 0 just before and read just after."""
    import torch

    from dragposer_tpu_torch import config as cfg
    from dragposer_tpu_torch.models import loading
    from dragposer_tpu_torch.train import temporal as train_temporal

    model_dir = fresh_model_dir(os.path.basename(train_model_dir(layout,
                                                                 rate)),
                                generator_dir)
    param = dict(cfg.TEMPORAL_PARAM, dropout=rate)
    counts = training_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    for c in counts.values():
        c.reset()
    clocks = [gpu_clocks()]
    t0 = time.time()
    out = train_temporal.train(data_dir, model_dir, param, epochs=epochs,
                               log=lambda s: None, device=device,
                               layout=layout)
    torch.cuda.synchronize()
    seconds = time.time() - t0
    clocks.append(gpu_clocks())
    launches = {k: c.kernel for k, c in counts.items()}
    launches.update({f"{k}_plain": c.plain for k, c in counts.items()})
    hist = out["history"]
    steady = hist[1:] or hist
    steps = sum(h["steps"] for h in steady)
    windows = sum(h["windows"] for h in steady)
    step_s = sum(h["train_seconds"] for h in steady)
    loaded = loading.load_temporal(model_dir)
    res = {"layout": layout, "dropout": rate, "epochs": epochs,
           "batch": windows // steps,
           "seconds": seconds, "launches": launches,
           "steps_per_s": steps / step_s, "windows_per_s": windows / step_s,
           "per_epoch": [{k: h[k] for k in ("epoch", "steps", "train_loss",
                                            "eval_loss", "train_seconds")}
                         for h in hist],
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           # the run's own: the peak above what earlier phases still hold
           "run_peak_mem_gb": (torch.cuda.max_memory_allocated() - held) / 1e9,
           "clocks_sm_mem": clocks,
           "checkpoint_loads": loaded is not None}
    res["ok_finite"] = all(np.isfinite([h["train_loss"], h["eval_loss"]]).all()
                           for h in hist)
    if loaded is not None:
        params, ml, sl = loaded
        res["checkpoint_loads"] = (
            params["enc_layers"][0]["ff1"]["w"].shape == (2048, 48)
            and ml.shape == (24,) and bool(np.all(sl > 0)))
    return res


def profile_training_steps(data_dir: str, rate: float, steps: int = 3,
                           timed_steps: int = 50, repeats: int = 3,
                           device="cuda", layout: str = "lanes") -> dict:
    """The trainer's own step (batch gather included) at the recipe's
    batch, from the checkpoint that :func:`run_training` wrote at this
    ``rate``: after one warm-up step, ``repeats`` runs of ``timed_steps``
    steps each, timed on the host clock and ended by a synchronize
    (``step_ms`` per run; the steady-state rate is from their median),
    then ``steps`` steps under ``torch.profiler`` for where the device time
    goes."""
    import torch

    from dragposer_tpu_torch import config as cfg
    from dragposer_tpu_torch.data import datasets
    from dragposer_tpu_torch.models import loading, vae
    from dragposer_tpu_torch.models import temporal as tmodel
    from dragposer_tpu_torch.train import temporal as train_temporal

    model_dir = train_model_dir(layout, rate)
    param = dict(cfg.TEMPORAL_PARAM, dropout=rate)
    gen_params, means, stds = loading.load_generator(model_dir)
    vae_params = loading.tree_to_torch(gen_params, device)
    statics = vae.build_statics(EXAMPLE_PARENTS, cfg.VAE_PARAM)
    data = train_temporal.stage_dataset(datasets.TemporalTrainData(
        **datasets.try_load_cache(datasets.cache_path(data_dir, True))),
        device)
    tp, ml, sl = loading.load_temporal(model_dir)
    tparams = tmodel.trainable(tp, device)
    step = train_temporal.make_train_step(
        vae_params, statics, param,
        train_temporal.make_optimizer(tparams, param), layout)
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32,  # noqa: E731
                                  device=device)
    stats = [t(means["dqs"]), t(stds["dqs"]), t(ml), t(sl)]
    host_gen = torch.Generator().manual_seed(SEED)
    dev_gen = torch.Generator(device=device).manual_seed(SEED)
    idx = torch.arange(param["batch_size"], device=device)

    def run(n):
        for _ in range(n):
            step(tparams, host_gen, dev_gen,
                 *(a.index_select(0, idx) for a in (
                     data.dqs_past, data.dqs_future, data.disp_past_acc,
                     data.heights)), *stats)

    run(1)
    step_ms = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.time()
        run(timed_steps)
        torch.cuda.synchronize()
        step_ms.append((time.time() - t0) * 1e3 / timed_steps)
    median = float(np.median(step_ms))
    res = profile_device_time(lambda: run(steps), training_kernels(layout))
    return {"layout": layout, "dropout": rate, "batch": param["batch_size"],
            "timed_steps": timed_steps, "step_ms": step_ms,
            "steps_per_s": 1e3 / median,
            "windows_per_s": param["batch_size"] * 1e3 / median,
            "profiled_steps": steps, **res}


# Card vs CPU training step: each gradient leaf to this relative L2 error.
# The step's ReLU gates are the card kernel's on both sides (see
# train_step_card_vs_cpu), so what is left is float32 rounding.
GRAD_L2_TOL = 1e-5


@contextlib.contextmanager
def _swapped(module, **attrs):
    """Replace attributes of ``module`` for the duration of a block."""
    old = {k: getattr(module, k) for k in attrs}
    for k, v in attrs.items():
        setattr(module, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(module, k, v)


def _bf16(t):
    import torch

    return t.to(torch.bfloat16).to(torch.float32)


def _step_leaves(init, param, dev, batch, seeds, layout: str = "lanes"):
    """One training step from ``init`` on ``dev``: (loss, {path: (updated
    parameter, gradient)}), both on the CPU."""
    from dragposer_tpu_torch.models import temporal as tmodel
    from dragposer_tpu_torch.train import temporal as train_temporal

    tp = tmodel.trainable(init, dev)
    opt = train_temporal.make_optimizer(tp, param)
    loss = train_temporal.apply_step(tp, opt, param,
                                     *(a.to(dev) for a in batch), seeds,
                                     layout)
    return float(loss), {p: (x.detach().cpu(), x.grad.cpu())
                         for p, x in tmodel.named_leaves(tp)}


def _k3_site_input(x, layout: str):
    """A feed-forward site's input as its kernel takes it: (S, D, B), or
    the (..., D) rows flattened to (M, D)."""
    return x if layout == "lanes" else x.reshape(-1, x.shape[-1])


def _card_step(init, param, batch, seeds, control: bool = False,
               layout: str = "lanes"):
    """The step on the card, and the ReLU gate ((S, F, B) or (M, F)) of
    each feed-forward site as the kernel computed it, read back through the
    forward kernel from the recorded inputs.  ``control`` launches the
    kernels on operands rounded to bfloat16."""
    from dragposer_tpu_torch.ops import ff_fused

    lay = K3_LAYOUTS[layout]
    sites = []
    ff, fwd, bwd = (k3_fn(layout, "entry"), k3_fn(layout, "fwd"),
                    k3_fn(layout, "bwd"))
    rnd = _bf16 if control else (lambda t: t)

    def record(x, ff1, ff2, rate, seed):
        sites.append([t.detach().clone() for t in (
            _k3_site_input(x, layout), ff1["w"], ff1["b"])])
        return ff(x, ff1, ff2, rate, seed)

    swaps = {lay["entry"]: record}
    if control:
        swaps[lay["fwd"]] = lambda x, w1, b1, w2, b2, r, s: fwd(
            rnd(x), rnd(w1), b1, rnd(w2), b2, r, s)
        swaps[lay["bwd"]] = lambda x, w1, b1, w2, g, r, s: bwd(
            rnd(x), rnd(w1), b1, rnd(w2), rnd(g), r, s)
    with _swapped(ff_fused, **swaps):
        step = _step_leaves(init, param, "cuda", batch, seeds, layout)
    gates = [k3_hidden_from_kernel(rnd(x), rnd(w1), b1, 0.0, 0,
                                   layout).cpu() > 0
             for x, w1, b1 in sites]
    return step, gates


def _cpu_step(init, param, batch, seeds, gates=None, layout: str = "lanes"):
    """The step on the CPU (plain twins).  With ``gates``, each
    feed-forward site is its plain function with the given ReLU gate in
    place of its own; the number of gate entries that differ from its own
    is returned beside."""
    import torch

    from dragposer_tpu_torch.ops import ff_fused, hash_dropout

    if gates is None:
        return _step_leaves(init, param, "cpu", batch, seeds, layout), None
    todo, flips = iter(gates), []

    def gated(x, ff1, ff2, rate, seed):
        gate = next(todo)
        if layout == "lanes":
            pre = torch.einsum("fd,sdb->sfb", ff1["w"], x) \
                + ff1["b"][None, :, None]
        else:
            pre = _k3_site_input(x, layout) @ ff1["w"].T + ff1["b"]
        flips.append(int(((pre > 0) != gate).sum()))
        h = pre * gate
        if rate > 0:
            keep = (ff_fused.keep_mask_lanes(*pre.shape, rate, seed)
                    if layout == "lanes" else
                    ff_fused.keep_mask_rows(*pre.shape, rate, seed))
            h = torch.where(keep, h * hash_dropout.keep_scale(rate),
                            torch.zeros(()))
        if layout == "lanes":
            return torch.einsum("df,sfb->sdb", ff2["w"], h) \
                + ff2["b"][None, :, None]
        return (h @ ff2["w"].T + ff2["b"]).reshape(x.shape)

    with _swapped(ff_fused, **{K3_LAYOUTS[layout]["entry"]: gated}):
        step = _step_leaves(init, param, "cpu", batch, seeds, layout)
    return step, flips


def _step_agreement(card, cpu, grad_tol: float = GRAD_L2_TOL) -> dict:
    """Loss, gradients leaf by leaf in the L2 norm, and updated
    parameters of two runs of one step.  The gradient's floor, 1e-6 of the
    model's largest gradient per entry, covers the key projection's bias,
    whose gradient is 0 in exact arithmetic (softmax ignores a shift
    shared by a row).  Adam's first step moves a parameter by about ±lr
    whatever its gradient's size, so parameters whose gradient is near
    eps may differ by more than rounding: at most 0.1% beyond 1e-5."""
    import torch

    (lg, pg), (lc, pc) = card, cpu
    gmax = max(float(pc[p][1].abs().max()) for p in pc)
    rel = {p: float(torch.linalg.vector_norm(pg[p][1] - pc[p][1])
                    / (torch.linalg.vector_norm(pc[p][1])
                       + 1e-6 * gmax * pc[p][1].numel() ** 0.5))
           for p in pc}
    worst = max(rel, key=rel.get)
    diffs = torch.cat([(pg[p][0] - pc[p][0]).abs().flatten() for p in pc])
    res = {"loss_card": lg, "loss_cpu": lc,
           "grad_rel_l2_err": rel[worst], "worst_grad_leaf": worst,
           "param_max_abs_err": float(diffs.max()),
           "params_over_1e-5": int((diffs > 1e-5).sum()),
           "n_params": int(diffs.numel())}
    res["ok"] = (abs(lg - lc) <= 1e-5 * abs(lc)
                 and rel[worst] <= grad_tol
                 and res["params_over_1e-5"] <= diffs.numel() // 1000)
    return res


def train_step_card_vs_cpu(data_dir: str, rate: float, B: int = 16,
                           layout: str = "lanes",
                           generator_dir: str = MODEL_DIR) -> dict:
    """One training step (loss, gradients, Adam update) in ``layout`` on
    the card with the kernels against the same step on the CPU with the
    plain twins, from the same init, latents, batch and dropout seeds.

    The activations reaching K3 differ between the devices in their last
    bits, so a ReLU gate whose pre-activation lies within rounding of 0 can
    open on one device and not on the other.  One such flip moves one
    entry of db1 by a whole column's term (~1/√(S·B·F/2) of the leaf) and
    the column's dx, and through it every earlier leaf.  So the held
    comparison gives the CPU the card kernel's gates: what is left is
    float32 rounding, held to ``GRAD_L2_TOL``.  Beside it: the flips per
    K3 site; the CPU with its own gates, which must agree as well when no
    gate flipped; and a control, K3 on bfloat16 operands, which the same
    check must refuse."""
    import torch

    from dragposer_tpu_torch import config as cfg
    from dragposer_tpu_torch.data import datasets
    from dragposer_tpu_torch.models import loading
    from dragposer_tpu_torch.models import temporal as tmodel
    from dragposer_tpu_torch.models import vae
    from dragposer_tpu_torch.ops import hash_dropout
    from dragposer_tpu_torch.train import temporal as train_temporal

    param = dict(cfg.TEMPORAL_PARAM, dropout=rate)
    gen_params, means, stds = loading.load_generator(generator_dir)
    cached = datasets.try_load_cache(datasets.cache_path(data_dir, True))
    if cached is not None:
        data = datasets.TemporalTrainData(**cached)
    else:
        motions, _, _ = datasets.load_motion_dir(
            os.path.join(data_dir, "train"), param,
            height_indices=param["height_indices"])
        data = datasets.build_temporal_dataset(motions, param, means, stds)
    statics = vae.build_statics(EXAMPLE_PARENTS, cfg.VAE_PARAM)
    vae_cpu = loading.tree_to_torch(gen_params, "cpu")
    g = torch.Generator().manual_seed(SEED)
    with torch.no_grad():
        both = train_temporal._encode_windows(
            vae_cpu, statics, g, torch.as_tensor(np.concatenate(
                (data.dqs_past[:B], data.dqs_future[:B]), axis=1)))
    lat, lat_f = both[:, :15], both[:, 15:]
    disp, hts = (torch.as_tensor(a[:B]) for a in (data.disp_past_acc,
                                                  data.heights))
    ml = lat.reshape(-1, 24).mean(0)
    sl = lat.reshape(-1, 24).std(0)
    seeds = hash_dropout.seeds_for(g, train_temporal.N_SEEDS)
    init = tmodel.init_params(torch.Generator().manual_seed(SEED), param)
    batch = (lat, lat_f, disp, hts, ml, sl)
    brief = ("loss_card", "loss_cpu", "grad_rel_l2_err", "worst_grad_leaf",
             "ok")

    card, gates = _card_step(init, param, batch, seeds, layout=layout)
    synced, flips = _cpu_step(init, param, batch, seeds, gates, layout)
    own, _ = _cpu_step(init, param, batch, seeds, layout=layout)
    control, control_gates = _card_step(init, param, batch, seeds,
                                        control=True, layout=layout)
    control_ref, _ = _cpu_step(init, param, batch, seeds, control_gates,
                               layout)
    res = {"layout": layout, "dropout": rate, "B": B,
           "grad_l2_tol": GRAD_L2_TOL,
           **_step_agreement(card, synced), "gate_flips_per_k3_site": flips}
    own_res = _step_agreement(card, own)
    res["own_gates"] = {k: own_res[k] for k in brief}
    ctrl = _step_agreement(control, control_ref)
    res["bf16_control"] = {k: ctrl[k] for k in brief}
    res["ok"] = (res["ok"] and (own_res["ok"] or sum(flips) > 0)
                 and not ctrl["ok"])
    return res


# ---------------------------------------------------------------------------
# The VAE trainer, and the models it makes driven end to end
# ---------------------------------------------------------------------------

VAE_EPOCHS = 1
# Card vs CPU VAE step: each gradient leaf to this relative L2 error (the
# second-order consecutive term goes through the decoder and FK twice).
VAE_GRAD_L2_TOL = 1e-4
VAE_DATA_DIR = os.path.join(WORK_DIR, "vae_data")


def vae_corpus(root: str = VAE_DATA_DIR, corpus: str = TRAIN_DIR) -> str:
    """A data directory whose train/ and eval/ are the training corpus's
    (links), so that the caches of the freshly trained generator's
    windows stay apart from the example generator's."""
    import shutil

    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    for sub in ("train", "eval"):
        os.symlink(os.path.join(corpus, sub), os.path.join(root, sub),
                   target_is_directory=True)
    return root


def run_vae_training(data_dir: str, epochs: int = VAE_EPOCHS,
                     device="cuda") -> dict:
    """The port's VAE trainer on the card with the recipe
    (``config.VAE_PARAM``: batch 64 pairs, AdamW 1e-4, FK loss) for
    ``epochs`` over the corpus; its model directory is ``vae_model``."""
    import shutil

    import torch

    from dragposer_tpu_torch import config as cfg
    from dragposer_tpu_torch.models import loading
    from dragposer_tpu_torch.train import vae as train_vae

    model_dir = os.path.join(WORK_DIR, "vae_model")
    shutil.rmtree(model_dir, ignore_errors=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    clocks = [gpu_clocks()]
    t0 = time.time()
    out = train_vae.train(data_dir, model_dir, use_fk=True, epochs=epochs,
                          log=lambda s: None, device=device)
    torch.cuda.synchronize()
    seconds = time.time() - t0
    clocks.append(gpu_clocks())
    hist = out["history"]
    pairs = sum(h["pairs"] for h in hist)
    steps = sum(h["steps"] for h in hist)
    step_s = sum(h["train_seconds"] for h in hist)
    last = hist[-1]
    res = {"epochs": epochs, "batch": cfg.VAE_PARAM["batch_size"],
           "pairs": pairs, "steps": steps, "seconds": seconds,
           "pairs_per_s": pairs / step_s, "steps_per_s": steps / step_s,
           "train_loss": last["train_loss"], "terms": last["terms"],
           "mpjpe_m": last["mpjpe"], "mpeepe_m": last["mpeepe"],
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           # the run's own: the peak above what earlier phases still hold
           "run_peak_mem_gb": (torch.cuda.max_memory_allocated() - held) / 1e9,
           "clocks_sm_mem": clocks, "model_dir": model_dir}
    res["ok_finite"] = bool(np.isfinite(
        [last["train_loss"], last["mpjpe"], last["mpeepe"],
         *last["terms"].values()]).all())
    params, means, stds = loading.load_generator(model_dir)
    res["checkpoint_loads"] = (
        params["decoder"]["convs"][2]["w"].shape == (92, 92, 1)
        and means["dqs"].shape == (176,) and bool(np.all(stds["dqs"] > 0))
        and os.path.exists(os.path.join(model_dir, "parameters.json")))
    return res


def profile_vae_steps(data_dir: str, model_dir: str, steps: int = 3,
                      timed_steps: int = 50, device="cuda") -> dict:
    """The VAE trainer's own step (pair gather included) at the recipe's
    batch, from the generator that :func:`run_vae_training` wrote: after
    one warm-up step, ``timed_steps`` steps on the host clock ended by a
    synchronize, then ``steps`` steps under ``torch.profiler``."""
    import torch

    from dragposer_tpu_torch import config as cfg
    from dragposer_tpu_torch.data import datasets
    from dragposer_tpu_torch.models import loading, vae
    from dragposer_tpu_torch.models import temporal as tmodel
    from dragposer_tpu_torch.ops.topology import Skeleton
    from dragposer_tpu_torch.train import vae as train_vae

    param = cfg.VAE_PARAM
    params, means, stds = loading.load_generator(model_dir)
    cached = datasets.try_load_cache(datasets.cache_path(data_dir, False))
    skeleton = Skeleton.build(EXAMPLE_PARENTS, cached["offsets"])
    statics = vae.statics_on(vae.build_statics(EXAMPLE_PARENTS, param),
                             device)
    tp = tmodel.trainable(params, device)
    step = train_vae.make_train_step(statics, skeleton, param, True,
                                     train_vae.make_optimizer(tp, param))
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    windows = t(cached["dqs"]), t(cached["displacement"])
    stats = t(means["dqs"]), t(stds["dqs"])
    gen = torch.Generator(device=device).manual_seed(SEED)
    idx = torch.arange(param["batch_size"], device=device)

    def run(n):
        for _ in range(n):
            step(tp, gen, *train_vae.pair_batch(*windows, idx), *stats)

    run(1)
    torch.cuda.synchronize()
    t0 = time.time()
    run(timed_steps)
    torch.cuda.synchronize()
    step_ms = (time.time() - t0) * 1e3 / timed_steps
    return {"batch": param["batch_size"], "timed_steps": timed_steps,
            "step_ms": step_ms,
            "pairs_per_s": param["batch_size"] * 1e3 / step_ms,
            "profiled_steps": steps,
            **profile_device_time(lambda: run(steps), {})}


def vae_step_card_vs_cpu(data_dir: str, model_dir: str = MODEL_DIR,
                         B: int = 64) -> dict:
    """One VAE training step (six-term loss with the grad-of-grad
    consecutive term, backward, clip, AdamW) on the card against the same
    step on the CPU: the generator of ``model_dir``, the first B window
    pairs of the corpus normalized with its statistics, one
    reparameterization draw.  Held as the temporal step is
    (:func:`_step_agreement`), gradients to ``VAE_GRAD_L2_TOL``.

    The default is the example generator, whose statistics come from
    mocap.  The synthetic corpus's own root-rotation channel is nearly
    constant (w's std 2.9e-6), so one float32 ulp of a unit quaternion's w
    moves its normalized value by 0.02 and the two devices' rounding alone
    moves the loss by ~2e-5 of itself."""
    import torch

    from dragposer_tpu_torch import config as cfg
    from dragposer_tpu_torch.data import datasets
    from dragposer_tpu_torch.models import loading, vae
    from dragposer_tpu_torch.models import temporal as tmodel
    from dragposer_tpu_torch.ops.topology import Skeleton
    from dragposer_tpu_torch.train import vae as train_vae

    param = cfg.VAE_PARAM
    params, means, stds = loading.load_generator(model_dir)
    cached = datasets.try_load_cache(datasets.cache_path(data_dir, False))
    skeleton = Skeleton.build(EXAMPLE_PARENTS, cached["offsets"])
    statics = vae.build_statics(EXAMPLE_PARENTS, param)

    def renormalized(field, key):
        raw = (cached[field][:B + 1] * cached[f"stds_{key}"]
               + cached[f"means_{key}"])
        return torch.as_tensor(((raw - means[key]) / stds[key])
                               .astype(np.float32))

    dqs, disp = train_vae.pair_batch(renormalized("dqs", "dqs"),
                                     renormalized("displacement",
                                                  "displacement"),
                                     torch.arange(B))
    noise = torch.randn((2 * B, param["latent_dim"]),
                        generator=torch.Generator().manual_seed(SEED))
    stats = [torch.as_tensor(means["dqs"]), torch.as_tensor(stds["dqs"])]

    def step_on(dev):
        tp = tmodel.trainable(params, dev)
        opt = train_vae.make_optimizer(tp, param)
        step = train_vae.make_train_step(vae.statics_on(statics, dev),
                                         skeleton, param, True, opt)
        total, _ = step(tp, None, dqs.to(dev), disp.to(dev),
                        *(a.to(dev) for a in (*stats, noise)))
        return float(total), {p: (x.detach().cpu(), x.grad.cpu())
                              for p, x in tmodel.named_leaves(tp)}

    return {"B": B, "generator": os.path.basename(model_dir),
            "grad_l2_tol": VAE_GRAD_L2_TOL,
            **_step_agreement(step_on("cuda"), step_on("cpu"),
                              VAE_GRAD_L2_TOL)}


def close_the_loop(model_dir: str, bvh, B: int = 64, T: int = 48) -> dict:
    """``cli.eval_drag.build_engine`` on ``model_dir`` (the freshly trained
    generator and rows-trained temporal predictor), then B lanes × T frames
    of the synthetic clip through ``run_batch_pipelined``, launch counts
    set to 0 just before and read just after."""
    import torch

    from dragposer_tpu_torch.cli.eval_drag import build_engine, resolve_config
    from dragposer_tpu_torch.data import encoding
    from dragposer_tpu_torch.drag import fast_iter
    from dragposer_tpu_torch.ops import temporal_fused
    from dragposer_tpu_torch.ops.topology import Skeleton

    _, _, parents, offsets, _ = encoding.info_from_bvh(bvh)
    skeleton = Skeleton.build(parents, offsets, bvh.names)
    engine, means, stds = build_engine(model_dir, parents,
                                       resolve_config("6_trackers"),
                                       skeleton=skeleton)
    states, dqs, gp, gr = lane_batch(engine, bvh, means, stds, B, T)
    torch.cuda.synchronize()
    for c in (fast_iter.COUNTS, temporal_fused.COUNTS):
        c.reset()
    t0 = time.time()
    _, out = engine.run_batch_pipelined(states, dqs, gp, gr, sync_k=SYNC_K)
    torch.cuda.synchronize()
    seconds = time.time() - t0
    launches = {"K1": fast_iter.COUNTS.kernel,
                "K2": temporal_fused.COUNTS.kernel,
                "K1_plain": fast_iter.COUNTS.plain,
                "K2_plain": temporal_fused.COUNTS.plain}
    finite = (tuple(out.pose.shape) == (B, T, 88)
              and bool(torch.isfinite(out.pose).all())
              and bool(torch.isfinite(out.global_pos).all()))
    return {"B": B, "T": T, "seconds": seconds, "launches": launches,
            "mean_iterations": float(out.iterations.float().mean()),
            "lane0_mpjpe_m": lane_mpjpe(out, bvh, means, stds, skeleton, T),
            "ok": (finite and launches["K1"] > 0 and launches["K2"] > 0
                   and not launches["K1_plain"]
                   and not launches["K2_plain"])}


def train_and_check(phase: str, data_dir: str, layout: str,
                    generator_dir: str = MODEL_DIR) -> dict:
    """The trainer in ``layout`` at each dropout of ``TRAIN_EPOCHS``, its
    launch counts held to the path's kernels (the other layout's and every
    plain count 0; K4 at dropout 0 only, the JAX package's rule), then the
    step alone timed and profiled.  Returns the runs by dropout."""
    runs = {}
    mine = K3_LAYOUTS[layout]["names"]
    other = K3_LAYOUTS["rows" if layout == "lanes" else "lanes"]["names"]
    for rate, epochs in TRAIN_EPOCHS.items():
        r = run_training(data_dir, rate, epochs, layout=layout,
                         generator_dir=generator_dir)
        runs[rate] = r
        print(f"{phase} training path, {layout} layout, dropout {rate}: "
              + json.dumps(r), flush=True)
        n = r["launches"]
        fused_attn = layout == "lanes" and rate == 0.0
        if not all(n[k] > 0 for k in mine) or any(n[k] for k in other):
            fail(f"the {layout} feed-forward kernels did not carry the "
                 f"training run: {n}")
        if (n["K4a"] > 0) != fused_attn or (n["K4b"] > 0) != fused_attn:
            fail(f"K4 launches break the dropout rule: {n}")
        if any(v for k, v in n.items() if k.endswith("_plain")):
            fail(f"a plain twin ran on the training path: {n}")
        if not (r["ok_finite"] and r["checkpoint_loads"]):
            fail(f"training run failed its checks: {r}")
        clocks = gpu_clocks()
        prof = profile_training_steps(data_dir, rate, layout=layout)
        prof["clocks_sm_mem"] = [clocks, gpu_clocks()]
        print(f"{phase} training step alone and its device time by kernel "
              f"(torch.profiler), {layout} layout, dropout {rate}: "
              + json.dumps(prof), flush=True)
    return runs


def step_card_vs_cpu(phase: str, data_dir: str, rate: float, B: int,
                     layout: str, generator_dir: str = MODEL_DIR) -> None:
    r = train_step_card_vs_cpu(data_dir, rate, B, layout, generator_dir)
    print(f"{phase} training step on the card vs on the CPU: "
          + json.dumps(r), flush=True)
    if not r["ok"]:
        fail(f"the card's training step disagrees with the CPU's: {r}")


def gate_probe(phase: str, layout: str) -> None:
    for rate in (0.1, 0.0):
        r = k3_gate_probe(layout, rate)
        print(f"{phase} gate probe, backward against forward: "
              + json.dumps(r), flush=True)
        if not r["ok"]:
            fail(f"the backward's ReLU gates differ from the forward's: {r}")


def k3_entries(r: dict, fwd_name: str, bwd_name: str, source: str,
               replaces, launches) -> list:
    """The ``kernels`` entries of a feed-forward pair from its check: ``ms``
    is each kernel's own device time a call (every launch of the call
    summed), ``event_ms`` CUDA events around the wrapper."""
    return [
        {"name": fwd_name, "route": "cuda", "source": source,
         "replaces": replaces[0], "launches": launches[0],
         "max_abs_err": r["max_abs_err"]["y"], "ms": r["fwd_device_ms"],
         "plain_ms": r["fwd_plain_ms"], "bound_ms": r["fwd_bound_ms"],
         "bound_by": r["fwd_bound_by"], "library_ms": None,
         "event_ms": r["fwd_ms"],
         "bound_f32_cuda_core_ms": r["fwd_bound_f32_cuda_core_ms"]},
        {"name": bwd_name, "route": "cuda", "source": source,
         "replaces": replaces[1], "launches": launches[1],
         "max_abs_err": max(v for k, v in r["max_abs_err"].items()
                            if k != "y"),
         "ms": r["bwd_device_ms"], "plain_ms": r["bwd_plain_ms"],
         "bound_ms": r["bwd_bound_ms"], "bound_by": r["bwd_bound_by"],
         "library_ms": None, "event_ms": r["bwd_ms"],
         "bound_f32_cuda_core_ms": r["bwd_bound_f32_cuda_core_ms"]}]


# ---------------------------------------------------------------------------
# The anchor path: engine.run / run_batch, and the offline CLI
# ---------------------------------------------------------------------------

T_ANCHOR = 48           # frames of the card-against-CPU anchor runs
B_ANCHOR, T_ANCHOR_B = 8, 24    # the anchor against the pipelined path
# At the full max_iter the anchor (autograd Adam, K2 rollout) and the
# pipelined path (K1 + K2) agree by statistics only.  JAX's anchor against
# JAX's pipeline on these inputs (8 lanes x 24 frames of the main clip, the
# port's initial states carried over, on the CPU) read mean iterations
# 21.880 / 21.932 (0.24% apart) and mean MPJPE 0.0219117 / 0.0219104 m
# (1.4e-6 apart); the bounds leave room for the card's rounding.
ANCHOR_ITER_REL = 0.02
ANCHOR_MPJPE_M = 2e-4
T_CLI = 64              # frames of the CLI runs' clips
# the beam run's --restarts, --survivors, --branch-every, --max-frames: the
# 3-tracker config's 64 lanes, 8 survivors and 512 frames cut for time (its
# ratio of lanes to survivors kept), on the clip's first 32 frames (a
# 3-tracker frame costs its slowest lane's ~50-100 Adam iterations)
CLI_BEAM = ("8", "1", "16", "32")


def kernel_counts() -> dict:
    """K1's and K2's launch counts and their plain twins' calls (what the
    daemon's ``OP_STATS`` reports as "kernels")."""
    from dragposer_tpu_torch import _build

    return _build.kernel_launches()


def reset_kernel_counts() -> None:
    from dragposer_tpu_torch.drag import fast_iter, iter_kernel
    from dragposer_tpu_torch.ops import temporal_fused

    fast_iter.COUNTS.reset()
    iter_kernel.GENERAL_COUNTS.reset()
    for c in iter_kernel.LAYOUT_COUNTS.values():
        c.reset()
    temporal_fused.COUNTS.reset()


def anchor_card_vs_cpu(config: str, bvh, T: int = T_ANCHOR) -> dict:
    """``DragEngine.run`` (the per-lane anchor: autograd Adam, K2 rollout
    with the visibility mask) on the card against the same on the CPU,
    one lane × T frames of the clip from the same initial state, in
    lockstep at one Adam step a frame, held by :func:`one_step_lockstep`.
    The card run must launch K2, run no plain K2 call and launch no K1."""
    import collections

    import torch

    from dragposer_tpu_torch.drag import engine as eng

    t_setup = time.time()
    gpu_engine, cpu_engine, gargs, cargs = _windowed_setup(config, bvh, 1, T)
    lane = lambda args: (eng.DragState(*[x[0] for x in args[0]]),  # noqa: E731
                         *[a[0] for a in args[1:]])
    lockstep = dict(KNIFE_FREE, max_iter=1)
    torch.cuda.synchronize()
    reset_kernel_counts()
    t0 = time.time()
    with hyper_override(gpu_engine, **lockstep), \
            k2_lanes_recorded() as lanes:
        _, g = gpu_engine.run(*lane(gargs))
        torch.cuda.synchronize()
    card_s = time.time() - t0
    counts = kernel_counts()
    t0 = time.time()
    with hyper_override(cpu_engine, **lockstep):
        _, c = cpu_engine.run(*lane(cargs))
    res = {"config": config, "lanes": 1, "T": T, "card_s": card_s,
           "phase_s": time.time() - t_setup,
           "cpu_s": time.time() - t0,
           **one_step_lockstep(_cpu_output(g), c), "launches": counts,
           "k2_launches_by_lanes": dict(collections.Counter(lanes))}
    res["ok"] = (res.pop("one_step_ok") and counts["K2"] > 0
                 and counts["K2_plain"] == 0 and counts["K1"] == 0
                 and counts["K1_plain"] == 0)
    return res


def anchor_vs_pipeline(engine, bvh, means, stds, skeleton,
                       B: int = B_ANCHOR, T: int = T_ANCHOR_B) -> dict:
    """``run_batch`` (the anchor) against ``run_batch_pipelined`` (K1 + K2),
    both on the card, B lanes × T frames of the clip from the same initial
    states: in lockstep at one Adam step a frame (the one-step gate), and
    at the full ``max_iter`` by statistics (mean iterations within
    ``ANCHOR_ITER_REL``, the lanes' mean MPJPE within ``ANCHOR_MPJPE_M``).
    The anchor runs must launch no K1."""
    import torch

    t_setup = time.time()
    states, dqs, gp, gr = lane_batch(engine, bvh, means, stds, B, T)
    args = (states, dqs, gp, gr)
    res = {"B": B, "T": T}
    anchor_counts = []

    def anchor(**hyper):
        torch.cuda.synchronize()
        reset_kernel_counts()
        t0 = time.time()
        with hyper_override(engine, **hyper):
            _, o = engine.run_batch(*args)
        torch.cuda.synchronize()
        anchor_counts.append(kernel_counts())
        return _cpu_output(o), time.time() - t0

    def pipelined(**hyper):
        torch.cuda.synchronize()
        t0 = time.time()
        with hyper_override(engine, **hyper):
            _, o = engine.run_batch_pipelined(*args, sync_k=SYNC_K)
        torch.cuda.synchronize()
        return _cpu_output(o), time.time() - t0

    lockstep = dict(KNIFE_FREE, max_iter=1)
    a1, _ = anchor(**lockstep)
    p1, _ = pipelined(**lockstep)
    res.update(one_step_lockstep(a1, p1))
    a, res["anchor_s"] = anchor()
    p, res["pipelined_s"] = pipelined()
    stats = {}
    for name, o in (("anchor", a), ("pipelined", p)):
        stats[name] = {
            "mean_iterations": float(o.iterations.float().mean()),
            "mean_mpjpe_m": float(np.mean([
                lane_mpjpe(o, bvh, means, stds, skeleton, T, i)
                for i in range(B)]))}
    res.update(stats=stats, anchor_launches=anchor_counts,
               phase_s=time.time() - t_setup,
               bounds={"iterations_rel": ANCHOR_ITER_REL,
                       "mpjpe_m": ANCHOR_MPJPE_M})
    it_a = stats["anchor"]["mean_iterations"]
    it_p = stats["pipelined"]["mean_iterations"]
    res["ok"] = (res.pop("one_step_ok")
                 and abs(it_a - it_p) <= ANCHOR_ITER_REL * it_p
                 and abs(stats["anchor"]["mean_mpjpe_m"]
                         - stats["pipelined"]["mean_mpjpe_m"])
                 <= ANCHOR_MPJPE_M
                 and all(c["K1"] == 0 and c["K1_plain"] == 0
                         and c["K2"] > 0 and c["K2_plain"] == 0
                         for c in anchor_counts))
    return res


def cli_runs(work_dir: str = os.path.join(WORK_DIR, "cli")) -> list:
    """The offline CLI on the card through ``cli.eval_drag.main``, four
    runs on seeded synthetic clips of ``T_CLI`` frames, launch counts set
    to 0 just before each and read just after: one file at 6 trackers
    (``evaluate_file`` → ``engine.run``: K2, no K1), ``--batch`` over two
    files with 4 restarts (the pipelined batch: K1 and K2), the 3-tracker
    beam on one file (``run_batch``: K2, no K1; ``CLI_BEAM``) and ``--batch``
    with constraints (the pipeline's per-lane loop: K2, no K1).  Each must
    give finite MPJPE and jitter (read back from the written BVH)."""
    import io

    import torch

    from dragposer_tpu_torch import metrics
    from dragposer_tpu_torch.cli import eval_drag
    from dragposer_tpu_torch.io.bvh import BVH

    shutil.rmtree(work_dir, ignore_errors=True)
    os.makedirs(os.path.join(work_dir, "clips"))
    files = write_synthetic_clips(os.path.join(work_dir, "clips"),
                                  (T_CLI, T_CLI), SEED + 1)
    runs = (("one file, 6_trackers (evaluate_file -> engine.run)",
             files[:1], [], False),
            ("--batch, 2 files, --restarts 4", files, ["--batch",
                                                       "--restarts", "4"],
             True),
            (f"3_trackers beam, --restarts {CLI_BEAM[0]} --survivors "
             f"{CLI_BEAM[1]} --branch-every {CLI_BEAM[2]} --max-frames "
             f"{CLI_BEAM[3]} (cut from 64, 8 and 512 and the clip's "
             f"{T_CLI} frames for time)", files[:1],
             ["--config", "3_trackers", "--restarts", CLI_BEAM[0],
              "--survivors", CLI_BEAM[1], "--branch-every", CLI_BEAM[2],
              "--max-frames", CLI_BEAM[3]], False),
            ("--batch, 2 files, --constraints feet_floor:0.1,"
             "head_hips_colinear:0.05 (per-lane inner loop)", files,
             ["--batch", "--constraints",
              "feet_floor:0.1,head_hips_colinear:0.05"], False))
    out = []
    for i, (name, inputs, flags, k1_expected) in enumerate(runs):
        save = os.path.join(work_dir, f"run{i}")
        text = io.StringIO()
        torch.cuda.synchronize()
        reset_kernel_counts()
        t0 = time.time()
        with contextlib.redirect_stdout(text):
            results = eval_drag.main([MODEL_DIR, *inputs, "--save-dir", save,
                                      *flags])
        torch.cuda.synchronize()
        seconds = time.time() - t0
        counts = kernel_counts()
        jit = [metrics.jitter(BVH().load(os.path.join(
            save, "eval_" + os.path.basename(f)))) for f in inputs]
        per_file = (int(flags[flags.index("--max-frames") + 1])
                    if "--max-frames" in flags else T_CLI)
        frames = per_file * len(inputs)
        r = {"run": name, "seconds": seconds, "frames": frames,
             "frames_per_s": frames / seconds,
             "mpjpe_m": [m for m, _ in results], "jitter_m_s3": jit,
             "launches": counts,
             "said": [ln for ln in text.getvalue().splitlines()
                      if ln.startswith(("restarts:", "hypotheses:",
                                        "constraints active"))]}
        r["ok"] = (len(results) == len(inputs)
                   and bool(np.isfinite(r["mpjpe_m"]).all())
                   and bool(np.isfinite(jit).all())
                   and counts["K2"] > 0 and counts["K2_plain"] == 0
                   and counts["K1_plain"] == 0
                   and (counts["K1"] > 0) == k1_expected)
        out.append(r)
    return out


def anchor_timing(engine, bvh, means, stds, T: int = 24, B: int = 64,
                  T_batch: int = 6, T_profile: int = 2) -> dict:
    """Not gated: ``engine.run`` frames/s at B = 1 over T frames of the
    clip and ``run_batch`` at B lanes over its first ``T_batch`` (a frame
    costs its slowest lane's iterations, 100 at B = 64), 6 trackers, the
    full stop rule; and the device's busy time and idle share over the
    first ``T_profile`` frames of the single lane under ``torch.profiler``
    (a frame is ~30,000 profiler events, whose processing takes seconds
    a frame).  The frame counts are cut from 48, 48 and 8 for time."""
    import torch

    from dragposer_tpu_torch.drag import engine as eng

    states, dqs, gp, gr = lane_batch(engine, bvh, means, stds, B, T)
    one = (eng.DragState(*[x[0] for x in states]), dqs[0], gp[0], gr[0])
    res = {"card": gpu_clocks()}
    torch.cuda.synchronize()
    t0 = time.time()
    _, o1 = engine.run(*one)
    torch.cuda.synchronize()
    s1 = time.time() - t0
    t0 = time.time()
    _, ob = engine.run_batch(states, dqs[:, :T_batch], gp[:, :T_batch],
                             gr[:, :T_batch])
    torch.cuda.synchronize()
    sb = time.time() - t0
    res.update({
        "run_B1": {"T": T, "seconds": s1, "frames_per_s": T / s1,
                   "mean_iterations": float(o1.iterations.float().mean())},
        f"run_batch_B{B}": {"T": T_batch, "seconds": sb,
                            "frames_per_s": B * T_batch / sb,
                            "mean_iterations":
                                float(ob.iterations.float().mean()),
                            "iterations_a_frame_max_over_lanes": float(
                                ob.iterations.max(dim=0).values.float()
                                .mean())}})
    prof = profile_device_time(
        lambda: engine.run(one[0], *[a[:T_profile] for a in one[1:]]),
        {"K2": "temporal_forward_kernel"})
    res[f"profile_run_B1_{T_profile}_frames"] = prof
    return res



# ---------------------------------------------------------------------------
# The realtime front: sessions, the multi-avatar batch and the daemon (the
# daemon's helpers are shared with tests/test_torch_server.py on the CPU)
# ---------------------------------------------------------------------------

T_REALTIME = 120        # frames of each timed realtime run (2 windows of 60)
N_CROWD = 64            # avatars of the RealtimeBatch runs
CROWD_CONFIGS = ("6_trackers", "4_trackers", "3_trackers")
ONE_STEP = (0.0, 0.0, 1, 0.01)   # set_optim_params: one Adam step a frame
N_DAEMON_CLIENTS = 4
T_DAEMON = 60           # frames each daemon client steps
DAEMON_EVAL_CLIPS = (240, 200)
DAEMON_WORK_DIR = os.path.join(WORK_DIR, "daemon")


def configure_session(session, skeleton_path: str, config: str = "6_trackers",
                      optim=None, lambdas=None, model_dir: str = MODEL_DIR):
    """The reference client's set-up of a ``RealtimeSession``: skeleton,
    models, ``config``'s mask and weights and, where given, optimizer
    parameters and lambdas (else the realtime defaults: max_iter 10,
    window 60)."""
    from dragposer_tpu_torch import config as cfg

    c = cfg.BUILTIN_CONFIGS[config]
    session.set_reference_skeleton(skeleton_path)
    session.load_models(model_dir)
    session.set_mask_and_weights(c.mask_array(), c.weights_array())
    if optim is not None:
        session.set_optim_params(*optim)
    if lambdas is not None:
        session.set_lambdas(*lambdas)
    return session


def session_frame(session, wp, wq, f: int, root):
    """Frame ``f`` of a clip's trackers (``clip_trackers``) through
    ``session.drag_pose``, positions relative to ``root`` (3,), the root
    the client last read; returns (local (J, 4), global_pos (3,))."""
    j = session.skeleton.n_joints
    idx = session._mask_indices
    pose = np.zeros((j, 4), np.float32)
    gp = np.zeros((1, 3), np.float32)
    session.drag_pose(wp[f, idx] - root, wq[f, idx], pose, gp)
    return pose, gp[0]


def crowd_targets(wp, wq, frames, roots):
    """Dense targets of a crowd: avatar i reads frame ``frames[i]``,
    relative to its root ``roots[i]``."""
    return wp[frames] - roots[:, None], wq[frames]


def latency_ms(seconds) -> dict:
    """Frame latency: the median, p90 (the highest percentile with ten
    samples beyond it at 120 frames) and p99, the worst and the mean."""
    ms = np.asarray(seconds) * 1e3
    return {"p50_ms": float(np.percentile(ms, 50)),
            "p90_ms": float(np.percentile(ms, 90)),
            "p99_ms": float(np.percentile(ms, 99)),
            "max_ms": float(ms.max()), "mean_ms": float(ms.mean()),
            "frames": int(ms.size)}


def realtime_session_phase(skeleton_path: str, bvh,
                           frames: int = T_REALTIME) -> dict:
    """``RealtimeSession`` on the card: one frame at one Adam step against
    the same frame on the CPU from the same carried state (the lockstep
    gate of :func:`one_step_lockstep`: latent 1e-4, root 1e-5; the
    parent-local quaternions 1e-4), at the realtime default window 60, so
    its rollout is K2 at S_dec = 16; then ``frames`` frames at the
    realtime defaults (max_iter 10, window 60) timed frame by frame, launch
    counts set to 0 just before and read just after: K2 launched, its twin
    and K1 never."""
    import torch

    from dragposer_tpu_torch.runtime.realtime import RealtimeSession

    wp, wq = clip_trackers(bvh)
    root0 = wp[0, 0]
    card = configure_session(RealtimeSession(log_path=None), skeleton_path,
                             optim=ONE_STEP)
    cpu = configure_session(RealtimeSession(log_path=None, device="cpu"),
                            skeleton_path, optim=ONE_STEP)
    for s in (cpu, card):
        s.init_drag_pose(root0[None], wq[0, 0][None])
    card._state = card._engine.on_device(cpu._state)
    (gl, gg), (cl, cg) = [session_frame(s, wp, wq, 0, root0)
                          for s in (card, cpu)]
    res = {"one_step": {
        "latent_err": float((card._state.latent.cpu()
                             - cpu._state.latent).abs().max()),
        "root_err": float(np.abs(gg - cg).max()),
        "local_quat_err": float(np.abs(gl - cl).max())}}
    one = res["one_step"]
    one["ok"] = (one["latent_err"] <= 1e-4 and one["root_err"] <= 1e-5
                 and one["local_quat_err"] <= 1e-4)

    card.set_optim_params(1e-4, 0.01, 10, 0.01)   # the realtime defaults
    card._ensure_engine()        # the rebuild and its prewarm frame, untimed
    torch.cuda.synchronize()
    reset_kernel_counts()
    seconds, root, finite = [], gg, True
    for f in range(1, frames + 1):
        t0 = time.perf_counter()
        local, root = session_frame(card, wp, wq, f, root)
        seconds.append(time.perf_counter() - t0)
        finite = finite and bool(np.isfinite(local).all()
                                 and np.isfinite(root).all())
    counts = kernel_counts()
    res.update(latency_ms(seconds), launches=counts,
               window=card.temporal_future_window, max_iter=card.max_iter,
               k2_s_dec=card.temporal_future_window // 4 + 1,
               unit_quats=bool(np.allclose(np.linalg.norm(local, axis=-1),
                                           1.0, atol=1e-4)))
    res["ok"] = (one["ok"] and finite and res["unit_quats"]
                 and counts["K2"] > 0 and counts["K2_plain"] == 0
                 and counts["K1"] == 0 and counts["K1_plain"] == 0)
    return res


def _crowd(session, n: int, wp, frames: int):
    """``session.make_batch(n)`` with the avatars' configs cycling through
    ``CROWD_CONFIGS`` and avatar i starting at frame 2i of the clip (modulo
    what leaves ``frames`` frames after the start)."""
    from dragposer_tpu_torch import config as cfg

    batch = session.make_batch(n)
    for i in range(n):
        c = cfg.BUILTIN_CONFIGS[CROWD_CONFIGS[i % len(CROWD_CONFIGS)]]
        batch.set_mask_and_weights(i, c.mask_array(), c.weights_array())
    starts = (2 * np.arange(n)) % (wp.shape[0] - frames - 1)
    return batch, starts


def crowd_agreement(g, c, max_iter: int) -> dict:
    """One batched frame on the card against the CPU under K1's gate
    (``k1_agreement``): lanes whose iteration counts differ (a stop-rule
    knife edge) are counted and left out; on the others the new latent,
    the decoded latent, both losses, the root and the parent-local
    quaternions within ``K1_TOL`` (atol ``atol_per_step`` × max_iter, rtol
    on the CPU's value); at most B // 1000 lanes of either kind.  ``g``
    and ``c`` are ``realtime.make_batched_frame``'s results (state,
    ``FrameOutput``, local quaternions) on the card and on the CPU."""
    (gs, go, gl), (cs, co, cl) = g, c
    gg, cg = go.global_pos, co.global_pos
    B = gl.shape[0]
    same_t = go.iterations.cpu() == co.iterations
    atol = K1_TOL["atol_per_step"] * max_iter
    over = np.zeros(B, bool)
    worst = 0.0
    for a, b in ((gs.latent, cs.latent), (go.latent, co.latent),
                 (go.loss_pos, co.loss_pos), (go.loss_rot, co.loss_rot),
                 (gg, cg), (gl, cl)):
        a, b = a.cpu().numpy().reshape(B, -1), b.numpy().reshape(B, -1)
        err = np.abs(a - b)
        over |= (err > atol + K1_TOL["rtol"] * np.abs(b)).any(axis=1)
        worst = max(worst, float(err[same_t.numpy()].max(initial=0.0)))
    mismatch = int((~same_t).sum())
    n_over = int((over & same_t.numpy()).sum())
    return {"tolerance": f"K1_TOL: atol {atol:g} (atol_per_step x max_iter "
                         f"{max_iter}) + rtol {K1_TOL['rtol']:g}; lanes "
                         f"with unequal iteration counts left out; at most "
                         f"B // 1000 = {B // 1000} lanes of either kind",
            "max_abs_err": worst, "t_mismatch": mismatch,
            "lanes_over_tol": n_over,
            "mean_iterations": float(co.iterations.float().mean()),
            "ok": mismatch <= B // 1000 and n_over <= B // 1000}


def realtime_batch_phase(skeleton_path: str, bvh, n: int = N_CROWD,
                         frames: int = T_REALTIME) -> dict:
    """``RealtimeBatch`` of ``n`` avatars (6/4/3 trackers in turn) at the
    realtime defaults: one frame on the card (K1 + K2) against the CPU's
    twins from the same state (:func:`crowd_agreement`), launch counts of
    the card's frame; then ``frames`` frames timed frame by frame with
    the window phases in lockstep and staggered (``stagger_phases``),
    counts set to 0 just before each run and read just after."""
    import torch

    from dragposer_tpu_torch.drag import engine as eng
    from dragposer_tpu_torch.runtime.realtime import (RealtimeSession,
                                                      make_batched_frame)

    wp, wq = clip_trackers(bvh)
    card_s = configure_session(RealtimeSession(log_path=None), skeleton_path)
    cpu_s = configure_session(RealtimeSession(log_path=None, device="cpu"),
                              skeleton_path)
    (card, starts), (cpu, _) = (_crowd(card_s, n, wp, frames),
                                _crowd(cpu_s, n, wp, frames))
    gp0, gr0 = wp[starts, 0], wq[starts, 0]
    cpu.init_drag_pose(gp0, gr0)
    card._state = card._engine.on_device(cpu._state)
    tpos, trot = crowd_targets(wp, wq, starts + 1, gp0)
    card_frame, cpu_frame = (make_batched_frame(card._engine),
                             make_batched_frame(cpu._engine))
    torch.cuda.synchronize()
    reset_kernel_counts()
    g = card_frame(card._model_b(), card._state, card._engine.tensor(tpos),
                   card._engine.tensor(trot))
    torch.cuda.synchronize()
    counts = kernel_counts()
    c = cpu_frame(cpu._model_b(), cpu._state, torch.as_tensor(tpos),
                  torch.as_tensor(trot))
    res = {"n": n, "configs": CROWD_CONFIGS,
           "one_frame": crowd_agreement(g, c, card._engine.hyper.max_iter)}
    res["one_frame"]["launches"] = counts
    ok = (res["one_frame"]["ok"] and counts["K1"] == 1 and counts["K2"] > 0
          and counts["K1_plain"] == 0 and counts["K2_plain"] == 0)
    res["launches"] = {}
    for stagger in (False, True):
        card.init_drag_pose(gp0, gr0, stagger_phases=stagger)
        roots = gp0.copy()
        torch.cuda.synchronize()
        reset_kernel_counts()
        seconds = []
        with k2_lanes_recorded() as lanes:
            for f in range(1, frames + 1):
                tpos, trot = crowd_targets(wp, wq, starts + f, roots)
                t0 = time.perf_counter()
                local, roots = card.drag_pose(tpos, trot)
                seconds.append(time.perf_counter() - t0)
        counts = kernel_counts()
        key = "staggered" if stagger else "lockstep"
        run = res[key] = {**latency_ms(seconds), "launches": counts,
                          "k2_lanes_per_launch": sorted(set(lanes))}
        res["launches"][key] = counts
        run["finite"] = bool(np.isfinite(local).all()
                             and np.isfinite(roots).all())
        ok = (ok and run["finite"] and counts["K1"] == frames
              and counts["K2"] > 0 and counts["K1_plain"] == 0
              and counts["K2_plain"] == 0)
    budget = eng.rollout_lane_budget(n, card._engine.hyper
                                     .temporal_future_window)
    res["rollout_lane_budget"] = budget
    # staggered phases must keep every rollout inside the sub-batch budget
    res["ok"] = ok and max(res["staggered"]["k2_lanes_per_launch"],
                           default=0) <= rollout_lanes(card._engine, n,
                                                       budget)
    return res


def start_daemon(socket_path: str, device: str = "cuda",
                 cwd: str = DAEMON_WORK_DIR, coalesce_window=None,
                 env=None) -> subprocess.Popen:
    """Start ``python -m dragposer_tpu_torch.runtime.server`` on ``device``
    from this checkout and wait for its ready byte (``--ready-fd``): it
    has loaded its kernels and listens.  Its output goes to
    ``cwd/daemon.log``.  Stop it with :func:`stop_daemon`."""
    os.makedirs(cwd, exist_ok=True)
    env = dict(os.environ if env is None else env)
    env["PYTHONPATH"] = HERE + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [sys.executable, "-m", "dragposer_tpu_torch.runtime.server",
           "--socket", socket_path, "--device", device]
    if coalesce_window is not None:
        cmd += ["--coalesce-window", str(coalesce_window)]
    r, w = os.pipe()
    with open(os.path.join(cwd, "daemon.log"), "w") as log:
        proc = subprocess.Popen(cmd + ["--ready-fd", str(w)], env=env,
                                cwd=cwd, pass_fds=(w,), stdout=log,
                                stderr=subprocess.STDOUT)
    os.close(w)
    try:
        ready = os.read(r, 1)
    finally:
        os.close(r)
    if not ready:
        proc.wait(timeout=60)
        with open(os.path.join(cwd, "daemon.log")) as f:
            raise RuntimeError(f"the daemon exited ({proc.returncode}) "
                               f"before listening: {f.read()[-2000:]}")
    return proc


def stop_daemon(proc: subprocess.Popen) -> None:
    proc.terminate()
    try:
        proc.wait(timeout=30)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=30)


class DaemonSession:
    """One realtime session over its own connection to the daemon: the
    session opcodes (setup, drag, stats) on ``runtime.client.DaemonClient``'s
    framing."""

    def __init__(self, socket_path: str, timeout: float = 600.0):
        from dragposer_tpu_torch.runtime.client import DaemonClient

        self.client = DaemonClient(socket_path, timeout=timeout)
        self.handle = None
        self.mask_indices = None

    def call(self, op: int, payload: bytes = b"") -> tuple:
        """(status, body) of one request."""
        return self.client.request(op, payload)

    def ok(self, op: int, payload: bytes = b"") -> bytes:
        """The body of one request; an error reply raises ``DaemonError``."""
        return self.client._call(op, payload)

    def setup(self, skeleton_path: str, root, rot, config="6_trackers",
              optim=(1e-4, 0.01, 10, 0.01), lambdas=(1.0, 0.02, 60),
              model_dir: str = MODEL_DIR):
        """The reference DLL sequence: init, skeleton, models, mask and
        weights, the initial pose, optimizer parameters and lambdas."""
        import struct

        from dragposer_tpu_torch import config as cfg
        from dragposer_tpu_torch.runtime import server as proto

        (self.handle,) = struct.unpack("<q", self.ok(proto.OP_INIT))
        h = struct.pack("<q", self.handle)
        (j,) = struct.unpack("<i", self.ok(proto.OP_SET_REF_SKELETON,
                                           h + skeleton_path.encode()))
        self.ok(proto.OP_LOAD_MODELS, h + model_dir.encode())
        c = cfg.BUILTIN_CONFIGS[config]
        mask, weights = c.mask_array(), c.weights_array()
        self.mask_indices = np.nonzero(mask)[0]
        (e,) = struct.unpack("<i", self.ok(
            proto.OP_SET_MASK_WEIGHTS, h + struct.pack("<i", j)
            + mask.astype("<f4").tobytes() + weights.astype("<f4").tobytes()))
        if e != len(self.mask_indices):
            raise RuntimeError(f"the daemon counts {e} end effectors")
        self.ok(proto.OP_SET_OPTIM_PARAMS, h + struct.pack("<ffif", *optim))
        self.ok(proto.OP_SET_LAMBDAS, h + struct.pack("<ffi", *lambdas))
        self.ok(proto.OP_INIT_DRAG_MODEL,
                h + struct.pack("<7f", *root, *rot))
        self.n_joints = j
        return self

    def drag(self, tpos, trot):
        """One frame from sparse targets (E, 3) and (E, 4 wxyz): (local
        (J, 4), global_pos (3,))."""
        import struct

        from dragposer_tpu_torch.runtime import server as proto

        e = len(tpos)
        body = (struct.pack("<qi", self.handle, e)
                + np.asarray(tpos, "<f4").tobytes()
                + np.asarray(trot, "<f4").tobytes())
        out = np.frombuffer(self.ok(proto.OP_DRAG_POSE, body), "<f4")
        j = self.n_joints
        return out[: 4 * j].reshape(j, 4), out[4 * j:]

    def frame(self, wp, wq, f: int, root):
        idx = self.mask_indices
        return self.drag(wp[f, idx] - root, wq[f, idx])

    def stats(self) -> dict:
        return self.client.stats()

    def close(self) -> None:
        self.client.close()


def build_native_smoke(out_dir: str) -> str:
    """``native/dragposer_client.cpp`` + ``native/smoke_main.cpp`` built
    with ``g++`` into ``out_dir/dragposer_smoke_client`` (the socket client
    library and the reference DLL's call sequence, no interpreter)."""
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, "dragposer_smoke_client")
    native = os.path.join(HERE, "native")
    subprocess.run(["g++", "-std=c++17", "-O2", "-pthread",
                    "-I" + native, "-o", out,
                    os.path.join(native, "dragposer_client.cpp"),
                    os.path.join(native, "smoke_main.cpp")],
                   check=True, capture_output=True, text=True, timeout=300)
    return out


def run_native_smoke(binary: str, socket_path: str, skeleton_path: str,
                     cycles: int = 2, cwd: str = DAEMON_WORK_DIR,
                     model_dir: str = MODEL_DIR):
    """The native smoke lifecycle against a running daemon
    (``DRAGPOSER_NO_SPAWN``: never its own); returns the finished
    process."""
    env = dict(os.environ, DRAGPOSER_SOCKET=socket_path,
               DRAGPOSER_NO_SPAWN="1")
    return subprocess.run([binary, model_dir, skeleton_path, str(cycles)],
                          capture_output=True, text=True, env=env, cwd=cwd,
                          timeout=600)


def daemon_phase(skeleton_path: str, bvh, device: str = "cuda",
                 frames: int = T_DAEMON) -> dict:
    """The serving daemon on the card, as a process of its own: four
    raw-socket clients (6 trackers, the realtime defaults) step ``frames``
    frames each from their own threads, coalesced by the
    daemon (``OP_STATS``: coalesced frames, ticks, and the daemon's launch
    counts as the difference of two reads around the run); one
    ``OP_EVAL_BATCH`` on two synthetic clips while client 0 keeps stepping
    (at least 3 frames during the job); the native smoke client
    (``build_native_smoke``) through ``DRAGPOSER_NO_SPAWN``."""
    import threading

    from dragposer_tpu_torch.runtime.client import DaemonClient

    shutil.rmtree(DAEMON_WORK_DIR, ignore_errors=True)
    os.makedirs(DAEMON_WORK_DIR)
    sock = os.path.join(DAEMON_WORK_DIR, "dragposer.sock")
    wp, wq = clip_trackers(bvh)
    t0 = time.time()
    proc = start_daemon(sock, device)
    res = {"start_s": time.time() - t0}
    clients = []
    try:
        starts = 3 * np.arange(N_DAEMON_CLIENTS)
        roots = [wp[s, 0] for s in starts]
        t0 = time.time()
        clients = [DaemonSession(sock).setup(skeleton_path, wp[s, 0],
                                             wq[s, 0]) for s in starts]
        res["setup_s"] = time.time() - t0
        before = clients[0].stats()
        seconds = [[] for _ in clients]
        errors = []
        barrier = threading.Barrier(len(clients))

        def run(i):
            try:
                barrier.wait(timeout=120)
                for f in range(1, frames + 1):
                    t = time.perf_counter()
                    local, roots[i] = clients[i].frame(wp, wq, starts[i] + f,
                                                       roots[i])
                    seconds[i].append(time.perf_counter() - t)
                    if not np.allclose(np.linalg.norm(local, axis=-1), 1.0,
                                       atol=1e-3):
                        raise ValueError(f"client {i} frame {f}: not unit "
                                         "quaternions")
            except Exception as e:  # reported below, fails the phase
                errors.append(repr(e))

        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(clients))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        after = clients[0].stats()
        delta = {k: after[k] - before[k]
                 for k in ("frames", "ticks", "coalesced_frames")}
        launches = {k: after["kernels"][k] - before["kernels"][k]
                    for k in after["kernels"]}
        res["clients"] = {**latency_ms(np.concatenate(seconds)),
                          **delta, "max_group": after["max_group"],
                          "launches": launches, "errors": errors}
        ok = (not errors and delta["frames"] == len(clients) * frames
              and delta["coalesced_frames"] > 0 and launches["K1"] > 0
              and launches["K2"] > 0 and launches["K1_plain"] == 0
              and launches["K2_plain"] == 0)

        clip_dir = os.path.join(DAEMON_WORK_DIR, "clips")
        os.makedirs(clip_dir)
        files = write_synthetic_clips(clip_dir, DAEMON_EVAL_CLIPS, SEED + 7)
        job = {}

        def eval_job():
            try:
                with DaemonClient(sock, timeout=600) as c:
                    job["out"] = c.eval_batch(MODEL_DIR, skeleton_path, files,
                                              save_dir=DAEMON_WORK_DIR)
            except Exception as e:  # reported below, fails the phase
                job["error"] = repr(e)

        before = clients[0].stats()
        thread = threading.Thread(target=eval_job)
        thread.start()
        during, f, root = 0, starts[0] + frames, roots[0]
        while thread.is_alive():
            f = f + 1 if f + 1 < wp.shape[0] else 1
            _, root = clients[0].frame(wp, wq, f, root)
            during += thread.is_alive()
        thread.join()
        after = clients[0].stats()
        out = job.get("out", {})
        mpjpe = [r["mpjpe"] for r in out.get("results", [])]
        res["eval_job"] = {
            "files": len(files), "frames": list(DAEMON_EVAL_CLIPS),
            "elapsed_s": out.get("elapsed_s"), "mpjpe_m": mpjpe,
            "frames_stepped_during_job": during, "error": job.get("error"),
            "launches": {k: after["kernels"][k] - before["kernels"][k]
                         for k in after["kernels"]}}
        ok = (ok and len(mpjpe) == len(files)
              and bool(np.all(np.isfinite(mpjpe))) and during >= 3
              and res["eval_job"]["launches"]["K1"] > 0)

        before = clients[0].stats()
        smoke = run_native_smoke(build_native_smoke(os.path.join(
            HERE, "build")), sock, skeleton_path)
        after = clients[0].stats()
        res["native_smoke"] = {
            "returncode": smoke.returncode,
            "said": [ln for ln in smoke.stdout.splitlines()
                     if "smoke OK" in ln or "end effectors" in ln],
            "stderr_tail": smoke.stderr[-300:] if smoke.returncode else "",
            "launches": {k: after["kernels"][k] - before["kernels"][k]
                         for k in after["kernels"]}}
        ok = (ok and smoke.returncode == 0 and "smoke OK" in smoke.stdout
              and smoke.stdout.count("end effectors: 6") == 2)
        res["launches"] = {k: (res["clients"]["launches"][k]
                               + res["eval_job"]["launches"][k]
                               + res["native_smoke"]["launches"][k])
                           for k in launches}
    finally:
        for c in clients:
            c.close()
        stop_daemon(proc)
    res["ok"] = ok
    return res


# ---------------------------------------------------------------------------
# The port's native layer: the embedded C ABI and the socket client, driven
# by a host like Unity's (shared with tests/test_torch_native.py on the CPU)
# ---------------------------------------------------------------------------

T_NATIVE = 120          # frames of each native run (2 windows of 60)
NATIVE_TOL = 1e-5       # the host's frames against in-process capi, card
NATIVE_WORK_DIR = os.path.join(WORK_DIR, "native")
PORT_NATIVE = os.path.join(HERE, "dragposer_tpu_torch", "native")


def build_probe(out_dir: str) -> str:
    """``dragposer_tpu_torch/native/probe.cpp`` built with ``g++`` into
    ``out_dir/dragposer_probe``: it links no library of the port, it
    opens one with ``dlopen``."""
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, "dragposer_probe")
    subprocess.run(["g++", "-std=c++17", "-O2", "-pthread", "-I" + PORT_NATIVE,
                    "-o", out, os.path.join(PORT_NATIVE, "probe.cpp"), "-ldl"],
                   check=True, capture_output=True, text=True, timeout=300)
    return out


def build_smoke_against(kind: str, out_dir: str) -> tuple:
    """``native/smoke_main.cpp``, unchanged, compiled against the port's
    ``dragposer_abi.h`` and linked to ``_build.native_library(kind)``:
    the drop-in proof.  A ``#include "..."`` looks first in the including
    file's own directory, which holds the JAX package's header, so the
    file is compiled from a byte-for-byte copy in ``out_dir``; ``g++ -H``
    lists the headers read.  Returns (binary, the ABI headers read)."""
    from dragposer_tpu_torch import _build

    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, "smoke_main.cpp")
    shutil.copyfile(os.path.join(HERE, "native", "smoke_main.cpp"), src)
    lib = _build.native_library(kind)
    out = os.path.join(out_dir, f"dragposer_smoke_{kind}")
    done = subprocess.run(["g++", "-std=c++17", "-O2", "-H", "-I" + PORT_NATIVE,
                           "-o", out, src, str(lib),
                           "-Wl,-rpath," + str(lib.parent)],
                          check=True, capture_output=True, text=True,
                          timeout=300)
    headers = [ln.lstrip(". ") for ln in done.stderr.splitlines()
               if ln.endswith("dragposer_abi.h")]
    return out, headers


def write_probe_targets(path: str, bvh, frames: int = T_NATIVE,
                        config: str = "6_trackers") -> None:
    """The probe's targets file (``probe.cpp``): ``config``'s mask and
    weights, the clip's first root position and rotation, then ``frames``
    frames of the masked joints' world positions less the clip's root one
    frame before, and their rotations; little-endian float32."""
    from dragposer_tpu_torch import config as cfg

    wp, wq = clip_trackers(bvh)
    c = cfg.BUILTIN_CONFIGS[config]
    mask = c.mask_array()
    idx = np.nonzero(mask)[0]
    per_frame = [np.concatenate(((wp[f, idx] - wp[f - 1, 0]).ravel(),
                                 wq[f, idx].ravel()))
                 for f in range(1, frames + 1)]
    np.concatenate([mask, c.weights_array().ravel(), wp[0, 0], wq[0, 0],
                    *per_frame]).astype("<f4").tofile(path)


def read_probe_targets(path: str, n_joints: int) -> dict:
    """A targets file as the probe reads it."""
    data = np.fromfile(path, "<f4")
    j = n_joints
    mask = data[:j]
    e = int(np.count_nonzero(mask))
    frames = data[3 * j + 7:].reshape(-1, 7 * e)
    return {"mask": mask, "weights": data[j:3 * j], "root": data[3 * j:3 * j + 3],
            "rot": data[3 * j + 3:3 * j + 7],
            "pos": frames[:, :3 * e].reshape(-1, e, 3),
            "quat": frames[:, 3 * e:].reshape(-1, e, 4)}


def capi_frames(targets: str, skeleton_path: str, device,
                model_dir: str = MODEL_DIR) -> tuple:
    """The probe's lifecycle through ``runtime.capi`` in this process, fed
    the same targets as bytes: (frames (N, 4J + 3) float32, seconds a
    frame)."""
    import torch

    from dragposer_tpu_torch.runtime import capi

    h = capi.init(device)
    try:
        j = capi.set_reference_skeleton(h, skeleton_path)
        capi.load_models(h, model_dir)
        t = read_probe_targets(targets, j)
        e = capi.set_mask_and_weights(h, t["mask"].tobytes(),
                                      t["weights"].tobytes())
        root = [float(x) for x in t["root"]]
        capi.init_drag_model(h, *root, *[float(x) for x in t["rot"]])
        capi.set_optim_params(h, *np.float32([1e-4, 0.01]).tolist(), 10,
                              float(np.float32(0.01)))
        capi.set_lambdas(h, 1.0, float(np.float32(0.02)), 60)
        capi.set_global_pos(h, *root)
        out, seconds = [], []
        for pos, quat in zip(t["pos"], t["quat"]):
            t0 = time.perf_counter()
            out.append(np.frombuffer(capi.drag_pose(
                h, pos.tobytes(), quat.tobytes(), e), "<f4"))
            seconds.append(time.perf_counter() - t0)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        return np.stack(out), seconds
    finally:
        capi.destroy(h)


def capi_repeatability(targets: str, skeleton_path: str, device="cuda"
                       ) -> dict:
    """The probe's lifecycle through ``capi`` twice in this process on the
    same targets: each frame's max abs difference between the two runs,
    the first frame that differs at all and the first past
    ``NATIVE_TOL``."""
    with contextlib.chdir(NATIVE_WORK_DIR):   # capi's session log
        a, _ = capi_frames(targets, skeleton_path, device)
        b, _ = capi_frames(targets, skeleton_path, device)
    err = np.abs(a - b).max(axis=1)
    return {"max_abs_err": float(err.max()),
            "first_frame_differing": (int(np.argmax(err > 0))
                                      if (err > 0).any() else None),
            "first_frame_over_tol": (int(np.argmax(err > NATIVE_TOL))
                                     if (err > NATIVE_TOL).any() else None),
            "frame_0_err": float(err[0]), "frames": int(err.size)}


def first_nondeterministic_op(targets: str, skeleton_path: str,
                              device="cuda"):
    """``init_drag_model`` and one frame of two fresh ``capi`` sessions,
    every aten op recorded (``TorchDispatchMode``: the op and digests of
    its tensor inputs and outputs; the outputs of ``empty`` ops, memory
    never written, left out): the first op whose inputs are equal in both
    runs and whose outputs differ, as ``(index, op)``, or None."""
    import hashlib

    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    from dragposer_tpu_torch.runtime import capi

    def digests(tree):
        return [hashlib.sha1(x.detach().contiguous().cpu().numpy()
                             .tobytes()).hexdigest()
                for x in tree_flatten(tree)[0] if torch.is_tensor(x)]

    class Record(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            self.ops.append((str(func), digests((args, kwargs)),
                             [] if "empty" in str(func) else digests(out)))
            return out

    runs = []
    for _ in range(2):
        with contextlib.chdir(NATIVE_WORK_DIR):
            h = capi.init(device)
            try:
                j = capi.set_reference_skeleton(h, skeleton_path)
                capi.load_models(h, MODEL_DIR)
                t = read_probe_targets(targets, j)
                e = capi.set_mask_and_weights(h, t["mask"].tobytes(),
                                              t["weights"].tobytes())
                with Record() as rec:
                    capi.init_drag_model(h, *t["root"].tolist(),
                                         *t["rot"].tolist())
                    capi.drag_pose(h, t["pos"][0].tobytes(),
                                   t["quat"][0].tobytes(), e)
                runs.append(rec.ops)
            finally:
                capi.destroy(h)
    for i, (a, b) in enumerate(zip(*runs)):
        if a[1] == b[1] and a[2] != b[2]:
            return i, a[0]
    return None


def repeatability_figures(frames: int = T_NATIVE) -> dict:
    """For an A/B of the card path's repeatability against another
    checkout (run from its root, this file loaded by path):
    :func:`capi_repeatability` over ``frames`` frames of the main clip and
    :func:`first_nondeterministic_op`, with the card's name and power
    limit."""
    import torch

    from dragposer_tpu_torch import _build

    _build.build_all(["temporal_forward"])
    bvh = load_clip(T_MAIN, SEED)
    os.makedirs(NATIVE_WORK_DIR, exist_ok=True)
    targets = os.path.join(NATIVE_WORK_DIR, "repeatability.f32")
    write_probe_targets(targets, bvh, frames)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    return {"card": smi, "torch": torch.__version__,
            "capi_twice": capi_repeatability(targets, clip_path(SEED)),
            "first_nondeterministic_op": first_nondeterministic_op(
                targets, clip_path(SEED))}


def run_probe(probe: str, library, targets: str, skeleton_path: str,
              env: dict, cwd: str, threads: bool = False,
              report: bool = False, model_dir: str = MODEL_DIR,
              timeout: float = 600) -> dict:
    """Run the probe host on ``library`` with ``env`` from ``cwd`` (its
    output in files there: a daemon the client library starts inherits
    them and outlives the probe).  Returns its exit code, the frames (N,
    4J + 3), the host-clock ms of each frame and set-up call, the report
    and the end of its output."""
    os.makedirs(cwd, exist_ok=True)
    cmd = [probe, str(library), model_dir, skeleton_path, targets]
    cmd += ["--threads"] * threads + ["--report"] * report
    out_path, err_path = (os.path.join(cwd, "probe.out"),
                          os.path.join(cwd, "probe.err"))
    with open(out_path, "w") as out, open(err_path, "w") as err:
        rc = subprocess.run(cmd, stdout=out, stderr=err, env=env, cwd=cwd,
                            timeout=timeout).returncode
    with open(out_path) as f:
        lines = f.read().splitlines()
    with open(err_path) as f:
        stderr = f.read()
    frames = [ln.split()[1:] for ln in lines if ln.startswith("frame ")]
    res = {"returncode": rc,
           "frames": np.array([v[2:] for v in frames], np.float32),
           "frame_ids": [int(v[0]) for v in frames],
           "ms": [float(v[1]) for v in frames],
           "setup_ms": {ln.split()[1]: float(ln.split()[2])
                        for ln in lines if ln.startswith("setup ")},
           "report": next((json.loads(ln[len("report "):]) for ln in lines
                           if ln.startswith("report ")), None),
           "ok_line": "probe OK" in lines, "stderr": stderr[-2000:]}
    return res


def daemon_pid(socket_path: str) -> int:
    """The pid of the process listening on ``socket_path``
    (``SO_PEERCRED``)."""
    import socket
    import struct

    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
        s.connect(socket_path)
        cred = s.getsockopt(socket.SOL_SOCKET, socket.SO_PEERCRED,
                            struct.calcsize("3i"))
    return struct.unpack("3i", cred)[0]


def proc_cmdline(pid: int) -> list:
    with open(f"/proc/{pid}/cmdline", "rb") as f:
        return [a.decode() for a in f.read().split(b"\0") if a]


def _proc_gone(pid: int) -> bool:
    """No process ``pid``, or a zombie (not this process's child to reap)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] in ("Z", "X")
    except FileNotFoundError:
        return True


def end_process(pid: int, timeout: float = 30.0) -> bool:
    """SIGTERM ``pid`` (SIGKILL after ``timeout`` s); True once it is
    gone."""
    import signal

    for sig in (signal.SIGTERM, signal.SIGKILL):
        try:
            os.kill(pid, sig)
        except ProcessLookupError:
            return True
        t0 = time.time()
        while time.time() - t0 < timeout:
            if _proc_gone(pid):
                return True
            time.sleep(0.05)
    return _proc_gone(pid)


def spawned_daemon(socket_path: str) -> dict:
    """The daemon that answers on ``socket_path``, started by the client
    library: its pid and command line, its kernels' launch counts
    (``OP_STATS``), then ended here (it would otherwise wait out its idle
    timeout)."""
    from dragposer_tpu_torch.runtime.client import DaemonClient

    pid = daemon_pid(socket_path)
    cmdline = proc_cmdline(pid)
    with DaemonClient(socket_path, timeout=60) as c:
        kernels = c.stats()["kernels"]
    return {"pid": pid, "cmdline": cmdline, "kernels": kernels,
            "port_module": "dragposer_tpu_torch.runtime.server" in cmdline,
            "jax_module": any(re.search(r"\bdragposer_tpu\.", a)
                              for a in cmdline),
            "ended": end_process(pid)}


def native_env(**extra) -> dict:
    """This environment without the native layer's variables, plus
    ``extra``."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("DRAGPOSER_DEVICE", "DRAGPOSER_SOCKET",
                        "DRAGPOSER_NO_SPAWN", "DRAGPOSER_PYROOT",
                        "DRAGPOSER_PYTHON")}
    env.update(extra)
    return env


def native_phase(bvh, skeleton_path: str, session: dict,
                 frames: int = T_NATIVE) -> dict:
    """The port's native layer on the card.  (a) ``probe`` on the embedded
    ABI (no ``DRAGPOSER_DEVICE``: the card), ``frames`` frames of the clip,
    against ``capi`` in this process on the card (``NATIVE_TOL``), with
    K2's library removed first so that the host process builds it (its
    seconds apart from the frames); the report from the embedded
    interpreter: the session's device, the card, K2 launched and no plain
    K2, no module of the JAX package.  (b) the frame latency through the
    ABI beside ``[16]``'s (``session``) and this process's capi run.  (c)
    ``probe`` on the socket client with no daemon listening: it starts the
    port's daemon on the card, whose command line and launch counts are
    read and which is then ended; its frames held to the same tolerance."""
    from dragposer_tpu_torch import _build

    shutil.rmtree(NATIVE_WORK_DIR, ignore_errors=True)
    os.makedirs(NATIVE_WORK_DIR)
    t0 = time.time()
    libs = {k: _build.native_library(k) for k in ("abi", "client")}
    probe = build_probe(NATIVE_WORK_DIR)
    res = {"build_s": time.time() - t0,
           "libraries": {k: os.path.basename(v) for k, v in libs.items()}}
    targets = os.path.join(NATIVE_WORK_DIR, "targets.f32")
    write_probe_targets(targets, bvh, frames)
    k2_library = _build.library_path("temporal_forward")
    k2_library.unlink()          # the host's first rollout builds it anew
    abi = run_probe(probe, libs["abi"], targets, skeleton_path, native_env(),
                    os.path.join(NATIVE_WORK_DIR, "abi"), report=True)
    with contextlib.chdir(NATIVE_WORK_DIR):   # capi's session log
        ref, ref_seconds = capi_frames(targets, skeleton_path, "cuda")
    report = abi["report"] or {}
    kernels = report.get("kernels", {})
    a = res["abi"] = {
        "returncode": abi["returncode"], "frames": len(abi["ms"]),
        "max_abs_err": (float(np.abs(abi["frames"] - ref).max())
                        if abi["frames"].shape == ref.shape else None),
        "tolerance": NATIVE_TOL, "devices": report.get("devices"),
        "card": report.get("card"), "launches": kernels,
        "k2_build_s": report.get("build_seconds", {}).get(
            "temporal_forward"),
        "setup_ms": abi["setup_ms"],
        "jax_package_modules": report.get("jax_package_modules"),
        "stderr_tail": abi["stderr"][-300:] if abi["returncode"] else ""}
    res["latency"] = {
        "abi": {**latency_ms(np.asarray(abi["ms"]) / 1e3),
                "first_frame_ms": abi["ms"][0] if abi["ms"] else None},
        "capi_in_process": latency_ms(ref_seconds),
        "session [16]": {k: session[k] for k in ("p50_ms", "p90_ms",
                                                 "p99_ms")}}
    ok = (abi["returncode"] == 0 and abi["ok_line"]
          and a["max_abs_err"] is not None and a["max_abs_err"] <= NATIVE_TOL
          and bool(a["devices"]) and all(d.startswith("cuda")
                                         for d in a["devices"])
          and a["card"] is not None and kernels.get("K2", 0) > 0
          and kernels.get("K2_plain", 1) == 0
          and a["k2_build_s"] is not None and a["jax_package_modules"] == [])

    sock = os.path.join(NATIVE_WORK_DIR, "d.sock")
    t0 = time.time()
    try:
        client = run_probe(probe, libs["client"], targets, skeleton_path,
                           native_env(DRAGPOSER_SOCKET=sock),
                           os.path.join(NATIVE_WORK_DIR, "client"))
    finally:   # the daemon the client started, ended however the run went
        daemon = (spawned_daemon(sock) if os.path.exists(sock)
                  else {"error": "no daemon listens"})
    c = res["client"] = {
        "returncode": client["returncode"], "frames": len(client["ms"]),
        "seconds": time.time() - t0,
        "max_abs_err": (float(np.abs(client["frames"] - ref).max())
                        if client["frames"].shape == ref.shape else None),
        "latency": latency_ms(np.asarray(client["ms"]) / 1e3)
        if client["ms"] else None,
        "setup_ms": client["setup_ms"],
        "stderr_tail": client["stderr"][-300:] if client["returncode"]
        else ""}
    d = c["daemon"] = daemon
    res["ok"] = (ok and client["returncode"] == 0 and client["ok_line"]
                 and c["max_abs_err"] is not None
                 and c["max_abs_err"] <= NATIVE_TOL
                 and d.get("port_module", False)
                 and not d.get("jax_module", True)
                 and d.get("kernels", {}).get("K2", 0) > 0
                 and d["kernels"]["K2_plain"] == 0 and d["ended"])
    return res


# ---------------------------------------------------------------------------
# The wide models (K1's general build), the data-parallel CLI, the .pt import
# ---------------------------------------------------------------------------

# The narrow K1 build's 3xTF32 kernel as the build before the general one
# compiled it on the H100 machine (k1_narrow_sass_digest of that build's
# library): the narrow build must compile to it instruction for instruction
# where the same nvcc release builds it.
K1_NARROW_SASS = dict(
    nvcc="Build cuda_12.9.r12.9/compiler.36037853_0", instructions=4280,
    sha256="1440b5ff62476dda2b53d72810689e07"
           "49bbe8b8d53d0d28b3215886ae26b7aa")
WIDE_LATENT = 48                # a latent width past the narrow build's 32
WIDE_CHAINS = (33, 64)          # chains past its 32 joints and 64 hidden
WIDE_LIMIT = (128, 128)         # a chain at the general build's J and L
# the [3] shape of each general layout's path in [19]
K1_PATH_SHAPES = {"resident": f"example_latent{WIDE_LATENT}",
                  "streamed4": f"chain{WIDE_CHAINS[0]}_latent24",
                  "streamed2": f"chain{WIDE_CHAINS[1]}_latent24",
                  "streamed1": "chain{}_latent{}".format(*WIDE_LIMIT)}
B_LIMIT_PATH = 2048   # [19]'s path at the limits, cut from 8192 for time
WIDE_DIR = os.path.join(WORK_DIR, "wide48")
MESH_WORK_DIR = os.path.join(WORK_DIR, "mesh")
PT_WORK_DIR = os.path.join(WORK_DIR, "pt")


def k1_narrow_sass_gate(digest: dict) -> dict:
    """``digest`` against ``K1_NARROW_SASS``: equal where the same nvcc
    release built both, not comparable otherwise."""
    same_tool = digest["nvcc"] == K1_NARROW_SASS["nvcc"]
    return {"digest": digest, "recorded": K1_NARROW_SASS,
            "comparable": same_tool,
            "ok": not same_tool or (
                digest["instructions"] == K1_NARROW_SASS["instructions"]
                and digest["sha256"] == K1_NARROW_SASS["sha256"])}


def wide_engines(parents, skeleton, device="cuda") -> dict:
    """The models K1's general build serves in the checks: the example
    skeleton at latent 48 (:func:`write_wide_model`, no temporal model),
    chains of ``WIDE_CHAINS`` joints at latent 24 and the chain at the
    build's limits, ``WIDE_LIMIT`` (hidden 136 / 264, 1.52 MB of split
    weights; :func:`wide_engine`).  {name: engine}."""
    from dragposer_tpu_torch.cli.eval_drag import build_engine, resolve_config

    write_wide_model(WIDE_DIR, WIDE_LATENT)
    out = {f"example_latent{WIDE_LATENT}": build_engine(
        WIDE_DIR, parents, resolve_config("6_trackers"), skeleton=skeleton,
        use_temporal=False, device=device)[0]}
    for J, L in [(J, 24) for J in WIDE_CHAINS] + [WIDE_LIMIT]:
        out[f"chain{J}_latent{L}"] = wide_engine(J, L, device=device)[0]
    return out


# One H100 SM: registers (allocated 256 a warp), shared memory (1 KB of it
# reserved a block), warps and blocks it holds at most.
H100_SM = dict(registers=65536, shared_bytes=233472, reserved_bytes=1024,
               warps=64, blocks=32)


def blocks_per_sm(regs: int, threads: int, smem: int, sm=H100_SM) -> int:
    """Blocks an SM holds at ``regs`` registers a thread, ``threads`` a
    block and ``smem`` bytes of shared memory a block (the occupancy
    calculator's rule)."""
    warps = -(-threads // 32)
    regs_warp = -(-regs * 32 // 256) * 256
    return min(sm["registers"] // (regs_warp * warps),
               sm["shared_bytes"] // (smem + sm["reserved_bytes"]),
               sm["warps"] // warps, sm["blocks"])


def k1_launch_config(kctx, opt, fn) -> dict:
    """K1's launch for these inputs as the card reports it
    (``iter_kernel.launch_config``: registers a thread, threads and shared
    memory a block, blocks an SM) or, in a package from before that entry,
    as the profiler's trace of one call of ``fn`` records it (blocks an SM
    then :func:`blocks_per_sm`), with the warps an SM and the waves:
    blocks over blocks an SM × SMs."""
    import torch

    from dragposer_tpu_torch.drag import iter_kernel

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if hasattr(iter_kernel, "launch_config"):
        c = iter_kernel.launch_config(kctx, opt)
        threads, blocks, per_sm = c["threads"], c["blocks"], c["blocks_per_sm"]
        res = {k: c[k] for k in ("registers", "shared_bytes")}
    else:
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        os.makedirs(WORK_DIR, exist_ok=True)
        path = os.path.join(WORK_DIR, "k1_launch_trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        args = next(e.get("args", {}) for e in events
                    if e.get("cat") == "kernel"
                    and "iter_block_kernel" in e.get("name", ""))
        blocks, threads = int(np.prod(args["grid"])), int(
            np.prod(args["block"]))
        res = {"registers": int(args["registers per thread"]),
               "shared_bytes": int(args["shared memory"])}
        per_sm = blocks_per_sm(res["registers"], threads,
                               res["shared_bytes"])
    return {**res, "blocks": blocks, "threads": threads,
            "teams_a_block": threads // 128, "blocks_per_sm": per_sm,
            "warps_per_sm": per_sm * threads // 32,
            "waves": blocks / (per_sm * sms) if per_sm else None}


def k1_resource_usage(library: str = None) -> dict:
    """Registers, stack and local memory of each K1 kernel in a built
    ``iter_block`` library (``cuobjdump --dump-resource-usage``), by the
    kernel's key in :func:`k1_kernels`, as text."""
    from dragposer_tpu_torch import _build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run(
        [tool, "--dump-resource-usage",
         library or str(_build.library_path("iter_block"))],
        capture_output=True, text=True, check=True, timeout=300).stdout
    out = {}
    for fn, usage in re.findall(r"Function\s+(\S+):\s*\n\s*(REG:.*)", text):
        key = k1_kernel_key(fn)
        if key is not None:
            out["/".join(map(str, key))] = " ".join(
                w for w in usage.split() if w.split(":")[0] in (
                    "REG", "STACK", "SHARED", "LOCAL"))
    return out


def check_k1_general(engine, B: int = B_MAIN, plain_calls: int = 1
                     ) -> dict:
    """K1's general build against its twin at sync_k = 1 (with the TF32
    control, which must fail) and at ``SYNC_K`` (timed; the twin timed
    over ``plain_calls`` calls, 0: not timed), with the first-step knife
    lanes (:func:`k1_knife_lanes`) exempt only where
    :func:`k1_agreement` says; at ``SYNC_K`` also its timed build's cycles
    by phase and its launch (:func:`k1_launch_config`), which must be the
    layout ``iter_kernel.general_layout`` picks: its teams a block, shared
    memory and blocks an SM as the card reports them."""
    import torch

    from dragposer_tpu_torch.drag import iter_kernel

    knife = k1_knife_lanes(engine, B)
    one = check_k1(engine, B, 1, timed=False, control=True, knife=knife)
    clocks = gpu_clocks()
    full = check_k1(engine, B, SYNC_K, timed=True, knife=knife,
                    plain_calls=plain_calls)
    full["clocks_sm_mem"] = [clocks, gpu_clocks()]
    J, ws = engine.skeleton.n_joints, engine.model.decoder["ws"]
    full["shape"] = {"J": J, "L": ws[0].shape[1], "H1": ws[0].shape[0],
                     "H2": ws[1].shape[0], "H3": 4 * J + 3}
    args = k1_inputs(engine, B)
    full["phase_cycles"] = iter_kernel.phase_cycles(
        args[0], args[1], engine.hyper, SYNC_K, *args[2:])
    full["launch"] = k1_launch_config(
        args[1], args[2], lambda: iter_kernel.run_block_fused(
            args[0], args[1], engine.hyper, SYNC_K, *args[2:]))
    ok = (one["ok"] and one["tf32_control_refused"] and full["ok"]
          and one["build"] == full["build"] == "general"
          and full["t_mismatch"] <= B // 1000)
    if hasattr(iter_kernel, "general_layout"):
        # the layout the wrapper picked is the one that launched
        shape = full["shape"]
        layout = iter_kernel.general_layout(
            shape["J"], shape["L"], shape["H1"], shape["H2"], B,
            *iter_kernel.device_limits(torch.device("cuda")))
        full["layout"] = layout._asdict()
        launch = full["launch"]
        ok = ok and (full["kernel"] == one["kernel"] == layout.name
                     == full["phase_cycles"]["kernel"]
                     and launch["teams_a_block"] == layout.teams
                     and launch["shared_bytes"] == layout.smem_bytes
                     and launch["blocks_per_sm"] == layout.blocks_per_sm)
    return {"sync_k_1": one, f"sync_k_{SYNC_K}": full, "ok": ok}


@contextlib.contextmanager
def k1_layout(name: str):
    """Inside, K1's general build takes the layout ``name`` wherever it
    fits (``general_layout(prefer=name)``), to time one layout against the
    other."""
    from dragposer_tpu_torch.drag import iter_kernel

    pick = iter_kernel.general_layout
    iter_kernel.general_layout = lambda *a: pick(*a, prefer=name)
    try:
        yield
    finally:
        iter_kernel.general_layout = pick


def k1_general_figures(B: int = B_MAIN) -> dict:
    """K1's general build for a parent/change comparison, from whatever
    ``dragposer_tpu_torch`` is first on the path: the card; at each shape
    of [3] (:func:`wide_engines`, the limit shape included) at B lanes and
    sync_k = 24, :func:`check_k1_general` (its own device time, its phase
    cycles, its launch; the twin untimed) and, in a package with two
    layouts, the other layout's own time where it fits; the registers of
    every K1 kernel; then [19]'s path at latent 48 (B × ``T_MAIN``) timed,
    and the tile efficiency of its launches."""
    import torch

    from dragposer_tpu_torch.cli.eval_drag import build_engine, resolve_config
    from dragposer_tpu_torch.data import encoding
    from dragposer_tpu_torch.drag import iter_kernel
    from dragposer_tpu_torch.ops.topology import Skeleton

    bvh = load_clip(T_MAIN, SEED)
    _, _, parents, offsets, _ = encoding.info_from_bvh(bvh)
    skeleton = Skeleton.build(parents, offsets, bvh.names)
    res = {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), "clocks": [gpu_clocks()], "shapes": {}}
    keep = ("ms", "wrapper_device_ms", "event_ms", "bound_ms", "steps",
            "max_abs_err", "lanes_over_tol", "knife_lanes", "shape",
            "kernel", "layout", "phase_cycles", "launch")
    for name, engine in wide_engines(parents, skeleton).items():
        r = check_k1_general(engine, B, plain_calls=0)
        full = r[f"sync_k_{SYNC_K}"]
        res["shapes"][name] = {"ok": r["ok"],
                               **{k: full[k] for k in keep if k in full}}
        for other in getattr(iter_kernel, "LAYOUTS", ()):
            if other == full["kernel"]:
                continue
            with k1_layout(other):   # the other layouts, where they fit
                alt = check_k1(engine, B, SYNC_K, plain_calls=0)
            if alt["kernel"] == other:
                res["shapes"][name][other] = {
                    k: alt[k] for k in ("ms", "max_abs_err",
                                        "lanes_over_tol")}
    res["resources"] = k1_resource_usage()
    write_wide_model(WIDE_DIR, WIDE_LATENT)
    engine, means, stds = build_engine(
        WIDE_DIR, parents, resolve_config("6_trackers"), skeleton=skeleton,
        use_temporal=False)
    states, dqs, gp, gr = lane_batch(engine, bvh, means, stds, B, T_MAIN)
    torch.cuda.synchronize()
    t0 = time.time()
    engine.run_batch_pipelined(states, dqs, gp, gr, sync_k=SYNC_K)
    torch.cuda.synchronize()
    seconds = time.time() - t0
    with k1_steps_recorded() as steps:
        engine.run_batch_pipelined(states, dqs, gp, gr, sync_k=SYNC_K)
    res["path_latent48"] = {"seconds": seconds,
                            "frames_per_s": B * T_MAIN / seconds,
                            "tile_efficiency": tile_efficiency(steps, 16)}
    res["clocks"].append(gpu_clocks())
    return res


def wide_path(bvh, parents, skeleton, B: int = B_MAIN, T: int = T_MAIN
              ) -> dict:
    """The pipelined path at latent 48 (the example skeleton, 6 trackers,
    no temporal model) through K1's general build: :func:`general_path`."""
    from dragposer_tpu_torch.cli.eval_drag import build_engine, resolve_config

    write_wide_model(WIDE_DIR, WIDE_LATENT)
    engines, means, stds = {}, None, None
    for dev in ("cuda", "cpu"):
        engines[dev], means, stds = build_engine(
            WIDE_DIR, parents, resolve_config("6_trackers"),
            skeleton=skeleton, use_temporal=False, device=dev)
    res = general_path(engines, bvh, means, stds, skeleton, B, T)
    return {"latent_dim": WIDE_LATENT, **res}


def chain_path(n_joints: int = WIDE_CHAINS[0], latent: int = 24,
               B: int = B_MAIN, T: int = T_MAIN) -> dict:
    """The pipelined path on a chain of ``n_joints`` at ``latent``
    (:func:`wide_engine`, its seeded clip :func:`synthetic_chain_bvh`)
    through K1's general build: :func:`general_path`."""
    engines = {dev: wide_engine(n_joints, latent, device=dev)[0]
               for dev in ("cuda", "cpu")}
    _, means, stds, _ = wide_generator(chain_parents(n_joints), latent)
    # at least the 24 frames of the lockstep
    res = general_path(engines, synthetic_chain_bvh(n_joints, max(T, 24)),
                       means, stds, engines["cuda"].skeleton, B, T)
    return {"n_joints": n_joints, "latent_dim": latent, **res}


def general_path(engines, bvh, means, stds, skeleton, B: int, T: int
                 ) -> dict:
    """The pipelined path of ``engines["cuda"]`` (a model past the narrow
    build) on the card: B lanes × T frames with the launch counts set to 0
    just before and read just after (the general build must launch, in
    the layout ``iter_kernel.launch_build`` names, no plain K1 call and no
    aux rebuild), frames/s and the tile efficiency of its launches; then a
    small batch (8 × 24) card against ``engines["cpu"]`` at one Adam step
    a frame (``one_step_lockstep``)."""
    import torch

    from dragposer_tpu_torch.drag import fast_iter, iter_kernel
    from dragposer_tpu_torch.ops import temporal_fused

    engine = engines["cuda"]
    states, dqs, gp, gr = lane_batch(engine, bvh, means, stds, B, T)
    torch.cuda.synchronize()
    reset_kernel_counts()
    t0 = time.time()
    with k1_steps_recorded() as steps:
        _, out = engine.run_batch_pipelined(states, dqs, gp, gr,
                                            sync_k=SYNC_K)
    torch.cuda.synchronize()
    seconds = time.time() - t0
    launches = {"K1_general": iter_kernel.GENERAL_COUNTS.kernel,
                **{f"K1_general_{n}": c.kernel
                   for n, c in iter_kernel.LAYOUT_COUNTS.items()},
                "K1": fast_iter.COUNTS.kernel,
                "K1_plain": fast_iter.COUNTS.plain,
                "K1_aux_rebuilds": fast_iter.COUNTS.aux,
                "K2": temporal_fused.COUNTS.kernel}
    J = skeleton.n_joints
    ws = engine.model.decoder["ws"]
    layout = iter_kernel.general_layout(
        J, ws[0].shape[1], ws[0].shape[0], ws[1].shape[0], B,
        *iter_kernel.device_limits(torch.device("cuda")))
    res = {"B": B, "T": T, "seconds": seconds,
           "frames_per_s": B * T / seconds,
           "mean_iterations": float(out.iterations.float().mean()),
           "lane0_mpjpe_m": lane_mpjpe(out, bvh, means, stds, skeleton, T),
           "launches": launches, "layout": layout._asdict(),
           "tile_efficiency": tile_efficiency(steps, 16)}
    shapes_ok = (tuple(out.pose.shape) == (B, T, 4 * J)
                 and bool(torch.isfinite(out.pose).all())
                 and bool(torch.isfinite(out.latent).all())
                 and int(out.iterations.min()) >= 1)
    gargs, cargs = _card_and_cpu_args(
        engine, *lane_batch(engines["cpu"], bvh, means, stds, 8, 24))
    lockstep = dict(KNIFE_FREE, max_iter=1)
    before = iter_kernel.GENERAL_COUNTS.kernel
    ref = one_step_lockstep(_run_pipelined(engine, gargs, lockstep),
                            _run_pipelined(engines["cpu"], cargs, lockstep))
    ref["card_general_launches"] = iter_kernel.GENERAL_COUNTS.kernel - before
    res["card_vs_cpu"] = ref
    res["ok"] = (shapes_ok and launches["K1_general"] > 0
                 and launches[f"K1_general_{layout.name}"]
                 == launches["K1_general"]
                 and not launches["K1_plain"] and not launches["K1"]
                 and not launches["K1_aux_rebuilds"] and ref["one_step_ok"]
                 and ref["card_general_launches"] > 0)
    return res


def _cli(argv) -> tuple:
    """``cli.eval_drag.main(argv)``: its results and its printed
    frames/s."""
    import io

    from dragposer_tpu_torch.cli import eval_drag

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        results = eval_drag.main(argv)
    rate = re.findall(r"\(([0-9.]+) frames/s\)", buf.getvalue())
    return results, float(rate[-1]) if rate else None


def mesh_cli_runs(work_dir: str = MESH_WORK_DIR, mesh: int = 1,
                  n_clips: int = 2, device: str = None) -> dict:
    """``eval_drag --batch`` on ``n_clips`` synthetic clips on one device
    ("plain": no ``--mesh``, whose default is one device), and the same with
    ``--mesh N`` (in turns: plain, mesh, mesh, plain): the metrics and
    each run's frames/s.  At N = 1 both take the one-device path, so the
    metrics and the exported BVH files must be equal.  At N > 1 the lanes
    run on N cards (``eval_drag._run_sharded``, which must run, with
    finite metrics), each piece at another lane count, which cuBLAS may
    round differently; under the full stop rule one flipped iteration
    sends a lane down another trajectory, so the metrics' difference is
    reported and not gated: :func:`mesh_lockstep` holds the sharded path's
    values, at one Adam step a frame."""
    from dragposer_tpu_torch.cli import eval_drag

    os.makedirs(work_dir, exist_ok=True)
    files = write_synthetic_clips(
        work_dir, tuple(T_CLI - 4 * (i % 5) for i in range(n_clips)),
        SEED + 5)
    runs = {"plain": {"frames_per_s": []}, "mesh": {"frames_per_s": []}}
    sharded = []
    real = eval_drag._run_sharded

    def counted(*args, **kwargs):
        sharded.append(args[1])
        return real(*args, **kwargs)

    eval_drag._run_sharded = counted
    try:
        for name in ("plain", "mesh", "mesh", "plain"):
            # the reference is the default, one device
            extra = ["--mesh", str(mesh)] if name == "mesh" else []
            if device is not None:
                extra += ["--device", device]
            out = os.path.join(work_dir, name)
            results, rate = _cli([MODEL_DIR, *files, "--batch",
                                  "--save-dir", out, *extra])
            runs[name]["results"] = [list(map(float, r)) for r in results]
            runs[name]["frames_per_s"].append(rate)
    finally:
        eval_drag._run_sharded = real
    plain, other = (np.asarray(runs[n]["results"]) for n in ("plain",
                                                             "mesh"))
    res = {"mesh_devices": mesh, "clips": n_clips, **runs,
           "sharded_runs": len(sharded),
           "max_abs_metric_diff": float(np.abs(plain - other).max())}
    finite = bool(np.isfinite(plain).all())
    if mesh == 1:
        res["bvh_files_equal"] = all(
            open(os.path.join(work_dir, "plain", "eval_"
                              + os.path.basename(f)), "rb").read()
            == open(os.path.join(work_dir, "mesh", "eval_"
                                 + os.path.basename(f)), "rb").read()
            for f in files)
        res["ok"] = (finite and res["bvh_files_equal"] and not sharded
                     and bool((plain == other).all()))
    else:
        res["ok"] = (finite and bool(np.isfinite(other).all())
                     and sharded == [mesh, mesh])
    return res


def mesh_lockstep(n_dev: int, B: int = 7, T: int = 24, device=None) -> dict:
    """``eval_drag._run_sharded`` over ``n_dev`` local cards (B lanes
    padded to a multiple of ``n_dev``; at 1, the sharded path's replica,
    stream and thread on one card) against ``run_batch_pipelined`` on one,
    from the same states, at one Adam step a frame (``one_step_lockstep``:
    iterations equal, latent 1e-4, root 1e-5, pose rtol 1e-3 / atol
    2e-3), with the shards' wall time beside the one-card run's."""
    import torch

    from dragposer_tpu_torch.cli import eval_drag
    from dragposer_tpu_torch.cli.eval_drag import build_engine, resolve_config
    from dragposer_tpu_torch.data import encoding
    from dragposer_tpu_torch.drag.engine import FrameOutput, to_host
    from dragposer_tpu_torch.ops.topology import Skeleton

    bvh = load_clip(T_MAIN, SEED)
    _, _, parents, offsets, _ = encoding.info_from_bvh(bvh)
    engine, means, stds = build_engine(
        MODEL_DIR, parents, resolve_config("6_trackers"),
        skeleton=Skeleton.build(parents, offsets, bvh.names), device=device)
    states, dqs, gp, gr = lane_batch(engine, bvh, means, stds, B, T)
    lengths = np.full(B, T, np.int32)
    lengths[1::3] = T - 5
    tens = lambda o: FrameOutput(*[torch.as_tensor(x) for x in o])  # noqa: E731
    with hyper_override(engine, **dict(KNIFE_FREE, max_iter=1)):
        t0 = time.time()
        sharded = eval_drag._run_sharded(engine, n_dev, states, dqs, gp, gr,
                                         lengths, SYNC_K)
        t1 = time.time()
        _, one = engine.run_batch_pipelined(states, dqs, gp, gr,
                                            sync_k=SYNC_K, lengths=lengths)
        one = to_host(one)
        t2 = time.time()
    res = one_step_lockstep(tens(sharded), tens(one))
    res.update(cards=n_dev, lanes=B, frames=T, sharded_s=t1 - t0,
               one_card_s=t2 - t1, ok=res.pop("one_step_ok"))
    return res


class _InlineThread:
    """``threading.Thread`` whose ``start`` runs the target at once: the
    sharded path's shards one after another in the calling thread."""

    def __init__(self, target, args=()):
        self.target, self.args = target, args

    def start(self):
        self.target(*self.args)

    def join(self):
        pass


def mesh_scaling(cards=(1, 2, 4), B: int = B_MAIN, T: int = T_MAIN,
                 device=None, devices=None) -> dict:
    """Not gated: where the sharded eval (``eval_drag._run_sharded``) spends
    its time, on the main path's model and size (6 trackers, B lanes × T
    frames, the full stop rule).  The engine replicas are built and each
    card warmed by one short sharded run before any clock starts.  For each
    N of ``cards``: the shards in their threads (as ``--mesh N`` runs
    them) and the same shards one after another in one thread, each with
    every shard's wall time, its thread's CPU time (``time.thread_time``)
    and its start against the first; beside them ``run_batch_pipelined``
    on one card over all B lanes.  If the threads' wall time is near the
    one-after-another time, the shards do not overlap: they wait on each
    other's host work (one interpreter).  ``devices``: the devices the
    shards may take (default every local one); one card named four times
    runs four threads, streams and replicas on that card."""
    import types

    import torch

    from dragposer_tpu_torch.cli import eval_drag
    from dragposer_tpu_torch.cli.eval_drag import build_engine, resolve_config
    from dragposer_tpu_torch.data import encoding
    from dragposer_tpu_torch.drag.engine import DragEngine
    from dragposer_tpu_torch.ops.topology import Skeleton
    from dragposer_tpu_torch.parallel import mesh as meshlib

    bvh = load_clip(T_MAIN, SEED)
    _, _, parents, offsets, _ = encoding.info_from_bvh(bvh)
    engine, means, stds = build_engine(
        MODEL_DIR, parents, resolve_config("6_trackers"),
        skeleton=Skeleton.build(parents, offsets, bvh.names), device=device)
    states, dqs, gp, gr = lane_batch(engine, bvh, means, stds, B, T)
    lengths = np.full(B, T, np.int32)
    devices = list(devices or meshlib.local_devices(engine.device.type))
    shards, real = [], DragEngine.run_batch_pipelined

    def sync():
        if engine.device.type == "cuda":
            for d in devices:
                torch.cuda.synchronize(d)

    def timed(self, *args, **kwargs):
        t0, c0 = time.perf_counter(), time.thread_time()
        out = real(self, *args, **kwargs)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        shards.append({"device": str(self.device), "t0": t0,
                       "wall_s": time.perf_counter() - t0,
                       "thread_cpu_s": time.thread_time() - c0})
        return out

    def run(n, inline):
        shards.clear()
        with contextlib.ExitStack() as ctx:
            if inline:
                ctx.enter_context(_swapped(eval_drag, threading=(
                    types.SimpleNamespace(Thread=_InlineThread))))
            sync()
            t0 = time.perf_counter()
            eval_drag._run_sharded(engine, n, states, dqs, gp, gr, lengths,
                                   SYNC_K)
            wall = time.perf_counter() - t0
        first = min(r["t0"] for r in shards)
        return {"wall_s": wall, "frames_per_s": B * T / wall,
                "shards": [{"device": r["device"],
                            "start_s": r["t0"] - first,
                            "wall_s": r["wall_s"],
                            "thread_cpu_s": r["thread_cpu_s"]}
                           for r in sorted(shards, key=lambda r: r["t0"])]}

    res = {"lanes": B, "frames": T, "cards": list(cards),
           "devices": [str(d) for d in devices]}
    with _swapped(meshlib, local_devices=lambda kind=None: devices), \
            _swapped(DragEngine, run_batch_pipelined=timed):
        for n in cards:             # replicas built, every card warmed
            eval_drag._run_sharded(engine, n, states, dqs[:, :8], gp[:, :8],
                                   gr[:, :8], np.full(B, 8, np.int32), SYNC_K)
        sync()
        t0 = time.perf_counter()
        engine.run_batch_pipelined(states, dqs, gp, gr, sync_k=SYNC_K)
        sync()
        wall = time.perf_counter() - t0
        res["one_card"] = {"wall_s": wall, "frames_per_s": B * T / wall}
        for n in cards:
            res[f"threads_{n}"] = run(n, inline=False)
            res[f"one_after_another_{n}"] = run(n, inline=True)
    return res


def write_reference_pt(out_dir: str, model_dir: str = MODEL_DIR,
                       break_mask: bool = False,
                       break_pool: bool = False) -> None:
    """The model of ``model_dir`` as the reference stores it
    (``python/src/train.py:257-319`` of the reference): ``generator.pt``
    (its state dict with the conv masks and pool/unpool matrices stored
    beside the weights; ``break_mask`` / ``break_pool`` change one entry
    of one, which the import must refuse), ``data.pt`` (means and stds)
    and ``temporal.pt`` (nn.Transformer names, the positional encoding's
    buffer, the latent statistics)."""
    import math

    import torch

    from dragposer_tpu_torch import config as cfg
    from dragposer_tpu_torch.models import checkpoint, vae

    t = lambda a: torch.from_numpy(np.array(a, np.float32))  # noqa: E731
    params, extra = checkpoint.load(os.path.join(model_dir, "generator.npz"))
    st = vae.build_statics(EXAMPLE_PARENTS, cfg.VAE_PARAM)
    sd, enc, dec = {}, params["encoder"], params["decoder"]
    for l in range(vae.N_LAYERS):
        pre = f"autoencoder.encoder.layers.{l}"
        mask, pool = np.array(st.enc_masks[l]), np.array(st.enc_pools[l])
        if break_mask and l == 1:
            mask.flat[0] = 1.0 - mask.flat[0]
        if break_pool and l == 2:
            pool.flat[0] += 1e-3
        sd.update({f"{pre}.0.weight": t(enc["convs"][l]["w"]),
                   f"{pre}.0.bias": t(enc["convs"][l]["b"]),
                   f"{pre}.0.mask": t(mask), f"{pre}.1.weight": t(pool)})
        pre = f"autoencoder.decoder.layers.{l}"
        sd.update({f"{pre}.0.weight": t(st.dec_unpools[l]),
                   f"{pre}.1.weight": t(dec["convs"][l]["w"]),
                   f"{pre}.1.bias": t(dec["convs"][l]["b"]),
                   f"{pre}.1.mask": t(st.dec_masks[l])})
    for name, p in (("encoder.f_mu", enc["f_mu"]),
                    ("encoder.f_logvar", enc["f_logvar"]),
                    ("decoder.f_latent", dec["f_latent"])):
        sd[f"autoencoder.{name}.weight"] = t(p["w"])
        sd[f"autoencoder.{name}.bias"] = t(p["b"])
    os.makedirs(out_dir, exist_ok=True)
    torch.save({"model_state_dict": sd},
               os.path.join(out_dir, "generator.pt"))
    torch.save({k: {n: t(v) for n, v in extra[k].items()}
                for k in ("means", "stds")}, os.path.join(out_dir, "data.pt"))

    tp, textra = checkpoint.load(os.path.join(model_dir, "temporal.npz"))
    sd = {}

    def lin(pre, p):
        sd[f"{pre}.weight"], sd[f"{pre}.bias"] = t(p["w"]), t(p["b"])

    def attn(pre, p):
        sd.update({f"{pre}.in_proj_weight": t(p["in_w"]),
                   f"{pre}.in_proj_bias": t(p["in_b"]),
                   f"{pre}.out_proj.weight": t(p["out_w"]),
                   f"{pre}.out_proj.bias": t(p["out_b"])})

    def ln(pre, p):
        sd[f"{pre}.weight"], sd[f"{pre}.bias"] = t(p["g"]), t(p["b"])

    lin("in_proj_encoder", tp["in_proj_enc"])
    lin("in_proj_decoder", tp["in_proj_dec"])
    lin("out_proj", tp["out_proj"])
    for kind, layers in (("encoder", tp["enc_layers"]),
                         ("decoder", tp["dec_layers"])):
        for i, lp in enumerate(layers):
            pre = f"temporal.{kind}.layers.{i}"
            attn(f"{pre}.self_attn", lp["self_attn"])
            if kind == "decoder":
                attn(f"{pre}.multihead_attn", lp["cross_attn"])
                ln(f"{pre}.norm3", lp["ln3"])
            lin(f"{pre}.linear1", lp["ff1"])
            lin(f"{pre}.linear2", lp["ff2"])
            ln(f"{pre}.norm1", lp["ln1"])
            ln(f"{pre}.norm2", lp["ln2"])
    ln("temporal.encoder.norm", tp["enc_norm"])
    ln("temporal.decoder.norm", tp["dec_norm"])
    d, n = 48, 30
    pe = torch.zeros(n, d)
    pos = torch.arange(0, n, dtype=torch.float).view(-1, 1)
    div = torch.exp(torch.arange(0, d, 2).float() * (-math.log(10000.0)) / d)
    pe[:, 0::2], pe[:, 1::2] = torch.sin(pos * div), torch.cos(pos * div)
    sd["positional_encoding.pos_encoding"] = pe
    torch.save({"model_state_dict": sd,
                "means_latent": t(textra["means_latent"]),
                "stds_latent": t(textra["stds_latent"])},
               os.path.join(out_dir, "temporal.pt"))


def pt_round_trip(bvh, parents, skeleton, work_dir: str = PT_WORK_DIR,
                  B: int = 16, T: int = 24) -> dict:
    """The reference's ``.pt`` files of the example model
    (:func:`write_reference_pt`) on the card: ``cli.import_checkpoint``
    writes ``.npz`` files equal to the example's, and an engine built from
    the ``.pt`` directory (``models/loading.py``'s fallback) computes the
    example engine's pipelined batch exactly (B × T, K1 + K2)."""
    import torch

    from dragposer_tpu_torch.cli import import_checkpoint
    from dragposer_tpu_torch.cli.eval_drag import build_engine, resolve_config
    from dragposer_tpu_torch.models import checkpoint

    pt_dir, out_dir = (os.path.join(work_dir, n) for n in ("reference",
                                                           "imported"))
    write_reference_pt(pt_dir)
    import io
    with contextlib.redirect_stdout(io.StringIO()):
        import_checkpoint.main([pt_dir, out_dir, clip_path(SEED)])

    def leaves(tree):
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in leaves(tree[k])]
        if isinstance(tree, (list, tuple)):
            return [x for v in tree for x in leaves(v)]
        return [np.asarray(tree)]

    npz_equal = all(
        len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))
        for name in ("generator.npz", "temporal.npz")
        for a, b in [(leaves(checkpoint.load(os.path.join(out_dir, name))),
                      leaves(checkpoint.load(os.path.join(MODEL_DIR,
                                                          name))))])
    outs = {}
    for name, d in (("pt", pt_dir), ("npz", MODEL_DIR)):
        engine, means, stds = build_engine(
            d, parents, resolve_config("6_trackers"), skeleton=skeleton)
        args = lane_batch(engine, bvh, means, stds, B, T)
        outs[name] = _run_pipelined(engine, args, {})
    same = all(torch.equal(a, b) for a, b in zip(outs["pt"], outs["npz"]))
    return {"npz_files_equal": npz_equal, "pipelined_outputs_equal": same,
            "ok": npz_equal and same}


def realtime_launches(name: str, session: dict, crowd: dict,
                      daemon: dict) -> dict:
    """Kernel ``name``'s launches on each realtime path ([16]-[18])."""
    return {"realtime session [16]": session["launches"][name],
            "RealtimeBatch [17]": (crowd["one_frame"]["launches"][name]
                                   + sum(c[name] for c in
                                         crowd["launches"].values())),
            "daemon [18]": daemon["launches"][name]}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    raise SystemExit(1)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    t_start = time.time()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print("[1] card (nvidia-smi name, power.limit):")
    print(smi, flush=True)

    from dragposer_tpu_torch import _build
    from dragposer_tpu_torch._device import resolve_device
    from dragposer_tpu_torch.cli.eval_drag import build_engine, resolve_config
    from dragposer_tpu_torch.data import encoding
    from dragposer_tpu_torch.drag import fast_iter, iter_kernel
    from dragposer_tpu_torch.ops import temporal_fused
    from dragposer_tpu_torch.ops.topology import Skeleton

    resolve_device("cuda")
    sources = ["iter_block", "temporal_forward", "ff_lanes", "ff_rows",
               "attn_lanes"]
    logs = _build.build_all(sources)
    ptx = [ln.strip() for name in sources for ln in logs[name].splitlines()
           if "registers" in ln or "spill" in ln]
    print(f"[2] built {', '.join(n + '.cu' for n in sources)} in "
          f"{logs['_seconds']} s (nvcc -arch sm_90a); ptxas: "
          + " | ".join(ptx), flush=True)
    for name, source, function in (
            ("K1", "iter_block", None), ("K2", "temporal_forward", None),
            ("K3a", "ff_rows", "ff_fwd_kernel"),
            ("K3b", "ff_rows", "ff_bwd_kernel"),
            ("K3c", "ff_lanes", "ff_fwd_kernel"),
            ("K3d", "ff_lanes", "ff_bwd_kernel")):
        n_mma = sass_mma_count(source, function)
        print(f"[2] {name} SASS (cuobjdump -sass): {n_mma} HMMA/HGMMA "
              "instructions", flush=True)
        if n_mma == 0:
            fail(f"{name}'s SASS has no tensor-core instruction")
    r = k1_narrow_sass_gate(k1_narrow_sass_digest())
    print("[2] K1's narrow build against the build before the general one "
          "(SASS of its 3xTF32 kernel): " + json.dumps(r), flush=True)
    if not r["ok"]:
        fail(f"K1's narrow build no longer compiles as it did: {r}")
    bvh = load_clip(T_MAIN, SEED)
    _, _, parents, offsets, _ = encoding.info_from_bvh(bvh)
    skeleton = Skeleton.build(parents, offsets, bvh.names)
    engine, means, stds = build_engine(MODEL_DIR, parents,
                                       resolve_config("6_trackers"),
                                       skeleton=skeleton)

    k1_main = None
    for sync_k, per_lane in ((1, False), (1, True), (SYNC_K, True),
                             (SYNC_K, False)):
        main_shape = sync_k == SYNC_K and not per_lane
        clocks = gpu_clocks()
        control = sync_k == 1 and not per_lane
        r = check_k1(engine, B_MAIN, sync_k, per_lane=per_lane,
                     timed=main_shape, control=control)
        if main_shape:
            r["clocks_sm_mem"] = [clocks, gpu_clocks()]
        print(f"[3] K1 B={B_MAIN} sync_k={sync_k} per_lane={per_lane}: "
              + json.dumps(r), flush=True)
        if control and not r["tf32_control_refused"]:
            fail(f"K1_TOL passes K1 with its products in one TF32 pass: {r}")
        if not r["ok"] or r["t_mismatch"] > B_MAIN // 1000:
            fail(f"K1 disagrees with its plain twin: {r}")
        if main_shape:
            k1_main = r
    print(f"[3] K1's plain twin on the card vs on the CPU, B={B_TWIN_CPU} "
          "sync_k=1 (K1_TOL on the raw pose and on pose · std): "
          + json.dumps(k1_twin_card_vs_cpu(engine, B_TWIN_CPU)), flush=True)
    args = k1_inputs(engine, B_MAIN)
    phases = iter_kernel.phase_cycles(args[0], args[1], engine.hyper, SYNC_K,
                                      *args[2:])
    print(f"[3] K1 B={B_MAIN} sync_k={SYNC_K}, its timed build (SM clock "
          "cycles per warp-step by phase): " + json.dumps(phases), flush=True)
    k1_general = {}
    for name, wide in wide_engines(parents, skeleton).items():
        t3 = time.time()
        # the twin is timed at the paths' shapes ([19]) only
        r = check_k1_general(wide, plain_calls=int(
            name in K1_PATH_SHAPES.values()))
        r["check_s"] = time.time() - t3
        k1_general[name] = r
        print(f"[3] K1 general build, {name}, B={B_MAIN} (at most B // 1000 "
              f"lanes over K1_TOL; TF32 control at sync_k=1; the layout "
              f"general_layout picks, its phase cycles and launch): "
              + json.dumps(r), flush=True)
        if not r["ok"]:
            fail(f"K1's general build disagrees with its plain twin, or "
                 f"K1_TOL passes its TF32 control: {r}")

    k2_main, k2_long = None, {}
    # the main path's shape (S_dec = 1), the windowed configs' (5), and the
    # realtime rollouts' at window 60 (16) and at the longest window the
    # positional encoding allows, 119 (30: the build for 32 steps)
    for s_dec, kind in ((5, "row"), (5, "square"), (1, "row"), (16, "row"),
                        (30, "row"), (30, "square")):
        main_shape = s_dec == 1
        timed = main_shape or (s_dec in (16, 30) and kind == "row")
        clocks = gpu_clocks()
        r = check_k2(engine, B_MAIN, s_dec, kind, timed=timed,
                     library=timed, control=True)
        if timed:
            r["clocks_sm_mem"] = [clocks, gpu_clocks()]
        if main_shape:
            r["perf_md_ms"] = K2_PERF_MD_MS
        print(f"[4] K2 B={B_MAIN} S_enc=14 S_dec={s_dec} mask={kind}: "
              + json.dumps(r), flush=True)
        if not r["tf32_control_refused"]:
            fail(f"K2_TOL passes the plain twin with TF32 matmuls: {r}")
        if not r["ok"]:
            fail(f"K2 disagrees with its plain twin: {r}")
        if main_shape:
            if r["library_err"] > 1e-3:
                fail(f"nn.Transformer yardstick computes another function: "
                     f"{r['library_err']}")
            k2_main = r
        elif timed:
            k2_long[s_dec] = r

    # ---- the main path ----
    states, dqs, gp, gr = lane_batch(engine, bvh, means, stds, B_MAIN,
                                     T_MAIN)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in (fast_iter.COUNTS, temporal_fused.COUNTS):
        c.reset()
    clocks = [gpu_clocks()]
    t0 = time.time()
    with k1_steps_recorded() as k1_steps:
        _, out = engine.run_batch_pipelined(states, dqs, gp, gr,
                                            sync_k=SYNC_K)
    torch.cuda.synchronize()
    seconds = time.time() - t0
    clocks.append(gpu_clocks())
    launches = {"K1": fast_iter.COUNTS.kernel,
                "K2": temporal_fused.COUNTS.kernel,
                "K1_plain": fast_iter.COUNTS.plain,
                "K1_aux_rebuilds": fast_iter.COUNTS.aux,
                "K2_plain": temporal_fused.COUNTS.plain}
    tiles = tile_efficiency(k1_steps, iter_kernel.TILE_LANES)
    shapes_ok = (tuple(out.pose.shape) == (B_MAIN, T_MAIN, 88)
                 and bool(torch.isfinite(out.pose).all())
                 and bool(torch.isfinite(out.global_pos).all())
                 and int(out.iterations.min()) >= 1)
    mpjpe = lane_mpjpe(out, bvh, means, stds, skeleton, T_MAIN)
    mpjpe_mean = mean_mpjpe(out, bvh, means, stds, skeleton, T_MAIN)
    main_res = {"B": B_MAIN, "T": T_MAIN, "sync_k": SYNC_K,
                "seconds": seconds,
                "frames_per_s": B_MAIN * T_MAIN / seconds,
                "mean_iterations": float(out.iterations.float().mean()),
                "lane0_mpjpe_m": mpjpe,
                f"mean_mpjpe_m_first_{MAIN_MPJPE_LANES}_lanes": mpjpe_mean,
                "launches": launches,
                "k1_tile_efficiency": tiles,
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                "clocks_sm_mem": clocks}
    print("[5] main path 6_trackers, model_dancedb_example: "
          + json.dumps(main_res), flush=True)
    if not shapes_ok:
        fail("main path output has the wrong shape or non-finite values")
    if launches["K1"] == 0 or launches["K2"] == 0:
        fail(f"a kernel of the main path never launched: {launches}")
    if launches["K1_plain"] or launches["K2_plain"] or \
            launches["K1_aux_rebuilds"]:
        fail(f"plain code of a kernel ran on the main path: {launches}")
    if not mpjpe < 0.2:
        fail(f"lane-0 MPJPE {mpjpe} m is not a reconstruction")
    if (abs(mpjpe - MAIN_MPJPE_M) > 1e-4
            or abs(mpjpe_mean - MAIN_MEAN_MPJPE_M) > 1e-4 or abs(
            main_res["mean_iterations"] - MAIN_MEAN_ITERATIONS)
            > 0.01 * MAIN_MEAN_ITERATIONS):
        fail(f"the main path's results moved: {main_res}")

    prof = profile_main_path(engine, states, dqs, gp, gr, T_PROFILE)
    print(f"[5] device time of the main path, first {T_PROFILE} frames "
          "(torch.profiler): " + json.dumps(prof), flush=True)

    cpu_engine, _, _ = build_engine(MODEL_DIR, parents,
                                    resolve_config("6_trackers"),
                                    skeleton=skeleton, device="cpu")
    ref = check_against_cpu(engine, cpu_engine, bvh, means, stds)
    print("[5] main path on the card vs on the CPU (B=8, T=24): "
          + json.dumps(ref), flush=True)
    if not (ref["lockstep_ok"] and ref["stop_rule_ok"]):
        fail(f"the card's main path disagrees with the CPU's: {ref}")
    win = check_windowed_against_cpu("4_trackers", bvh)
    print("[5] windowed path 4_trackers on the card vs on the CPU (B=24, "
          "T=24, staggered window phases, one Adam step a frame; K2 "
          "launches by lane count): " + json.dumps(win), flush=True)
    if not win["ok"]:
        fail(f"the card's windowed path disagrees with the CPU's, or ran "
             f"no sub-batch rollout through K2: {win}")

    # ---- K3 and K4 against their plain twins ----
    k3_main = k3_big = None
    for B, rate in ((B_TRAIN, 0.1), (B_TRAIN, 0.0), (B_PROFILED, 0.1),
                    (B_PROFILED, 0.0)):
        clocks = gpu_clocks()
        r = check_k3(15, B, rate, timed=rate > 0 or B == B_TRAIN)
        r["clocks_sm_mem"] = [clocks, gpu_clocks()]
        print(f"[6] K3c/K3d S=15 B={B} rate={rate}: " + json.dumps(r),
              flush=True)
        if not r["ok"]:
            fail(f"K3 disagrees with its plain twin, or K3_TOL passes the "
                 f"TF32 control: {r}")
        if (B, rate) == (B_TRAIN, 0.1):
            k3_main = r
        elif (B, rate) == (B_PROFILED, 0.1):
            k3_big = r
    gate_probe("[6]", "lanes")
    k4_main = k4_big = None
    # the trainer's three shapes (encoder, cross, causal decoder), then a
    # scattered non-causal mask, a fully masked query row, one query, one
    # lane and a lane count no 8-lane group divides (single floats)
    for B, sq, sk, kind in ((B_TRAIN, 14, 14, "zero"),
                            (B_TRAIN, 15, 14, "zero"),
                            (B_TRAIN, 15, 15, "causal"),
                            (B_PROFILED, 15, 15, "causal"),
                            (B_TRAIN, 15, 15, "scattered"),
                            (B_TRAIN, 15, 15, "dead_row"),
                            (B_TRAIN, 1, 15, "zero"),
                            (1, 15, 15, "causal"),
                            (130, 15, 14, "scattered")):
        main_shape = sq == sk == 15 and kind == "causal" and B > 1
        clocks = gpu_clocks()
        r = check_k4(sq, sk, B, kind, timed=main_shape, library=main_shape)
        if main_shape:
            r["clocks_sm_mem"] = [clocks, gpu_clocks()]
        print(f"[7] K4a/K4b B={B} Sq={sq} Sk={sk} mask={kind}: "
              + json.dumps(r), flush=True)
        if not r["ok"]:
            fail(f"K4 disagrees with its plain twin: {r}")
        if main_shape and r["library_err"] > 1e-4:
            fail(f"the SDPA yardstick computes another function: {r}")
        if main_shape and B == B_TRAIN:
            k4_main = r
        elif main_shape:
            k4_big = r

    # ---- the training path, lanes layout ----
    t0 = time.time()
    data_dir = write_training_corpus()
    print(f"[8] synthetic corpus: {TRAIN_CLIPS[0]} x {TRAIN_CLIPS[1]} train, "
          f"{EVAL_CLIPS[0]} x {EVAL_CLIPS[1]} eval frames in "
          f"{time.time() - t0:.1f} s", flush=True)
    runs = {"lanes": train_and_check("[8]", data_dir, "lanes")}
    # B = 8 too: a flipped gate weighs ~1/√(S·B·F/2) of its leaf, most at
    # the smallest batch
    for rate, B in ((0.1, 16), (0.0, 16), (0.1, 8)):
        step_card_vs_cpu("[9]", data_dir, rate, B, "lanes")

    # ---- K3a/K3b against their plain twins ----
    k3r_main = k3r_big = None
    for B, rate in ((B_TRAIN, 0.1), (B_TRAIN, 0.0), (B_PROFILED, 0.1),
                    (B_PROFILED, 0.0)):
        clocks = gpu_clocks()
        r = check_k3(15, B, rate, timed=rate > 0 or B == B_TRAIN,
                     layout="rows")
        r["clocks_sm_mem"] = [clocks, gpu_clocks()]
        print(f"[10] K3a/K3b M=15x{B}={15 * B} rate={rate}: " + json.dumps(r),
              flush=True)
        if not r["ok"]:
            fail(f"K3a/K3b disagree with their plain twins, or K3_TOL "
                 f"passes the TF32 control: {r}")
        if (B, rate) == (B_TRAIN, 0.1):
            k3r_main = r
        elif (B, rate) == (B_PROFILED, 0.1):
            k3r_big = r
    gate_probe("[10]", "rows")

    # ---- the pose-VAE trainer, then the rows trainer on its generator ----
    vae_data = vae_corpus()
    vae_run = run_vae_training(vae_data)
    print("[11] VAE training path (recipe: batch 64 pairs, FK loss): "
          + json.dumps(vae_run), flush=True)
    if not (vae_run["ok_finite"] and vae_run["checkpoint_loads"]):
        fail(f"VAE training run failed its checks: {vae_run}")
    clocks = gpu_clocks()
    prof = profile_vae_steps(vae_data, vae_run["model_dir"])
    prof["clocks_sm_mem"] = [clocks, gpu_clocks()]
    print("[11] VAE training step alone and its device time "
          "(torch.profiler): " + json.dumps(prof), flush=True)
    r = vae_step_card_vs_cpu(vae_data)
    print("[11] VAE training step on the card vs on the CPU: "
          + json.dumps(r), flush=True)
    if not r["ok"]:
        fail(f"the card's VAE step disagrees with the CPU's: {r}")
    runs["rows"] = train_and_check("[12]", vae_data, "rows",
                                   vae_run["model_dir"])
    for rate, B in ((0.1, 16), (0.0, 16), (0.1, 8)):
        step_card_vs_cpu("[13]", vae_data, rate, B, "rows",
                         vae_run["model_dir"])

    # ---- the trained models drive the serving path ----
    loop = close_the_loop(train_model_dir("rows", 0.1), bvh)
    print("[14] reconstruction with the freshly trained generator and "
          "rows-trained temporal predictor (MPJPE not gated): "
          + json.dumps(loop), flush=True)
    if not loop["ok"]:
        fail(f"the trained models do not drive the serving path: {loop}")

    # ---- the anchor path and the offline CLI ----
    t15 = time.time()
    anchor_launches = []
    for config in ("6_trackers", "4_trackers"):
        r = anchor_card_vs_cpu(config, bvh)
        anchor_launches.append(r["launches"])
        print(f"[15] anchor engine.run on the card vs on the CPU, {config}, "
              f"1 lane x {T_ANCHOR} frames, one Adam step a frame: "
              + json.dumps(r), flush=True)
        if not r["ok"]:
            fail(f"the anchor on the card disagrees with the CPU's, or its "
                 f"kernels are not K2 alone: {r}")
    r = anchor_vs_pipeline(engine, bvh, means, stds, skeleton)
    anchor_launches += r["anchor_launches"]
    print(f"[15] anchor run_batch vs run_batch_pipelined (K1 + K2) on the "
          f"card, B={B_ANCHOR} x {T_ANCHOR_B} frames: " + json.dumps(r),
          flush=True)
    if not r["ok"]:
        fail(f"the anchor and the pipelined path disagree: {r}")
    for r in cli_runs():
        anchor_launches.append(r["launches"])
        print("[15] CLI on the card (cli.eval_drag.main): " + json.dumps(r),
              flush=True)
        if not r["ok"]:
            fail(f"a CLI run failed its checks: {r}")
    r = anchor_timing(engine, bvh, means, stds)
    r["nvidia_smi"] = smi
    r["phase_15_s"] = time.time() - t15
    print("[15] anchor timing, 6_trackers (not gated): " + json.dumps(r),
          flush=True)
    anchor_k = {k: sum(c[k] for c in anchor_launches) for k in ("K1", "K2")}

    # ---- the realtime front: a session, a crowd, the daemon ----
    t16 = time.time()
    path = clip_path(SEED)
    session = realtime_session_phase(path, bvh)
    session["phase_s"] = time.time() - t16
    print(f"[16] RealtimeSession on the card (6 trackers): one frame at one "
          f"Adam step vs the CPU from the same state, then {T_REALTIME} "
          f"frames at the realtime defaults (max_iter 10, window 60: K2 at "
          f"S_dec 16), frame latency: " + json.dumps(session), flush=True)
    if not session["ok"]:
        fail(f"the realtime session failed its checks: {session}")
    t17 = time.time()
    crowd = realtime_batch_phase(path, bvh)
    crowd["phase_s"] = time.time() - t17
    print(f"[17] RealtimeBatch of {N_CROWD} avatars (6/4/3 trackers): one "
          f"frame on the card (K1 + K2) vs the CPU's twins, then "
          f"{T_REALTIME} frames with window phases in lockstep and "
          f"staggered, frame latency: " + json.dumps(crowd), flush=True)
    if not crowd["ok"]:
        fail(f"the realtime batch failed its checks: {crowd}")
    t18 = time.time()
    daemon = daemon_phase(path, bvh)
    daemon["phase_s"] = time.time() - t18
    daemon["nvidia_smi"] = smi
    print(f"[18] serving daemon on the card: {N_DAEMON_CLIENTS} raw-socket "
          f"clients x {T_DAEMON} frames, an eval job while a client steps, "
          f"the native smoke client: " + json.dumps(daemon), flush=True)
    if not daemon["ok"]:
        fail(f"the serving daemon failed its checks: {daemon}")
    # ---- K1's general build on its path, the data-parallel CLI, .pt ----
    t19 = time.time()
    wide = wide_path(bvh, parents, skeleton)
    wide["phase_s"] = time.time() - t19
    wide["nvidia_smi"] = smi
    print(f"[19] pipelined path at latent {WIDE_LATENT} (K1's general "
          f"build), B={B_MAIN} x {T_MAIN} frames, then 8 x 24 on the card "
          f"vs the CPU at one Adam step a frame: " + json.dumps(wide),
          flush=True)
    if not wide["ok"]:
        fail(f"the path at latent {WIDE_LATENT} failed its checks: {wide}")
    paths = {"resident": (f"latent {WIDE_LATENT} [19]", wide)}
    for layout, J, L, B in (("streamed4", WIDE_CHAINS[0], 24, B_MAIN),
                            ("streamed2", WIDE_CHAINS[1], 24, B_MAIN),
                            ("streamed1", *WIDE_LIMIT, B_LIMIT_PATH)):
        t19 = time.time()
        chain = chain_path(J, L, B)
        chain["phase_s"] = time.time() - t19
        print(f"[19] pipelined path on a {J}-joint chain at latent {L} "
              f"(K1's general build, {layout}), B={B} x {T_MAIN} frames, "
              f"then 8 x 24 on the card vs the CPU at one Adam step a "
              f"frame: " + json.dumps(chain), flush=True)
        if not chain["ok"]:
            fail(f"the path on the {J}-joint chain failed its checks: "
                 f"{chain}")
        paths[layout] = (f"{J}-joint chain, latent {L} [19]", chain)
    for layout, (_, run) in paths.items():
        if run["layout"]["name"] != layout:
            fail(f"[19]'s {layout} path took the {run['layout']} layout")
    t20 = time.time()
    mesh = mesh_cli_runs()
    mesh["phase_s"] = time.time() - t20
    print("[20] eval_drag --batch on two synthetic clips, without and with "
          "--mesh 1: " + json.dumps(mesh), flush=True)
    if not mesh["ok"]:
        fail(f"eval_drag --mesh 1 differs from the run without it: {mesh}")
    r = mesh_lockstep(1)
    print("[20] the sharded path (replica, stream, thread) on one card "
          "against the one-card path, one Adam step a frame: "
          + json.dumps(r), flush=True)
    if not r["ok"]:
        fail(f"the sharded path disagrees with the one-card path: {r}")
    r = pt_round_trip(bvh, parents, skeleton)
    print("[21] the reference's .pt files of the example model on the card "
          "(import_checkpoint, the loading fallback, the pipelined batch): "
          + json.dumps(r), flush=True)
    if not r["ok"]:
        fail(f"the .pt import round trip failed: {r}")
    t22 = time.time()
    native = native_phase(bvh, path, session)
    native["phase_s"] = time.time() - t22
    native["nvidia_smi"] = smi
    print(f"[22] the port's native layer on the card: a host process "
          f"(dlopen RTLD_LOCAL) through the embedded ABI and through the "
          f"socket client, which starts the port's daemon, {T_NATIVE} frames "
          f"each against capi in this process (max abs <= {NATIVE_TOL:g}), "
          f"frame latency beside [16], K2's build in the host: "
          + json.dumps(native), flush=True)
    if not native["ok"]:
        fail(f"the native layer failed its checks: {native}")
    native_k2 = {"native ABI [22]": native["abi"]["launches"]["K2"],
                 "socket client's daemon [22]":
                 native["client"]["daemon"]["kernels"]["K2"]}

    realtime_k = {k: (session["launches"][k]
                      + sum(c[k] for c in crowd["launches"].values())
                      + crowd["one_frame"]["launches"][k]
                      + daemon["launches"][k]) for k in ("K1", "K2")}

    k1_gen = {layout: k1_general[name][f"sync_k_{SYNC_K}"]
              for layout, name in K1_PATH_SHAPES.items()}

    def launched(layout, name):
        return sum(r["launches"][name] for r in runs[layout].values())

    kernels = [
        {"name": "K1 drag-iteration block", "route": "cuda",
         "source": "dragposer_tpu_torch/csrc/iter_block.cu",
         "replaces": "dragposer_tpu/drag/iter_kernel.py:349",
         "launches": launches["K1"] + anchor_k["K1"] + realtime_k["K1"],
         "launches_by_path": {"main [5]": launches["K1"],
                              "anchor phase [15]": anchor_k["K1"],
                              **realtime_launches("K1", session, crowd,
                                                  daemon)},
         "max_abs_err": k1_main["max_abs_err"],
         "ms": k1_main["ms"], "plain_ms": k1_main["plain_ms"],
         "bound_ms": k1_main["bound_ms"], "bound_by": k1_main["bound_by"],
         "library_ms": None,
         "wrapper_device_ms": k1_main["wrapper_device_ms"],
         "event_ms": k1_main["event_ms"],
         "bound_f32_cuda_core_ms": k1_main["bound_f32_cuda_core_ms"],
         "tile_efficiency": tiles["efficiency"]},
        *({"name": f"K1 drag-iteration block, general build, {layout}",
           "route": "cuda",
           "source": "dragposer_tpu_torch/csrc/iter_block.cu",
           "replaces": "dragposer_tpu/drag/iter_kernel.py:349",
           "launches": run["launches"][f"K1_general_{layout}"],
           "launches_by_path": {path: run["launches"][f"K1_general_{layout}"]},
           **{k: k1_gen[layout][k] for k in (
               "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")},
           "library_ms": None,
           "shape": k1_gen[layout]["shape"],
           "tile_efficiency": run["tile_efficiency"]["efficiency"],
           "by_shape": {n: {k: r[f"sync_k_{SYNC_K}"][k] for k in (
               "kernel", "ms", "bound_ms", "bound_by", "max_abs_err",
               "shape")} for n, r in k1_general.items()
               if r[f"sync_k_{SYNC_K}"]["kernel"] == layout}}
          for layout, (path, run) in paths.items()),
        {"name": "K2 temporal-transformer forward", "route": "cuda",
         "source": "dragposer_tpu_torch/csrc/temporal_forward.cu",
         "replaces": "dragposer_tpu/ops/temporal_fused.py:248",
         "launches": (launches["K2"] + anchor_k["K2"] + realtime_k["K2"]
                      + sum(native_k2.values())),
         "launches_by_path": {"main [5]": launches["K2"],
                              "anchor phase [15]": anchor_k["K2"],
                              **realtime_launches("K2", session, crowd,
                                                  daemon), **native_k2},
         "max_abs_err": k2_main["max_abs_err"],
         "ms": k2_main["ms"], "plain_ms": k2_main["plain_ms"],
         "bound_ms": k2_main["bound_ms"], "bound_by": k2_main["bound_by"],
         "library_ms": k2_main["library_ms"],
         "bound_f32_cuda_core_ms": k2_main["bound_f32_cuda_core_ms"],
         "library_tf32_ms": k2_main["library_tf32_ms"],
         "by_s_dec": {s: {k: r[k] for k in ("ms", "plain_ms", "bound_ms",
                                            "bound_by", "library_ms",
                                            "max_abs_err")}
                      for s, r in k2_long.items()}},
        *k3_entries(k3r_main, "K3a rows feed-forward forward",
                    "K3b rows feed-forward backward",
                    "dragposer_tpu_torch/csrc/ff_rows.cu",
                    ("dragposer_tpu/ops/ff_fused.py:163",
                     "dragposer_tpu/ops/ff_fused.py:189"),
                    (launched("rows", "K3a"), launched("rows", "K3b"))),
        *k3_entries(k3_main, "K3c lanes feed-forward forward",
                    "K3d lanes feed-forward backward",
                    "dragposer_tpu_torch/csrc/ff_lanes.cu",
                    ("dragposer_tpu/ops/ff_fused.py:348",
                     "dragposer_tpu/ops/ff_fused.py:375"),
                    (launched("lanes", "K3c"), launched("lanes", "K3d"))),
        {"name": "K4a lanes attention core forward", "route": "cuda",
         "source": "dragposer_tpu_torch/csrc/attn_lanes.cu",
         "replaces": "dragposer_tpu/ops/attn_fused.py:159",
         "launches": launched("lanes", "K4a"),
         "max_abs_err": k4_main["max_abs_err"]["o"],
         "ms": k4_main["fwd_ms"], "plain_ms": k4_main["fwd_plain_ms"],
         "bound_ms": k4_main["fwd_bound_ms"],
         "bound_by": k4_main["fwd_bound_by"],
         "library_ms": k4_main["library_fwd_ms"]},
        {"name": "K4b lanes attention core backward", "route": "cuda",
         "source": "dragposer_tpu_torch/csrc/attn_lanes.cu",
         "replaces": "dragposer_tpu/ops/attn_fused.py:188",
         "launches": launched("lanes", "K4b"),
         "max_abs_err": max(v for k, v in k4_main["max_abs_err"].items()
                            if k != "o"),
         "ms": k4_main["bwd_ms"], "plain_ms": k4_main["bwd_plain_ms"],
         "bound_ms": k4_main["bwd_bound_ms"],
         "bound_by": k4_main["bwd_bound_by"],
         "library_ms": k4_main["library_bwd_ms"]},
    ]
    times = ("fwd_ms", "fwd_plain_ms", "fwd_bound_ms", "bwd_ms",
             "bwd_plain_ms", "bwd_bound_ms")
    k3_times = (*times, "fwd_device_ms", "bwd_device_ms",
                "fwd_bound_f32_cuda_core_ms", "bwd_bound_f32_cuda_core_ms")
    print("[23] the same kernels at B=4096, the batch the JAX package "
          "profiled its step at: " + json.dumps({
              "K3a/K3b": {k: k3r_big[k] for k in k3_times},
              "K3c/K3d": {k: k3_big[k] for k in k3_times},
              "K4": {k: k4_big[k] for k in (*times, "library_fwd_ms",
                                            "library_bwd_ms")}}), flush=True)
    print(f"[23] total {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
