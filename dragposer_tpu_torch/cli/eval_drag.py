"""Offline drag-reconstruction evaluation on the GPU (port of
``dragposer_tpu/cli/eval_drag.py``).

Usage::

    python -m dragposer_tpu_torch.cli.eval_drag <model_dir> <bvh-or-dir> [...]
        [--config 6_trackers | path/to/config.json] [--verbose] [--batch]
        [--restarts N] [--branch-every N] [--branch-sigma S]
        [--survivors K] [--constraints SPEC] [--no-temporal]
        [--max-frames N] [--save-dir data] [--profile DIR] [--mesh N]
        [--device cuda|cpu]

Each file runs on its own (:func:`evaluate_file`: the per-lane anchor
``engine.run``, or restarts, or the hypothesis beam) unless ``--batch`` is
given with more than one file: then all files run concurrently in one
pipelined batch (:func:`evaluate_batched`; ragged lengths halt per lane).
With ``--batch``, ``--mesh N`` cuts the lanes over N local devices, one
engine replica, CUDA stream and host thread a device.  The default is one
device, where the JAX CLI's is every local device: the threads share one
interpreter and the path is host-bound, so on several cards it runs
slower than on one (PERF.md).
Restarts, the beam and constraints default to the config's
(``3_trackers``: a 64-lane beam re-branched every 512 frames).  Prints
MPJPE / MPEEPE (and per file jitter and time) as the JAX CLI does.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import threading
import time

import numpy as np
import torch

from dragposer_tpu_torch import config as cfg
from dragposer_tpu_torch import _build, export, metrics, tracing
from dragposer_tpu_torch.data import encoding
from dragposer_tpu_torch.drag import constraints as constraints_mod
from dragposer_tpu_torch.drag import hypotheses
from dragposer_tpu_torch.drag.engine import (DragEngine, DragHyper, DragModel,
                                             DragState, FrameOutput, to_host)
from dragposer_tpu_torch.io.bvh import BVH
from dragposer_tpu_torch.models import loading, vae
from dragposer_tpu_torch.ops.topology import Skeleton
from dragposer_tpu_torch.parallel import mesh as meshlib

# Offline optimizer budget (reference ``eval_drag.py:210-215``).
EVAL_STOP_EPS_POS = 1e-4
EVAL_STOP_EPS_ROT = 1e-2
EVAL_MAX_ITER = 100
EVAL_MIN_LOSS_INCR = 1e-5
EVAL_LR = 1e-2
EVAL_LAMBDA_ROT = 1.0


def resolve_config(name_or_path: str | None) -> cfg.TrackerConfig:
    if name_or_path is None:
        return cfg.SIX_TRACKERS
    if name_or_path in cfg.BUILTIN_CONFIGS:
        return cfg.BUILTIN_CONFIGS[name_or_path]
    return cfg.TrackerConfig.from_json(name_or_path)


def build_engine(model_dir: str, parents, tracker: cfg.TrackerConfig, *,
                 use_temporal: bool = True, skeleton: Skeleton,
                 max_iter: int = EVAL_MAX_ITER,
                 learning_rate: float = EVAL_LR,
                 constraints: str | None = None,
                 device=None) -> tuple[DragEngine, dict, dict]:
    """Load the checkpoints of ``model_dir`` and build a DragEngine for one
    tracker config on ``device`` (``cuda`` unless ``"cpu"``).
    ``constraints`` is a ``constraints.parse_spec`` string of extra loss
    terms; ``None`` takes the config's ``default_constraints``."""
    params, means, stds = loading.load_generator(model_dir, parents,
                                                 cfg.VAE_PARAM)
    loaded = loading.load_temporal(model_dir) if use_temporal else None
    if use_temporal and loaded is None:
        print(f"WARNING: no temporal checkpoint in {model_dir}; "
              "running without temporal guidance (lambda_temporal = 0)")
        use_temporal = False
    latent_dim = cfg.VAE_PARAM["latent_dim"]
    if loaded is not None:
        tpar, means_latent, stds_latent = loaded
    else:
        tpar = None
        means_latent = np.zeros(latent_dim, np.float32)
        stds_latent = np.ones(latent_dim, np.float32)

    ja = None
    if tracker.enable_joint_adjustment:
        joint, ee_slot = tracker.joint_adjustment_indices
        ja = (int(joint), int(tracker.mask_indices[ee_slot]))

    model = DragModel(
        decoder=params["decoder"], encoder=params["encoder"], temporal=tpar,
        mean_dqs=means["dqs"], std_dqs=stds["dqs"],
        mean_disp=means["displacement"], std_disp=stds["displacement"],
        means_latent=means_latent, stds_latent=stds_latent,
        mask=tracker.mask_array(), weights=tracker.weights_array(),
    )
    hyper = DragHyper(
        max_iter=max_iter,
        stop_eps_pos=EVAL_STOP_EPS_POS,
        stop_eps_rot=EVAL_STOP_EPS_ROT,
        min_loss_incr=EVAL_MIN_LOSS_INCR,
        learning_rate=learning_rate,
        lambda_rot=EVAL_LAMBDA_ROT,
        lambda_temporal=tracker.lambda_temporal,
        temporal_future_window=tracker.temporal_future_window,
        sample_step=cfg.TEMPORAL_PARAM["sample_step"],
        past_frames=tuple(cfg.TEMPORAL_PARAM["past_frames"]),
        height_indices=tuple(cfg.HEIGHT_INDICES),
        use_temporal=use_temporal,
        joint_adjustment=ja,
        joint_adjustment_weight=tracker.joint_adjustment_weight,
        constraints=constraints_mod.parse_spec(
            tracker.default_constraints if constraints is None
            else constraints),
    )
    statics = vae.build_statics(parents, cfg.VAE_PARAM)
    engine = DragEngine(model, statics, skeleton, hyper, cfg.TEMPORAL_PARAM,
                        device=device)
    return engine, means, stds




def _encode(path: str, skeleton, means, stds):
    """A BVH file → (bvh, encoded motion, normalized motion)."""
    bvh = BVH().load(path)
    rots, pos, _, offsets, _ = encoding.info_from_bvh(bvh)
    motion = encoding.encode_motion(
        offsets, pos[:, 0, :], rots, skeleton,
        downsample=cfg.VAE_PARAM["downsample"],
        height_indices=cfg.HEIGHT_INDICES)
    return bvh, motion, encoding.normalize(motion, means, stds)


def run_restarts(engine: DragEngine, generator: torch.Generator,
                 n_restarts: int, dqs, gp, gr, heights0, initial_pose,
                 sync_k: int = 24):
    """Reconstruct the same sequence from ``n_restarts`` latent inits at
    once (one pipelined batch: K1 and K2) and keep the restart with the
    lowest mean tracker-fit loss (pos + rot), no ground truth consulted.
    The underconstrained configs (3 trackers) land in init-dependent
    basins that this loss ranks.  Returns (the kept restart's FrameOutput
    (T, ...), its index, every restart's score)."""
    R = int(n_restarts)
    rep = lambda a: engine.tensor(a)[None].repeat(  # noqa: E731
        (R,) + (1,) * np.ndim(a))
    states = engine.init_state(generator, rep(initial_pose), rep(gp[0]),
                               rep(gr[0]), rep(heights0))
    _, out = engine.run_batch_pipelined(states, rep(dqs), rep(gp), rep(gr),
                                        sync_k=sync_k)
    out = to_host(out)
    score = out.loss_pos.mean(axis=1) + out.loss_rot.mean(axis=1)
    best = int(np.argmin(score))
    return FrameOutput(*[a[best] for a in out]), best, score


def evaluate_file(engine: DragEngine, means, stds, skeleton,
                  input_path: str, *, max_frames: int | None = None,
                  save_dir: str = "data", verbose: bool = False,
                  seed: int = cfg.VAE_PARAM["seed"], downsample_gt: int = 1,
                  restarts: int = 1, branch_every: int = 0,
                  branch_sigma: float = 0.25, branch_survivors: int = 8,
                  sync_k: int = 24):
    """Reconstruct one file: the hypothesis beam (``restarts > 1`` and
    ``branch_every > 0``), restarts (``restarts > 1``) or one start through
    the anchor ``engine.run``.  Writes ``save_dir/eval_<file>`` and prints
    MPJPE / MPEEPE, jitter and the time (with ``verbose`` the losses and
    iterations of every frame first).  Returns (MPJPE, MPEEPE, seconds,
    frames)."""
    filename = os.path.basename(input_path)
    bvh, motion, norm = _encode(input_path, skeleton, means, stds)
    n_frames = norm.dqs.shape[0] if max_frames is None \
        else min(max_frames, norm.dqs.shape[0])
    dqs = norm.dqs[:n_frames]
    gp = norm.global_pos[:n_frames]
    gr = norm.global_rot[:n_frames]
    gen = torch.Generator(device=engine.device).manual_seed(seed)
    initial_pose = np.tile(dqs[0][:, None], (1, cfg.VAE_PARAM["window_size"]))

    start = time.time()
    if restarts > 1 and branch_every > 0:
        out, parents, _ = hypotheses.run_hypotheses(
            engine, gen, restarts, dqs, gp, gr, motion.heights[0],
            initial_pose, branch_every=branch_every, sigma=branch_sigma,
            survivors=branch_survivors)
        lead_changes = int((parents[:, 0] != 0).sum())
        print(f"hypotheses: {restarts}-lane beam (top {branch_survivors} "
              f"survive), resample every {branch_every} frames "
              f"(sigma {branch_sigma}); {lead_changes} lead change(s) "
              f"across {len(parents)} chunks")
    elif restarts > 1:
        out, best, scores = run_restarts(engine, gen, restarts, dqs, gp, gr,
                                         motion.heights[0], initial_pose,
                                         sync_k)
        print(f"restarts: kept {best} of {restarts} "
              f"(fit loss {scores[best]:.5f}; worst {scores.max():.5f})")
    else:
        states = engine.init_state(gen, initial_pose[None], gp[:1], gr[:1],
                                   motion.heights[:1])
        state = type(states)(*[x[0] for x in states])
        _, out = engine.run(state, dqs, gp, gr)
    out = to_host(out)
    elapsed = time.time() - start

    if verbose:
        # per-frame loss breakdown (reference --verbose, drag_pose.py:361-364)
        for lp, lr, it in zip(out.loss_pos, out.loss_rot, out.iterations):
            print(f"Loss sqrt(Pos): {np.sqrt(lp):.5f} // "
                  f"Loss Rot: {lr:.5f} // Iter: {int(it)}")
        it = out.iterations
        print(f"iterations/frame: mean {it.mean():.1f}, max {int(it.max())}, "
              f"min {int(it.min())}")

    out_bvh = export.result_to_bvh(out.pose, means, stds, bvh, skeleton,
                                   global_pos=out.global_pos,
                                   are_root_rot_incr=False)
    os.makedirs(save_dir, exist_ok=True)
    eval_path = os.path.join(save_dir, "eval_" + filename)
    out_bvh.save(eval_path)
    out_loaded = BVH().load(eval_path)
    mpjpe, mpeepe = metrics.positional_error(bvh, out_loaded,
                                             downsample_gt=downsample_gt)
    print(f"Evaluate Loss: {mpjpe + mpeepe}")
    print(f"Mean Per Joint Position Error: {mpjpe}")
    print(f"Mean End Effector Position Error: {mpeepe}")
    jit = metrics.jitter(out_loaded)
    jit_gt = metrics.jitter(bvh, downsample=downsample_gt)
    print(f"Jitter (m/s^3): {jit:.1f} (ground truth {jit_gt:.1f})")
    print(f"Time: {elapsed}")
    return mpjpe, mpeepe, elapsed, n_frames


def evaluate_batched(engine: DragEngine, means, stds, skeleton, files, *,
                     max_frames=None, save_dir: str = "data",
                     seed: int = cfg.VAE_PARAM["seed"],
                     downsample_gt: int = 1, restarts: int = 1,
                     branch_every: int = 0, branch_sigma: float = 0.25,
                     branch_survivors: int = 8, sync_k: int = 24,
                     mesh_devices: int = 1):
    """Reconstruct many sequences concurrently: one pipelined batch (each
    file ``restarts`` times, the lowest fit loss kept per file), or with
    ``restarts > 1`` and ``branch_every > 0`` the hypothesis beam per file
    (``hypotheses.run_hypotheses_batched``).  The pipelined batch runs
    data-parallel over ``mesh_devices`` local devices of the engine's kind
    (``parallel.mesh.local_devices``; default 1: this one):
    :func:`_run_sharded`, with the per-device engine replicas built before
    the clock starts.

    Sequences are padded to the longest by repeating their last frame and
    each lane halts at its own length.  Initial latents are drawn from a
    ``torch.Generator`` seeded with ``seed`` (its numbers differ from the
    JAX package's).  Returns [(MPJPE, MPEEPE)] per file."""
    encoded = [_encode(path, skeleton, means, stds) for path in files]
    bvhs = [e[0] for e in encoded]
    lengths = [n.dqs.shape[0] if max_frames is None
               else min(max_frames, n.dqs.shape[0]) for _, _, n in encoded]
    fmax = max(lengths)

    def pad(x, f):
        return np.concatenate((x[:f], np.repeat(x[f - 1:f], fmax - f, 0)))

    dqs = np.stack([pad(n.dqs, f) for (_, _, n), f in zip(encoded, lengths)])
    gp = np.stack([pad(n.global_pos, f)
                   for (_, _, n), f in zip(encoded, lengths)])
    gr = np.stack([pad(n.global_rot, f)
                   for (_, _, n), f in zip(encoded, lengths)])
    h0 = np.stack([m.heights[0] for _, m, _ in encoded])
    gen = torch.Generator(device=engine.device).manual_seed(seed)
    R = max(int(restarts), 1)
    export_args = (files, lengths, bvhs, means, stds, skeleton, save_dir,
                   downsample_gt)

    if R > 1 and branch_every > 0:
        start = time.time()
        out, cum = hypotheses.run_hypotheses_batched(
            engine, gen, R, dqs, gp, gr, h0, dqs[:, 0][:, :, None],
            lengths=np.asarray(lengths), branch_every=branch_every,
            sigma=branch_sigma, survivors=branch_survivors)
        print(f"hypotheses: {R}-lane beam per file (top {branch_survivors} "
              f"survive, resample every {branch_every} frames); kept "
              f"{cum.argmin(axis=1).tolist()}")
        return _export_batched(out.pose, out.global_pos,
                               time.time() - start, *export_args)

    lengths_b = np.repeat(np.asarray(lengths), R)
    if R > 1:
        dqs, gp, gr, h0 = (np.repeat(a, R, axis=0) for a in (dqs, gp, gr, h0))
    states = engine.init_state(gen, dqs[:, 0][:, :, None], gp[:, 0],
                               gr[:, 0], h0)
    devices = meshlib.local_devices(engine.device.type)
    want = int(mesh_devices)
    if want > len(devices):
        raise ValueError(f"--mesh {want} > {len(devices)} local devices")
    if want > 1:
        for dev in devices[:want]:
            _replica(engine, dev)
    start = time.time()
    if want > 1:
        out = _run_sharded(engine, want, states, dqs, gp, gr, lengths_b,
                           sync_k)
    else:
        _, out = engine.run_batch_pipelined(states, dqs, gp, gr,
                                            sync_k=sync_k, lengths=lengths_b)
        out = to_host(out)
    elapsed = time.time() - start
    if R > 1:
        # per file, the lowest fit loss over each lane's real frames
        score = out.loss_pos + out.loss_rot
        valid = np.arange(score.shape[1])[None, :] < lengths_b[:, None]
        score = (score * valid).sum(1) / np.maximum(valid.sum(1), 1)
        best = score.reshape(len(files), R).argmin(axis=1)
        out = FrameOutput(*[a[np.arange(len(files)) * R + best] for a in out])
        print(f"restarts: kept {best.tolist()} of {R} per file")
    return _export_batched(out.pose, out.global_pos, elapsed, *export_args)


def _run_sharded(engine: DragEngine, n_dev: int, states: DragState, dqs, gp,
                 gr, lengths, sync_k: int) -> FrameOutput:
    """Data-parallel lanes (the JAX CLI's ``--mesh``): pad the lane count to
    a multiple of ``n_dev`` with inert lanes (copies of lane 0 of length 0:
    they never step), cut every lane axis over a 1-D data mesh of local
    devices, run each piece through ``run_batch_pipelined`` on its
    device's engine replica (K1's and K2's weights on that device) and
    CUDA stream, each in a thread of its own, then gather on the host and
    drop the padding.  Lanes are independent: each computes what the
    unsharded run computes, up to the rounding that batched products do
    otherwise at another lane count."""
    n = dqs.shape[0]
    pad = (-n) % n_dev

    def pad1(a):
        a = a if torch.is_tensor(a) else torch.as_tensor(np.asarray(a))
        return torch.cat((a, a[:1].repeat((pad,) + (1,) * (a.dim() - 1))))

    lengths = np.concatenate((np.asarray(lengths),
                              np.zeros(pad, np.asarray(lengths).dtype)))
    mesh = meshlib.make_mesh(data=n_dev, devices=meshlib.local_devices(
        engine.device.type))
    pieces = meshlib.shard_batch(
        (DragState(*[pad1(x) for x in states]), pad1(dqs), pad1(gp),
         pad1(gr), torch.as_tensor(lengths)), mesh)
    outs, errors = [None] * n_dev, []

    def run(i):
        dev = mesh.devices[i, 0]
        try:
            replica = _replica(engine, dev)
            with contextlib.ExitStack() as ctx:
                if dev.type == "cuda":
                    ctx.enter_context(torch.cuda.device(dev))
                    ctx.enter_context(torch.cuda.stream(torch.cuda.Stream(
                        dev)))
                _, out = replica.run_batch_pipelined(*pieces[i][:4],
                                                     sync_k=sync_k,
                                                     lengths=pieces[i][4])
                outs[i] = to_host(out)
        except Exception as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n_dev)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return FrameOutput(*[np.concatenate(x)[:n] for x in zip(*outs)])


def _replica(engine: DragEngine, dev) -> DragEngine:
    """The engine that runs on ``dev``: ``engine`` itself on the CPU, its
    replica (weights copied once per engine) on a card."""
    return engine if dev.type == "cpu" else engine.replica(dev)


def _export_batched(poses, global_pos, elapsed, files, lengths, bvhs, means,
                    stds, skeleton, save_dir, downsample_gt):
    """BVH export + metrics per file."""
    os.makedirs(save_dir, exist_ok=True)
    results = []
    for i, (path, f) in enumerate(zip(files, lengths)):
        filename = os.path.basename(path)
        out_bvh = export.result_to_bvh(poses[i, :f], means, stds, bvhs[i],
                                       skeleton, global_pos=global_pos[i, :f],
                                       are_root_rot_incr=False)
        eval_path = os.path.join(save_dir, "eval_" + filename)
        out_bvh.save(eval_path)
        mpjpe, mpeepe = metrics.positional_error(
            bvhs[i], BVH().load(eval_path), downsample_gt=downsample_gt)
        print(f"{filename}: Evaluate Loss: {mpjpe + mpeepe:.6f} // "
              f"MPJPE: {mpjpe:.6f} // MPEEPE: {mpeepe:.6f}")
        results.append((mpjpe, mpeepe))
    total = sum(lengths)
    print(f"Batched: {len(files)} sequences, {total} frames in "
          f"{elapsed:.2f}s ({total / elapsed:.0f} frames/s)")
    return results


@contextlib.contextmanager
def _profiled(directory: str, device: torch.device):
    """A ``torch.profiler`` trace of the block (the card too on CUDA),
    written to ``directory/trace.json`` (Chrome trace format), with the
    program's ``dragposer.*`` spans; and the totals of the kernels' launch
    records made meanwhile (``tracing.counter_totals``) in
    ``directory/counters.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    _build.clear_launch_logs()
    with profile(activities=activities) as prof:
        yield
    os.makedirs(directory, exist_ok=True)
    prof.export_chrome_trace(os.path.join(directory, "trace.json"))
    with open(os.path.join(directory, "counters.json"), "w") as f:
        json.dump(tracing.counter_totals(), f, indent=1)
    _build.clear_launch_logs()


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Evaluate DragPoser on the GPU")
    parser.add_argument("model_path", help="model folder (native .npz)")
    parser.add_argument("inputs", nargs="+",
                        help=".bvh files or one directory of .bvh files")
    parser.add_argument("--config", default=None,
                        help="builtin name (6_trackers/5_trackers/"
                             "4_trackers/3_trackers) or a config JSON path")
    parser.add_argument("--verbose", action="store_true",
                        help="per-frame losses and iterations")
    parser.add_argument("--no-temporal", action="store_true",
                        help="disable the temporal predictor (lambda_t = 0)")
    parser.add_argument("--max-frames", type=int, default=None)
    parser.add_argument("--save-dir", default="data")
    parser.add_argument("--profile", default=None, metavar="DIR",
                        help="write a torch.profiler trace of the run "
                             "(with the dragposer.* spans) to "
                             "DIR/trace.json and the launch counters' "
                             "totals to DIR/counters.json")
    parser.add_argument("--batch", action="store_true",
                        help="reconstruct all files concurrently in one "
                             "pipelined batch")
    parser.add_argument("--restarts", type=int, default=None,
                        help="reconstruct from N latent inits at once and "
                             "keep the lowest tracker-fit loss (no ground "
                             "truth); default: the config's")
    parser.add_argument("--branch-every", type=int, default=None,
                        metavar="N",
                        help="with restarts > 1: the hypothesis beam, "
                             "resampled every N frames (0: off); default: "
                             "the config's")
    parser.add_argument("--branch-sigma", type=float, default=None,
                        help="re-seed latent noise in latent-std units; "
                             "default: the config's")
    parser.add_argument("--survivors", type=int, default=None,
                        help="beam lineages kept at each resampling point; "
                             "default: the config's")
    parser.add_argument("--downsample-gt", type=int, default=1,
                        help="downsample factor of the ground truth in the "
                             "metrics")
    parser.add_argument("--constraints", default=None, metavar="SPEC",
                        help="extra loss terms, e.g. 'feet_floor:0.1,"
                             "head_hips_colinear:0.05' (drag/constraints.py); "
                             "default: the config's; '' turns them off")
    parser.add_argument("--mesh", type=int, default=1, metavar="N",
                        help="with --batch: shard the lane axis over a "
                             "1-D data mesh of N local devices (default: "
                             "1, single-device)")
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    tracker = resolve_config(args.config)
    if args.restarts is None:
        args.restarts = tracker.default_restarts
    if args.branch_every is None:
        args.branch_every = tracker.default_branch_every
    if args.branch_sigma is None:
        args.branch_sigma = tracker.default_branch_sigma
    if args.survivors is None:
        args.survivors = tracker.default_branch_survivors
    if len(args.inputs) == 1 and os.path.isdir(args.inputs[0]):
        d = args.inputs[0]
        files = sorted(os.path.join(d, f) for f in os.listdir(d)
                       if f.endswith(".bvh"))
    else:
        files = list(args.inputs)
    first = BVH().load(files[0])
    _, _, parents, offsets, _ = encoding.info_from_bvh(first)
    skeleton = Skeleton.build(parents, offsets, first.names)
    engine, means, stds = build_engine(
        args.model_path, parents, tracker,
        use_temporal=not args.no_temporal, skeleton=skeleton,
        constraints=args.constraints, device=args.device)
    if engine.hyper.constraints:
        spec = (tracker.default_constraints if args.constraints is None
                else args.constraints)
        print(f"constraints active: {spec}")
    search = dict(restarts=args.restarts, branch_every=args.branch_every,
                  branch_sigma=args.branch_sigma,
                  branch_survivors=args.survivors)
    with (_profiled(args.profile, engine.device) if args.profile
          else contextlib.nullcontext()):
        if args.batch and len(files) > 1:
            results = evaluate_batched(
                engine, means, stds, skeleton, files,
                max_frames=args.max_frames, save_dir=args.save_dir,
                downsample_gt=args.downsample_gt, mesh_devices=args.mesh,
                **search)
        else:
            results = []
            for path in files:
                print(f"Evaluate {path} ------------------------")
                results.append(evaluate_file(
                    engine, means, stds, skeleton, path,
                    max_frames=args.max_frames, save_dir=args.save_dir,
                    verbose=args.verbose, downsample_gt=args.downsample_gt,
                    **search)[:2])
    if args.profile:
        print(f"profiler trace and counters written to {args.profile}")
    return results


if __name__ == "__main__":
    main()
