"""Offline batched drag-reconstruction evaluation on the GPU (port of
``dragposer_tpu/cli/eval_drag.py``: ``resolve_config``, ``build_engine``,
``evaluate_batched`` and ``main`` for a directory or a list of files).

Usage::

    python -m dragposer_tpu_torch.cli.eval_drag <model_dir> <bvh-or-dir> [...]
        [--config 6_trackers | path/to/config.json] [--max-frames N]
        [--save-dir data] [--device cuda|cpu]

All files are reconstructed concurrently in one pipelined batch (ragged
lengths halt per lane).  Prints MPJPE / MPEEPE per file and the throughput.
Restarts, the hypothesis beam, meshes and constraints are not ported yet:
a config that asks for them by default (``3_trackers``) is refused.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from dragposer_tpu_torch import config as cfg
from dragposer_tpu_torch import export, metrics
from dragposer_tpu_torch.data import encoding
from dragposer_tpu_torch.drag.engine import DragEngine, DragHyper, DragModel
from dragposer_tpu_torch.io.bvh import BVH
from dragposer_tpu_torch.models import loading, vae
from dragposer_tpu_torch.ops.topology import Skeleton

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
                 device=None) -> tuple[DragEngine, dict, dict]:
    """Load the checkpoints of ``model_dir`` and build a DragEngine for one
    tracker config on ``device`` (``cuda`` unless ``"cpu"``)."""
    if tracker.default_constraints:
        raise NotImplementedError("constraints are not ported yet")
    params, means, stds = loading.load_generator(model_dir)
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
    )
    statics = vae.build_statics(parents, cfg.VAE_PARAM)
    engine = DragEngine(model, statics, skeleton, hyper, cfg.TEMPORAL_PARAM,
                        device=device)
    return engine, means, stds


def evaluate_batched(engine: DragEngine, means, stds, skeleton, files, *,
                     max_frames=None, save_dir: str = "data",
                     seed: int = cfg.VAE_PARAM["seed"],
                     downsample_gt: int = 1, sync_k: int = 24):
    """Reconstruct many sequences concurrently in one pipelined batch.

    Sequences are padded to the longest by repeating their last frame and
    each lane halts at its own length.  Initial latents are drawn from a
    ``torch.Generator`` seeded with ``seed`` (its numbers differ from the
    JAX package's).  Returns [(MPJPE, MPEEPE)] per file."""
    encoded, norms, bvhs = [], [], []
    for path in files:
        bvh = BVH().load(path)
        rots, pos, _, offsets, _ = encoding.info_from_bvh(bvh)
        motion = encoding.encode_motion(
            offsets, pos[:, 0, :], rots, skeleton,
            downsample=cfg.VAE_PARAM["downsample"],
            height_indices=cfg.HEIGHT_INDICES)
        encoded.append(motion)
        norms.append(encoding.normalize(motion, means, stds))
        bvhs.append(bvh)
    lengths = [n.dqs.shape[0] if max_frames is None
               else min(max_frames, n.dqs.shape[0]) for n in norms]
    fmax = max(lengths)

    def pad(x, f):
        return np.concatenate((x[:f], np.repeat(x[f - 1:f], fmax - f, 0)))

    dqs = np.stack([pad(n.dqs, f) for n, f in zip(norms, lengths)])
    gp = np.stack([pad(n.global_pos, f) for n, f in zip(norms, lengths)])
    gr = np.stack([pad(n.global_rot, f) for n, f in zip(norms, lengths)])
    h0 = np.stack([m.heights[0] for m in encoded])

    gen = torch.Generator(device=engine.device).manual_seed(seed)
    states = engine.init_state(gen, dqs[:, 0][:, :, None], gp[:, 0],
                               gr[:, 0], h0)
    start = time.time()
    _, out = engine.run_batch_pipelined(states, dqs, gp, gr, sync_k=sync_k,
                                        lengths=np.asarray(lengths))
    poses = out.pose.cpu().numpy()          # waits for the device
    elapsed = time.time() - start
    return _export_batched(poses, out.global_pos.cpu().numpy(), elapsed,
                           files, lengths, bvhs, means, stds, skeleton,
                           save_dir, downsample_gt)


def _export_batched(poses, global_pos, elapsed, files, lengths, bvhs, means,
                    stds, skeleton, save_dir, downsample_gt):
    """BVH export + metrics per file."""
    os.makedirs(save_dir, exist_ok=True)
    results = []
    for i, (path, f) in enumerate(zip(files, lengths)):
        filename = os.path.basename(path)
        out_bvh = export.result_to_bvh(poses[i, :f], means, stds, bvhs[i],
                                       skeleton, global_pos=global_pos[i, :f])
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


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Evaluate DragPoser on the GPU (batched)")
    parser.add_argument("model_path", help="model folder (native .npz)")
    parser.add_argument("inputs", nargs="+",
                        help=".bvh files or one directory of .bvh files")
    parser.add_argument("--config", default=None,
                        help="builtin name (6_trackers/5_trackers/"
                             "4_trackers/3_trackers) or a config JSON path")
    parser.add_argument("--no-temporal", action="store_true")
    parser.add_argument("--max-frames", type=int, default=None)
    parser.add_argument("--save-dir", default="data")
    parser.add_argument("--downsample-gt", type=int, default=1)
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    tracker = resolve_config(args.config)
    # The JAX CLI runs this config's restarts and beam by default; running
    # one start here instead would give another result without a word.
    if tracker.default_restarts > 1 or tracker.default_branch_every > 0:
        raise NotImplementedError(
            f"config {tracker.name!r} asks for {tracker.default_restarts} "
            f"restarts / a beam re-branched every "
            f"{tracker.default_branch_every} frames: restarts and the "
            "hypothesis beam are not ported yet")
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
        device=args.device)
    return evaluate_batched(engine, means, stds, skeleton, files,
                            max_frames=args.max_frames,
                            save_dir=args.save_dir,
                            downsample_gt=args.downsample_gt)


if __name__ == "__main__":
    main()
