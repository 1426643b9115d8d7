"""Pose-VAE training (port of ``dragposer_tpu/train/vae.py``).

Six-term loss: quaternion MSE (root + joints), displacement MSE, KLD, FK
position MSE, and the drag-consistency ("consecutive") regularizer, an MSE
between ``z₀ − ∇_z f`` and ``z₁`` over pairs of consecutive frames where
``f = Σ(pos(z₀) − pos(z₁))²``.  The gradient of a gradient is
``torch.autograd.grad(f, z, create_graph=True)``, as in the reference.

Optimizer: global-norm clipping at ``clip_grad_value`` then AdamW(1e-4,
β 0.9/0.999, eps 1e-8, weight decay 0.01): optax's ``chain(
clip_by_global_norm, adamw)``.  The best checkpoint is chosen by
MPJPE + MPEEPE on the eval files, evaluated every epoch.  Randomness comes
from two ``torch.Generator``\\ s: a CPU one for the shuffles and one on the
device for the reparameterization noise.  The windows are staged on the
device once and each batch is gathered there by index.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from dragposer_tpu_torch import config as cfg
from dragposer_tpu_torch import export, metrics
from dragposer_tpu_torch._device import resolve_device
from dragposer_tpu_torch.data import datasets, encoding
from dragposer_tpu_torch.models import checkpoint, vae
from dragposer_tpu_torch.models.temporal import named_leaves
from dragposer_tpu_torch.ops import fk
from dragposer_tpu_torch.train.temporal import (_assign, load_opt_state,
                                                opt_state_tree)


def make_optimizer(params, param) -> torch.optim.AdamW:
    """AdamW over the tree's leaves, one tensor at a time; the clipping is
    in :func:`clip_and_step`."""
    return torch.optim.AdamW([t for _, t in named_leaves(params)],
                             lr=param["learning_rate"], betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=0.01, foreach=False,
                             fused=False)


def _pin_root(qs):
    """(..., J, 4) quaternions with the root slot set to identity."""
    identity = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=qs.dtype,
                            device=qs.device)
    return torch.cat((identity.expand(qs.shape[:-2] + (1, 4)),
                      qs[..., 1:, :]), dim=-2)


def _fk_from_origin(qs, skeleton):
    pos, _ = fk.fk_root_space(_pin_root(qs), torch.zeros(
        qs.shape[:-2] + (3,), dtype=qs.dtype, device=qs.device), skeleton)
    return pos


def _positions_of_latent(z, dec_params, statics, skeleton, mean_dqs, std_dqs,
                         pair_shape):
    """Decode → denormalize → root pinned to identity → FK from the origin:
    z (B·2, L) → positions (B, 2, T, J, 3)."""
    motion, _ = vae.decode(dec_params, statics, z, mean_dqs, std_dqs)
    mean_q, std_q = vae.quat_stats(mean_dqs, std_dqs)
    qs = motion * std_q[None, :, None] + mean_q[None, :, None]
    b2, _, t = qs.shape
    pos = _fk_from_origin(qs.permute(0, 2, 1).reshape(b2, t, -1, 4),
                          skeleton)
    return pos.reshape(pair_shape + pos.shape[1:])


def loss_fn(params, statics, skeleton, generator, batch, mean_dqs, std_dqs,
            param, use_fk: bool, noise=None) -> Tuple[torch.Tensor, Dict]:
    """batch: dqs (B, 2, C, T), displacement (B, 2, 3, T), consecutive
    pairs.  ``noise`` (2B, L) replaces the reparameterization draw when
    given.  Returns (total, terms)."""
    dqs, disp = batch
    b, two, c, t = dqs.shape
    motion, displacement, mu, logvar, z = vae.forward(
        params, statics, generator, dqs.reshape(b * two, c, t), mean_dqs,
        std_dqs, noise)
    motion = motion.reshape(b, two, -1, t)
    displacement = displacement.reshape(b, two, 3, t)
    target_q = dqs.reshape(b, two, -1, 8, t)[:, :, :, :4].reshape(
        b, two, -1, t)

    loss_joints = ((motion[:, :, 4:] - target_q[:, :, 4:]) ** 2).mean()
    loss_root = ((motion[:, :, :4] - target_q[:, :, :4]) ** 2).mean()
    loss_displacement = ((displacement - disp) ** 2).mean()
    loss_kld = -0.5 * (1.0 + logvar - mu ** 2 - torch.exp(logvar)).sum(
        dim=-1).mean()

    pos = _positions_of_latent(z, params["decoder"], statics, skeleton,
                               mean_dqs, std_dqs, (b, two))
    mean_q, std_q = vae.quat_stats(mean_dqs, std_dqs)
    tq = target_q * std_q[None, None, :, None] + mean_q[None, None, :, None]
    target_pos = _fk_from_origin(
        tq.permute(0, 1, 3, 2).reshape(b, two, t, -1, 4), skeleton)
    loss_fk = ((pos - target_pos) ** 2).mean()

    # consecutive (drag-consistency) term: ∇_z of the pairwise position
    # gap through the decoder and FK, differentiated again by backward()
    f = ((pos[:, 0] - pos[:, 1]) ** 2).sum()
    grad_f, = torch.autograd.grad(f, z, create_graph=True)
    z_pairs, g_pairs = z.reshape(b, two, -1), grad_f.reshape(b, two, -1)
    z_drag = z_pairs[:, 0] - g_pairs[:, 0]
    loss_consecutive = ((z_drag - z_pairs[:, 1]) ** 2).mean()

    terms = {
        "kld": loss_kld * param["lambda_kld"],
        "root": loss_root * param["lambda_root"],
        "displacement": loss_displacement * param["lambda_displacement"],
        "consecutive": loss_consecutive * param["lambda_consecutive"],
        "joints": loss_joints,
    }
    if use_fk:
        terms["fk"] = loss_fk * param["lambda_fk"]
    return sum(terms.values()), terms


def clip_and_step(optimizer, param):
    """The update from the leaves' gradients: clip their global norm at
    ``clip_grad_value``, then AdamW.  Returns the norm before clipping (a
    device scalar)."""
    norm = torch.nn.utils.clip_grad_norm_(
        optimizer.param_groups[0]["params"], param["clip_grad_value"],
        foreach=False)
    optimizer.step()
    return norm


def make_train_step(statics, skeleton, param, use_fk: bool, optimizer):
    """One step: loss, backward, :func:`clip_and_step`.  Returns the total
    and the terms as device scalars (no host sync)."""

    def step(params, generator, dqs, disp, mean_dqs, std_dqs, noise=None):
        optimizer.zero_grad(set_to_none=True)
        total, terms = loss_fn(params, statics, skeleton, generator,
                               (dqs, disp), mean_dqs, std_dqs, param, use_fk,
                               noise)
        total.backward()
        clip_and_step(optimizer, param)
        return total.detach(), {k: v.detach() for k, v in terms.items()}

    return step


def make_reconstruct(statics):
    """Per-sequence reconstruction, sampled as the reference does at eval:
    dqs_norm (F, C) → (poses (F, J*4), displacement (F, 3))."""

    def reconstruct(params, generator, dqs_norm, mean_dqs, std_dqs,
                    noise=None):
        with torch.no_grad():
            mu, logvar = vae.encode(params["encoder"], statics,
                                    dqs_norm[:, :, None])
            z = vae.reparameterize(generator, mu, logvar, noise)
            motion, disp = vae.decode(params["decoder"], statics, z,
                                      mean_dqs, std_dqs)
        return motion[:, :, 0], disp[:, :, 0]

    return reconstruct


def evaluate_generator(params, reconstruct, generator, eval_motions,
                       eval_bvhs, skeleton, means, stds) -> Tuple[float,
                                                                  float]:
    """Reconstruct every eval file, export it, and average MPJPE and
    MPEEPE over the files."""
    dev = params["decoder"]["f_latent"]["w"].device
    mean_dqs = torch.as_tensor(means["dqs"], device=dev)
    std_dqs = torch.as_tensor(stds["dqs"], device=dev)
    mpjpes, mpeepes = [], []
    for motion, (bvh, _) in zip(eval_motions, eval_bvhs):
        norm = encoding.normalize(motion, means, stds)
        poses, disp = reconstruct(
            params, generator,
            torch.as_tensor(norm.dqs, dtype=torch.float32, device=dev),
            mean_dqs, std_dqs)
        out = export.result_to_bvh(
            poses.cpu().numpy(), means, stds, bvh, skeleton,
            displacement=disp.cpu().numpy(), are_root_rot_incr=True,
            gt_rotations=motion.global_rot)
        mpjpe, mpeepe = metrics.positional_error(bvh, out)
        mpjpes.append(mpjpe)
        mpeepes.append(mpeepe)
    return float(np.mean(mpjpes)), float(np.mean(mpeepes))


def pair_batch(dqs_all, disp_all, idx):
    """Window pairs (idx, idx + 1) of the staged (N, T, C) windows:
    (dqs (B, 2, C, T), displacement (B, 2, 3, T))."""
    nxt = idx + 1
    dqs = torch.stack((dqs_all[idx], dqs_all[nxt]), dim=1)
    disp = torch.stack((disp_all[idx], disp_all[nxt]), dim=1)
    return dqs.permute(0, 1, 3, 2), disp.permute(0, 1, 3, 2)


def train(data_dir: str, model_dir: str, param=None, *, use_fk: bool = True,
          epochs: int | None = None, load: bool = False,
          seed: int | None = None, log=print, device=None) -> Dict:
    """Train on ``data_dir/train``, select on ``data_dir/eval``; writes
    ``generator.npz`` and ``parameters.json`` (best MPJPE + MPEEPE) and
    ``generator.last.npz`` (exact resume state) into ``model_dir``.  Runs on
    ``cuda`` unless ``device="cpu"``.  Returns ``{"params", "history",
    "means", "stds"}``; each history entry has the epoch's losses per step,
    its steps and pairs, the eval MPJPE/MPEEPE and ``train_seconds`` (the
    steps, ended by the one host fetch of the losses)."""
    dev = resolve_device(device)
    param = param or cfg.VAE_PARAM

    log(f"loading data from {data_dir} ...")
    train_motions, skeleton, _ = datasets.load_motion_dir(
        os.path.join(data_dir, "train"), param)
    eval_motions, _, eval_bvhs = datasets.load_motion_dir(
        os.path.join(data_dir, "eval"), param, keep_bvh=True)
    data = datasets.load_or_build_vae_dataset(train_motions, param, data_dir)
    means, stds = data.means, data.stds

    seed = param["seed"] if seed is None else seed
    host_gen = torch.Generator().manual_seed(seed)
    dev_gen = torch.Generator(device=dev).manual_seed(seed)
    params = vae.init_params(host_gen, skeleton.parents, param, dev)
    statics = vae.statics_on(vae.build_statics(skeleton.parents, param), dev)

    best_path = os.path.join(model_dir, "generator.npz")
    last_path = os.path.join(model_dir, "generator.last.npz")
    resume_state = None
    if load:
        loaded, extra = checkpoint.load(best_path)
        _assign(params, loaded)
        means, stds = extra["means"], extra["stds"]
        data = datasets.build_vae_dataset(train_motions, param, means, stds)
        if os.path.exists(last_path):
            resume_state = last_path

    optimizer = make_optimizer(params, param)
    train_step = make_train_step(statics, skeleton, param, use_fk, optimizer)
    reconstruct = make_reconstruct(statics)
    mean_dqs = torch.as_tensor(means["dqs"], device=dev)
    std_dqs = torch.as_tensor(stds["dqs"], device=dev)
    dqs_all = torch.as_tensor(data.dqs, device=dev)
    disp_all = torch.as_tensor(data.displacement, device=dev)

    n_pairs = data.n_pairs
    bs = param["batch_size"]
    best = float("inf")
    start_epoch = 0
    if resume_state:
        rparams, opt, rextra = checkpoint.load_training_state(resume_state)
        _assign(params, rparams)
        load_opt_state(optimizer, params, opt)
        best = float(rextra["best"])
        start_epoch = int(rextra["epoch"]) + 1
        host_gen.set_state(torch.as_tensor(rextra["rng_host"]))
        dev_gen.set_state(torch.as_tensor(rextra["rng_device"]))
        log(f"exact resume from {resume_state}: epoch {start_epoch}, "
            f"best {best:.4f}")
    elif load:
        mpjpe, mpeepe = evaluate_generator(params, reconstruct, dev_gen,
                                           eval_motions, eval_bvhs, skeleton,
                                           means, stds)
        best = mpjpe + mpeepe

    extra_stats = {"means": means, "stds": stds}
    history: List[Dict] = []
    n_epochs = epochs if epochs is not None else param["epochs"]
    log(f"training: {n_pairs} window pairs, batch {bs}, "
        f"{vae.count_params(params, statics)} params on {dev}")
    start = time.time()
    for epoch in range(start_epoch, n_epochs):
        order = torch.randperm(n_pairs, generator=host_gen).to(dev)
        accum, n_batches = None, 0   # device sums; ONE host fetch per epoch
        epoch_time = time.time()
        for i in range(0, n_pairs, bs):
            dqs, disp = pair_batch(dqs_all, disp_all, order[i: i + bs])
            total, terms = train_step(params, dev_gen, dqs, disp, mean_dqs,
                                      std_dqs)
            terms = {**terms, "total": total}
            accum = terms if accum is None else {
                k: accum[k] + v for k, v in terms.items()}
            n_batches += 1
        epoch_terms = dict(zip(accum, torch.stack(list(accum.values()))
                               .cpu().tolist()))
        train_seconds = time.time() - epoch_time
        epoch_loss = epoch_terms.pop("total")

        mpjpe, mpeepe = evaluate_generator(params, reconstruct, dev_gen,
                                           eval_motions, eval_bvhs, skeleton,
                                           means, stds)
        eval_loss = mpjpe + mpeepe
        was_best = eval_loss < best
        if was_best:
            best = eval_loss
            checkpoint.save(best_path, params, extra=extra_stats)
            checkpoint.save_hparams(model_dir, param)
        checkpoint.save_training_state(
            last_path, params, opt_state_tree(optimizer, params),
            extra={**extra_stats, "epoch": np.asarray(epoch),
                   "best": np.asarray(best),
                   "rng_host": host_gen.get_state().numpy(),
                   "rng_device": dev_gen.get_state().numpy()})
        per_step = {k: v / n_batches for k, v in epoch_terms.items()}
        history.append({"epoch": epoch, "steps": n_batches,
                        "pairs": n_pairs, "train_loss": epoch_loss / n_batches,
                        "terms": per_step, "mpjpe": mpjpe, "mpeepe": mpeepe,
                        "eval_loss": eval_loss,
                        "train_seconds": train_seconds})
        terms_str = " // ".join(f"{k}: {v:.4f}" for k, v in per_step.items())
        log(f"Epoch: {epoch} // Train Loss: {epoch_loss / n_batches:.4f} // "
            f"Time: {time.time() - epoch_time:.1f} "
            f"({time.time() - start:.1f})\n  {terms_str}\n"
            f"  Eval Loss: {eval_loss:.4f} // MPJPE: {mpjpe:.4f} // "
            f"MPEEPE: {mpeepe:.4f}" + ("*" if was_best else ""))
    return {"params": params, "history": history, "means": means,
            "stds": stds}
