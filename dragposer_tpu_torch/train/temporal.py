"""Temporal-predictor training (port of ``dragposer_tpu/train/temporal.py``).

Teacher-forced seq2seq over frozen-VAE latents: the encoder sees 14 past
latents ⊕ raw accumulated displacements ⊕ raw heights; the decoder sees the
last past latent followed by the future latents shifted right, under a causal
mask.  Latent normalization stats come from one encoding pass over the train
set.  Limb-occlusion augmentation replaces a random limb's (normalized) past
dual quats with denormalized-scale Gaussian noise at p=0.1 per limb per
batch, a reference quirk kept verbatim.

The step runs in one of the JAX package's two layouts: "lanes"
(``models/temporal.forward_T``, train mode, the default), whose
feed-forwards go through K3c/K3d and, at dropout 0, its attention cores
through K4; or "rows" (``models/temporal.forward``, train mode), whose
feed-forwards go through K3a/K3b.  On the CPU the kernels' plain twins run
instead.
Randomness comes from two ``torch.Generator``\\ s: a CPU one for everything
drawn on the host (shuffles, per-site dropout seeds, limb choices, the
noise seed), and one on the device for the VAE's reparameterization noise.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from dragposer_tpu_torch import config as cfg
from dragposer_tpu_torch._device import resolve_device
from dragposer_tpu_torch.data import datasets
from dragposer_tpu_torch.models import checkpoint, loading
from dragposer_tpu_torch.models import temporal as tmodel
from dragposer_tpu_torch.models import vae
from dragposer_tpu_torch.ops import hash_dropout

LIMBS = tuple(tuple(v) for v in cfg.LIMB_INDICES.values())
N_SEEDS = 64   # dropout seeds per step, as the JAX package draws them


def _encode_windows(vae_params, statics, generator, dqs):
    """dqs: (N, S, C) normalized windows → sampled latents (N, S, L)."""
    n, s, c = dqs.shape
    x = dqs.reshape(n * s, c)[:, :, None]
    mu, logvar = vae.encode(vae_params["encoder"], statics, x)
    z = vae.reparameterize(generator, mu, logvar)
    return z.reshape(n, s, -1)


def compute_latent_stats(vae_params, statics, generator,
                         data: datasets.TemporalTrainData, device,
                         batch: int = 256) -> Tuple[np.ndarray, np.ndarray]:
    """Mean/std of sampled latents over all past+future windows."""
    both = np.concatenate((data.dqs_past, data.dqs_future), axis=1)
    buf = []
    with torch.no_grad():
        for i in range(0, both.shape[0], batch):
            x = torch.as_tensor(both[i: i + batch], device=device)
            buf.append(_encode_windows(vae_params, statics, generator, x))
    lat = torch.cat(buf).reshape(-1, buf[0].shape[-1]).cpu().numpy()
    return lat.mean(axis=0), lat.std(axis=0, ddof=1)


def draw_limb_noise(generator: torch.Generator, prob: float):
    """Per-limb replace flags and the noise seed, drawn on the host."""
    applies = (torch.rand(len(LIMBS), generator=generator) < prob).tolist()
    seed = int(torch.randint(0, 2 ** 31 - 1, (1,), generator=generator))
    return applies, seed


def _limb_noise(dqs_past, mean_dqs, std_dqs, applies: Sequence[bool],
                seed: int):
    """Replace whole limbs (those whose flag is set) in all-but-last past
    frames with counter-hash noise at the dataset's scale.  A host branch
    skips the draw when no limb fires."""
    if not any(applies):
        return dqs_past
    b, p, c = dqs_past.shape
    dq = dqs_past.reshape(b, p, -1, 8)
    j = dq.shape[2]
    replace = torch.zeros(j, dtype=torch.bool)
    for limb, on in zip(LIMBS, applies):
        if on:
            replace[list(limb)] = True
    noise = (hash_dropout.normal((b, p - 1, j, 8), seed, dq.device)
             * std_dqs.reshape(-1, 8) + mean_dqs.reshape(-1, 8))
    head = torch.where(replace.to(dq.device)[None, None, :, None], noise,
                       dq[:, :-1])
    return torch.cat((head, dq[:, -1:]), dim=1).reshape(b, p, c)


def _teacher_forced_loss(tparams, param, latents, latents_future, disp_acc,
                         heights, means_latent, stds_latent, *, train: bool,
                         seeds: Sequence[int] | None = None,
                         layout: str = "lanes"):
    """MSE of the teacher-forced predictor.  ``layout="lanes"`` runs
    ``forward_T`` (the JAX package's TPU defaults ``fused_ff`` and
    ``fused_attn``), ``"rows"`` runs ``forward`` (in training JAX's
    ``fused_ff=True``).  The two give the same loss at dropout 0."""
    lat = (latents - means_latent) / stds_latent
    lat_t = (latents_future - means_latent) / stds_latent
    enc_in = torch.cat((lat, disp_acc, heights), dim=-1)[:, :-1]
    dec_in = torch.cat((lat[:, -1:], lat_t[:, :-1]), dim=1)
    mask = tmodel.causal_mask(dec_in.shape[1], lat.device)
    if layout == "rows":
        out = tmodel.forward(tparams, param, enc_in, dec_in, mask,
                             train=train, seeds=seeds)
        return ((out - lat_t) ** 2).mean()
    out_T = tmodel.forward_T(tparams, param, enc_in.permute(1, 2, 0),
                             dec_in.permute(1, 2, 0), mask, train=train,
                             seeds=seeds)
    return ((out_T - lat_t.permute(1, 2, 0)) ** 2).mean()


def make_optimizer(tparams, param) -> torch.optim.Adam:
    """Adam over the tree's leaves, optax ``adam``'s update (b1 0.9, b2
    0.999, eps 1e-8); one tensor at a time, no fused or foreach kernel."""
    return torch.optim.Adam([t for _, t in tmodel.named_leaves(tparams)],
                            lr=param["learning_rate"], betas=(0.9, 0.999),
                            eps=1e-8, foreach=False, fused=False)


def apply_step(tparams, optimizer, param, latents, latents_future, disp_acc,
               heights, means_latent, stds_latent, seeds: Sequence[int],
               layout: str = "lanes"):
    """One Adam step on given latents and dropout seeds; returns the loss
    as a device scalar (no host sync)."""
    optimizer.zero_grad(set_to_none=True)
    loss = _teacher_forced_loss(
        tparams, param, latents, latents_future, disp_acc, heights,
        means_latent, stds_latent, train=True, seeds=seeds, layout=layout)
    loss.backward()
    optimizer.step()
    return loss.detach()


def make_train_step(vae_params, statics, param, optimizer,
                    layout: str = "lanes"):
    """The training step: limb noise, one frozen-VAE encode of past+future,
    then :func:`apply_step` in ``layout``."""
    prob = param["limbs_random_prob"]

    def step(tparams, host_gen, dev_gen, dqs_past, dqs_future, disp_acc,
             heights, mean_dqs, std_dqs, means_latent, stds_latent):
        applies, noise_seed = draw_limb_noise(host_gen, prob)
        dqs_past = _limb_noise(dqs_past, mean_dqs, std_dqs, applies,
                               noise_seed)
        with torch.no_grad():
            both = _encode_windows(vae_params, statics, dev_gen,
                                   torch.cat((dqs_past, dqs_future), dim=1))
        p = dqs_past.shape[1]
        seeds = hash_dropout.seeds_for(host_gen, N_SEEDS)
        return apply_step(tparams, optimizer, param, both[:, :p],
                          both[:, p:], disp_acc, heights, means_latent,
                          stds_latent, seeds, layout)

    return step


_STAGED = ("dqs_past", "dqs_future", "disp_past_acc", "heights")


def stage_dataset(data: datasets.TemporalTrainData, device):
    """The tensors the loop reads, moved to ``device`` once; batches are
    then gathered there by index."""
    return dataclasses.replace(data, **{
        f: torch.as_tensor(getattr(data, f), device=device) for f in _STAGED})


def make_eval_step(vae_params, statics, param):
    def step(tparams, generator, dqs_past, dqs_future, disp_acc, heights,
             means_latent, stds_latent):
        with torch.no_grad():
            both = _encode_windows(vae_params, statics, generator,
                                   torch.cat((dqs_past, dqs_future), dim=1))
            p = dqs_past.shape[1]
            return _teacher_forced_loss(
                tparams, param, both[:, :p], both[:, p:], disp_acc, heights,
                means_latent, stds_latent, train=False, layout="rows")

    return step


def evaluate(eval_step, tparams, generator, data, means_latent, stds_latent,
             batch: int) -> float:
    """Window-weighted mean loss over staged ``data`` (one host fetch)."""
    losses, weights = [], []
    n = data.dqs_past.shape[0]
    for i in range(0, n, batch):
        sl = slice(i, min(i + batch, n))
        losses.append(eval_step(tparams, generator, data.dqs_past[sl],
                                data.dqs_future[sl], data.disp_past_acc[sl],
                                data.heights[sl], means_latent, stds_latent))
        weights.append(sl.stop - sl.start)
    if not losses:
        return float("inf")
    return float(np.average(torch.stack(losses).cpu().numpy(),
                            weights=weights))


# ---------------------------------------------------------------------------
# Exact resume: Adam moments and generator states
# ---------------------------------------------------------------------------

def opt_state_tree(optimizer, tparams) -> Dict:
    """The Adam moments as trees shaped like the params, and the step."""
    m, v, step = {}, {}, 0.0
    for path, t in tmodel.named_leaves(tparams):
        st = optimizer.state.get(t)
        if st:
            m[path], v[path] = st["exp_avg"], st["exp_avg_sq"]
            step = float(st["step"])
    return {"m": checkpoint._unflatten(m), "v": checkpoint._unflatten(v),
            "step": np.asarray(step, np.float32)}


def load_opt_state(optimizer, tparams, opt: Dict) -> None:
    m = dict(tmodel.named_leaves(opt["m"]))
    v = dict(tmodel.named_leaves(opt["v"]))
    step = float(opt["step"])
    for path, t in tmodel.named_leaves(tparams):
        if path in m:
            optimizer.state[t] = {
                "step": torch.tensor(step, dtype=torch.float32),
                "exp_avg": torch.as_tensor(m[path], device=t.device).clone(),
                "exp_avg_sq": torch.as_tensor(v[path],
                                              device=t.device).clone()}


def _assign(tparams, values) -> None:
    new = dict(tmodel.named_leaves(values))
    with torch.no_grad():
        for path, t in tmodel.named_leaves(tparams):
            t.copy_(torch.as_tensor(new[path], dtype=torch.float32))


# ---------------------------------------------------------------------------
# The training loop
# ---------------------------------------------------------------------------

def train(data_dir: str, model_dir: str, param=None, *,
          epochs: int | None = None, load: bool = False,
          eval_window_step: int | None = None, seed: int | None = None,
          log=print, device=None, layout: str = "lanes") -> Dict:
    """Train on ``data_dir/train``, select on ``data_dir/eval``; writes
    ``temporal.npz`` (best eval loss) and ``temporal.last.npz`` (exact
    resume state) into ``model_dir``, which holds the generator.  Runs on
    ``cuda`` unless ``device="cpu"``, its steps in ``layout`` ("lanes" or
    "rows").  Returns ``{"params", "history",
    "means_latent", "stds_latent"}``; each history entry has the epoch's
    losses, its steps and windows, and ``train_seconds`` (the steps, ended
    by the one host fetch of the losses)."""
    dev = resolve_device(device)
    param = param or cfg.TEMPORAL_PARAM
    vae_param = cfg.VAE_PARAM

    log(f"loading data from {data_dir} ...")
    train_motions, skeleton, _ = datasets.load_motion_dir(
        os.path.join(data_dir, "train"), param,
        height_indices=param["height_indices"])
    eval_motions, _, _ = datasets.load_motion_dir(
        os.path.join(data_dir, "eval"), param,
        height_indices=param["height_indices"])
    gen_params, means, stds = loading.load_generator(model_dir)
    vae_params = loading.tree_to_torch(gen_params, dev)
    statics = vae.build_statics(skeleton.parents, vae_param)

    log("building windows ...")
    data = datasets.load_or_build_temporal_dataset(train_motions, param,
                                                   means, stds, data_dir)
    # the reference evaluates on non-overlapping windows (step = window size)
    eval_param = dict(param,
                      window_step=eval_window_step or param["window_size"])
    eval_data = datasets.build_temporal_dataset(eval_motions, eval_param,
                                                means, stds)

    seed = vae_param["seed"] if seed is None else seed
    host_gen = torch.Generator().manual_seed(seed)
    dev_gen = torch.Generator(device=dev).manual_seed(seed)
    tparams = tmodel.init_params(host_gen, param, dev)

    resume_state = None
    resume_best = False
    last_path = os.path.join(model_dir, "temporal.last.npz")
    best_path = os.path.join(model_dir, "temporal.npz")
    if load:
        if os.path.exists(last_path):
            resume_state = last_path
        else:
            resume_best = True   # re-establish the bar before overwriting
        loaded, extra = checkpoint.load(best_path)
        _assign(tparams, loaded)
        ml, sl = extra["means_latent"], extra["stds_latent"]
    else:
        log(f"computing latent stats over {data.dqs_past.shape[0]} "
            "windows ...")
        ml, sl = compute_latent_stats(vae_params, statics, dev_gen, data, dev)
    means_latent = torch.as_tensor(ml, dtype=torch.float32, device=dev)
    stds_latent = torch.as_tensor(sl, dtype=torch.float32, device=dev)
    log(f"training: {data.dqs_past.shape[0]} windows, "
        f"{tmodel.count_params(tparams)} temporal params on {dev}")

    optimizer = make_optimizer(tparams, param)
    data = stage_dataset(data, dev)
    eval_data = stage_dataset(eval_data, dev)
    train_step = make_train_step(vae_params, statics, param, optimizer,
                                 layout)
    eval_step = make_eval_step(vae_params, statics, param)
    mean_dqs = torch.as_tensor(means["dqs"], device=dev)
    std_dqs = torch.as_tensor(stds["dqs"], device=dev)

    n = data.dqs_past.shape[0]
    bs = min(param["batch_size"], n)
    eval_bs = min(bs, eval_data.dqs_past.shape[0])
    best = float("inf")
    start_epoch = 0
    if resume_state:
        rparams, opt, rextra = checkpoint.load_training_state(resume_state)
        _assign(tparams, rparams)
        load_opt_state(optimizer, tparams, opt)
        best = float(rextra["best"])
        start_epoch = int(rextra["epoch"]) + 1
        host_gen.set_state(torch.as_tensor(rextra["rng_host"]))
        dev_gen.set_state(torch.as_tensor(rextra["rng_device"]))
        log(f"exact resume from {resume_state}: epoch {start_epoch}, "
            f"best {best:.4f}")
    if resume_best:
        best = evaluate(eval_step, tparams, dev_gen, eval_data, means_latent,
                        stds_latent, eval_bs)
        log(f"resumed; previous checkpoint eval loss: {best:.4f}")

    extra_stats = {"means_latent": np.asarray(ml, np.float32),
                   "stds_latent": np.asarray(sl, np.float32)}
    take = lambda a, idx: a.index_select(0, idx)  # noqa: E731
    history: List[Dict] = []
    n_epochs = epochs if epochs is not None else param["epochs"]
    start = time.time()
    for epoch in range(start_epoch, n_epochs):
        order = torch.randperm(n, generator=host_gen).to(dev)
        step_losses = []   # device scalars; ONE host fetch per epoch
        epoch_time = time.time()
        for i in range(0, n - bs + 1, bs):   # partial batches dropped
            idx = order[i: i + bs]
            step_losses.append(train_step(
                tparams, host_gen, dev_gen, take(data.dqs_past, idx),
                take(data.dqs_future, idx), take(data.disp_past_acc, idx),
                take(data.heights, idx), mean_dqs, std_dqs, means_latent,
                stds_latent))
        count = len(step_losses)
        epoch_loss = float(torch.stack(step_losses).sum()) if count else 0.0
        train_seconds = time.time() - epoch_time
        eval_loss = evaluate(eval_step, tparams, dev_gen, eval_data,
                             means_latent, stds_latent, eval_bs)
        was_best = eval_loss < best
        if was_best:
            best = eval_loss
            checkpoint.save(best_path, tparams, extra=extra_stats)
        checkpoint.save_training_state(
            last_path, tparams, opt_state_tree(optimizer, tparams),
            extra={**extra_stats, "epoch": np.asarray(epoch),
                   "best": np.asarray(best),
                   "rng_host": host_gen.get_state().numpy(),
                   "rng_device": dev_gen.get_state().numpy()})
        history.append({"epoch": epoch, "steps": count, "windows": count * bs,
                        "train_loss": epoch_loss / max(count, 1),
                        "eval_loss": eval_loss,
                        "train_seconds": train_seconds})
        log(f"Epoch: {epoch} // Train Loss: {epoch_loss / max(count, 1):.4f}"
            f" // Eval Loss: {eval_loss:.4f} // "
            f"Time: {time.time() - epoch_time:.1f} "
            f"({time.time() - start:.1f})" + ("*" if was_best else ""))
    return {"params": tparams, "history": history,
            "means_latent": means_latent, "stds_latent": stds_latent}
