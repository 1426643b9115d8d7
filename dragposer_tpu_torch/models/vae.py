"""Structured pose VAE (port of ``dragposer_tpu/models/vae.py``).

* encoder: 3 × (SkeletonConv → SkeletonPool → LeakyReLU 0.2) collapsing
  22 → 14 → 9 → 6 joints at 8 channels per joint, then linear heads
  48 → 24 for (mu, logvar), the logvar weight zero at init;
* decoder: linear 24 → 24 (6 joints × 4 channels), then 3 × (SkeletonUnpool
  → SkeletonConv [→ LeakyReLU]) expanding to 23 slots (the last is the
  displacement pseudo-joint): :func:`decode`, the form the trainer
  differentiates; for inference folded into three dense matmuls
  24 → 40 → 60 → 92 (:func:`fold_decoder`).  The quaternion output is
  de-normalized, unit-normalized and re-normalized.

The static structure (masks, pool matrices) comes from the skeleton
topology, exactly as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

from dragposer_tpu_torch.models import skeleton_nn as nn
from dragposer_tpu_torch.models.temporal import named_leaves, trainable
from dragposer_tpu_torch.ops import topology

N_LAYERS = 3
ENC_CPJ = 8   # encoder channels per joint
DEC_CPJ = 4   # decoder channels per joint
CHANNELS_PER_JOINT = 4


@dataclass(frozen=True)
class VAEStatics:
    """Static (non-trainable) structure: host numpy arrays, or tensors on a
    device (:func:`statics_on`)."""

    enc_masks: Tuple[np.ndarray, ...]
    enc_pools: Tuple[np.ndarray, ...]
    dec_masks: Tuple[np.ndarray, ...]
    dec_unpools: Tuple[np.ndarray, ...]
    kernel: int
    latent_dim: int
    n_joints: int
    padding: int = 0     # the convolutions' reflect padding, (kernel-1)//2
    stride: int = 1      # the encoder convolutions' stride


def _levels(parents, decoder: bool):
    """Per level, the parent list and the pooling to the next level; the
    decoder adds the displacement pseudo-joint on all but the last."""
    levels, poolings = [np.asarray(parents)], []
    p = parents
    for l in range(N_LAYERS):
        pooling, p = topology.pooling_schedule(
            p, add_displacement=decoder and l != N_LAYERS - 1)
        poolings.append(pooling)
        levels.append(np.asarray(p))
    return levels, poolings


def _hoods(parents, nd):
    """Neighbourhoods of each encoder layer and each decoder layer."""
    enc, _ = _levels(parents, False)
    dec, _ = _levels(parents, True)
    return ([topology.neighbor_lists(enc[l], nd, add_displacement=False)
             for l in range(N_LAYERS)],
            [topology.neighbor_lists(dec[N_LAYERS - l - 1], nd,
                                     add_displacement=True)
             for l in range(N_LAYERS)])


def build_statics(parents, param) -> VAEStatics:
    kernel = param["kernel_size_temporal_dim"]
    enc_parents, enc_poolings = _levels(parents, False)
    _, dec_poolings = _levels(parents, True)
    enc_hoods, dec_hoods = _hoods(parents, param["neighbor_distance"])
    enc_masks = [topology.conv_mask(h, ENC_CPJ, ENC_CPJ, kernel)
                 for h in enc_hoods]
    enc_pools = [topology.pool_matrix(enc_poolings[l], len(enc_parents[l]),
                                      ENC_CPJ) for l in range(N_LAYERS)]
    dec_masks = [topology.conv_mask(h, DEC_CPJ, DEC_CPJ, kernel)
                 for h in dec_hoods]
    dec_unpools = [topology.unpool_matrix(dec_poolings[N_LAYERS - l - 1],
                                          DEC_CPJ) for l in range(N_LAYERS)]

    f32 = lambda ms: tuple(np.asarray(m, np.float32) for m in ms)  # noqa: E731
    return VAEStatics(
        enc_masks=f32(enc_masks), enc_pools=f32(enc_pools),
        dec_masks=f32(dec_masks), dec_unpools=f32(dec_unpools),
        kernel=kernel, latent_dim=param["latent_dim"],
        n_joints=len(parents), padding=(kernel - 1) // 2,
        stride=param["stride_encoder_conv"],
    )


def statics_on(statics: VAEStatics, device) -> VAEStatics:
    """The same statics as float32 tensors on ``device``, so that a step
    copies none of them from the host."""
    on = lambda ms: tuple(torch.as_tensor(m, device=device) for m in ms)  # noqa: E731
    return dataclasses.replace(
        statics, enc_masks=on(statics.enc_masks),
        enc_pools=on(statics.enc_pools), dec_masks=on(statics.dec_masks),
        dec_unpools=on(statics.dec_unpools))


def init_params(generator: torch.Generator, parents, param, device="cpu"):
    """Fresh parameters (the JAX package's distributions, drawn from a CPU
    ``torch.Generator``), as leaf tensors on ``device`` that require
    gradients."""
    kernel = param["kernel_size_temporal_dim"]
    enc_parents, _ = _levels(parents, False)
    dec_parents, _ = _levels(parents, True)
    enc_hoods, dec_hoods = _hoods(parents, param["neighbor_distance"])
    latent, gen = param["latent_dim"], generator
    encoder = {
        "convs": [nn.init_skeleton_conv(gen, h, ENC_CPJ, ENC_CPJ, kernel)
                  for h in enc_hoods],
        "f_mu": nn.init_linear(gen, ENC_CPJ * len(enc_parents[-1]), latent),
        "f_logvar": nn.init_linear(gen, ENC_CPJ * len(enc_parents[-1]),
                                   latent, zero_weight=True),
    }
    decoder = {
        "f_latent": nn.init_linear(gen, latent,
                                   DEC_CPJ * len(dec_parents[-1])),
        "convs": [nn.init_skeleton_conv(gen, h, DEC_CPJ, DEC_CPJ, kernel)
                  for h in dec_hoods],
    }
    return trainable({"encoder": encoder, "decoder": decoder}, device)


def encode(params, statics: VAEStatics, x):
    """x: (B, J*8, T) normalized root-space dual quats → (mu, logvar) (B, L)."""
    h = x
    for l in range(N_LAYERS):
        mask = torch.as_tensor(statics.enc_masks[l], device=x.device)
        pool = torch.as_tensor(statics.enc_pools[l], device=x.device)
        h = nn.skeleton_conv(h, params["convs"][l], mask, statics.padding,
                             statics.stride)
        h = nn.leaky_relu(nn.pool(h, pool))
    h = h.reshape(h.shape[0], -1)
    return nn.linear(h, params["f_mu"]), nn.linear(h, params["f_logvar"])


def reparameterize(generator: torch.Generator, mu, logvar, noise=None):
    """mu + ε·exp(logvar/2), ε drawn from ``generator`` unless given."""
    std = torch.exp(0.5 * logvar)
    if noise is None:
        noise = torch.randn(std.shape, generator=generator, dtype=std.dtype,
                            device=std.device)
    return mu + noise * std


def _unit_quats(h, mean_dqs, std_dqs):
    """Decoder output (B, J*4 + 4, T) → (motion (B, J*4, T) whose
    de-normalized quaternions are unit, displacement (B, 3, T))."""
    cpj = CHANNELS_PER_JOINT
    motion, displacement = h[:, :-cpj], h[:, -cpj:][:, :3]
    mean_q, std_q = (s[None, :, None] for s in quat_stats(mean_dqs, std_dqs))
    motion = motion * std_q + mean_q
    b, c, t = motion.shape
    q = motion.reshape(b, c // cpj, cpj, t)
    q = q / torch.linalg.norm(q, dim=2, keepdim=True)
    return (q.reshape(b, c, t) - mean_q) / std_q, displacement


def decode(params, statics: VAEStatics, z, mean_dqs, std_dqs):
    """The unfolded decoder: z (B, L) → (motion (B, J*4, 1), displacement
    (B, 3, 1)), motion in normalized quaternion channels."""
    h = nn.linear(z, params["f_latent"])[..., None]
    for l in range(N_LAYERS):
        h = nn.unpool(h, torch.as_tensor(statics.dec_unpools[l],
                                         device=z.device))
        h = nn.skeleton_conv(h, params["convs"][l], torch.as_tensor(
            statics.dec_masks[l], device=z.device), statics.padding, 1)
        if l != N_LAYERS - 1:
            h = nn.leaky_relu(h)
    return _unit_quats(h, mean_dqs, std_dqs)


def decode_folded(folded, z, mean_dqs, std_dqs):
    """:func:`decode` on folded weights (inference): the same outputs."""
    h = z
    for l in range(N_LAYERS):
        h = h @ folded["ws"][l].T + folded["bs"][l]
        if l != N_LAYERS - 1:
            h = nn.leaky_relu(h)
    return _unit_quats(h[..., None], mean_dqs, std_dqs)


def forward(params, statics: VAEStatics, generator, x, mean_dqs, std_dqs,
            noise=None):
    """x (B, J*8, T) → (motion, displacement, mu, logvar, z)."""
    mu, logvar = encode(params["encoder"], statics, x)
    z = reparameterize(generator, mu, logvar, noise)
    motion, displacement = decode(params["decoder"], statics, z, mean_dqs,
                                  std_dqs)
    return motion, displacement, mu, logvar, z


def sample(params, statics: VAEStatics, generator, n_samples: int, mean_dqs,
           std_dqs, mean=None, base_std: float = 0.3, noise=None):
    """Decode draws from the latent prior N(mean, base_std²); ``noise``
    (n, L) replaces the standard normal draw when given."""
    latent, dev = statics.latent_dim, mean_dqs.device
    mu = (torch.zeros((n_samples, latent), device=dev) if mean is None else
          torch.as_tensor(mean, dtype=torch.float32,
                          device=dev).reshape(1, latent).expand(n_samples, -1))
    if noise is None:
        noise = torch.randn((n_samples, latent), generator=generator,
                            device=dev)
    return decode(params["decoder"], statics, mu + noise * base_std,
                  mean_dqs, std_dqs)


def count_params(params, statics: VAEStatics) -> int:
    """Parameters as the reference counts them: the trainable leaves and
    the frozen masks and pool/unpool matrices (168,352 for the example
    skeleton)."""
    return sum(int(np.prod(t.shape)) for _, t in named_leaves(params)) + sum(
        int(np.prod(m.shape)) for m in (*statics.enc_masks, *statics.enc_pools,
                                        *statics.dec_masks,
                                        *statics.dec_unpools))


def fold_decoder(dec_params, statics: VAEStatics, device) -> Dict:
    """Pre-fold the decoder into 3 dense matmuls (kernel size 1): the
    constant unpool matrices and masks fold into the conv weights, and the
    latent projection folds into layer 0.  ``dec_params`` is a numpy tree;
    the folding is done in numpy float32, as in the JAX package."""
    if statics.kernel != 1:
        raise NotImplementedError("folding assumes kernel size 1")
    ws, bs = [], []
    w_in = np.asarray(dec_params["f_latent"]["w"], np.float32)
    b_in = np.asarray(dec_params["f_latent"]["b"], np.float32)
    for l in range(N_LAYERS):
        conv = (np.asarray(dec_params["convs"][l]["w"], np.float32)[:, :, 0]
                * statics.dec_masks[l][:, :, 0])
        w_layer = conv @ statics.dec_unpools[l]
        b_conv = np.asarray(dec_params["convs"][l]["b"], np.float32)
        if l == 0:
            ws.append(w_layer @ w_in)
            bs.append(w_layer @ b_in + b_conv)
        else:
            ws.append(w_layer)
            bs.append(b_conv)
    to = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)  # noqa: E731
    return {"ws": [to(w) for w in ws], "bs": [to(b) for b in bs]}


def quat_stats(mean_dqs, std_dqs):
    """Quaternion channels of the per-joint dual-quat stats, (J*4,) each."""
    cpj = CHANNELS_PER_JOINT
    return (mean_dqs.reshape(-1, 8)[:, :cpj].reshape(-1),
            std_dqs.reshape(-1, 8)[:, :cpj].reshape(-1))


def decode_folded_flat(folded, z, mean_dqs, std_dqs):
    """z (..., L) → (pose_n (..., J*4), displacement (..., 3))."""
    cpj = CHANNELS_PER_JOINT
    h = z
    for l in range(N_LAYERS):
        h = h @ folded["ws"][l].T + folded["bs"][l]
        if l != N_LAYERS - 1:
            h = nn.leaky_relu(h)
    motion = h[..., :-cpj]
    displacement = h[..., -cpj:-cpj + 3]
    mean_q, std_q = quat_stats(mean_dqs, std_dqs)
    x = motion * std_q + mean_q
    q = x.reshape(x.shape[:-1] + (-1, cpj))
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    return (q.reshape(x.shape) - mean_q) / std_q, displacement
