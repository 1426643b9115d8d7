"""Structured pose VAE, the parts the drag path uses (port of
``dragposer_tpu/models/vae.py``).

* encoder: 3 × (SkeletonConv → SkeletonPool → LeakyReLU 0.2) collapsing
  22 → 14 → 9 → 6 joints at 8 channels per joint, then linear heads
  48 → 24 for (mu, logvar);
* decoder, folded for inference into three dense matmuls
  24 → 40 → 60 → 92 (LeakyReLU 0.2 between), whose quaternion output is
  de-normalized, unit-normalized and re-normalized.

The static structure (masks, pool matrices) comes from the skeleton
topology, exactly as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

from dragposer_tpu_torch.models import skeleton_nn as nn
from dragposer_tpu_torch.ops import topology

N_LAYERS = 3
ENC_CPJ = 8   # encoder channels per joint
DEC_CPJ = 4   # decoder channels per joint
CHANNELS_PER_JOINT = 4


@dataclass(frozen=True)
class VAEStatics:
    """Static (non-trainable) structure, host numpy arrays."""

    enc_masks: Tuple[np.ndarray, ...]
    enc_pools: Tuple[np.ndarray, ...]
    dec_masks: Tuple[np.ndarray, ...]
    dec_unpools: Tuple[np.ndarray, ...]
    kernel: int
    latent_dim: int
    n_joints: int


def build_statics(parents, param) -> VAEStatics:
    kernel = param["kernel_size_temporal_dim"]
    nd = param["neighbor_distance"]

    enc_parents = [np.asarray(parents)]
    enc_poolings = []
    p = parents
    for _ in range(N_LAYERS):
        pooling, p = topology.pooling_schedule(p, add_displacement=False)
        enc_poolings.append(pooling)
        enc_parents.append(np.asarray(p))
    enc_masks, enc_pools = [], []
    for l in range(N_LAYERS):
        hood = topology.neighbor_lists(enc_parents[l], nd,
                                       add_displacement=False)
        enc_masks.append(topology.conv_mask(hood, ENC_CPJ, ENC_CPJ, kernel))
        enc_pools.append(topology.pool_matrix(
            enc_poolings[l], len(enc_parents[l]), ENC_CPJ))

    # displacement pseudo-joint on all but the last decoder level
    dec_parents = [np.asarray(parents)]
    dec_poolings = []
    p = parents
    for l in range(N_LAYERS):
        pooling, p = topology.pooling_schedule(
            p, add_displacement=(l != N_LAYERS - 1))
        dec_poolings.append(pooling)
        dec_parents.append(np.asarray(p))
    dec_masks, dec_unpools = [], []
    for l in range(N_LAYERS):
        level = N_LAYERS - l - 1
        hood = topology.neighbor_lists(dec_parents[level], nd,
                                       add_displacement=True)
        dec_masks.append(topology.conv_mask(hood, DEC_CPJ, DEC_CPJ, kernel))
        dec_unpools.append(topology.unpool_matrix(dec_poolings[level],
                                                  DEC_CPJ))

    f32 = lambda ms: tuple(np.asarray(m, np.float32) for m in ms)  # noqa: E731
    return VAEStatics(
        enc_masks=f32(enc_masks), enc_pools=f32(enc_pools),
        dec_masks=f32(dec_masks), dec_unpools=f32(dec_unpools),
        kernel=kernel, latent_dim=param["latent_dim"],
        n_joints=len(parents),
    )


def encode(params, statics: VAEStatics, x):
    """x: (B, J*8, T) normalized root-space dual quats → (mu, logvar) (B, L)."""
    h = x
    for l in range(N_LAYERS):
        mask = torch.as_tensor(statics.enc_masks[l], device=x.device)
        pool = torch.as_tensor(statics.enc_pools[l], device=x.device)
        h = nn.skeleton_conv(h, params["convs"][l], mask)
        h = nn.leaky_relu(nn.pool(h, pool))
    h = h.reshape(h.shape[0], -1)
    return nn.linear(h, params["f_mu"]), nn.linear(h, params["f_logvar"])


def reparameterize(generator: torch.Generator, mu, logvar):
    std = torch.exp(0.5 * logvar)
    noise = torch.randn(std.shape, generator=generator, dtype=std.dtype,
                        device=std.device)
    return mu + noise * std


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
