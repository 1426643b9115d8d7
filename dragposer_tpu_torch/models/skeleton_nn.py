"""Skeleton-aware network blocks (port of ``dragposer_tpu/models/skeleton_nn.py``).

The skeleton convolution is a dense 1-D convolution whose weight is masked
to per-joint graph neighbourhoods; pooling and unpooling are constant
matrices from the topology.  The checkpoints use kernel size 1, so every
block is one masked matmul; only that case is ported.  Parameters are plain
dicts of tensors in the torch ``(out, in)`` convention.
"""

from __future__ import annotations

import torch

LEAKY_SLOPE = 0.2   # the VAE's slope (reference generator), not torch's 0.01


def skeleton_conv(x, params, mask):
    """Masked kernel-1 conv.  x: (B, C_in, T) → (B, C_out, T)."""
    if params["w"].shape[-1] != 1:
        raise NotImplementedError("only kernel size 1 is ported")
    w = (params["w"] * mask)[:, :, 0]
    return torch.einsum("oc,bct->bot", w, x) + params["b"][None, :, None]


def pool(x, pool_mat):
    """(B, C_old, T) → (B, C_new, T) via the constant averaging matrix."""
    return torch.einsum("oc,bct->bot", pool_mat, x)


def linear(x, params):
    """y = x @ Wᵀ + b with W (out, in)."""
    return x @ params["w"].T + params["b"]


def leaky_relu(x):
    return torch.where(x >= 0, x, LEAKY_SLOPE * x)
