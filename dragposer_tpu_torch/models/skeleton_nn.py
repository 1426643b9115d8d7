"""Skeleton-aware network blocks (port of ``dragposer_tpu/models/skeleton_nn.py``).

The skeleton convolution is a dense 1-D convolution whose weight is masked
to per-joint graph neighbourhoods, over time with reflect padding and a
stride; pooling and unpooling are constant matrices from the topology.
The checkpoints use kernel size 1 and stride 1, where every block is one
masked matmul.  Parameters are
plain dicts of tensors in the torch ``(out, in)`` convention.  Init draws
from a CPU ``torch.Generator`` with the JAX package's distributions
(torch's kaiming_uniform(a=√5) restricted to each joint's neighbourhood:
U(±1/√fan_in) on the masked block).
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from dragposer_tpu_torch.ops import topology

LEAKY_SLOPE = 0.2   # the VAE's slope (reference generator), not torch's 0.01


def _uniform(gen, shape, bound):
    return (torch.rand(shape, generator=gen, dtype=torch.float32) * 2.0
            - 1.0) * bound


def init_skeleton_conv(gen: torch.Generator, neighbors: List[List[int]],
                       in_cpj: int, out_cpj: int,
                       kernel: int) -> Dict[str, torch.Tensor]:
    """Weight (J·out, J·in, kernel) nonzero only on each joint's
    neighbourhood columns; bias (J·out,)."""
    n = len(neighbors)
    w = np.zeros((n * out_cpj, n * in_cpj, kernel), dtype=np.float32)
    b = np.zeros((n * out_cpj,), dtype=np.float32)
    for i, cols in enumerate(topology.expand_neighbors(neighbors, in_cpj)):
        bound = 1.0 / math.sqrt(len(cols) * kernel)
        rows = slice(i * out_cpj, (i + 1) * out_cpj)
        w[rows, cols, :] = _uniform(gen, (out_cpj, len(cols), kernel),
                                    bound).numpy()
        b[rows] = _uniform(gen, (out_cpj,), bound).numpy()
    return {"w": torch.as_tensor(w), "b": torch.as_tensor(b)}


def init_linear(gen: torch.Generator, in_dim: int, out_dim: int,
                zero_weight: bool = False) -> Dict[str, torch.Tensor]:
    bound = 1.0 / math.sqrt(in_dim)
    w = (torch.zeros((out_dim, in_dim)) if zero_weight
         else _uniform(gen, (out_dim, in_dim), bound))
    return {"w": w, "b": _uniform(gen, (out_dim,), bound)}


def skeleton_conv(x, params, mask, padding: int = 0, stride: int = 1):
    """Masked conv1d with reflect padding.  x: (B, C_in, T) → (B, C_out,
    T'), T' = (T + 2·padding − kernel) // stride + 1."""
    w = params["w"] * mask
    b = params["b"][None, :, None]
    if w.shape[-1] == 1 and padding == 0 and stride == 1:
        return torch.einsum("oc,bct->bot", w[:, :, 0], x) + b
    if padding > 0:
        # numpy's (and jnp.pad's) reflect indices, a length-1 axis included
        idx = np.pad(np.arange(x.shape[-1]), padding, mode="reflect")
        x = x[..., torch.as_tensor(idx, device=x.device)]
    return torch.nn.functional.conv1d(x, w, stride=stride) + b


def pool(x, pool_mat):
    """(B, C_old, T) → (B, C_new, T) via the constant averaging matrix."""
    return torch.einsum("oc,bct->bot", pool_mat, x)


def unpool(x, unpool_mat):
    """(B, C_old, T) → (B, C_new, T) via the constant copying matrix."""
    return torch.einsum("oc,bct->bot", unpool_mat, x)


def linear(x, params):
    """y = x @ Wᵀ + b with W (out, in)."""
    return x @ params["w"].T + params["b"]


def leaky_relu(x):
    return torch.where(x >= 0, x, LEAKY_SLOPE * x)
