"""Counter-hash dropout (port of ``dragposer_tpu/ops/hash_dropout.py``).

A mask element is the murmur3 finalizer ``fmix32`` of ``position +
seed·0x9E3779B1`` (uint32 arithmetic), so for the same int32 seed the
masks are bit for bit those of the JAX package.  PyTorch's uint32 support
is thin, so the hash runs in int64 masked with ``& 0xFFFFFFFF``; the
multiplications are split into 16-bit halves so that no product leaves
int64's range.  Per-site seeds are drawn on the host from a
``torch.Generator`` (:func:`seeds_for`) and reach the kernels as plain
ints: no launch waits on a device-to-host copy.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np
import torch

M32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B1       # seed multiplier
STREAM2 = 0x632BE59B      # offset of normal()'s second stream


def _mul32(h, c: int):
    """(h · c) mod 2³² for int64 ``h`` in [0, 2³²) and a uint32 constant."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def fmix32(h):
    """murmur3 finalizer: full-avalanche bijection on uint32 values held
    in an int64 tensor."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def threshold(rate: float) -> int:
    """Keep iff ``hash >= threshold(rate)``, from the Python float rate."""
    return min(int(rate * (1 << 32)), (1 << 32) - 1)


def keep_scale(rate: float) -> float:
    """The float32 value of ``1/(1-rate)`` that scales a kept element."""
    return float(np.float32(1.0 / (1.0 - rate)))


def _positions(shape, seed: int, device):
    n = math.prod(shape)
    pos = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
    return (pos + ((int(seed) * GOLDEN) & M32)) & M32


def keep_mask(shape, rate: float, seed: int, device="cpu"):
    """Boolean keep mask, P(keep) = 1-rate; ``seed`` a non-negative int."""
    return fmix32(_positions(shape, seed, device)) >= threshold(rate)


def seeds_for(generator: torch.Generator, n: int) -> List[int]:
    """n independent per-site seeds in [0, 2³¹-1), drawn on the host."""
    return torch.randint(0, 2 ** 31 - 1, (n,), generator=generator).tolist()


def dropout(x, rate: float, seed: int, train: bool):
    """Inverted dropout with a counter-hash mask over ``x``'s flat C-order
    positions."""
    if not train or rate == 0.0:
        return x
    keep = keep_mask(x.shape, rate, seed, x.device)
    return torch.where(keep, x * keep_scale(rate), torch.zeros((), dtype=x.dtype,
                                                               device=x.device))


def normal(shape, seed: int, device="cpu", dtype=torch.float32):
    """Counter-hash standard normals (Box-Muller on two fmix32 streams)."""
    base = _positions(shape, seed, device)
    h1 = fmix32(base)
    h2 = fmix32((base + STREAM2) & M32)
    scale = float(np.float32(1.0 / 4294967296.0))
    u1 = (h1.to(torch.float32) + 1.0) * scale
    u2 = h2.to(torch.float32) * scale
    r = torch.sqrt(-2.0 * torch.log(u1))
    two_pi = float(2.0 * np.float32(np.pi))
    return (r * torch.cos(two_pi * u2)).to(dtype)
