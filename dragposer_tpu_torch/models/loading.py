"""Model-directory loading (port of ``dragposer_tpu/models/loading.py``),
and the function that carries weights across from the JAX package.

A model directory is interchangeable with the reference's
(``models/model_<name>_<data>/``): the native ``generator.npz`` /
``temporal.npz`` first, as the JAX package reads them, else the
reference's ``generator.pt`` + ``data.pt`` / ``temporal.pt``
(``models/torch_import.py``).  Parameter trees keep the JAX package's
structure (nested dicts and lists, torch ``(out, in)`` weight convention),
with numpy leaves on the host and torch tensors on the device.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from dragposer_tpu_torch import config as cfg
from dragposer_tpu_torch.models import checkpoint, torch_import


def tree_to_torch(tree: Any, device, dtype=torch.float32) -> Any:
    """Carry a parameter tree across: nested dicts/lists/tuples of arrays
    (numpy, or anything ``np.asarray`` takes, such as the JAX package's
    arrays) become the same structure of float32 tensors on ``device``.

    This is how a JAX-side VAE or temporal parameter tree becomes the
    port's: ``tree_to_torch(jax.device_get(params), device)``."""
    if isinstance(tree, dict):
        return {k: tree_to_torch(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to_torch(v, device, dtype) for v in tree)
    return torch.as_tensor(np.asarray(tree), dtype=dtype, device=device)


def load_generator(model_dir: str, parents=None,
                   param=None) -> Tuple[Dict, Dict, Dict]:
    """Returns ``(vae_params, means, stds)`` as numpy trees; prefers the
    native format.  The ``.pt`` files are checked against the statics of
    ``parents`` under ``param`` (default ``config.VAE_PARAM``), so they
    need the skeleton's parents."""
    native = os.path.join(model_dir, "generator.npz")
    if os.path.exists(native):
        params, extra = checkpoint.load(native)
        return params, extra["means"], extra["stds"]
    if not os.path.exists(os.path.join(model_dir, "generator.pt")):
        raise FileNotFoundError(
            f"{model_dir}: no generator.npz, nor the reference's "
            "generator.pt")
    if parents is None:
        raise ValueError(f"{model_dir} has no generator.npz; reading its "
                         "generator.pt needs the skeleton's parents")
    return torch_import.load_generator(model_dir, parents,
                                       param or cfg.VAE_PARAM)


def load_temporal(model_dir: str, param=None) -> Optional[
        Tuple[Dict, np.ndarray, np.ndarray]]:
    """Returns ``(params, means_latent, stds_latent)``, or None if absent;
    prefers the native format (``param``: default
    ``config.TEMPORAL_PARAM``, for ``temporal.pt``)."""
    native = os.path.join(model_dir, "temporal.npz")
    if os.path.exists(native):
        params, extra = checkpoint.load(native)
        return params, extra["means_latent"], extra["stds_latent"]
    if os.path.exists(os.path.join(model_dir, "temporal.pt")):
        return torch_import.load_temporal(model_dir,
                                          param or cfg.TEMPORAL_PARAM)
    return None
