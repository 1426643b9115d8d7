"""Model-directory loading (port of ``dragposer_tpu/models/loading.py``),
and the function that carries weights across from the JAX package.

The port reads the same native ``.npz`` files as the JAX package; the
reference ``.pt`` import is not ported yet.  Parameter trees keep the JAX
package's structure (nested dicts and lists, torch ``(out, in)`` weight
convention), with numpy leaves on the host and torch tensors on the device.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from dragposer_tpu_torch.models import checkpoint


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


def load_generator(model_dir: str) -> Tuple[Dict, Dict, Dict]:
    """Returns ``(vae_params, means, stds)`` as numpy trees."""
    path = os.path.join(model_dir, "generator.npz")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path}: the port reads native .npz checkpoints only")
    params, extra = checkpoint.load(path)
    return params, extra["means"], extra["stds"]


def load_temporal(model_dir: str) -> Optional[Tuple[Dict, np.ndarray,
                                                    np.ndarray]]:
    """Returns ``(params, means_latent, stds_latent)``, or None if absent."""
    path = os.path.join(model_dir, "temporal.npz")
    if not os.path.exists(path):
        return None
    params, extra = checkpoint.load(path)
    return params, extra["means_latent"], extra["stds_latent"]
