"""Native checkpoints (port of ``dragposer_tpu/models/checkpoint.py``).

A model directory holds ``generator.npz`` (VAE params under ``params/…``
plus ``extra/means|stds/…``), ``temporal.npz`` (temporal params plus
``extra/means_latent|stds_latent``) and ``parameters.json``.  Paths inside
an archive are slash-separated pytree paths; all-digit keys are lists.
Archives written here are read by the JAX package's ``checkpoint.load``
and the other way round.  The training state (``temporal.last.npz``) adds
the optimizer state under ``opt/…``; it resumes exactly within the port.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Tuple

import numpy as np
import torch


def _flatten(tree: Any, prefix: str, out: Dict[str, np.ndarray]) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}{k}/", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}{i}/", out)
    elif torch.is_tensor(tree):
        out[prefix[:-1]] = tree.detach().cpu().numpy()
    else:
        out[prefix[:-1]] = np.asarray(tree)


def _unflatten(flat: Dict[str, np.ndarray]) -> Any:
    root: Dict = {}
    for path, value in flat.items():
        keys = path.split("/")
        node = root
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = value

    def listify(node):
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys and all(k.isdigit() for k in keys):
            return [listify(node[str(i)]) for i in range(len(keys))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def _section(flat: Dict[str, np.ndarray], name: str) -> Any:
    n = len(name) + 1
    part = {k[n:]: v for k, v in flat.items() if k.startswith(name + "/")}
    return _unflatten(part) if part else {}


def _write(path: str, flat: Dict[str, np.ndarray]) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **flat)
    os.replace(tmp, path)


def save(path: str, params: Any, extra: Dict[str, Any] | None = None) -> None:
    """Params (numpy or tensor leaves) under ``params/…``, ``extra`` under
    ``extra/…``; written atomically."""
    flat: Dict[str, np.ndarray] = {}
    _flatten(params, "params/", flat)
    if extra:
        _flatten(extra, "extra/", flat)
    _write(path, flat)


def load(path: str) -> Tuple[Any, Dict[str, Any]]:
    """Returns ``(params, extra)`` as nested dicts/lists of numpy arrays."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    return _section(flat, "params"), _section(flat, "extra")


def save_training_state(path: str, params: Any, opt_state: Any,
                        extra: Dict[str, Any] | None = None) -> None:
    """Full resume checkpoint: params, the optimizer state tree under
    ``opt/…`` and scalars under ``extra/…``."""
    flat: Dict[str, np.ndarray] = {}
    _flatten(params, "params/", flat)
    _flatten(opt_state, "opt/", flat)
    if extra:
        _flatten(extra, "extra/", flat)
    _write(path, flat)


def load_training_state(path: str) -> Tuple[Any, Any, Dict[str, Any]]:
    """Returns ``(params, opt_state, extra)`` as numpy trees."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    return (_section(flat, "params"), _section(flat, "opt"),
            _section(flat, "extra"))


def save_hparams(model_dir: str, param: Dict) -> None:
    os.makedirs(model_dir, exist_ok=True)
    with open(os.path.join(model_dir, "parameters.json"), "w") as f:
        json.dump(param, f, indent=1)


def model_paths(name: str, data_dir: str, root: str = "models") -> str:
    """models/model_<name>_<datadir>/, the reference's layout rule."""
    model_name = f"model_{name}_{os.path.basename(os.path.normpath(data_dir))}"
    return os.path.join(root, model_name)
