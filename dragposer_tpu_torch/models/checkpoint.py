"""Native checkpoint reading (port of ``dragposer_tpu/models/checkpoint.load``).

A model directory holds ``generator.npz`` (VAE params under ``params/…``
plus ``extra/means|stds/…``), ``temporal.npz`` (temporal params plus
``extra/means_latent|stds_latent``) and ``parameters.json``.  Paths inside
an archive are slash-separated pytree paths; all-digit keys are lists.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np


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


def load(path: str) -> Tuple[Any, Dict[str, Any]]:
    """Returns ``(params, extra)`` as nested dicts/lists of numpy arrays."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    params = {k[len("params/"):]: v for k, v in flat.items()
              if k.startswith("params/")}
    extra = {k[len("extra/"):]: v for k, v in flat.items()
             if k.startswith("extra/")}
    return _unflatten(params), (_unflatten(extra) if extra else {})
