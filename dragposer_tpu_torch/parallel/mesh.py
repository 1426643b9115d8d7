"""Device meshes and sharding helpers (port of
``dragposer_tpu/parallel/mesh.py``).

The JAX module names a ``("data", "model")`` grid of devices and places
arrays on it with a ``PartitionSpec``; XLA's partitioner then runs one
program over the shards.  PyTorch runs eagerly and has no partitioner, so
the port keeps the names and the layout rules and places tensors in the
two ways PyTorch has:

* where a process group runs (``torch.distributed``, one process a
  device: :mod:`parallel.distributed`), the mesh carries a
  ``DeviceMesh`` and placing a tensor makes a ``DTensor`` with the
  placements the spec names (``Shard(0)``, ``Shard(1)``, ``Replicate()``
  on each mesh axis);
* in one process, a mesh is a grid of local devices (every card, or the
  one CPU where the caller asks for it; a caller may name the same
  device more than once), and
  placing a tree gives one copy of it per device, cut as the spec says;
  the caller runs its work on each (``cli/eval_drag.evaluate_batched``:
  one engine replica and CUDA stream a device).

* **batched eval** — lanes are independent: the batch axis is cut over
  ``data``, the model replicated;
* **tensor-parallel temporal training** — the transformer FFN (2048
  hidden) and attention heads cut over ``model``
  (:func:`temporal_param_sharding`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch

from dragposer_tpu_torch._device import resolve_device

AXES = ("data", "model")


def local_devices(kind: Optional[str] = None) -> list:
    """This process's devices of ``kind``: every local card (``cuda``,
    the default, which raises where no GPU is visible) or the one CPU
    (``cpu``, only when asked for)."""
    if resolve_device(kind).type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


@dataclass(frozen=True)
class Mesh:
    """A ``(data, model)`` grid of devices; ``device_mesh`` is the
    ``torch.distributed`` ``DeviceMesh`` over the same grid where a
    process group spans it (one process a device), else None."""

    devices: np.ndarray                 # (data, model) of torch.device
    axis_names: Tuple[str, str] = AXES
    device_mesh: Any = None

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))


@dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec: entry i of ``spec`` names the mesh axis that
    dimension i of a tensor is cut over (None or absent: whole)."""

    mesh: Mesh
    spec: Tuple[Optional[str], ...] = ()

    @property
    def placements(self) -> list:
        """The DTensor placements of this spec, one a mesh axis."""
        from torch.distributed.tensor import Replicate, Shard

        return [Shard(self.spec.index(axis)) if axis in self.spec
                else Replicate() for axis in self.mesh.axis_names]


def make_mesh(data: Optional[int] = None, model: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """(data, model) mesh; defaults to all local cards on the data axis
    (no GPU raises: a CPU mesh is built from ``devices``).  Where a
    process group runs and ``devices`` is not given, the mesh spans its
    processes (one device each) and carries their ``DeviceMesh``."""
    import torch.distributed as dist

    if devices is None and dist.is_available() and dist.is_initialized():
        from torch.distributed.device_mesh import init_device_mesh

        world = dist.get_world_size()
        if data is None:
            data = world // model
        kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
        dm = init_device_mesh(kind, (data, model), mesh_dim_names=AXES)
        grid = np.empty((data, model), object)
        for r in range(data * model):
            grid.flat[r] = (torch.device("cuda", r % max(
                torch.cuda.device_count(), 1)) if kind == "cuda"
                            else torch.device("cpu"))
        return Mesh(grid, AXES, dm)
    devices = list(devices if devices is not None else local_devices())
    if data is None:
        data = len(devices) // model
    if data * model > len(devices) or data < 1:
        raise ValueError(f"a {data} x {model} mesh needs {data * model} "
                         f"devices; {len(devices)} given")
    grid = np.empty((data, model), object)
    for i, d in enumerate(devices[: data * model]):
        grid.flat[i] = torch.device(d)
    return Mesh(grid, AXES)


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Cut the leading (batch) axis over the data axis."""
    return NamedSharding(mesh, ("data",))


def map_tree(fn, tree):
    """``fn`` on every leaf of a tree of dicts, lists, tuples and
    NamedTuples, the containers kept."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[map_tree(fn, v) for v in tree])
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree) -> list:
    """The leaves of a tree, in the order :func:`map_tree` visits them."""
    leaves = []
    map_tree(leaves.append, tree)
    return leaves


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def _tensor(x):
    return x if torch.is_tensor(x) else torch.as_tensor(np.array(x))


def _piece(x, sharding: NamedSharding, idx):
    """Tensor ``x``'s piece for grid position ``idx``, on that device."""
    mesh = sharding.mesh
    for axis, i in zip(mesh.axis_names, idx):
        if axis in sharding.spec:
            dim, n = sharding.spec.index(axis), mesh.shape[axis]
            if x.shape[dim] % n:
                raise ValueError(f"dimension {dim} of {tuple(x.shape)} does "
                                 f"not divide over {n} devices")
            x = x.chunk(n, dim=dim)[i]
    return x.to(mesh.devices[idx])


def _place_tree(tree, mesh: Mesh, spec_of):
    """Place a tree on ``mesh``, leaf x under ``NamedSharding(mesh,
    spec_of(path, x))``: under a DeviceMesh the same tree of DTensors;
    in one process a list over the grid's devices (C order) of trees, the
    one at position (i, k) holding every leaf's piece for device (i, k)."""

    def walk(t, path, fn):
        if isinstance(t, dict):
            return {k: walk(v, f"{path}/{k}" if path else str(k), fn)
                    for k, v in t.items()}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*[walk(v, f"{path}/{k}", fn)
                             for k, v in zip(t._fields, t)])
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v, f"{path}/{i}", fn)
                           for i, v in enumerate(t))
        x = _tensor(t)
        return fn(x, NamedSharding(mesh, spec_of(path, x)))

    if mesh.device_mesh is not None:
        from torch.distributed.tensor import distribute_tensor

        return walk(tree, "", lambda x, s: distribute_tensor(
            x, mesh.device_mesh, s.placements))
    return [walk(tree, "", lambda x, s: _piece(x, s, idx))
            for idx in np.ndindex(*mesh.devices.shape)]


def shard_batch(tree, mesh: Mesh):
    """Place every tensor of the tree with its leading axis on ``data``
    (see :func:`_place_tree`)."""
    return _place_tree(tree, mesh, lambda path, x: ("data",))


def replicate(tree, mesh: Mesh):
    return _place_tree(tree, mesh, lambda path, x: ())


def temporal_spec(path: str, ndim: int) -> Tuple[Optional[str], ...]:
    """The tensor-parallel layout of one temporal-transformer leaf (its
    ``/``-joined path): ``ff1`` (ff, d) rows and ``ff2`` (d, ff) columns
    on ``model``, one reduction a FF block; the packed QKV ``in_w`` (3d,
    d) rows and ``out_w`` (d, d) columns on ``model`` (heads); every other
    leaf (LayerNorms, small projections, biases) replicated."""
    if ndim < 2:
        return ()
    if path.endswith("ff1/w") or path.endswith("in_w"):
        return ("model", None)
    if path.endswith("ff2/w") or path.endswith("out_w"):
        return (None, "model")
    return ()


def temporal_param_sharding(tparams, mesh: Mesh):
    """The temporal parameters placed on ``mesh`` by
    :func:`temporal_spec` (see :func:`_place_tree`)."""
    return _place_tree(tparams, mesh,
                       lambda path, x: temporal_spec(path, x.dim()))
