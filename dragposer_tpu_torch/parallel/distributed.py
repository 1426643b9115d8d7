"""Multi-process scale-out: process-group initialization and global meshes
(port of ``dragposer_tpu/parallel/distributed.py``).

* :func:`initialize` — one call per process (``torch.distributed``'s
  ``init_process_group``: ``nccl`` on the cards, ``gloo`` on the CPU; the
  arguments may come from environment variables, so a launcher can start
  N identical processes);
* :func:`global_mesh` — a (data, model) mesh over every process's device,
  with its ``DeviceMesh``;
* :func:`shard_host_batch` — each process's LOCAL batch shard as one
  global ``DTensor`` cut over ``data``;
* :func:`process_slice` — this process's contiguous part of a global
  batch.

Nothing here tells a program of a cluster: the coordinator's address, the
process count and this process's id are given, or read from
``DRAGPOSER_COORDINATOR`` / ``DRAGPOSER_NUM_PROCS`` / ``DRAGPOSER_PROC_ID``.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from dragposer_tpu_torch.parallel import mesh as meshlib


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Join the process group (a no-op for a single-process run: no
    argument and no variable set).  ``coordinator_address`` is
    ``host:port`` (or a ``tcp://`` URL) of process 0."""
    import torch.distributed as dist

    coordinator_address = coordinator_address or os.environ.get(
        "DRAGPOSER_COORDINATOR")
    if num_processes is None and "DRAGPOSER_NUM_PROCS" in os.environ:
        num_processes = int(os.environ["DRAGPOSER_NUM_PROCS"])
    if process_id is None and "DRAGPOSER_PROC_ID" in os.environ:
        process_id = int(os.environ["DRAGPOSER_PROC_ID"])
    if coordinator_address is None and num_processes is None:
        return  # single process
    if dist.is_initialized():
        return
    if coordinator_address is None or num_processes is None or \
            process_id is None:
        raise ValueError("initialize needs the coordinator's address, the "
                         "process count and this process's id")
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group("nccl" if cuda else "gloo", init_method=url,
                            world_size=num_processes, rank=process_id)


def global_mesh(data: Optional[int] = None, model: int = 1) -> meshlib.Mesh:
    """(data, model) mesh over every process's device (after
    :func:`initialize`); processes tile the data axis."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("global_mesh needs initialize() first")
    return meshlib.make_mesh(data=data, model=model)


def shard_host_batch(tree, mesh: meshlib.Mesh):
    """Each process passes its LOCAL batch shard (leading axis); returns
    global DTensors whose leading axis is the concatenation over the
    processes, cut over the mesh's ``data`` axis."""
    from torch.distributed.tensor import DTensor

    placements = meshlib.batch_sharding(mesh).placements
    dev = mesh.devices.flat[meshlib._rank()]
    return meshlib.map_tree(lambda x: DTensor.from_local(
        meshlib._tensor(x).to(dev), mesh.device_mesh, placements), tree)


def process_slice(n_global: int) -> slice:
    """This process's contiguous slice of a global batch of ``n_global``."""
    import torch.distributed as dist

    count = dist.get_world_size() if dist.is_initialized() else 1
    index = dist.get_rank() if dist.is_initialized() else 0
    per = n_global // count
    return slice(index * per, (index + 1) * per)
