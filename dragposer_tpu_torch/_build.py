"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled with
``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC``
into ``build/torch_kernels/lib<name>-<hash>.so`` at the root of the
checkout, at first use, then loaded with ``ctypes``.  The file name carries
a hash of the source and of the shared headers (``csrc/*.cuh``), so an
edited kernel is never served from a stale library.  Nothing here runs at
import time.  :func:`load` is safe to call from several threads (the
serving daemon serves each connection on its own): one lock per kernel
name, and each build writes its own temporary file (named by pid, thread
id and a build count).
"""

from __future__ import annotations

import ctypes
import hashlib
import itertools
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List

import torch

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCKS: Dict[str, threading.Lock] = {}
_LOCKS_LOCK = threading.Lock()   # guards _LOCKS; never held over a build
_BUILD_IDS = itertools.count()   # a thread id may be reused once it ends


_NAMED_COUNTS: Dict[str, "KernelCounts"] = {}


class KernelCounts:
    """Launch counters of one kernel and of its plain twin (plain ints).
    A counter made with a ``name`` is reported by :func:`kernel_launches`."""

    def __init__(self, name: str | None = None):
        self.kernel = 0
        self.plain = 0
        if name is not None:
            _NAMED_COUNTS[name] = self

    def reset(self):
        self.kernel = 0
        self.plain = 0


def kernel_launches() -> dict:
    """Each named kernel's launches in this process and its plain twin's
    calls: ``{name: n, name + "_plain": n}`` (K1 and K2 once their modules
    are imported; what the daemon's ``OP_STATS`` reports as "kernels")."""
    out = {name: c.kernel for name, c in _NAMED_COUNTS.items()}
    out.update({f"{name}_plain": c.plain
                for name, c in _NAMED_COUNTS.items()})
    return out


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the GPU")


def library_path(name: str) -> Path:
    """The library's path, named by a hash of its source and of every
    header in ``csrc/``."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start_build(name: str):
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}."
                          f"{next(_BUILD_IDS)}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish_build(name: str, started) -> str:
    if started is None:
        return ""
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)
    return log


def build_all(names: List[str]) -> Dict[str, str]:
    """Compile every named kernel concurrently (one ``nvcc`` per source).
    Returns each build's compiler log (ptxas register/spill report)."""
    t0 = time.time()
    started = {n: _start_build(n) for n in names}
    logs = {n: _finish_build(n, s) for n, s in started.items()}
    logs["_seconds"] = f"{time.time() - t0:.1f}"
    return logs


def load(name: str, declare=None) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed.
    ``declare(lib)`` sets its entry points' ``ctypes`` signatures once, when
    the library is first loaded, so a launch pays no declaration.  Threads
    that ask for one name while it builds wait for that build, and all get
    the same library."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCKS_LOCK:
        lock = _LOCKS.setdefault(name, threading.Lock())
    with lock:
        if name not in _LIBS:
            _finish_build(name, _start_build(name))
            lib = ctypes.CDLL(str(library_path(name)))
            if declare is not None:
                declare(lib)
            _LIBS[name] = lib
    return _LIBS[name]


def check_tensor(name: str, x, shape, device, dtype=torch.float32) -> None:
    """Raise ``ValueError`` unless ``x`` is a contiguous ``dtype`` tensor of
    ``shape`` on ``device``: what a kernel's pointer argument needs."""
    if x.device != device or x.dtype != dtype:
        raise ValueError(f"{name}: {dtype} on {device} expected, got "
                         f"{x.dtype} on {x.device}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(x.shape)} != {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def check(err: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
