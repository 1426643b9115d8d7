"""Build and load the port's CUDA kernels, and build its native libraries.

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

:func:`native_library` builds the C ABI of ``native/dragposer_abi.h`` the
same way, with ``g++`` (host C++, no CUDA): ``native/abi.cpp`` (CPython
embedded) and ``native/client.cpp`` (the socket client), named by a hash
of the sources and of the command, which compiles in this checkout and
this interpreter as the libraries' defaults.
"""

from __future__ import annotations

import ctypes
import hashlib
import itertools
import os
import shutil
import subprocess
import sys
import sysconfig
import threading
import time
from pathlib import Path
from typing import Dict, List

import torch

from dragposer_tpu_torch import tracing

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
NATIVE = _PKG / "native"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
CXX_FLAGS = ["-std=c++17", "-O2", "-fPIC", "-shared", "-pthread"]
NATIVE_LIBS = {"abi": "dragposer_tpu_torch_native",
               "client": "dragposer_tpu_torch_client"}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCKS: Dict[str, threading.Lock] = {}
_LOCKS_LOCK = threading.Lock()   # guards _LOCKS; never held over a build
_BUILD_IDS = itertools.count()   # a thread id may be reused once it ends
# seconds of each build this process ran (a library found built is absent)
BUILD_SECONDS: Dict[str, float] = {}


_NAMED_COUNTS: Dict[str, "KernelCounts"] = {}
_LOGGED_COUNTS: Dict[str, "KernelCounts"] = {}


class KernelCounts:
    """Launch counters of one kernel and of its plain twin (plain ints),
    and ``log``, the records of the launches made while a profiler records
    (``tracing.recording``).  A counter made with a ``name`` is reported by
    :func:`kernel_launches`, one made with a ``log_name`` only by
    :func:`launch_log`."""

    def __init__(self, name: str | None = None,
                 log_name: str | None = None):
        self.kernel = 0
        self.plain = 0
        self.log: List[dict] = []
        if name is not None:
            _NAMED_COUNTS[name] = self
        if name or log_name:
            _LOGGED_COUNTS[log_name or name] = self

    def reset(self):
        self.kernel = 0
        self.plain = 0
        self.log.clear()

    def launched(self, plain: bool = False, **record) -> None:
        """Count a launch (``plain``: a call of the twin) and, while a
        profiler records, keep ``record`` with ``plain`` added: host ints
        and references to tensors the caller made, never read here."""
        if plain:
            self.plain += 1
        else:
            self.kernel += 1
        if tracing.recording():
            record["plain"] = plain
            self.log.append(record)


def launch_log(*names: str) -> List[dict]:
    """The launch records of the counters ``names``, in that order (empty
    for a name no imported module has made)."""
    return [r for n in names if n in _LOGGED_COUNTS
            for r in _LOGGED_COUNTS[n].log]


def clear_launch_logs() -> None:
    """Empty every counter's launch records (the counts stay)."""
    for c in _LOGGED_COUNTS.values():
        c.log.clear()


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


def _temporary(out: Path) -> Path:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    return out.with_suffix(f".{os.getpid()}.{threading.get_ident()}."
                           f"{next(_BUILD_IDS)}.tmp")


def _start_build(name: str):
    out = library_path(name)
    if out.exists():
        return None
    tmp = _temporary(out)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out, time.time()


def _finish_build(name: str, started) -> str:
    if started is None:
        return ""
    proc, tmp, out, t0 = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"{proc.args[0]} failed for {name}:\n{log}")
    os.replace(tmp, out)
    BUILD_SECONDS[name] = time.time() - t0
    return log


def build_all(names: List[str]) -> Dict[str, str]:
    """Compile every named kernel concurrently (one ``nvcc`` per source).
    Returns each build's compiler log (ptxas register/spill report)."""
    t0 = time.time()
    started = {n: _start_build(n) for n in names}
    logs = {n: _finish_build(n, s) for n, s in started.items()}
    logs["_seconds"] = f"{time.time() - t0:.1f}"
    return logs


def _name_lock(name: str) -> threading.Lock:
    with _LOCKS_LOCK:
        return _LOCKS.setdefault(name, threading.Lock())


def _gxx() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found: the native libraries are built "
                           "with the host's C++ compiler")
    return found


def _native_command(kind: str) -> tuple:
    """(compile flags, link flags) of ``native/<kind>.cpp``: this checkout
    and this interpreter compiled in as the defaults of
    ``DRAGPOSER_PYROOT`` and ``DRAGPOSER_PYTHON``; the embedded ABI also
    takes Python's headers, libpython and an rpath to it."""
    flags = [*CXX_FLAGS, f"-I{NATIVE}",
             f'-DDRAGPOSER_DEFAULT_PYROOT="{_PKG.parent}"',
             f'-DDRAGPOSER_DEFAULT_PYTHON="{sys.executable}"']
    link = []
    if kind == "abi":
        libdir = sysconfig.get_config_var("LIBDIR")
        flags.append(f"-I{sysconfig.get_paths()['include']}")
        link = [f"-L{libdir}", f"-Wl,-rpath,{libdir}",
                f"-lpython{sysconfig.get_config_var('LDVERSION')}", "-ldl"]
    return flags, link


def native_library(kind: str) -> Path:
    """The path of the native library ``kind`` (``"abi"``:
    ``libdragposer_tpu_torch_native``, ``"client"``:
    ``libdragposer_tpu_torch_client``), built with ``g++`` on first use.
    Without ``g++`` it raises."""
    name = NATIVE_LIBS[kind]
    flags, link = _native_command(kind)
    source = NATIVE / f"{kind}.cpp"
    h = hashlib.sha256(source.read_bytes())
    h.update((NATIVE / "dragposer_abi.h").read_bytes())
    h.update("\0".join(flags + link).encode())
    out = BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"
    with _name_lock(name):
        if not out.exists():
            tmp = _temporary(out)
            proc = subprocess.Popen(
                [_gxx(), *flags, "-o", str(tmp), str(source), *link],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            _finish_build(name, (proc, tmp, out, time.time()))
    return out


def load(name: str, declare=None) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed.
    ``declare(lib)`` sets its entry points' ``ctypes`` signatures once, when
    the library is first loaded, so a launch pays no declaration.  Threads
    that ask for one name while it builds wait for that build, and all get
    the same library."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _name_lock(name):
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
