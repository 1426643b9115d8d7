"""Python client for the serving daemon (port of
``dragposer_tpu/runtime/client.py``; the protocol is
``dragposer_tpu_torch.runtime.server``'s).

The native C client (``native/dragposer_client.cpp``) covers the realtime
C-ABI surface; this module is the Python-side counterpart for job-style
usage — today the batched offline evaluation endpoint.

    from dragposer_tpu_torch.runtime.client import DaemonClient
    with DaemonClient("/tmp/dragposer_tpu_torch.sock") as c:
        out = c.eval_batch(model_dir, skeleton_bvh, files, config="6_trackers")
        for r in out["results"]:
            print(r["file"], r["mpjpe"])
"""

from __future__ import annotations

import json
import socket
import struct
from typing import Optional

from dragposer_tpu_torch.runtime import server as proto


class DaemonError(RuntimeError):
    pass


class DaemonClient:
    def __init__(self, socket_path: str = proto.DEFAULT_SOCKET,
                 timeout: Optional[float] = None):
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        if timeout is not None:
            self._sock.settimeout(timeout)
        self._sock.connect(socket_path)

    def close(self) -> None:
        self._sock.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def request(self, op: int, payload: bytes = b"") -> tuple:
        """One raw request: ``(status, body)`` of the reply, an error
        status (non-zero) returned, not raised."""
        self._sock.sendall(struct.pack("<IB", len(payload) + 1, op) + payload)
        hdr = self._recv_exact(5)
        (length,) = struct.unpack_from("<I", hdr)
        return hdr[4], self._recv_exact(length - 1)

    def _call(self, op: int, payload: bytes = b"") -> bytes:
        status, body = self.request(op, payload)
        if status != 0:
            raise DaemonError(body.decode("utf-8", "replace"))
        return body

    def _recv_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self._sock.recv(n - len(buf))
            if not chunk:
                raise DaemonError("daemon closed the connection")
            buf += chunk
        return buf

    def ping(self) -> None:
        self._call(proto.OP_PING)

    def eval_batch(self, model_dir: str, skeleton: str, files: list,
                   config: str = "6_trackers", use_temporal: bool = True,
                   max_frames: Optional[int] = None, downsample_gt: int = 1,
                   save_dir: str = "data", restarts: int = 1,
                   mesh: Optional[int] = None, branch_every: int = 0,
                   branch_sigma: float = 0.25,
                   branch_survivors: int = 8) -> dict:
        """Run a batched offline reconstruction job on the daemon's warm
        engine; returns ``{"results": [{file, mpjpe, mpeepe}...],
        "elapsed_s": ...}``.  ``mesh``: the local devices the lanes are
        cut over (``eval_drag --batch --mesh``; default: one, the
        daemon's)."""
        req = {
            "model_dir": model_dir, "skeleton": skeleton, "files": files,
            "config": config, "use_temporal": use_temporal,
            "downsample_gt": downsample_gt, "save_dir": save_dir,
            "restarts": restarts,
        }
        if max_frames is not None:
            req["max_frames"] = max_frames
        if mesh is not None:
            req["mesh"] = mesh
        if branch_every:
            req["branch_every"] = branch_every
            req["branch_sigma"] = branch_sigma
            req["branch_survivors"] = branch_survivors
        return json.loads(self._call(proto.OP_EVAL_BATCH,
                                     json.dumps(req).encode()))

    def stats(self) -> dict:
        """Coalescer counters (frames served, ticks, coalesced frames,
        largest coalesced group; absent if coalescing is disabled), the
        eval jobs' counters and the kernels' launch counts."""
        return json.loads(self._call(proto.OP_STATS))
