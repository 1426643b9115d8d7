"""Serving daemon (port of ``dragposer_tpu/runtime/server.py``): one
process owns the engines on the card; clients speak a tiny binary protocol
over a Unix domain socket.

The reference embeds a Python interpreter inside the host process
(``DragPoserDLL/exportFunc.cpp``), so every host (every Unity editor
restart) pays interpreter and model start-up, and two host processes cannot
share a card.  Here the engines live in one long-running daemon; the native
client library (``native/dragposer_client.cpp``, unchanged: it speaks this
protocol) is a few KB of socket code with no interpreter, so host start-up
is instant and N host processes share the warm engines.  The port's own
client library (``dragposer_tpu_torch/native/client.cpp``, built by
``_build.native_library("client")``) starts this daemon when none answers;
a client of ``native/`` is pointed at it::

    python -m dragposer_tpu_torch.runtime.server --socket PATH
    DRAGPOSER_SOCKET=PATH DRAGPOSER_NO_SPAWN=1 <native client>

Concurrency model (one thread per connection + a frame coalescer):

* Every accepted connection is served by its own thread, so a multi-second
  batched-eval job (``OP_EVAL_BATCH``) in one client never stalls another
  client's realtime frames: a job runs on its own CUDA stream, and the
  kernels launch on the current stream.  The protocol is strictly
  request/response per connection, so per-session ordering is the
  connection's own ordering.
* Concurrent ``OP_DRAG_POSE`` requests are COALESCED: the first arriving
  frame becomes the tick leader, waits up to ``--coalesce-window`` seconds
  (skipped when only one realtime client is live) for the other live
  clients' frames, then steps every compatible session (equal
  ``RealtimeSession.config_key()``) as one batch
  (``realtime.make_coalesced_step``: K2 for the rollouts, K1 for the
  optimizer) and fans the results out.  N clients cost about one frame of
  launches per tick instead of N — the crowd path of ``RealtimeBatch``,
  reachable from plain single-avatar native clients.  A session alone in
  its group takes its own frame (the per-lane anchor);
  ``--coalesce-window 0`` restores strictly per-request stepping.
* The kernels K1 and K2 are built and loaded before the first connection
  is accepted (on the card), so no client pays a build.

Wire format (little-endian):

    request  = u32 length | u8 opcode | payload
    response = u32 length | u8 status  | payload     (status 0 = ok)

``length`` counts the bytes after the length field.  Opcodes mirror the C
ABI (reference ``exportFunc.h:61-70``); see ``_OPS`` below.  Sessions are
identified by i64 handles; handles created on a connection are destroyed
when that connection closes (a crashed client cannot leak engine state).

Run:  python -m dragposer_tpu_torch.runtime.server [--socket PATH]
          [--idle-timeout SECONDS] [--coalesce-window SECONDS]
          [--ready-fd FD] [--device cuda|cpu]

The default socket is ``/tmp/dragposer_tpu_torch.sock``, not the JAX
daemon's, and the daemon refuses a path where another daemon answers.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import socket
import struct
import threading
import time

import numpy as np
import torch

from dragposer_tpu_torch._build import kernel_launches
from dragposer_tpu_torch._device import resolve_device


# opcode table (shared contract with native/dragposer_client.cpp)
OP_PING = 0
OP_INIT = 1
OP_DESTROY = 2
OP_SET_REF_SKELETON = 3
OP_LOAD_MODELS = 4
OP_SET_MASK_WEIGHTS = 5
OP_INIT_DRAG_MODEL = 6
OP_SET_OPTIM_PARAMS = 7
OP_SET_LAMBDAS = 8
OP_SET_GLOBAL_POS = 9
OP_DRAG_POSE = 10
# Batched offline evaluation: JSON request in, JSON result out.  The heavy
# lifting is the same engine the CLI uses (eval_drag.evaluate_batched with
# the pipelined ragged-batch runtime); engines are cached per
# (model_dir, config, temporal, skeleton) so repeated jobs skip their
# build (checkpoint loading, the decoder fold, K2's weight packing).
OP_EVAL_BATCH = 11
# Daemon statistics (JSON out): frame/tick counters from the coalescer and
# the kernels' launch counts — observability for the multi-client path.
OP_STATS = 12

# The port's own default: a JAX daemon listening at its default path
# (``/tmp/dragposer_tpu.sock``) is never displaced by the port's.
DEFAULT_SOCKET = "/tmp/dragposer_tpu_torch.sock"

_engines: dict = {}
_engines_lock = threading.Lock()   # guards the dicts below; NEVER a build
_engine_builds: dict = {}          # key -> per-key build lock
_eval_stats = {"jobs_active": 0, "jobs_done": 0, "building": []}


def engine_cache_get(key, build_fn):
    """Engine cache lookup with PER-KEY build locks.

    A first-time engine build loads checkpoints and packs weights; a
    single global lock would serialize every eval-batch job — including
    pure cache hits — behind it.  Here ``_engines_lock`` only guards dict
    access: a cold key builds under its own lock, so a concurrent job
    with a WARM key returns immediately, and two jobs racing the same cold
    key still build once.  The in-flight keys are surfaced via OP_STATS
    (``building``)."""
    with _engines_lock:
        if key in _engines:
            return _engines[key]
        build_lock = _engine_builds.setdefault(key, threading.Lock())
    with build_lock:
        with _engines_lock:
            if key in _engines:
                return _engines[key]
            _eval_stats["building"] = _eval_stats["building"] + [repr(key)]
        try:
            val = build_fn()
        finally:
            with _engines_lock:
                _eval_stats["building"] = [
                    k for k in _eval_stats["building"] if k != repr(key)]
        with _engines_lock:
            _engines[key] = val
        return val


@contextlib.contextmanager
def _job_stream(device: torch.device):
    """Run the block on a CUDA stream of its own (on the card), after the
    work already queued on the current one: the kernels launch on the
    current stream, so a job's launches do not queue behind, or ahead of,
    other connections' realtime frames."""
    if device.type != "cuda":
        yield
        return
    stream = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream):
        yield
    stream.synchronize()


def _eval_batch(req: dict, device=None) -> dict:
    """Serve one batched evaluation job (see OP_EVAL_BATCH) on ``device``.

    Request keys: ``model_dir``, ``skeleton`` (BVH path), ``files`` (list of
    BVH paths), ``config`` (builtin name or config-JSON path, default
    6_trackers), ``use_temporal`` (default true), ``max_frames`` (optional),
    ``downsample_gt`` (default 1), ``save_dir`` (default "data"),
    ``restarts``, ``branch_every``, ``branch_sigma``, ``branch_survivors``,
    ``mesh`` (local devices the lanes are cut over, as ``eval_drag
    --mesh``; default 1).
    """
    from dragposer_tpu_torch.cli.eval_drag import (build_engine,
                                                   evaluate_batched,
                                                   resolve_config)
    from dragposer_tpu_torch.data import encoding
    from dragposer_tpu_torch.io.bvh import BVH
    from dragposer_tpu_torch.ops.topology import Skeleton

    device = resolve_device(device)
    key = (req["model_dir"], req.get("config", "6_trackers"),
           bool(req.get("use_temporal", True)), req["skeleton"])

    def _build():
        bvh = BVH().load(req["skeleton"])
        _, _, parents, offsets, _ = encoding.info_from_bvh(bvh)
        sk = Skeleton.build(parents, offsets, bvh.names)
        engine, means, stds = build_engine(
            req["model_dir"], parents,
            resolve_config(req.get("config", "6_trackers")),
            use_temporal=bool(req.get("use_temporal", True)), skeleton=sk,
            device=device,
        )
        return engine, means, stds, sk

    with _job_stream(device):
        engine, means, stds, sk = engine_cache_get(key, _build)
        t0 = time.time()
        with _engines_lock:
            _eval_stats["jobs_active"] += 1
        try:
            results = evaluate_batched(
                engine, means, stds, sk, req["files"],
                max_frames=req.get("max_frames"),
                save_dir=req.get("save_dir", "data"),
                downsample_gt=int(req.get("downsample_gt", 1)),
                restarts=int(req.get("restarts", 1)),
                mesh_devices=int(req.get("mesh") or 1),
                branch_every=int(req.get("branch_every", 0)),
                branch_sigma=float(req.get("branch_sigma", 0.25)),
                branch_survivors=int(req.get("branch_survivors", 8)),
            )
        finally:
            with _engines_lock:
                _eval_stats["jobs_active"] -= 1
    with _engines_lock:
        _eval_stats["jobs_done"] += 1
    return {
        "results": [
            {"file": f, "mpjpe": float(m), "mpeepe": float(e)}
            for f, (m, e) in zip(req["files"], results)
        ],
        "elapsed_s": time.time() - t0,
    }


class _PendingDrag:
    """One in-flight OP_DRAG_POSE, parked while the coalescer ticks."""

    __slots__ = ("session", "tpos", "trot", "event", "result", "error")

    def __init__(self, session, tpos, trot):
        self.session = session
        self.tpos = tpos      # sparse (E, 3) float32
        self.trot = trot      # sparse (E, 4) wxyz float32
        self.event = threading.Event()
        self.result = None    # bytes: (J*4 local quats ++ 3 global pos) f32
        self.error = None


class DragCoalescer:
    """Collect concurrent drag requests for a tick; step them together.

    Connection threads call :meth:`drag` and block until their frame's
    result is ready.  The first request of a tick becomes the leader: it
    waits up to ``window_s`` (early-exit once every recently-active session
    has submitted; no wait at all when only one session is live), snapshots
    the pending set, groups it by ``RealtimeSession.config_key()``, and
    steps each multi-session group as one batch in chunks of at most
    ``max_lanes`` (``realtime.make_coalesced_step``, lanes padded to the
    next power of two so that few step functions are built).  Singleton
    groups take the session's own single-avatar path unchanged.
    """

    def __init__(self, window_s: float = 0.002, max_lanes: int = 64):
        self.window_s = float(window_s)
        self.max_lanes = int(max_lanes)
        self._cv = threading.Condition()
        self._pending: list[_PendingDrag] = []
        self._leader = False
        self._last_seen: dict[int, float] = {}  # id(session) -> t of last drag
        self._steps: dict = {}  # (config_key, n_lanes) -> (engine, step)
        self._steps_lock = threading.Lock()
        self.stats = {"frames": 0, "ticks": 0, "coalesced_frames": 0,
                      "max_group": 0}

    # ------------------------------------------------------------------
    def forget(self, session) -> None:
        """Drop a session from the live-quorum tracking (called when its
        owning connection closes) — a disconnected client must not inflate
        the tick quorum for the 1 s liveness horizon, nor leak an entry for
        the daemon's lifetime."""
        with self._cv:
            self._last_seen.pop(id(session), None)
            self._cv.notify_all()  # a waiting leader's quorum just shrank

    def drag(self, session, tpos, trot) -> bytes:
        req = _PendingDrag(session, tpos, trot)
        now = time.monotonic()
        with self._cv:
            self._pending.append(req)
            self._last_seen[id(session)] = now
            # prune sessions idle >60 s: liveness only looks 1 s back, so
            # long-gone sessions are dead weight (unbounded growth over the
            # daemon lifetime otherwise)
            for k in [k for k, t in self._last_seen.items()
                      if now - t > 60.0]:
                del self._last_seen[k]
            # sessions that dragged within the last second are "live"
            expected = sum(1 for t in self._last_seen.values()
                           if now - t < 1.0)
            lead = not self._leader
            if lead:
                self._leader = True
            else:
                self._cv.notify_all()  # leader may be waiting for quorum
        if lead:
            deadline = time.monotonic() + (self.window_s if expected > 1
                                           else 0.0)
            with self._cv:
                while len(self._pending) < expected:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cv.wait(remaining)
                batch = self._pending
                self._pending = []
                self._leader = False
            try:
                self._execute(batch)
            except Exception as e:  # defensive: never strand a waiter
                for r in batch:
                    if r.error is None and r.result is None:
                        r.error = e
            finally:
                for r in batch:
                    r.event.set()
        req.event.wait()
        if req.error is not None:
            raise req.error
        return req.result

    # ------------------------------------------------------------------
    def _execute(self, batch: list) -> None:
        groups: dict = {}
        for r in batch:
            if getattr(r.session, "_state", None) is None:
                r.error = RuntimeError("drag_pose before init_drag_pose")
                continue
            groups.setdefault(r.session.config_key(), []).append(r)
        st = self.stats
        st["ticks"] += 1
        st["frames"] += len(batch)
        for key, grp in groups.items():
            st["max_group"] = max(st["max_group"], len(grp))
            if len(grp) == 1:
                self._step_single(grp[0])
            else:
                st["coalesced_frames"] += len(grp)
                for chunk in (grp[i : i + self.max_lanes]
                              for i in range(0, len(grp), self.max_lanes)):
                    self._step_group(key, chunk)

    @staticmethod
    def _step_single(r: _PendingDrag) -> None:
        try:
            s = r.session
            j = s.skeleton.n_joints
            out_pose = np.zeros((j, 4), np.float32)
            out_gp = np.zeros((1, 3), np.float32)
            s.drag_pose(r.tpos, r.trot, out_pose, out_gp)
            r.result = np.concatenate(
                (out_pose.reshape(-1), out_gp.reshape(-1))
            ).astype("<f4").tobytes()
        except Exception as e:
            r.error = e

    def _step_group(self, key, grp: list) -> None:
        """One batched frame for every session in ``grp`` (equal config)."""
        from dragposer_tpu_torch.runtime.realtime import make_coalesced_step

        try:
            for r in grp:
                r.session._ensure_engine()
            n = len(grp)
            n_lanes = 1
            while n_lanes < n:
                n_lanes *= 2
            cache_key = (key, n_lanes)
            with self._steps_lock:
                if cache_key not in self._steps:
                    engine = grp[0].session._engine
                    self._steps[cache_key] = (
                        engine, make_coalesced_step(engine, n_lanes))
                engine, step = self._steps[cache_key]

            j = grp[0].session.skeleton.n_joints
            masks = np.zeros((n_lanes, j), np.float32)
            weights = np.zeros((n_lanes, j, 2), np.float32)
            tpos = np.zeros((n_lanes, j, 3), np.float32)
            trot = np.zeros((n_lanes, j, 4), np.float32)
            trot[:, :, 0] = 1.0
            active = np.zeros((n_lanes,), bool)
            states = []
            for i, r in enumerate(grp):
                s = r.session
                masks[i] = s._mask
                weights[i] = s._weights
                tpos[i], trot[i] = s.dense_targets(r.tpos, r.trot)
                active[i] = True
                states.append(s._state)
            states.extend(s._state for _ in range(n_lanes - n))  # padding

            new_states, local, gp = step(
                engine.model, masks, weights, tuple(states),
                tpos, trot, active)
            local, gp = local.cpu().numpy(), gp.cpu().numpy()
            for i, r in enumerate(grp):
                r.session._state = new_states[i]
                r.result = np.concatenate(
                    (np.asarray(local[i], np.float32).reshape(-1),
                     np.asarray(gp[i], np.float32).reshape(-1))
                ).astype("<f4").tobytes()
        except Exception as e:
            for r in grp:
                if r.error is None:
                    r.error = e


def _handle_request(capi, op: int, payload: bytes,
                    coalescer: DragCoalescer | None = None,
                    device=None) -> bytes:
    """Dispatch one decoded request to the flat capi bridge; sessions and
    eval jobs run on ``device``."""
    if op == OP_PING:
        return b""
    if op == OP_EVAL_BATCH:
        return json.dumps(_eval_batch(json.loads(payload), device)).encode()
    if op == OP_STATS:
        stats = dict(coalescer.stats) if coalescer is not None else {}
        with _engines_lock:
            stats["eval"] = {**_eval_stats,
                             "engines_cached": len(_engines)}
        stats["kernels"] = kernel_launches()
        return json.dumps(stats).encode()
    if op == OP_INIT:
        return struct.pack("<q", capi.init(device))
    h = struct.unpack_from("<q", payload)[0]
    body = payload[8:]
    if op == OP_DESTROY:
        capi.destroy(h)
        return b""
    if op == OP_SET_REF_SKELETON:
        return struct.pack("<i", capi.set_reference_skeleton(
            h, body.decode("utf-8")))
    if op == OP_LOAD_MODELS:
        capi.load_models(h, body.decode("utf-8"))
        return b""
    if op == OP_SET_MASK_WEIGHTS:
        (j,) = struct.unpack_from("<i", body)
        mask = body[4 : 4 + 4 * j]
        weights = body[4 + 4 * j : 4 + 12 * j]
        return struct.pack("<i", capi.set_mask_and_weights(h, mask, weights))
    if op == OP_INIT_DRAG_MODEL:
        vals = struct.unpack_from("<7f", body)
        capi.init_drag_model(h, *vals)
        return b""
    if op == OP_SET_OPTIM_PARAMS:
        ep, er, mi, lr = struct.unpack_from("<ffif", body)
        capi.set_optim_params(h, ep, er, mi, lr)
        return b""
    if op == OP_SET_LAMBDAS:
        lr_, lt, w = struct.unpack_from("<ffi", body)
        capi.set_lambdas(h, lr_, lt, w)
        return b""
    if op == OP_SET_GLOBAL_POS:
        x, y, z = struct.unpack_from("<3f", body)
        capi.set_global_pos(h, x, y, z)
        return b""
    if op == OP_DRAG_POSE:
        (n_ee,) = struct.unpack_from("<i", body)
        pos = body[4 : 4 + 12 * n_ee]
        rot = body[4 + 12 * n_ee : 4 + 28 * n_ee]
        if coalescer is None:
            return capi.drag_pose(h, pos, rot, n_ee)
        tpos = np.frombuffer(pos, dtype="<f4", count=3 * n_ee).reshape(n_ee, 3)
        trot = np.frombuffer(rot, dtype="<f4", count=4 * n_ee).reshape(n_ee, 4)
        return coalescer.drag(capi.get_session(h), tpos, trot)
    raise ValueError(f"unknown opcode {op}")


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("client closed")
        buf += chunk
    return buf


def load_kernels(device: torch.device) -> None:
    """Build (on a fresh checkout) and load K1 and K2 before the first
    connection, on the card: no client's first frame or job pays it."""
    if device.type != "cuda":
        return
    from dragposer_tpu_torch import _build
    from dragposer_tpu_torch.drag import iter_kernel
    from dragposer_tpu_torch.ops import temporal_fused

    _build.build_all(["iter_block", "temporal_forward"])
    iter_kernel._library()
    temporal_fused._library()


def claim_socket(socket_path: str) -> None:
    """Remove a stale socket file at ``socket_path``; raise if a daemon
    still answers there, so a second daemon never takes over a live one's
    path."""
    probe = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    try:
        probe.connect(socket_path)
    except (FileNotFoundError, ConnectionRefusedError):
        pass
    else:
        raise RuntimeError(f"a daemon already listens on {socket_path}; "
                           "pass another --socket")
    finally:
        probe.close()
    try:
        os.unlink(socket_path)
    except FileNotFoundError:
        pass


def serve(socket_path: str = DEFAULT_SOCKET, idle_timeout: float | None = None,
          ready_fd: int | None = None,
          coalesce_window: float = 0.002, device=None) -> None:
    # Resolve the device and load the kernels before accepting
    # connections: eval-batch engine builds can happen before any
    # RealtimeSession exists.
    from dragposer_tpu_torch.runtime import capi

    claim_socket(socket_path)   # before the kernels' build: fail fast
    device = resolve_device(device)
    load_kernels(device)

    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    srv.bind(socket_path)
    bound = os.stat(socket_path).st_ino
    srv.listen(64)
    srv.settimeout(1.0)

    if ready_fd is not None:  # tests: signal "listening" without polling
        os.write(ready_fd, b"1")
        os.close(ready_fd)

    coalescer = DragCoalescer(coalesce_window) if coalesce_window > 0 else None
    state = {"n_conns": 0, "last_activity": time.monotonic()}
    state_lock = threading.Lock()

    def client_thread(sock: socket.socket) -> None:
        handles: set[int] = set()
        try:
            while True:
                hdr = _recv_exact(sock, 4)
                (length,) = struct.unpack("<I", hdr)
                frame = _recv_exact(sock, length)
                op, payload = frame[0], frame[1:]
                try:
                    out = _handle_request(capi, op, payload, coalescer,
                                          device)
                    if op == OP_INIT:
                        handles.add(struct.unpack("<q", out)[0])
                    elif op == OP_DESTROY:
                        handles.discard(struct.unpack_from("<q", payload)[0])
                    resp = struct.pack("<IB", len(out) + 1, 0) + out
                except Exception as e:  # report, never kill the daemon
                    msg = f"{type(e).__name__}: {e}".encode()
                    resp = struct.pack("<IB", len(msg) + 1, 1) + msg
                sock.sendall(resp)
        except (ConnectionError, OSError):
            pass
        finally:
            sock.close()
            for h in handles:  # crashed clients must not leak engine state
                if coalescer is not None:
                    try:
                        coalescer.forget(capi.get_session(h))
                    except Exception:
                        pass  # handle already destroyed elsewhere
                capi.destroy(h)
            with state_lock:
                state["n_conns"] -= 1
                state["last_activity"] = time.monotonic()

    while True:
        try:
            sock, _ = srv.accept()
        except socket.timeout:
            with state_lock:
                idle = (state["n_conns"] == 0 and idle_timeout is not None
                        and time.monotonic() - state["last_activity"]
                        > idle_timeout)
            if idle:
                break
            continue
        with state_lock:
            state["n_conns"] += 1
            state["last_activity"] = time.monotonic()
        threading.Thread(target=client_thread, args=(sock,),
                         daemon=True).start()

    srv.close()
    try:   # only the file this daemon bound: never another's
        if os.stat(socket_path).st_ino == bound:
            os.unlink(socket_path)
    except FileNotFoundError:
        pass


def main(argv=None):
    p = argparse.ArgumentParser(
        description="DragPoser serving daemon (PyTorch/CUDA port)")
    p.add_argument("--socket", default=os.environ.get("DRAGPOSER_SOCKET",
                                                      DEFAULT_SOCKET))
    p.add_argument("--idle-timeout", type=float, default=None,
                   help="exit after this many seconds with no client "
                        "connected (auto-spawned daemons pass 300)")
    p.add_argument("--coalesce-window", type=float, default=0.002,
                   help="max seconds the tick leader waits for other live "
                        "clients' frames before stepping the coalesced "
                        "batch; 0 disables coalescing")
    p.add_argument("--ready-fd", type=int, default=None,
                   help="fd to write one byte to once listening")
    p.add_argument("--device", default=None,
                   help="torch device of the sessions and eval jobs "
                        "(default cuda; cpu runs the kernels' plain twins)")
    args = p.parse_args(argv)
    serve(args.socket, idle_timeout=args.idle_timeout,
          ready_fd=args.ready_fd, coalesce_window=args.coalesce_window,
          device=args.device)


if __name__ == "__main__":
    main()
