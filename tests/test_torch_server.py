"""The port's serving daemon (``runtime/server.py``, ``runtime/capi.py``)
and its thread-safe kernel loading (``_build.load``), on the CPU.

* the wire contract: opcodes equal to the JAX package's, a default
  socket of the port's own, a live daemon's path refused; ``capi`` and a coalesced tick against JAX's on the same
  carried states (parent-local quaternions atol 1e-4, roots atol 1e-5, as
  ``tests/test_torch_realtime.py``);
* ports of ``tests/test_daemon_hardening.py`` (per-key build locks, the
  coalescer's quorum bookkeeping);
* a daemon process on the CPU (``chip_smoke.start_daemon``): four clients
  coalescing, error replies that leave it running, handles of a closed
  connection destroyed, ``OP_EVAL_BATCH`` against a direct
  ``evaluate_batched`` (the same arithmetic in two processes, one thread
  each: rtol 1e-6), ``mesh`` served up to the daemon's local devices and
  refused past them, and the native smoke client
  (``native/``, built with ``g++``; skipped without it).
"""

import os
import shutil
import struct
import threading
import time

import numpy as np
import pytest
import torch

import chip_smoke

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL_DIR = os.path.join(REPO, "models", "model_dancedb_example")
J = 22
OPTIM = (1e-4, 0.01, 4, 0.01)
LAMBDAS = (1.0, 0.02, 16)


def test_opcodes_equal_jax():
    from dragposer_tpu.runtime import server as jserver
    from dragposer_tpu_torch.runtime import server

    names = [n for n in dir(jserver) if n.startswith("OP_")]
    assert len(names) == 13
    for n in names:
        assert getattr(server, n) == getattr(jserver, n), n
    # the port's daemon never displaces a JAX daemon at its default path
    assert server.DEFAULT_SOCKET != jserver.DEFAULT_SOCKET


def test_serve_refuses_a_path_where_a_daemon_answers(tmp_path):
    """A listening socket at the path stops ``serve`` before it touches
    the file; a stale file (nothing listening) is removed and taken."""
    import socket

    from dragposer_tpu_torch.runtime import server

    path = str(tmp_path / "d.sock")
    live = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    live.bind(path)
    live.listen(1)
    try:
        with pytest.raises(RuntimeError, match="already listens"):
            server.serve(path, device="cpu")
        assert os.path.exists(path)
        probe = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        probe.connect(path)   # the first listener still owns the path
        probe.close()
    finally:
        live.close()
    server.claim_socket(path)   # now stale: nothing accepts
    assert not os.path.exists(path)
    server.claim_socket(path)   # no file at all


def test_kernel_launches_reports_k1_and_k2():
    from dragposer_tpu_torch import _build
    from dragposer_tpu_torch.drag import fast_iter
    from dragposer_tpu_torch.ops import temporal_fused

    counts = _build.kernel_launches()
    assert counts["K1"] == fast_iter.COUNTS.kernel
    assert counts["K2"] == temporal_fused.COUNTS.kernel
    assert counts["K1_plain"] == fast_iter.COUNTS.plain
    assert counts["K2_plain"] == temporal_fused.COUNTS.plain


# ---------------------------------------------------------------------------
# Kernel loading from several threads
# ---------------------------------------------------------------------------

def test_kernel_load_builds_once_for_two_threads(monkeypatch):
    """Two threads load one kernel while its (stubbed) build runs: the
    build runs once, the library is declared once, both get it."""
    from dragposer_tpu_torch import _build

    builds, declared, got = [], [], []

    def slow_build(name):
        builds.append(name)
        time.sleep(0.2)

    monkeypatch.setattr(_build, "_start_build", slow_build)
    monkeypatch.setattr(_build, "_finish_build", lambda name, started: "")
    monkeypatch.setattr(_build, "library_path",
                        lambda name: f"lib{name}-0.so")
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: object())
    barrier = threading.Barrier(2)

    def load():
        barrier.wait(timeout=10)
        got.append(_build.load("stub_kernel", declared.append))

    threads = [threading.Thread(target=load) for _ in range(2)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        assert builds == ["stub_kernel"]
        assert len(declared) == 1
        assert len(got) == 2 and got[0] is got[1] is declared[0]
    finally:
        _build._LIBS.pop("stub_kernel", None)
        _build._LOCKS.pop("stub_kernel", None)


def test_build_temporary_file_is_per_thread(monkeypatch, tmp_path):
    """Each build writes its own temporary file (pid and thread id), so two
    builds of one kernel never write one file."""
    from dragposer_tpu_torch import _build

    outs = []

    class Popen:
        def __init__(self, cmd, **kwargs):
            outs.append(cmd[cmd.index("-o") + 1])

    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "Popen", Popen)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "library_path",
                        lambda name: tmp_path / f"lib{name}-0.so")
    threads = [threading.Thread(target=_build._start_build, args=("k",))
               for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert len(outs) == 2 and outs[0] != outs[1]
    for out in outs:
        assert f".{os.getpid()}." in out and out.endswith(".tmp")


# ---------------------------------------------------------------------------
# Ports of tests/test_daemon_hardening.py
# ---------------------------------------------------------------------------

def _reset_cache():
    from dragposer_tpu_torch.runtime import server

    with server._engines_lock:
        server._engines.clear()
        server._engine_builds.clear()
        server._eval_stats["building"] = []


def test_warm_key_returns_while_cold_key_builds():
    from dragposer_tpu_torch.runtime import server

    _reset_cache()
    server.engine_cache_get("warm", lambda: "warm-engine")
    cold_started, cold_release = threading.Event(), threading.Event()

    def cold_build():
        cold_started.set()
        assert cold_release.wait(timeout=30)
        return "cold-engine"

    t = threading.Thread(
        target=lambda: server.engine_cache_get("cold", cold_build))
    t.start()
    assert cold_started.wait(timeout=10)
    t0 = time.monotonic()
    assert server.engine_cache_get("warm", lambda: "never") == "warm-engine"
    assert time.monotonic() - t0 < 5.0
    with server._engines_lock:
        assert any("cold" in k for k in server._eval_stats["building"])
    cold_release.set()
    t.join(timeout=30)
    assert not t.is_alive()
    with server._engines_lock:
        assert server._engines["cold"] == "cold-engine"
        assert server._eval_stats["building"] == []


def test_same_cold_key_builds_once():
    from dragposer_tpu_torch.runtime import server

    _reset_cache()
    calls, results = [], []

    def build():
        calls.append(1)
        time.sleep(0.1)
        return "engine"

    ts = [threading.Thread(
        target=lambda: results.append(server.engine_cache_get("k", build)))
        for _ in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    assert results == ["engine"] * 4
    assert len(calls) == 1


def test_failed_build_clears_in_flight_marker():
    from dragposer_tpu_torch.runtime import server

    _reset_cache()

    def boom():
        raise RuntimeError("build failed")

    with pytest.raises(RuntimeError):
        server.engine_cache_get("bad", boom)
    with server._engines_lock:
        assert server._eval_stats["building"] == []
        assert "bad" not in server._engines


class _FakeSession:
    """Stands in for a RealtimeSession in the quorum bookkeeping."""


def test_coalescer_forget_removes_quorum_entry():
    from dragposer_tpu_torch.runtime import server

    c = server.DragCoalescer(window_s=0.0)
    s1, s2 = _FakeSession(), _FakeSession()
    now = time.monotonic()
    with c._cv:
        c._last_seen[id(s1)] = now
        c._last_seen[id(s2)] = now
    c.forget(s1)
    assert id(s1) not in c._last_seen and id(s2) in c._last_seen
    c.forget(s1)  # idempotent


def test_coalescer_prunes_stale_sessions(monkeypatch):
    from dragposer_tpu_torch.runtime import server

    c = server.DragCoalescer(window_s=0.0)
    stale, live = _FakeSession(), _FakeSession()
    now = time.monotonic()
    with c._cv:
        c._last_seen[id(stale)] = now - 120.0
        c._last_seen[id(live)] = now - 0.5
    monkeypatch.setattr(c, "_execute", lambda batch: [
        setattr(r, "result", b"") for r in batch])
    me = _FakeSession()
    me._state = object()
    c.drag(me, None, None)
    assert id(stale) not in c._last_seen
    assert id(live) in c._last_seen and id(me) in c._last_seen


# ---------------------------------------------------------------------------
# capi and a coalesced tick against the JAX package's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def skeleton_clip(tmp_path_factory):
    from dragposer_tpu_torch.io.bvh import BVH

    path = str(tmp_path_factory.mktemp("server_clip") / "clip.bvh")
    chip_smoke.synthetic_bvh(24, seed=6).save(path)
    wp, wq = chip_smoke.clip_trackers(BVH().load(path))
    return path, wp, wq


def _capi_setup(capi, handle, path):
    from dragposer_tpu_torch import config as cfg

    c = cfg.SIX_TRACKERS
    assert capi.set_reference_skeleton(handle, path) == J
    capi.load_models(handle, MODEL_DIR)
    assert capi.set_mask_and_weights(
        handle, c.mask_array().astype("<f4").tobytes(),
        c.weights_array().astype("<f4").tobytes()) == 6
    capi.set_optim_params(handle, *OPTIM)
    capi.set_lambdas(handle, *LAMBDAS)


def test_capi_matches_jax(skeleton_clip, tmp_path, monkeypatch):
    """The flat bridge: handles, bytes in and out; three frames of the
    port's session (carrying the JAX session's state) against JAX's."""
    from dragposer_tpu.runtime import capi as jcapi
    from dragposer_tpu_torch.runtime import capi

    monkeypatch.chdir(tmp_path)   # the sessions' logs

    path, wp, wq = skeleton_clip
    jh, th = jcapi.init(), capi.init(device="cpu")
    assert th != capi.init(device="cpu")
    for c, h in ((jcapi, jh), (capi, th)):
        _capi_setup(c, h, path)
        c.init_drag_model(h, *wp[0, 0], *wq[0, 0])
    ts = capi.get_session(th)
    assert ts.device.type == "cpu"
    ts._state = ts._engine.on_device(jcapi.get_session(jh)._state)
    idx = ts._mask_indices
    root = wp[0, 0]
    for f in range(1, 4):
        pos = (wp[f, idx] - root).astype("<f4").tobytes()
        rot = wq[f, idx].astype("<f4").tobytes()
        jout = np.frombuffer(jcapi.drag_pose(jh, pos, rot, 6), "<f4")
        tout = np.frombuffer(capi.drag_pose(th, pos, rot, 6), "<f4")
        assert tout.shape == (J * 4 + 3,)
        np.testing.assert_allclose(tout[:-3], jout[:-3], atol=1e-4)
        np.testing.assert_allclose(tout[-3:], jout[-3:], atol=1e-5)
        root = jout[-3:]
    capi.set_global_pos(th, 0.5, 0.25, 1.0)
    np.testing.assert_array_equal(ts._state.global_pos.numpy(),
                                  np.float32([0.5, 0.25, 1.0]))
    capi.destroy(th)
    with pytest.raises(KeyError):
        capi.get_session(th)


def test_coalesced_tick_matches_jax(skeleton_clip, tmp_path, monkeypatch):
    """One coalescer tick over three sessions of one config (the batched
    frame, K1's twin here) against the JAX daemon's tick, the port's
    sessions carrying the JAX sessions' states."""
    from dragposer_tpu.runtime import capi as jcapi
    from dragposer_tpu.runtime import server as jserver
    from dragposer_tpu_torch.runtime import capi, server

    monkeypatch.chdir(tmp_path)   # the sessions' logs

    path, wp, wq = skeleton_clip
    pairs = []
    for k in range(3):
        jh, th = jcapi.init(), capi.init(device="cpu")
        for c, h in ((jcapi, jh), (capi, th)):
            _capi_setup(c, h, path)
            c.init_drag_model(h, *wp[k, 0], *wq[k, 0])
        js, ts = jcapi.get_session(jh), capi.get_session(th)
        ts._state = ts._engine.on_device(js._state)
        pairs.append((js, ts))
    idx = pairs[0][1]._mask_indices
    ticks = []
    for mod, side in ((jserver, 0), (server, 1)):
        coalescer = mod.DragCoalescer(window_s=0.0)
        batch = [mod._PendingDrag(p[side], wp[k + 1, idx] - wp[k, 0],
                                  wq[k + 1, idx])
                 for k, p in enumerate(pairs)]
        coalescer._execute(batch)
        assert coalescer.stats["coalesced_frames"] == 3
        assert all(r.error is None for r in batch), [r.error for r in batch]
        ticks.append([np.frombuffer(r.result, "<f4") for r in batch])
    for jout, tout in zip(*ticks):
        np.testing.assert_allclose(tout[:-3], jout[:-3], atol=1e-4)
        np.testing.assert_allclose(tout[-3:], jout[-3:], atol=1e-5)
    for js, ts in pairs:
        np.testing.assert_allclose(ts._state.latent.numpy(),
                                   js._state.latent, atol=1e-4)


# ---------------------------------------------------------------------------
# A daemon process on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def daemon(tmp_path_factory):
    work = tmp_path_factory.mktemp("daemon")
    clips = work / "clips"
    clips.mkdir()
    files = chip_smoke.write_synthetic_clips(str(clips), (40, 32), 11)
    sock = str(work / "d.sock")
    # a wide coalescing window: the test's clients share a loaded CPU
    proc = chip_smoke.start_daemon(sock, device="cpu", cwd=str(work),
                                   coalesce_window=0.05,
                                   env=dict(os.environ, OMP_NUM_THREADS="1"))
    yield sock, proc, files, work
    chip_smoke.stop_daemon(proc)


def _clip(path):
    from dragposer_tpu_torch.io.bvh import BVH

    return chip_smoke.clip_trackers(BVH().load(path))


def test_daemon_coalesces_four_clients(daemon):
    sock, proc, files, _ = daemon
    wp, wq = _clip(files[0])
    clients = [chip_smoke.DaemonSession(sock).setup(
        files[0], wp[k, 0], wq[k, 0], optim=OPTIM, lambdas=LAMBDAS)
        for k in range(4)]
    try:
        before = clients[0].stats()
        barrier, errors = threading.Barrier(4), []

        def run(k):
            try:
                barrier.wait(timeout=60)
                root = wp[k, 0]
                for f in range(1, 7):
                    local, root = clients[k].frame(wp, wq, k + f, root)
                    np.testing.assert_allclose(
                        np.linalg.norm(local, axis=-1), 1.0, atol=1e-4)
            except Exception as e:  # reported below
                errors.append(repr(e))

        threads = [threading.Thread(target=run, args=(k,)) for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not errors, errors
        after = clients[0].stats()
    finally:
        for c in clients:
            c.close()
    assert after["frames"] - before["frames"] == 24
    assert after["coalesced_frames"] > before["coalesced_frames"]
    assert after["max_group"] >= 2
    assert after["ticks"] - before["ticks"] < 24
    # on the CPU the kernels' plain twins ran, no kernel launched
    assert after["kernels"]["K1_plain"] > before["kernels"]["K1_plain"]
    assert after["kernels"]["K2_plain"] > before["kernels"]["K2_plain"]
    assert after["kernels"]["K1"] == after["kernels"]["K2"] == 0
    assert proc.poll() is None


def test_daemon_reports_errors_without_dying(daemon):
    from dragposer_tpu_torch.runtime import server

    sock, proc, files, _ = daemon
    c = chip_smoke.DaemonSession(sock)
    try:
        status, body = c.call(99, struct.pack("<q", 0))
        assert status == 1 and b"unknown opcode" in body
        status, _ = c.call(server.OP_LOAD_MODELS,
                           struct.pack("<q", 424242) + b"/nonexistent")
        assert status == 1
        (h,) = struct.unpack("<q", c.ok(server.OP_INIT))
        c.ok(server.OP_SET_REF_SKELETON, struct.pack("<q", h)
             + files[0].encode())
        status, body = c.call(server.OP_LOAD_MODELS, struct.pack("<q", h)
                              + b"/nonexistent")
        assert status == 1 and b"generator.npz" in body
        c.ok(server.OP_PING)
    finally:
        c.close()
    assert proc.poll() is None


def test_daemon_destroys_the_handles_of_a_closed_connection(daemon):
    from dragposer_tpu_torch.runtime import server

    sock, _, _, _ = daemon
    c1 = chip_smoke.DaemonSession(sock)
    (h1,) = struct.unpack("<q", c1.ok(server.OP_INIT))
    c1.close()
    time.sleep(0.5)
    c2 = chip_smoke.DaemonSession(sock)
    try:
        status, body = c2.call(server.OP_LOAD_MODELS, struct.pack("<q", h1)
                               + b"/nonexistent")
        assert status == 1 and b"KeyError" in body
    finally:
        c2.close()


def test_daemon_eval_batch_matches_direct_call(daemon):
    from dragposer_tpu_torch.cli.eval_drag import (build_engine,
                                                   evaluate_batched,
                                                   resolve_config)
    from dragposer_tpu_torch.data import encoding
    from dragposer_tpu_torch.io.bvh import BVH
    from dragposer_tpu_torch.ops.topology import Skeleton
    from dragposer_tpu_torch.runtime.client import DaemonClient

    sock, _, files, work = daemon
    with DaemonClient(sock, timeout=600) as c:
        c.ping()
        out = c.eval_batch(MODEL_DIR, files[0], files, max_frames=16,
                           save_dir=str(work / "daemon_out"))
        stats = c.stats()
    assert stats["eval"]["jobs_done"] >= 1
    assert stats["eval"]["engines_cached"] >= 1
    bvh = BVH().load(files[0])
    _, _, parents, offsets, _ = encoding.info_from_bvh(bvh)
    sk = Skeleton.build(parents, offsets, bvh.names)
    engine, means, stds = build_engine(MODEL_DIR, parents,
                                       resolve_config("6_trackers"),
                                       skeleton=sk, device="cpu")
    # one thread, as the daemon (OMP_NUM_THREADS=1): other test modules
    # imported into this process may have set another count
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        want = evaluate_batched(engine, means, stds, sk, files,
                                max_frames=16,
                                save_dir=str(work / "direct_out"))
    finally:
        torch.set_num_threads(threads)
    assert [r["file"] for r in out["results"]] == files
    got = [(r["mpjpe"], r["mpeepe"]) for r in out["results"]]
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-6)
    assert all(0.0 < m < 0.5 for m, _ in got)


def test_daemon_refuses_mesh(daemon):
    """``mesh`` as the JAX daemon takes it (``eval_drag --mesh``): a mesh
    of the daemon's one local device gives the run without it; a mesh
    past its local devices is refused with an error naming ``--mesh``, and
    the daemon keeps running."""
    from dragposer_tpu_torch.runtime.client import DaemonClient, DaemonError

    sock, proc, files, work = daemon
    with DaemonClient(sock, timeout=600) as c:
        with pytest.raises(DaemonError, match="--mesh"):
            c.eval_batch(MODEL_DIR, files[0], files[:1], max_frames=4,
                         save_dir=str(work), mesh=2)
        one = c.eval_batch(MODEL_DIR, files[0], files[:1], max_frames=4,
                           save_dir=str(work), mesh=1)
        plain = c.eval_batch(MODEL_DIR, files[0], files[:1], max_frames=4,
                             save_dir=str(work))
    assert one["results"] == plain["results"]
    assert proc.poll() is None


def test_native_smoke_client_against_the_daemon(daemon):
    """``native/dragposer_client.cpp`` + ``native/smoke_main.cpp``, built
    with g++, run the reference DLL's call sequence through the port's
    daemon (``DRAGPOSER_NO_SPAWN``)."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the native client")
    sock, _, files, work = daemon
    binary = chip_smoke.build_native_smoke(str(work / "native"))
    out = chip_smoke.run_native_smoke(binary, sock, files[0], cycles=2,
                                      cwd=str(work))
    assert out.returncode == 0, (out.stdout[-1500:], out.stderr[-1500:])
    assert "smoke OK" in out.stdout
    assert out.stdout.count("end effectors: 6") == 2
