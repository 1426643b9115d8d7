"""The port's native layer (``dragposer_tpu_torch/native/``) on the CPU: the
embedded C ABI (``abi.cpp``) and the socket client (``client.cpp``), built by
``_build.native_library`` with ``g++``, driven by hosts that link them or
``dlopen`` them.

* the port's ``dragposer_abi.h`` declares the JAX package's exports with the
  same POD layouts, and ``native/smoke_main.cpp``, unchanged, compiles
  against it and runs against each library (2 cycles,
  ``DRAGPOSER_DEVICE=cpu``): the drop-in proof;
* ``probe`` (``dlopen`` RTLD_LOCAL, as a P/Invoke host) through the ABI
  equals ``runtime.capi`` in this process fed the same targets, to 1e-6
  (bitwise expected: one CPU thread a process, the same arithmetic), its
  frames on one host thread and on two host threads one after the other
  (the thread that started the interpreter is neither), with a ``PATH``
  that finds no interpreter of this installation;
* with no ``DRAGPOSER_DEVICE`` on this host, which has no GPU,
  ``init_drag_poser`` returns null and says why;
* the client library with no daemon listening starts the port's daemon
  (its ``/proc`` command line; no JAX library in its memory map), whose
  frames equal ``capi``'s to 1e-6; the test ends the daemon.

Skipped only where ``g++`` or an embeddable libpython is missing.
"""

import contextlib
import os
import re
import shutil
import subprocess
import sysconfig

import numpy as np
import pytest
import torch

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES = 6
TOL = 1e-6


@pytest.fixture(scope="module")
def native(tmp_path_factory):
    """The two libraries, the probe, a clip and its targets file, and the
    same lifecycle through ``capi`` in this process (the reference)."""
    from dragposer_tpu_torch import _build

    libpython = os.path.join(sysconfig.get_config_var("LIBDIR") or "",
                             sysconfig.get_config_var("INSTSONAME") or "")
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this host")
    if not (sysconfig.get_config_var("Py_ENABLE_SHARED")
            and os.path.exists(libpython)):
        pytest.skip("no embeddable libpython on this host")
    d = tmp_path_factory.mktemp("native")
    bvh = chip_smoke.synthetic_bvh(FRAMES + 2, seed=3)
    skeleton = str(d / "clip.bvh")
    bvh.save(skeleton)
    targets = str(d / "targets.f32")
    chip_smoke.write_probe_targets(targets, bvh, FRAMES)
    # one CPU thread, as the hosts (``OMP_NUM_THREADS=1``): another test
    # module imported into this worker may have set another count
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with contextlib.chdir(d):    # capi's session log
            ref, _ = chip_smoke.capi_frames(targets, skeleton, "cpu")
    finally:
        torch.set_num_threads(threads)
    return {"dir": d, "skeleton": skeleton, "targets": targets, "ref": ref,
            "probe": chip_smoke.build_probe(str(d)),
            "abi": _build.native_library("abi"),
            "client": _build.native_library("client")}


def _env(**extra):
    """A host's environment: one CPU thread a process, and a ``PATH``
    that leads to no interpreter of this Python installation (a Unity
    host's does not), so the libraries must find it themselves."""
    return chip_smoke.native_env(OMP_NUM_THREADS="1", PATH=os.defpath,
                                 **extra)


def _declarations(path):
    """The exports and POD structs of a header, comments dropped and
    whitespace collapsed."""
    text = re.sub(r"//[^\n]*", "", open(path).read())
    text = " ".join(text.split())
    return (sorted(re.findall(r"DRAGPOSER_EXPORT \w+\*? \w+\([^;]*\);",
                              text)),
            sorted(re.findall(r"struct \w+ \{[^}]*\};", text)))


def test_header_declares_the_jax_packages_abi():
    exports, structs = _declarations(
        os.path.join(chip_smoke.PORT_NATIVE, "dragposer_abi.h"))
    assert (exports, structs) == _declarations(
        os.path.join(REPO, "native", "dragposer_abi.h"))
    assert len(exports) == 12 and len(structs) == 3


@pytest.mark.parametrize("kind", ["abi", "client"])
def test_unchanged_smoke_main_runs_against(native, kind):
    """``native/smoke_main.cpp`` byte for byte, compiled against the port's
    header alone and linked to the library; with the client, the daemon it
    starts is ended here."""
    d = native["dir"] / f"smoke_{kind}"
    binary, headers = chip_smoke.build_smoke_against(kind, str(d))
    assert headers == [os.path.join(chip_smoke.PORT_NATIVE,
                                    "dragposer_abi.h")]
    with open(os.path.join(REPO, "native", "smoke_main.cpp"), "rb") as f:
        assert (d / "smoke_main.cpp").read_bytes() == f.read()
    sock = str(d / "s.sock")
    try:
        with open(d / "smoke.out", "w") as log:
            out = subprocess.run(
                [binary, chip_smoke.MODEL_DIR, native["skeleton"], "2"],
                stdout=log, stderr=subprocess.STDOUT,
                env=_env(DRAGPOSER_DEVICE="cpu", DRAGPOSER_SOCKET=sock),
                cwd=d, timeout=120)
    finally:
        if os.path.exists(sock):
            chip_smoke.spawned_daemon(sock)
    said = (d / "smoke.out").read_text()
    assert out.returncode == 0, said[-2000:]
    assert "smoke OK" in said and said.count("end effectors: 6") == 2


@pytest.mark.parametrize("threads", [False, True], ids=["one_thread",
                                                        "two_threads"])
def test_probe_through_the_abi_matches_capi(native, threads):
    r = chip_smoke.run_probe(
        native["probe"], native["abi"], native["targets"],
        native["skeleton"], _env(DRAGPOSER_DEVICE="cpu"),
        str(native["dir"] / f"abi_{threads}"), threads=threads, report=True,
        timeout=120)
    assert r["returncode"] == 0 and r["ok_line"], r["stderr"]
    assert r["frame_ids"] == list(range(FRAMES))
    assert r["frames"].shape == native["ref"].shape
    np.testing.assert_allclose(r["frames"], native["ref"], rtol=0, atol=TOL)
    rep = r["report"]
    assert rep["devices"] == ["cpu"] and rep["card"] is None
    assert rep["kernels"]["K2_plain"] > 0 and rep["kernels"]["K2"] == 0
    assert rep["jax_package_modules"] == []
    assert os.path.realpath(rep["torch"]) == os.path.realpath(torch.__file__)


def test_abi_without_a_gpu_or_cpu_returns_null(native):
    r = chip_smoke.run_probe(
        native["probe"], native["abi"], native["targets"],
        native["skeleton"], _env(), str(native["dir"] / "abi_no_device"),
        timeout=120)
    assert r["returncode"] == 3, r["stderr"]
    assert "init_drag_poser returned null" in r["stderr"]
    assert "no GPU is available" in r["stderr"]
    assert r["frames"].size == 0 and not r["ok_line"]


def test_client_starts_the_ports_daemon(native):
    """No daemon listens: the client library starts
    ``dragposer_tpu_torch.runtime.server --device cpu``, whose frames
    equal ``capi``'s."""
    d = native["dir"] / "client"
    sock = str(d / "c.sock")
    try:
        r = chip_smoke.run_probe(
            native["probe"], native["client"], native["targets"],
            native["skeleton"], _env(DRAGPOSER_DEVICE="cpu",
                                     DRAGPOSER_SOCKET=sock), str(d),
            timeout=120)
    finally:
        assert os.path.exists(sock), "no daemon listens"
        pid = chip_smoke.daemon_pid(sock)
        with open(f"/proc/{pid}/maps") as f:
            maps = f.read()
        daemon = chip_smoke.spawned_daemon(sock)
    assert daemon["ended"] and daemon["pid"] == pid
    cmdline = daemon["cmdline"]
    assert cmdline[1:3] == ["-m", "dragposer_tpu_torch.runtime.server"]
    assert cmdline[3:] == ["--socket", sock, "--idle-timeout", "300",
                           "--device", "cpu"]
    assert not daemon["jax_module"] and "jaxlib" not in maps
    assert daemon["kernels"]["K2_plain"] > 0
    assert r["returncode"] == 0 and r["ok_line"], r["stderr"]
    np.testing.assert_allclose(r["frames"], native["ref"], rtol=0, atol=TOL)


def test_capi_runs_repeat_bit_for_bit(native, monkeypatch):
    """The same lifecycle twice in this process, equal frame for frame, and
    no op whose equal inputs gave unequal outputs (the card check of
    ``chip_smoke.repeatability_figures``, here on the CPU)."""
    monkeypatch.setattr(chip_smoke, "NATIVE_WORK_DIR", str(native["dir"]))
    r = chip_smoke.capi_repeatability(native["targets"], native["skeleton"],
                                      "cpu")
    assert r["max_abs_err"] == 0.0 and r["first_frame_differing"] is None
    assert chip_smoke.first_nondeterministic_op(
        native["targets"], native["skeleton"], "cpu") is None


def test_native_library_is_built_once_and_needs_gxx(native, monkeypatch,
                                                    tmp_path):
    from dragposer_tpu_torch import _build

    before = dict(_build.BUILD_SECONDS)
    assert _build.native_library("client") == native["client"]
    assert _build.BUILD_SECONDS == before
    assert re.fullmatch(r"libdragposer_tpu_torch_client-[0-9a-f]{12}\.so",
                        native["client"].name)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        _build.native_library("abi")
