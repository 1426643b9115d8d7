"""The port imports neither ``jax`` nor the JAX package, and runs none of
its modules.

Every module of ``dragposer_tpu_torch/`` and ``chip_smoke.py`` is parsed
(not imported): each ``import`` / ``from … import`` is checked, and so is
every string, which must not name a module of the JAX package to run
(``-m dragposer_tpu.runtime.server``, or the dotted name alone, as a
subprocess or ``importlib`` would take it).
"""

import ast
import pathlib
import re

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
SOURCES = sorted((ROOT / "dragposer_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "dragposer_tpu")
RUNS_JAX_MODULE = re.compile(
    r"-m\s+dragposer_tpu\.|^\s*dragposer_tpu(\.\w+)+\s*$")


def _imported(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            if node.level == 0:
                yield node.module


def test_sources_found():
    assert len(SOURCES) > 20
    for name in ("iter_block", "temporal_forward", "ff_lanes", "ff_rows",
                 "attn_lanes"):
        assert (ROOT / "dragposer_tpu_torch" / "csrc" / f"{name}.cu").exists()
    for module in ("ops/hash_dropout.py", "ops/ff_fused.py",
                   "ops/attn_fused.py", "train/temporal.py",
                   "cli/train_temporal.py", "data/datasets.py",
                   "train/vae.py", "cli/train_vae.py", "models/vae.py",
                   "models/skeleton_nn.py", "export.py",
                   "drag/constraints.py", "drag/hypotheses.py",
                   "drag/engine.py", "metrics.py", "runtime/realtime.py",
                   "runtime/capi.py", "runtime/server.py",
                   "runtime/client.py", "client/math.py",
                   "client/retarget.py", "client/driver.py",
                   "cli/unity_server.py", "models/torch_import.py",
                   "cli/import_checkpoint.py", "parallel/mesh.py",
                   "parallel/distributed.py", "client/playback.py",
                   "client/vr.py", "cli/interactive.py", "cli/visualize.py"):
        assert ROOT / "dragposer_tpu_torch" / module in SOURCES


def test_every_jax_module_has_a_counterpart():
    """The port has a module for every module of the JAX package; its own
    extras are the kernel build and the device choice."""
    def modules(pkg):
        return {str(p.relative_to(ROOT / pkg))
                for p in (ROOT / pkg).rglob("*.py")}

    jax_side, port = modules("dragposer_tpu"), modules("dragposer_tpu_torch")
    assert jax_side - port == set()
    assert port - jax_side == {"_build.py", "_device.py"}
    assert (ROOT / "dragposer_tpu_torch" / "client" / "viewer.html").exists()


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_jax_import(path):
    for name in _imported(path):
        top = name.split(".")[0]
        assert top not in FORBIDDEN, f"{path.name} imports {name}"


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_runs_no_jax_module(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            assert not RUNS_JAX_MODULE.search(node.value), (
                f"{path.name}:{node.lineno} names a JAX package module to "
                f"run: {node.value!r}")


def test_the_string_check_catches_a_module_to_run():
    for text in ("-m dragposer_tpu.runtime.server", "dragposer_tpu.cli.x",
                 "python -m  dragposer_tpu.runtime"):
        assert RUNS_JAX_MODULE.search(text), text
    for text in ("-m dragposer_tpu_torch.runtime.server",
                 "/tmp/dragposer_tpu.sock", "port of dragposer_tpu/runtime"):
        assert not RUNS_JAX_MODULE.search(text), text
