"""The port imports neither ``jax`` nor the JAX package, and runs none of
its modules; it has every public name of the JAX package.

Every module of ``dragposer_tpu_torch/`` and ``chip_smoke.py`` is parsed
(not imported): each ``import`` / ``from … import`` is checked, and so is
every string, which must not name a module of the JAX package to run
(``-m dragposer_tpu.runtime.server``, or the dotted name alone, as a
subprocess or ``importlib`` would take it).  The C++ of the port's native
layer (``dragposer_tpu_torch/native/*.cpp``, ``*.h``) must not name one
anywhere (``dragposer_tpu.`` and a name: an embedded interpreter imports
it, a spawned daemon runs it).  Each JAX module's public top-level names
are its counterpart's too, but for an allow-list with a reason each.
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
NATIVE_SOURCES = sorted((ROOT / "dragposer_tpu_torch" / "native").glob(
    "*.cpp")) + sorted((ROOT / "dragposer_tpu_torch" / "native").glob("*.h"))
NAMES_JAX_MODULE = re.compile(r"(?<![\w/])dragposer_tpu\.\w")
# public names of the JAX package the port rightly lacks, and why
NOT_PORTED = {
    "drag/iter_kernel.py": {"JP", "TILE_B"},        # Mosaic tiling
    "ops/attn_fused.py": {"SQ_BLOCK", "TILE_B_FWD",  # Mosaic tiling
                          "TILE_B_BWD"},
    "ops/temporal_fused.py": {"BT"},                # Mosaic tiling
    # the TPU host's staging limit for device-resident batches
    "train/temporal.py": {"STAGE_LIMIT_BYTES"},
    "ops/__init__.py": {"host_device"},             # JAX's host CPU device
    # the path of an example clip that this repository does not hold
    "cli/interactive.py": {"EXAMPLE_BVH"},
}


def _imported(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            if node.level == 0:
                yield node.module


def _public_names(path):
    """Functions, classes and assigned names at a module's top level that
    do not start with ``_``."""
    names = set()
    for node in ast.parse(path.read_text(), filename=str(path)).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            names.update(n.id for t in targets for n in ast.walk(t)
                         if isinstance(n, ast.Name))
    return {n for n in names if not n.startswith("_")}


def test_sources_found():
    assert len(SOURCES) > 20
    assert [p.name for p in NATIVE_SOURCES] == [
        "abi.cpp", "client.cpp", "probe.cpp", "dragposer_abi.h"]
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
    extras are the kernel build, the device choice and the tracing."""
    def modules(pkg):
        return {str(p.relative_to(ROOT / pkg))
                for p in (ROOT / pkg).rglob("*.py")}

    jax_side, port = modules("dragposer_tpu"), modules("dragposer_tpu_torch")
    assert jax_side - port == set()
    assert port - jax_side == {"_build.py", "_device.py", "tracing.py"}
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


def test_every_jax_public_name_has_a_counterpart():
    """Module by module, the JAX package's public top-level names less the
    port's are exactly ``NOT_PORTED``."""
    jax_root, port_root = ROOT / "dragposer_tpu", ROOT / "dragposer_tpu_torch"
    missing = {}
    for path in sorted(jax_root.rglob("*.py")):
        rel = str(path.relative_to(jax_root))
        lacks = _public_names(path) - _public_names(port_root / rel)
        if lacks:
            missing[rel] = lacks
    assert missing == NOT_PORTED


@pytest.mark.parametrize("path", NATIVE_SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in NATIVE_SOURCES])
def test_native_names_no_jax_module(path):
    for lineno, line in enumerate(path.read_text().splitlines(), 1):
        assert not NAMES_JAX_MODULE.search(line), (
            f"{path.name}:{lineno} names a JAX package module: {line!r}")


def test_the_native_check_catches_a_jax_module():
    for text in ('PyImport_ImportModule("dragposer_tpu.runtime.capi");',
                 '"-m", "dragposer_tpu.runtime.server",',
                 "// forwards to dragposer_tpu.runtime.capi"):
        assert NAMES_JAX_MODULE.search(text), text
    for text in ('PyImport_ImportModule("dragposer_tpu_torch.runtime.capi");',
                 '"dragposer_tpu_torch.runtime.server"',
                 "// the port of native/dragposer_abi.cpp",
                 'return p ? p : "/tmp/dragposer_tpu_torch.sock";'):
        assert not NAMES_JAX_MODULE.search(text), text
