"""The port imports neither ``jax`` nor the JAX package.

Every module of ``dragposer_tpu_torch/`` and ``chip_smoke.py`` is parsed
(not imported) and each ``import`` / ``from … import`` is checked.
"""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
SOURCES = sorted((ROOT / "dragposer_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "dragposer_tpu")


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
                   "drag/engine.py", "metrics.py"):
        assert ROOT / "dragposer_tpu_torch" / module in SOURCES


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_jax_import(path):
    for name in _imported(path):
        top = name.split(".")[0]
        assert top not in FORBIDDEN, f"{path.name} imports {name}"
