"""Nothing the benchmark runs is of the JAX side, and its reference takes
nothing of the program: imports compared by whole top-level name."""

import ast
import os

from conftest import ROOT

HERE = os.path.join(ROOT, "benchmark")
JAX_SIDE = {"jax", "jaxlib", "flax", "dragposer_tpu"}


def imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def sources():
    for d, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_module_of_the_jax_side():
    found = {p: set(imports(p)) & JAX_SIDE for p in sources()}
    assert not any(found.values()), found


def test_the_reference_imports_nothing_of_the_program():
    ref = os.path.join(HERE, "reference")
    found = {p: [m for m in imports(p) if m == "dragposer_tpu_torch"]
             for p in sources() if p.startswith(ref)}
    assert found and not any(found.values()), found


def test_the_names_compared_are_whole():
    # the port's name begins with the JAX package's: a prefix test is wrong
    assert "dragposer_tpu_torch" not in JAX_SIDE
