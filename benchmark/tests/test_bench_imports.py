"""No module of the benchmark imports JAX or the JAX package; the
reference imports nothing of the program either. Modules are compared by
their top-level name, whole."""
import ast
import os

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "adaqp_tpu"}
PROGRAM = "adaqp_tpu_torch"


def _sources():
    for d, _, files in os.walk(BENCH):
        if os.path.basename(d) in ("cache", "__pycache__"):
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _tops(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(_sources()), ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax(path):
    assert not set(_tops(path)) & FORBIDDEN


def test_the_scan_compares_whole_names():
    assert PROGRAM.split(".")[0] not in FORBIDDEN and "adaqp_tpu" in FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(BENCH, "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            tops = set(_tops(os.path.join(ref, f)))
            assert PROGRAM not in tops and "benchmark" not in tops, f
