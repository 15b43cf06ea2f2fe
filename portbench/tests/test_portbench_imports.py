"""No module of the benchmark imports JAX or the JAX package (top-level
names compared whole: the program's name begins with the JAX package's),
and the yardstick (reference, counts, weights, attribution, check) imports
nothing of the program."""

import ast

import pytest

from portbench.tests.conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "caffe_escoin_tpu"}
PROGRAM = "caffe_escoin_tpu_torch"
YARDSTICK = ("reference", "counts.py", "weights.py", "traced.py", "check.py",
             "metrics")
FILES = sorted(p for p in (ROOT / "portbench").rglob("*.py"))


def imported(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax(path):
    assert not set(imported(path)) & FORBIDDEN


def test_yardstick_imports_nothing_of_the_program():
    for path in FILES:
        rel = path.relative_to(ROOT / "portbench")
        if rel.parts[0] in YARDSTICK:
            assert PROGRAM not in set(imported(path)), rel


def test_names_compared_whole():
    from portbench import harness

    assert "caffe_escoin_tpu" in harness.FORBIDDEN
    assert PROGRAM.split(".")[0] not in harness.FORBIDDEN
