"""No module of the benchmark imports JAX or the JAX package, compared by
whole top-level name (``duet_tpu_torch`` begins with ``duet_tpu``), and
the yardstick (the reference and the simulator) imports nothing of the
program."""

import ast
import os

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX = {"jax", "jaxlib", "flax", "duet_tpu"}


def modules():
    for dirpath, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.relpath(os.path.join(dirpath, f), BENCH)


def imported(rel: str) -> set[str]:
    with open(os.path.join(BENCH, rel)) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("rel", sorted(modules()))
def test_no_jax(rel):
    assert not imported(rel) & JAX


@pytest.mark.parametrize("rel", sorted(
    r for r in modules() if r.split(os.sep)[0] in ("reference", "sim")))
def test_yardstick_imports_nothing_of_the_program(rel):
    assert "duet_tpu_torch" not in imported(rel)


def test_the_rule_compares_whole_names():
    names = imported(os.path.join("tests", "test_bench_reference.py"))
    assert "duet_tpu_torch" in names and not names & JAX
