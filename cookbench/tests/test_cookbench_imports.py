"""What the benchmark's modules may import and read: nothing of JAX or of
the JAX package (whole top-level names), nothing of the program in the
reference, and no file of the JAX era."""
from __future__ import annotations

import ast
import os

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH_DIR = os.path.dirname(HERE)
FORBIDDEN = {"jax", "jaxlib", "flax", "cook_tpu"}
JAX_ERA = ("bench.py", "chip_smoke", "BENCH_", "MULTICHIP_", "tuned_match",
           "bench_tpu")


def sources():
    for dirpath, _, files in os.walk(BENCH_DIR):
        for name in sorted(files):
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)


def imported(path: str) -> set[str]:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


SOURCES = list(sources())


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: os.path.relpath(p, BENCH_DIR))
def test_no_jax_and_no_jax_package(path):
    tops = {name.split(".")[0] for name in imported(path)}
    assert not tops & FORBIDDEN


@pytest.mark.parametrize(
    "path", [p for p in SOURCES if f"{os.sep}reference{os.sep}" in p],
    ids=lambda p: os.path.relpath(p, BENCH_DIR))
def test_reference_imports_nothing_of_the_program(path):
    tops = {name.split(".")[0] for name in imported(path)}
    assert "cook_tpu_torch" not in tops
    assert tops <= {"__future__", "bisect", "dataclasses", "heapq", "numpy",
                    "cookbench"}


@pytest.mark.parametrize(
    "path", [p for p in SOURCES if f"{os.sep}tests{os.sep}" not in p],
    ids=lambda p: os.path.relpath(p, BENCH_DIR))
def test_reads_no_jax_era_file(path):
    with open(path) as f:
        text = f.read()
    for name in JAX_ERA:
        assert name not in text, name


def test_forbidden_names_are_whole():
    """`cook_tpu_torch` begins with `cook_tpu` and is allowed: the check
    compares whole top-level names."""
    import cookbench.run as run

    assert "cook_tpu_torch" not in run.FORBIDDEN
    assert set(run.FORBIDDEN) == FORBIDDEN
