"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program."""

import ast
from pathlib import Path

import pytest

from portbench import harness

BENCH = harness.BENCH_DIR
RUN_MODULES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.relative_to(BENCH).parts)
REFERENCE = sorted((BENCH / "reference").glob("*.py")) + [BENCH / "weights.py", BENCH / "traffic.py"]
#: what the reference may import besides the standard library
REFERENCE_MAY = {"torch", "numpy"}
REFERENCE_OWN = ("portbench.reference", "portbench.weights", "portbench.traffic")


def imported(path: Path):
    """Every module name ``path`` imports, anywhere in it."""
    names = []
    for node in ast.walk(ast.parse(path.read_text(encoding="utf-8"))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.append(node.module)
        elif isinstance(node, ast.ImportFrom) and node.level:
            raise AssertionError(f"{path}: relative import")
    return names


def test_the_scan_sees_every_part():
    parts = {p.relative_to(BENCH).parts[0] for p in RUN_MODULES}
    assert {"run.py", "harness.py", "drivers", "metrics", "reference"} <= parts


@pytest.mark.parametrize("path", RUN_MODULES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_module_the_benchmark_runs_imports_jax(path):
    tops = {name.split(".")[0] for name in imported(path)}
    assert not tops & set(harness.FORBIDDEN_MODULES), (path, tops & set(harness.FORBIDDEN_MODULES))


@pytest.mark.parametrize("path", REFERENCE, ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    for name in imported(path):
        top = name.split(".")[0]
        if top == "portbench":
            assert name.startswith(REFERENCE_OWN), (path, name)
        else:
            assert top != "distkeras_tpu_torch" and top not in harness.FORBIDDEN_MODULES
            assert top in REFERENCE_MAY or top in __import__("sys").stdlib_module_names, (path, name)


def test_names_are_compared_whole(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "distkeras_tpu_torch_probe", types.ModuleType("x"))
    assert "distkeras_tpu" not in harness.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert harness.forbidden_loaded() == ["jax"]
