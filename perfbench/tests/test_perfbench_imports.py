"""No JAX, no JAX package, and a reference that imports nothing of the
program, checked by whole top-level module names."""

import ast
import sys

import smoke
from harness import main as hm


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_forbidden_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_like", object())
    assert "repro_torch_like" not in hm.loaded_forbidden()
    assert all(m.split(".")[0] in hm.FORBIDDEN
               for m in hm.loaded_forbidden())
    monkeypatch.setitem(sys.modules, "repro.core", object())
    assert "repro.core" in hm.loaded_forbidden()


def test_nothing_under_the_benchmark_imports_jax_or_repro():
    for path in smoke.BENCH.rglob("*.py"):
        if "tests" in path.parts:
            continue
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "repro"), (path, mod)


def test_the_reference_imports_nothing_of_the_program():
    for path in (smoke.BENCH / "reference").glob("*.py"):
        for mod in _imports(path):
            assert mod.split(".")[0] not in ("repro_torch", "harness"), (
                path, mod)


def test_only_the_program_module_imports_the_port():
    for path in smoke.BENCH.rglob("*.py"):
        if "tests" in path.parts or path.name == "program.py":
            continue
        for mod in _imports(path):
            if mod.split(".")[0] == "repro_torch":
                # the dispatch the recorder wraps, and nothing else
                assert (path.name, mod) == ("record.py",
                                            "repro_torch.models"), path
