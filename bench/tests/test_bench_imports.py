"""Nothing under bench/ imports JAX or the JAX package (whole top-level
names: the port's ``repro_torch`` begins with ``repro``), and the plain
reference imports nothing of the program at all."""
from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest

import _bench_tiny as tiny

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imported_tops(path: Path) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


SOURCES = sorted(p for p in tiny.BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(tiny.BENCH)))
def test_no_jax_imports(path):
    assert not imported_tops(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(
    (tiny.BENCH / "references").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_only_numpy_and_torch(path):
    assert imported_tops(path) <= {"__future__", "numpy", "torch"}


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, 'bench/references'); "
            "import superlevel_ph0; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'repro', 'repro_torch', 'jax', 'jaxlib', 'flax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tiny.ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_guard_compares_whole_top_level_names():
    import harness.guard as guard
    assert guard.forbidden_loaded({"repro_torch", "repro_torch.ph",
                                   "reproduce", "numpy"}) == []
    assert guard.forbidden_loaded({"repro.core", "jax.numpy", "flax",
                                   "jaxlib"}) == ["flax", "jax.numpy",
                                                  "jaxlib", "repro.core"]
