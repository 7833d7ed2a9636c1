"""The benchmark imports neither JAX nor the JAX package, and its
reference nothing of the program."""

import ast
import sys
from pathlib import Path

import pytest

from benchmark import run

BENCH = Path(__file__).resolve().parents[1]


def _imports(path: Path):
    """Top-level names, whole, of every module ``path`` imports."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


FILES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_and_no_jax_package(path):
    assert not set(_imports(path)) & {"jax", "jaxlib", "flax", "mcmda_tpu"}


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "mcmda_tpu_torch" not in set(_imports(path))


def test_the_run_names_loaded_jax_by_whole_top_level_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "mcmda_tpu_torch_lookalike", sys)
    assert "mcmda_tpu" not in run.jax_modules()
    monkeypatch.setitem(sys.modules, "mcmda_tpu.config", sys)
    assert "mcmda_tpu" in run.jax_modules()
