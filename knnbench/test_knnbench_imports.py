"""Nothing the benchmark runs imports JAX or the JAX package, by whole
top-level module name; the yardstick imports nothing of the program."""
from __future__ import annotations

import ast
from pathlib import Path

import pytest

from knnbench.harness import FORBIDDEN, forbidden_loaded

BENCH = Path(__file__).resolve().parent
MODULES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)
# the reference, the comparison, the traffic, the peaks and byte counts, the
# trace reduction and every metric reader
YARDSTICK = [p for p in MODULES
             if p.parent.name in ("references", "metrics")
             or p.stem in ("check", "traffic", "roofline", "trace", "control")]


def _top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".", 1)[0])
    return names


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not _top_level_imports(path) & set(FORBIDDEN)


@pytest.mark.parametrize("path", YARDSTICK,
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_the_yardstick_imports_nothing_of_the_program(path):
    assert "repro_torch" not in _top_level_imports(path)
    assert "repro_torch" not in path.read_text().replace(
        "``repro_torch``", "")


def test_forbidden_modules_compare_whole_top_level_names():
    mods = {"repro_torch": 1, "repro_torch.api": 1, "reproduce": 1,
            "jaxtyping": 1, "jax.numpy": 1, "repro.core": 1, "flax": 1,
            "numpy": 1}
    assert forbidden_loaded(mods) == ["flax", "jax.numpy", "repro.core"]
