"""Nothing the benchmark runs imports JAX or the JAX package (top-level
module names compared whole: sketchtpu_torch is not sketchtpu), and the
reference and the generator import nothing of the port."""

from __future__ import annotations

import ast
import sys
from pathlib import Path

import pytest

from portbench import run

HERE = Path(run.__file__).resolve().parent
SOURCES = sorted(p for p in HERE.rglob("*.py") if "tests" not in p.parts)


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not top_level_imports(path) & set(run.BANNED)


@pytest.mark.parametrize("part", ["reference", "databases"])
def test_reference_and_generator_import_nothing_of_the_port(part):
    for path in sorted((HERE / part).glob("*.py")):
        assert "sketchtpu_torch" not in top_level_imports(path), path


def test_banned_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "sketchtpu_torch_fake.x", object())
    monkeypatch.setitem(sys.modules, "jaxtyping_fake", object())
    for name in run.BANNED:
        monkeypatch.delitem(sys.modules, name, raising=False)
    assert run.banned_modules() == []
    monkeypatch.setitem(sys.modules, "sketchtpu.dist", object())
    monkeypatch.setitem(sys.modules, "jax", object())
    assert run.banned_modules() == ["jax", "sketchtpu"]
