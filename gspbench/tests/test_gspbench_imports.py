"""No module of the benchmark imports JAX, Flax, the JAX package or
``benchmarks/`` (top-level names compared whole: ``repro_torch`` is not
``repro``), and the reference imports nothing of the program."""

import ast

import pytest

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}
SOURCES = sorted((ROOT / "gspbench").rglob("*.py"))


def _imported_top_levels(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_package(path):
    assert not set(_imported_top_levels(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((ROOT / "gspbench" / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "repro_torch" not in set(_imported_top_levels(path))


def test_the_check_compares_whole_names():
    assert "repro_torch".split(".")[0] not in FORBIDDEN
