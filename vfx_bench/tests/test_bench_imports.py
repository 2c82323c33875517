"""Nothing under vfx_bench/ imports JAX or the JAX package, and nothing
under vfx_bench/reference/ imports the port: each import's top-level name
(the part before the first dot) compared whole."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
JAX = {"jax", "jaxlib", "flax", "variantformer_tpu"}


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(p for p in HERE.rglob("*.py") if "tests" not in p.relative_to(HERE).parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not top_level_imports(path) & JAX


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not top_level_imports(path) & (JAX | {"variantformer_tpu_torch"})


def test_run_time_check_compares_whole_names(monkeypatch):
    """The port's name begins with the JAX package's: the check of
    ``sys.modules`` after the window tells them apart."""
    import sys

    from vfx_bench import harness

    import variantformer_tpu_torch.models.seq2gene  # noqa: F401

    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "variantformer_tpu.models", object())
    monkeypatch.setitem(sys.modules, "jaxlib", object())
    assert harness.forbidden_modules() == ["jaxlib", "variantformer_tpu"]


def test_reference_vfx_imports_are_reference_only():
    for path in (HERE / "reference").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ImportFrom) and node.module and \
                    node.module.startswith("vfx_bench"):
                assert node.module.startswith("vfx_bench.reference"), (path, node.module)
