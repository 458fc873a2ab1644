"""The port stands alone: no module of src/repro_torch, and not chip_smoke.py,
imports JAX or the JAX package ``repro``. Checked on the source with ``ast``,
so an import inside a function counts too."""

import ast
from pathlib import Path

import jax  # noqa: F401  (the port's tests import both frameworks)
import pytest
import torch  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
BANNED = ("jax", "jaxlib", "repro")


def imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_imports_neither_jax_nor_repro(path):
    for mod in imported_modules(path):
        assert mod.split(".")[0] not in BANNED, f"{path.name} imports {mod}"


def test_the_check_sees_the_port():
    assert len(FILES) > 20
    assert "repro_torch" in set(m.split(".")[0] for m in imported_modules(ROOT / "chip_smoke.py"))
