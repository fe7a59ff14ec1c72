"""The port stands alone: no module of ``src/repro_torch``, not
``chip_smoke.py`` and no script under ``tools/`` imports JAX or anything
of the JAX package ``repro`` (a ``repro_torch`` import is the port's
own)."""
import ast
import os
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + \
    [REPO / "chip_smoke.py"] + sorted((REPO / "tools").glob("*.py"))
BANNED = ("jax", "jaxlib", "repro")


def _imported_roots(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                    "__import__", "import_module") and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


def _roots_of(src: str):
    return set(_imported_roots(ast.parse(src)))


@pytest.mark.parametrize("path", FILES, ids=lambda p: os.path.relpath(
    p, REPO))
def test_port_file_imports_no_jax(path):
    assert path.exists(), path
    roots = _roots_of(path.read_text())
    assert not roots & set(BANNED), (path, roots & set(BANNED))


def test_scan_tells_repro_from_repro_torch():
    assert _roots_of("import repro_torch.kernels\n"
                     "from repro_torch import utils\n") == {"repro_torch"}
    assert "repro" in _roots_of("from repro.core import armijo\n")
    assert "jax" in _roots_of("import jax.numpy as jnp\n")
    assert "repro" in _roots_of("import importlib\n"
                                "importlib.import_module('repro.comm')\n")
