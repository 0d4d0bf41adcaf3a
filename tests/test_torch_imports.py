"""The port stands alone: no module of ``blockpuzzle_tpu_torch`` and not
``chip_smoke.py`` imports the JAX package, JAX, flax or gymnasium, at any
level (module top, function body, ``__import__`` of a literal name).
The card machine has none of them.  Parsed with ``ast``, not imported.
"""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("blockpuzzle_tpu", "jax", "flax", "gymnasium")
FILES = sorted((ROOT / "blockpuzzle_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def imported_modules(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and (getattr(node.func, "id", None) == "__import__"
                   or getattr(node.func, "attr", None) == "import_module")):
            yield node.lineno, str(node.args[0].value)


def forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in FORBIDDEN


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_flax_gymnasium_or_jax_package_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [(line, name) for line, name in imported_modules(tree) if forbidden(name)]
    assert not bad, f"{path.name} imports {bad}"


def test_the_check_catches_each_forbidden_form():
    src = ("import jax.numpy as jnp\nfrom blockpuzzle_tpu.oracle import x\n"
           "def f():\n    import gymnasium\n    from flax import linen\n"
           "    __import__('jax')\n    importlib.import_module('jax.random')\n"
           "import blockpuzzle_tpu_torch\nfrom blockpuzzle_tpu_torch import rules\n")
    names = [n for _, n in sorted(imported_modules(ast.parse(src))) if forbidden(n)]
    assert names == ["jax.numpy", "blockpuzzle_tpu.oracle", "gymnasium", "flax",
                     "jax", "jax.random"]
    assert len(FILES) > 20
