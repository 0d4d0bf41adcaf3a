"""The port stands alone: no module of ``blockpuzzle_tpu_torch`` and not
``chip_smoke.py`` imports the JAX package, JAX, flax or gymnasium, at any
level (module top, function body, ``__import__`` of a literal name), but
the Gymnasium surface, ``blockpuzzle_tpu_torch/vector_env.py``, imports
gymnasium, and nothing else imports that module, except the two Gymnasium
sections of the quickstart (``GYM_SECTIONS``: functions that import
gymnasium and the surface in their bodies, so that the module and its
other sections run without gymnasium).  The card machine has none of the
four.  Test files that the card machine runs whole (``CARD_TESTS``)
import none of the four either.  Parsed with ``ast``, not imported.
"""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("blockpuzzle_tpu", "jax", "flax", "gymnasium")
FILES = sorted((ROOT / "blockpuzzle_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
# test files the card machine runs whole (``--noconftest``)
CARD_TESTS = [ROOT / "tests" / "test_torch_properties.py"]
# the one module that may import gymnasium
GYM_SURFACE = ROOT / "blockpuzzle_tpu_torch" / "vector_env.py"
GYM_MODULE = "blockpuzzle_tpu_torch.vector_env"
# module -> its top-level functions that may import gymnasium and the surface
GYM_SECTIONS = {ROOT / "blockpuzzle_tpu_torch" / "examples" / "quickstart.py":
                ("single_env", "vector_env")}


def parse_outside_sections(path: pathlib.Path) -> ast.Module:
    """``path``'s syntax tree without the bodies of its ``GYM_SECTIONS``."""
    tree = ast.parse(path.read_text(), filename=str(path))
    sections = GYM_SECTIONS.get(path, ())
    tree.body = [node for node in tree.body
                 if not (isinstance(node, ast.FunctionDef) and node.name in sections)]
    return tree


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


def forbidden(name: str, allowed=()) -> bool:
    top = name.split(".")[0]
    return top in FORBIDDEN and top not in allowed


def imports_gym_surface(tree: ast.AST):
    """Lines that import ``blockpuzzle_tpu_torch.vector_env``, in any form:
    ``import``, ``from ... import``, ``from blockpuzzle_tpu_torch import
    vector_env``, a relative import of it, ``__import__``/``import_module``
    of its name."""
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            module = node.module or ""
            names = [a.name for a in node.names]
            if (module == GYM_MODULE or module.startswith(GYM_MODULE + ".")
                    or (node.level and module.split(".")[-1] == "vector_env")
                    or (module in ("blockpuzzle_tpu_torch", "") and "vector_env" in names)):
                yield node.lineno
    for line, name in imported_modules(tree):
        if name == GYM_MODULE or name.startswith(GYM_MODULE + "."):
            yield line


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_flax_gymnasium_or_jax_package_import(path):
    tree = parse_outside_sections(path)
    allowed = ("gymnasium",) if path == GYM_SURFACE else ()
    bad = [(line, name) for line, name in imported_modules(tree)
           if forbidden(name, allowed)]
    assert not bad, f"{path.name} imports {bad}"


@pytest.mark.parametrize("path", CARD_TESTS, ids=lambda p: str(p.relative_to(ROOT)))
def test_card_test_file_imports_no_jax_flax_gymnasium_or_jax_package(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [(line, name) for line, name in imported_modules(tree) if forbidden(name)]
    assert not bad, f"{path.name} imports {bad}"
    assert not list(imports_gym_surface(tree)), f"{path.name} imports {GYM_MODULE}"


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_nothing_imports_the_gymnasium_surface(path):
    """Only the tests import ``vector_env.py``: the package ``__init__``,
    the engine, the CLIs and ``chip_smoke.py`` run without gymnasium."""
    tree = parse_outside_sections(path)
    assert not list(imports_gym_surface(tree)), f"{path.name} imports {GYM_MODULE}"


def test_the_check_catches_each_forbidden_form():
    src = ("import jax.numpy as jnp\nfrom blockpuzzle_tpu.oracle import x\n"
           "def f():\n    import gymnasium\n    from flax import linen\n"
           "    __import__('jax')\n    importlib.import_module('jax.random')\n"
           "import blockpuzzle_tpu_torch\nfrom blockpuzzle_tpu_torch import rules\n")
    names = [n for _, n in sorted(imported_modules(ast.parse(src))) if forbidden(n)]
    assert names == ["jax.numpy", "blockpuzzle_tpu.oracle", "gymnasium", "flax",
                     "jax", "jax.random"]
    assert len(FILES) > 20
    assert GYM_SURFACE in FILES
    tree = ast.parse(GYM_SURFACE.read_text())
    assert any(n == "gymnasium" for _, n in imported_modules(tree))
    assert not any(forbidden(n, ("gymnasium",)) for _, n in imported_modules(tree))


def test_the_surface_check_catches_each_form():
    forms = ["import blockpuzzle_tpu_torch.vector_env",
             "from blockpuzzle_tpu_torch.vector_env import BlockPuzzleVectorEnv",
             "from blockpuzzle_tpu_torch import rules, vector_env",
             "from . import vector_env", "from ..vector_env import x",
             "def f():\n    __import__('blockpuzzle_tpu_torch.vector_env')",
             "importlib.import_module('blockpuzzle_tpu_torch.vector_env')"]
    for src in forms:
        assert list(imports_gym_surface(ast.parse(src))), src
    clean = ("import blockpuzzle_tpu_torch\nfrom blockpuzzle_tpu_torch import rules\n"
             "from blockpuzzle_tpu_torch.env import autoreset\n")
    assert not list(imports_gym_surface(ast.parse(clean)))


def test_the_gymnasium_sections_are_functions_importing_only_the_surface():
    """Each ``GYM_SECTIONS`` entry is a top-level function of its module,
    and imports gymnasium and the Gymnasium surface and nothing else that
    is forbidden: the allowance covers those two imports in those bodies
    only."""
    for path, names in GYM_SECTIONS.items():
        assert path in FILES
        tree = ast.parse(path.read_text(), filename=str(path))
        funcs = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
        for name in names:
            body = ast.Module(body=funcs[name].body, type_ignores=[])
            imported = {n for _, n in imported_modules(body) if forbidden(n)}
            assert imported == {"gymnasium"}, (name, imported)
            assert list(imports_gym_surface(body)), name
