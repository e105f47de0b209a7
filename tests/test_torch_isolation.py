"""The port imports only what the machine with the card has: the stdlib,
numpy and torch (triton, and matplotlib for ``viz.py``'s drawing, only
inside a function), never JAX and nothing of the JAX package
``ctrl_sim_tpu``."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "ctrl_sim_tpu_torch"
REFUSED = ("jax", "jaxlib", "flax", "optax", "orbax", "ctrl_sim_tpu")
ALLOWED_TOP = {"numpy", "torch", "ctrl_sim_tpu_torch"}
LAZY = {"triton", "matplotlib"}  # imported inside the functions that use them, never at import


def _sources():
    return sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _modules():
    out = []
    for path in sorted(PACKAGE.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        out.append(".".join(parts))
    return out


_CHILD = """
import importlib, importlib.abc, sys
REFUSED = {refused!r}

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in REFUSED:
            raise ImportError("refused: " + name)
        return None

sys.meta_path.insert(0, Refuse())
for mod in {modules!r}:
    importlib.import_module(mod)
import chip_smoke  # defines main() without running it
loaded = sorted(m for m in sys.modules if m.split(".")[0] in REFUSED)
assert not loaded, loaded
print("OK", len({modules!r}))
"""


def test_port_imports_without_jax():
    modules = _modules()
    code = _CHILD.format(refused=REFUSED, modules=modules)
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == f"OK {len(modules)}"


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_import_statements_name_only_stdlib_numpy_torch(path):
    tree = ast.parse(path.read_text())
    top_level = set(ast.iter_child_nodes(tree))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:  # relative import inside the package
                continue
            names = [node.module]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            if top in LAZY:
                assert node not in top_level, f"{path}: import {top} inside a function only"
                continue
            assert top in ALLOWED_TOP or top in sys.stdlib_module_names, f"{path}: imports {name}"
