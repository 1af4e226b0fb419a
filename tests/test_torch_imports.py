"""The port never imports JAX or the JAX package.

- Every module of ``mind_the_gaps_tpu_torch`` imports in a fresh process in
  which ``jax`` and ``mind_the_gaps_tpu`` cannot be imported
  (``sys.modules[name] = None`` makes any import of them fail), and
  leaves neither loaded.
- No source file of the port, nor ``chip_smoke.py``, holds an import of
  ``jax`` or of ``mind_the_gaps_tpu`` (``mind_the_gaps_tpu_torch`` aside),
  at any depth of the file (found with ``ast``, so imports inside
  functions count too).
"""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "mind_the_gaps_tpu_torch"

_IMPORT_ALL = """
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["mind_the_gaps_tpu"] = None
import mind_the_gaps_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
loaded = [k for k in sys.modules if k.split(".")[0] in ("jax", "jaxlib", "mind_the_gaps_tpu")
          and sys.modules[k] is not None]
print(len(names), loaded)
"""


def test_every_module_imports_without_jax():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    count, loaded = out.stdout.split(" ", 1)
    assert int(count) >= 30 and loaded.strip() == "[]"


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "mind_the_gaps_tpu")


def test_sources_hold_no_jax_import():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 30
    found = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            if isinstance(node, ast.Import):
                found += [(path.name, a.name) for a in node.names if _forbidden(a.name)]
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0 and _forbidden(node.module):
                found.append((path.name, node.module))
            elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", None)) in (
                    "import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant) \
                    and isinstance(node.args[0].value, str) and _forbidden(node.args[0].value):
                found.append((path.name, node.args[0].value))
    assert found == []
