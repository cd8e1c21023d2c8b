"""The port stands alone: no module of `mal_tpu_torch` (nor chip_smoke.py)
imports JAX, flax, optax or the JAX package `mal_tpu`, nor matplotlib,
which the card's machine lacks."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "flax", "optax", "mal_tpu", "matplotlib")
SOURCES = sorted((ROOT / "mal_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported(path: pathlib.Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.append(node.module)
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = [n for n in _imported(path)
           if n.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_every_module_loads_no_mal_tpu():
    code = (
        "import importlib, pkgutil, sys\n"
        "import mal_tpu_torch\n"
        "for m in pkgutil.walk_packages(mal_tpu_torch.__path__, 'mal_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('mal_tpu', 'jax', 'flax', 'optax', 'matplotlib')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
