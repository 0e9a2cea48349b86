"""Import hygiene of the port: no JAX, nothing of the reference package.

Every ``repro_torch`` module, ``chip_smoke.py`` and the ranks' child scripts
of the distributed, sharded, LM mesh and dry-run tests
(``tests/_torch_dist_child.py``, ``tests/_torch_sharded_child.py``,
``tests/_torch_lm_mesh_child.py``, ``tests/_torch_lm_train_mesh_child.py``,
``tests/_torch_lm_pod_child.py``) are imported in a
fresh interpreter, which must end with neither ``jax`` nor any ``repro`` /
``repro.*`` module loaded; their sources, the port's ``tools/*.py`` and its
example scripts ``examples/torch_*.py`` are also scanned with ``ast`` for
such imports, including ones inside functions.
"""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
DIST_CHILD = ROOT / "tests" / "_torch_dist_child.py"
SHARDED_CHILD = ROOT / "tests" / "_torch_sharded_child.py"
LM_MESH_CHILD = ROOT / "tests" / "_torch_lm_mesh_child.py"
LM_TRAIN_MESH_CHILD = ROOT / "tests" / "_torch_lm_train_mesh_child.py"
LM_POD_CHILD = ROOT / "tests" / "_torch_lm_pod_child.py"
SOURCES = (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py", DIST_CHILD, SHARDED_CHILD, LM_MESH_CHILD,
                                         LM_TRAIN_MESH_CHILD, LM_POD_CHILD]
           + sorted((ROOT / "tools").glob("*.py"))
           + sorted((ROOT / "examples").glob("torch_*.py")))


def _module_names() -> list[str]:
    names = []
    for path in sorted(PORT.rglob("*.py")):
        parts = path.relative_to(PORT.parent).with_suffix("").parts
        names.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    return names


def test_importing_the_port_loads_no_jax_and_no_reference():
    code = (
        "import importlib, json, sys\n"
        f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}, {str(DIST_CHILD.parent)!r}]\n"
        f"for name in {_module_names()!r} + ['chip_smoke', {DIST_CHILD.stem!r}, {SHARDED_CHILD.stem!r}, {LM_MESH_CHILD.stem!r}, "
        f"{LM_TRAIN_MESH_CHILD.stem!r}, {LM_POD_CHILD.stem!r}]:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'repro' or m.startswith('repro.'))\n"
        "print(json.dumps(bad))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=str(ROOT), timeout=120, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_no_jax_and_no_reference(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{path.name} imports {name}"
