"""The port stands alone: parallel_cnn_tpu_torch and chip_smoke.py import
neither JAX nor anything of the JAX package ``parallel_cnn_tpu``."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "parallel_cnn_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "parallel_cnn_tpu")
PORT_FILES = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]

# Runs in a fresh interpreter: a meta-path finder refuses every forbidden
# root, then every module of the port is imported.
_BLOCKED_IMPORT = """
import importlib, pkgutil, sys

FORBIDDEN = {forbidden!r}

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in FORBIDDEN:
            raise ImportError(f"blocked import of {{name}}")
        return None

sys.meta_path.insert(0, Block())
import parallel_cnn_tpu_torch as pkg
names = [pkg.__name__]
for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(info.name)
    names.append(info.name)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
assert not leaked, leaked
print(len(names), "modules")
"""


def _roots(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module.split(".")[0]


def test_port_imports_with_jax_blocked():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(REPO), env.get("PYTHONPATH")) if p
    )
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT.format(forbidden=FORBIDDEN)],
        capture_output=True, text=True, timeout=300, cwd=REPO, env=env,
    )
    assert proc.returncode == 0, proc.stderr
    n = int(proc.stdout.split()[0])
    assert n >= 20, proc.stdout


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_import_in_port_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [(line, root) for line, root in _roots(tree) if root in FORBIDDEN]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_kernel_source_names_the_tpu_kernel_it_replaces():
    src = (PKG / "csrc" / "tap_conv.cu").read_text()
    assert "pallas_conv.py:228" in src and "_tap_kernel" in src
