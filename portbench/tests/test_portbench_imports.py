"""No file of the benchmark imports JAX or the JAX package, and the plain
reference imports nothing of the program; top-level names compared whole,
so `bronko_tpu_torch` is not taken for `bronko_tpu`. At run time the
guard refuses the imports too."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

import pytest
from conftest import ROOT

PB = os.path.join(ROOT, "portbench")
JAX = {"jax", "jaxlib", "flax", "bronko_tpu"}


def _sources(folder: str) -> list[str]:
    return sorted(os.path.join(d, f) for d, _, fs in os.walk(folder) if ".cache" not in d
                  for f in fs if f.endswith(".py"))


def _imports(path: str) -> set[str]:
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.partition(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.partition(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).partition(".")[0])
    return names


@pytest.mark.parametrize("path", _sources(PB), ids=lambda p: os.path.relpath(p, PB))
def test_no_jax(path):
    assert not _imports(path) & JAX


@pytest.mark.parametrize("path", _sources(os.path.join(PB, "reference")),
                         ids=lambda p: os.path.relpath(p, PB))
def test_reference_is_independent(path):
    assert not _imports(path) & (JAX | {"bronko_tpu_torch"})


def test_guard_blocks_whole_names():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from portbench import guard; guard.install()\n"
            "import bronko_tpu_torch\n"
            "for m in ('jax', 'jax.numpy', 'bronko_tpu', 'bronko_tpu.cli', 'flax'):\n"
            "    try:\n"
            "        __import__(m)\n"
            "    except ImportError:\n"
            "        pass\n"
            "    else:\n"
            "        raise SystemExit('imported ' + m)\n"
            "assert guard.loaded() == [], guard.loaded()\n" % ROOT)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=120, cwd=ROOT)
    assert p.returncode == 0, p.stderr
