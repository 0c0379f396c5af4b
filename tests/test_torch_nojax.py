"""The port needs nothing of JAX and nothing of the JAX package: its build +
call (with the host and the device counter, on a mesh of one rank, and on
a nine-genome panel) run with `jax` and `bronko_tpu` blocked, and no
source of the port (the parallel/ modules too), nor
chip_smoke.py, imports either or reads a path under bronko_tpu/."""

import ast
import os
import re
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "bronko_tpu_torch")

SCRIPT = textwrap.dedent("""
    import os, sys
    sys.modules["jax"] = None          # any `import jax` now raises ImportError,
    sys.modules["bronko_tpu"] = None   # and so does any import of the JAX package
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from tests.make_synthetic import make_genome, make_sample, write_fasta, write_fastq
    from bronko_tpu_torch import cli

    tmp = sys.argv[1]
    rng = np.random.default_rng(5)
    genome = make_genome(rng, 900)
    reads, _ = make_sample(genome, rng, read_len=80, depth=300,
                           major_positions={400: 0.95})
    write_fasta(os.path.join(tmp, "ref.fasta"), "ref", genome)
    write_fastq(os.path.join(tmp, "s.fastq.gz"), reads)
    db = os.path.join(tmp, "db")
    assert cli.main(["build", "-g", os.path.join(tmp, "ref.fasta"), "-o", db]) == 0
    assert cli.main(["call", "-d", db + ".bkdb", "-r", os.path.join(tmp, "s.fastq.gz"),
                     "-o", os.path.join(tmp, "out"), "--pileup", "--counter", "host"]) == 0
    rows = [l for l in open(os.path.join(tmp, "out", "s.vcf")) if not l.startswith("#")]
    assert any(l.split("\\t")[1] == "401" for l in rows), rows
    assert cli.main(["call", "-d", db + ".bkdb", "-r", os.path.join(tmp, "s.fastq.gz"),
                     "-o", os.path.join(tmp, "out_device"), "--pileup",
                     "--counter", "device"]) == 0
    for f in ("s.vcf", "s.tsv", "bronko_overview.tsv"):
        assert (open(os.path.join(tmp, "out_device", f)).read()
                == open(os.path.join(tmp, "out", f)).read()), f
    assert cli.main(["call", "-d", db + ".bkdb", "-r", os.path.join(tmp, "s.fastq.gz"),
                     "-o", os.path.join(tmp, "out_mesh"), "--pileup", "--mesh", "1x1"]) == 0
    for f in ("s.vcf", "s.tsv", "bronko_overview.tsv"):
        assert (open(os.path.join(tmp, "out_mesh", f)).read()
                == open(os.path.join(tmp, "out", f)).read()), f
    panel =[os.path.join(tmp, "ref.fasta")]  # nine genomes: the multi-word histogram
    for i in range(8):
        g = bytearray(genome)
        for p in rng.integers(0, len(g), 6):
            g[p] = b"ACGT"[(b"ACGT".index(g[p]) + 1) % 4]
        panel.append(os.path.join(tmp, f"strain{i}.fasta"))
        write_fasta(panel[-1], f"strain{i}", bytes(g))
    assert cli.main(["call", "-g", *panel, "-r", os.path.join(tmp, "s.fastq.gz"),
                     "-o", os.path.join(tmp, "out_panel"), "--pileup"]) == 0
    for f in ("s.vcf", "s.tsv"):
        assert (open(os.path.join(tmp, "out_panel", f)).read()
                == open(os.path.join(tmp, "out", f)).read()), f
    for blocked in ("jax", "bronko_tpu"):
        loaded = sorted(m for m in sys.modules
                        if m == blocked or m.startswith((blocked + ".", "jaxlib")))
        assert sys.modules[blocked] is None and loaded == [blocked], loaded
    native = os.path.join(os.path.dirname(cli.__file__), "native", "build")
    assert os.path.exists(os.path.join(native, "libbronko_io.so"))
    print("NOJAX_OK")
""")


def test_build_and_call_with_jax_blocked(tmp_path):
    env = {**os.environ, "BRONKO_PLATFORM": "cpu", "PYTHONPATH": REPO}
    proc = subprocess.run([sys.executable, "-c", SCRIPT, str(tmp_path)], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "NOJAX_OK" in proc.stdout


def _sources() -> list[str]:
    """Every .py of the port, and chip_smoke.py, relative to the repo."""
    found = ["chip_smoke.py"]
    for root, dirs, files in os.walk(PORT):
        dirs[:] = sorted(d for d in dirs if d != "__pycache__")
        found += [os.path.relpath(os.path.join(root, f), REPO)
                  for f in sorted(files) if f.endswith(".py")]
    return found


SOURCES = _sources()
# a path component naming the JAX package's directory
JAX_PACKAGE_PATH = re.compile(r"(^|/)bronko_tpu(/|$)")
MODULE_NAME = re.compile(r"^[A-Za-z_][\w.]*$")


def _is_blocked_module(name: str | None) -> bool:
    return name is not None and any(
        name == top or name.startswith(top + ".") for top in ("jax", "jaxlib", "bronko_tpu"))


def _faults(tree: ast.AST) -> list[str]:
    """Imports of jax or of the JAX package, dynamic imports naming them,
    and string constants that build a path into bronko_tpu/ (arguments
    of a call, such as open or os.path.join, and operands of `/`)."""
    faults = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            faults += [f"import {a.name}" for a in node.names if _is_blocked_module(a.name)]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and _is_blocked_module(node.module):
                faults.append(f"from {node.module} import")
        elif isinstance(node, (ast.Call, ast.BinOp)):
            if isinstance(node, ast.Call):
                operands = node.args + [kw.value for kw in node.keywords]
            elif isinstance(node.op, ast.Div):
                operands = [node.left, node.right]
            else:
                continue
            for op in operands:
                for arg in op.elts if isinstance(op, (ast.List, ast.Tuple)) else [op]:
                    if isinstance(arg, ast.Constant) and isinstance(arg.value, str) and (
                            (MODULE_NAME.match(arg.value) and _is_blocked_module(arg.value))
                            or JAX_PACKAGE_PATH.search(arg.value)):
                        faults.append(f"line {arg.lineno}: {arg.value!r}")
    return faults


def _source_faults(source: str) -> list[str]:
    with open(os.path.join(REPO, source)) as fh:
        return _faults(ast.parse(fh.read(), source))


def test_sources_import_no_jax():
    """No source imports jax or the JAX package; the port has its own host
    modules (consts, config, io, index, call) and native sources."""
    assert len(SOURCES) >= 25
    for sub in ("consts.py", "config.py", "io/native.py", "index/store.py", "call/noise.py",
                "parallel/distributed.py", "parallel/mesh.py", "parallel/pipeline.py",
                "entry.py"):
        assert os.path.join("bronko_tpu_torch", sub) in SOURCES, sub
    assert {s: f for s in SOURCES if (f := _source_faults(s))} == {}


@pytest.mark.parametrize("source", SOURCES)
def test_source_imports_nothing_of_the_jax_package(source):
    """Parsed, each source imports neither jax nor bronko_tpu (only
    bronko_tpu_torch) and reads no path under bronko_tpu/."""
    assert _source_faults(source) == [], source


@pytest.mark.parametrize("code,fault", [
    ("import bronko_tpu", True),
    ("import bronko_tpu.consts as c", True),
    ("from bronko_tpu.io import native", True),
    ("from bronko_tpu import consts", True),
    ("from jax import numpy", True),
    ("importlib.import_module('bronko_tpu.cli')", True),
    ("open(os.path.join(REPO, 'bronko_tpu', 'native', 'x.so'))", True),
    ("p = Path(REPO) / 'bronko_tpu/native'", True),
    ("subprocess.run(['make', '-C', 'bronko_tpu/native'])", True),
    ("from bronko_tpu_torch.io import native", False),
    ("ap.add_argument('--x', help='jax.distributed address')", False),
    ("from . import consts", False),
    ("sys.modules['bronko_tpu'] = None", False),
    ("KERNELS = {'k': ('bronko_tpu/ops/pallas_buckets.py:83', 'src.cu')}", False),
    ("os.path.join(REPO, 'bronko_tpu_torch', 'native')", False),
])
def test_the_source_check_finds_what_it_should(code, fault):
    assert bool(_faults(ast.parse(code))) == fault
