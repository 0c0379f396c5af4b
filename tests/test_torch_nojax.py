"""The port needs nothing of JAX: its build + call (with the host and the
device counter, and on a nine-genome panel) run with jax blocked, and its
sources import neither jax nor the JAX package's device modules."""

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
# bronko_tpu modules that import jax (or need it to run)
JAX_MODULES = ("bronko_tpu.call.engine", "bronko_tpu.index.layout",
               "bronko_tpu.index.device_build", "bronko_tpu.ops.map",
               "bronko_tpu.ops.count", "bronko_tpu.ops.pallas_buckets",
               "bronko_tpu.ops.pallas_pack", "bronko_tpu.parallel",
               "bronko_tpu.utils.memory")

SCRIPT = textwrap.dedent("""
    import os, sys
    sys.modules["jax"] = None          # any `import jax` now raises ImportError
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
                     "-o", os.path.join(tmp, "out"), "--pileup"]) == 0
    rows = [l for l in open(os.path.join(tmp, "out", "s.vcf")) if not l.startswith("#")]
    assert any(l.split("\\t")[1] == "401" for l in rows), rows
    assert cli.main(["call", "-d", db + ".bkdb", "-r", os.path.join(tmp, "s.fastq.gz"),
                     "-o", os.path.join(tmp, "out_device"), "--pileup",
                     "--counter", "device"]) == 0
    for f in ("s.vcf", "s.tsv", "bronko_overview.tsv"):
        assert (open(os.path.join(tmp, "out_device", f)).read()
                == open(os.path.join(tmp, "out", f)).read()), f
    panel = [os.path.join(tmp, "ref.fasta")]  # nine genomes: the multi-word histogram
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
    loaded = sorted(m for m in sys.modules
                    if m == "jax" or m.startswith(("jax.", "jaxlib"))
                    or m.startswith(JAX_MODULES))
    assert sys.modules["jax"] is None and loaded == ["jax"], loaded
    print("NOJAX_OK")
""").replace("JAX_MODULES", repr(JAX_MODULES))


def test_build_and_call_with_jax_blocked(tmp_path):
    env = {**os.environ, "BRONKO_PLATFORM": "cpu", "PYTHONPATH": REPO}
    proc = subprocess.run([sys.executable, "-c", SCRIPT, str(tmp_path)], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "NOJAX_OK" in proc.stdout


def _port_sources():
    for root, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def test_sources_import_no_jax():
    jax_import = re.compile(r"^\s*(import jax|from jax)\b", re.M)
    device_import = re.compile(
        r"^\s*(?:from|import)\s+(" + "|".join(map(re.escape, JAX_MODULES)) + r")\b", re.M)
    sources = list(_port_sources())
    assert len(sources) >= 8
    for path in sources:
        text = open(path).read()
        assert not jax_import.search(text), path
        assert not device_import.search(text), path
        assert not re.search(r"bronko_tpu\.cli import [^\n]*run_call_cmd", text), path
