"""The port's device index build (index/device_build.py) against its host
layout (index/build.py + index/layout.py): every tensor and field equal,
on the cases of tests/test_device_build.py, and `call -g ...
--device-build on` byte-equal to the JAX package's."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from bronko_tpu_torch import cli  # noqa: E402
from bronko_tpu_torch.index.build import build_index  # noqa: E402
from bronko_tpu_torch.index.device_build import (  # noqa: E402
    build_device_index_on_device, device_build,
)
from bronko_tpu_torch.index.layout import build_device_index  # noqa: E402
from bronko_tpu_torch.index.store import load_index, save_index  # noqa: E402
# plain module name (pytest puts tests/ on sys.path): an installed package
# called `tests` can shadow this directory where the card is, and
# tests/test_torch_cuda.py imports this module's helpers there
from make_synthetic import make_genome, make_sample, write_fastq  # noqa: E402

CPU = torch.device("cpu")
PANELS = ["1x1", "4x1", "4x3", "13x2"]  # tests/test_device_build.py's (files, seqs)


def write_panel(tmp_path, rng, n_files, seqs_per_file=1, length=260, divergence=10):
    """tests/test_device_build.py's panel: n_files genomes of one base
    genome with `divergence` random substitutions, and more sequences a
    file, each 40 bp shorter than the last."""
    base = make_genome(rng, length)
    paths = []
    for g in range(n_files):
        p = tmp_path / f"g{g:03d}.fasta"
        with open(p, "w") as fh:
            for s in range(seqs_per_file):
                gen = bytearray(base if s == 0 else make_genome(rng, length - 40 * s))
                for q in rng.integers(0, len(gen), divergence):
                    gen[q] = b"ACGT"[rng.integers(4)]
                fh.write(f">g{g}s{s}\n{bytes(gen).decode()}\n")
        paths.append(str(p))
    return paths


def panel_paths(tmp_path, case):
    n_files, seqs = map(int, case.split("x"))
    return write_panel(tmp_path, np.random.default_rng(100 + n_files * 10 + seqs),
                       n_files, seqs)


def assert_same_index(got, want):
    """Every tensor and field of two port DeviceIndexes equal, the genome
    ids of the postings and every genome's sub-index included."""
    for name in ("keys", "offsets", "hist", "hist_words", "postings_local32", "postings"):
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu()), name
    for name in ("k", "num_genomes", "total_len", "max_bucket", "g_total_len",
                 "fid_grouped"):
        assert getattr(got, name) == getattr(want, name), name
    for name in ("genome_lens", "file_bases"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    assert got.seq_slices == want.seq_slices
    if want.offsets.numel() > 1:
        assert torch.equal(got.posting_fids().cpu(), want.posting_fids().cpu())
    for g in range(want.num_genomes):
        a, b = got.subindex(g), want.subindex(g)
        for name in ("keys_ordered", "offsets", "postings"):
            x, y = getattr(a, name), getattr(b, name)
            assert x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu()), (g, name)


def _short_and_n(tmp_path):
    """Sequences shorter than k are skipped; non-ACGT bytes index as 'A'."""
    rng = np.random.default_rng(7)
    p = tmp_path / "mix.fasta"
    with open(p, "w") as fh:
        fh.write(">tiny\nACGTACGT\n")
        fh.write(f">real\n{make_genome(rng, 200).decode()}\n")
        fh.write(f">withn\n{'ACGTN' * 50}\n")
    return [str(p)]


@pytest.mark.parametrize("case", [*PANELS, "short_and_n", "long_rows", "all_short"])
def test_device_build_equals_host_layout(tmp_path, case, monkeypatch):
    """The panels of tests/test_device_build.py ((1,1), (4,1), (4,3) and
    (13,2): single-word int32 and int64 histograms, the multi-word one),
    short and N sequences, sequences cut into several rows, and a panel
    with no window at all."""
    if case == "short_and_n":
        paths = _short_and_n(tmp_path)
    elif case == "all_short":
        paths = [str(tmp_path / "short.fasta")]
        with open(paths[0], "w") as fh:
            fh.write(">a\nACGTACGT\n>b\nACG\n")
    elif case == "long_rows":  # rows of 64 codes: a 260 bp sequence is 6 rows
        import bronko_tpu_torch.index.device_build as db
        monkeypatch.setattr(db, "ROW_CODES", 64)
        paths = panel_paths(tmp_path, "3x2")
    else:
        paths = panel_paths(tmp_path, case)
    host = build_device_index(build_index(21, paths), CPU)
    index, dev = build_device_index_on_device(21, paths, CPU)
    assert_same_index(dev, host)
    assert [f.name for f in index.files] == [f.name for f in build_index(21, paths).files]
    if case == "13x2":
        assert dev.hist_words is not None and dev.hist_words.shape[1] == 2


def test_device_build_from_loaded_bkdb_and_ungated_panels(tmp_path, monkeypatch):
    """A loaded .bkdb is device-built from its embedded sequences; and with
    a histogram refused (a bucket over 255 postings: poly-A) or int64
    global postings forced, the flat-tally and sub-index sources hold."""
    import bronko_tpu_torch.index.device_build as db
    import bronko_tpu_torch.index.layout as layout

    rng = np.random.default_rng(9)
    paths = write_panel(tmp_path, rng, 3)
    save_index(str(tmp_path / "x.bkdb"), build_index(21, paths))
    loaded = load_index(str(tmp_path / "x.bkdb"), expect_k=21)
    assert_same_index(device_build(loaded, CPU), build_device_index(loaded, CPU))

    polya = str(tmp_path / "polya.fasta")
    with open(polya, "w") as fh:
        fh.write(f">pa\n{make_genome(rng, 200).decode()}{'A' * 300}\n")
    monkeypatch.setattr(layout, "LOCAL32_LIMIT", 100)
    monkeypatch.setattr(db, "LOCAL32_LIMIT", 100)
    host = build_device_index(build_index(21, [*paths, polya]), CPU)
    assert host.hist is None and host.postings is not None
    _, dev = build_device_index_on_device(21, [*paths, polya], CPU)
    assert_same_index(dev, host)


@pytest.mark.parametrize("source", ["genomes", "db"])
def test_cli_device_build_on_matches_jax(tmp_path, monkeypatch, source):
    """`call ... --device-build on` writes bronko_tpu's files byte for
    byte, from -g and from -d."""
    import bronko_tpu.cli as jax_cli

    monkeypatch.setenv("BRONKO_PLATFORM", "cpu")
    rng = np.random.default_rng(12)
    paths = write_panel(tmp_path, rng, 4, length=1200, divergence=30)
    truth = open(paths[2]).read().split("\n", 1)[1].replace("\n", "").encode()
    reads, _ = make_sample(truth, rng, read_len=80, depth=120,
                           major_positions={400: 0.9}, minor_positions={})
    fq = str(tmp_path / "r.fastq.gz")
    write_fastq(fq, reads)
    ref = ["-g", *paths]
    if source == "db":
        assert cli.main(["build", "-g", *paths, "-o", str(tmp_path / "db")]) == 0
        ref = ["-d", str(tmp_path / "db.bkdb")]
    args = ["call", *ref, "-r", fq, "--pileup", "--device-build", "on",
            "--batch-size", "2048", "--chunk-reads", "4096", "-o"]
    assert cli.main([*args, str(tmp_path / "torch")]) == 0
    assert jax_cli.main([*args, str(tmp_path / "jax")]) == 0
    outs = {}
    for name in ("torch", "jax"):
        out = tmp_path / name
        outs[name] = {f: open(out / f, "rb").read() for f in sorted(os.listdir(out))}
    assert "r.vcf" in outs["jax"] and outs["torch"] == outs["jax"]
