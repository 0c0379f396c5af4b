"""The port's own host modules against the JAX package's, of which they are
copies: the index builder, the .bkdb stores, the carrying of an index
across (from_jax_index), the argument parser and config checks, the codec
helpers, the FASTA/FASTQ readers, the native library, the noise scan and
the variant caller — each equal on the same inputs."""

import contextlib
import dataclasses
import gzip
import io
import logging
import os
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import bronko_tpu.call.noise as jax_noise  # noqa: E402
import bronko_tpu.call.variants as jax_variants  # noqa: E402
import bronko_tpu.cli as jax_cli  # noqa: E402
import bronko_tpu.config as jax_config  # noqa: E402
import bronko_tpu.io.fasta as jax_fasta  # noqa: E402
import bronko_tpu.io.fastq as jax_fastq  # noqa: E402
import bronko_tpu.io.naming as jax_naming  # noqa: E402
import bronko_tpu.io.native as jax_native  # noqa: E402
from bronko_tpu.index import bincode_compat as jax_bincode  # noqa: E402
from bronko_tpu.index import build as jax_build  # noqa: E402
from bronko_tpu.index import store as jax_store  # noqa: E402
from bronko_tpu.ops import buckets as jb  # noqa: E402
from bronko_tpu.ops import codec as jc  # noqa: E402
from bronko_tpu_torch import cli  # noqa: E402
from bronko_tpu_torch import config  # noqa: E402
from bronko_tpu_torch.call import engine, noise, variants  # noqa: E402
from bronko_tpu_torch.index import bincode_compat, build, store  # noqa: E402
from bronko_tpu_torch.index.layout import build_device_index  # noqa: E402
from bronko_tpu_torch.index.model import BronkoIndex, from_jax_index  # noqa: E402
from bronko_tpu_torch.io import fasta, fastq, naming, native  # noqa: E402
from bronko_tpu_torch.ops import buckets as tb  # noqa: E402
from bronko_tpu_torch.ops import codec as tc  # noqa: E402
from tests.make_synthetic import make_genome, make_sample, write_fasta, write_fastq  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def panel(tmp_path_factory):
    """Three genome files: one plain, one of two contigs with lowercase and
    N bytes plus a contig shorter than any k, one gzipped; and a sample."""
    tmp = tmp_path_factory.mktemp("torch_host")
    rng = np.random.default_rng(77)
    genome = make_genome(rng, 1100)
    strain = bytearray(genome)
    for p in rng.integers(50, 1050, 10):
        strain[p] = b"ACGT"[(b"ACGT".index(strain[p]) + 1) % 4]
    strain[200:210] = b"acgtnNNacg"
    paths = [str(tmp / "ref.fasta"), str(tmp / "strain.fa"), str(tmp / "third.fasta.gz")]
    write_fasta(paths[0], "ref one", genome)
    with open(paths[1], "w") as fh:
        fh.write(f">c1 first\n{bytes(strain[:600]).decode()}\n>tiny\nACGT\n"
                 f">c2\n{bytes(strain[600:]).decode()}\n")
    with gzip.open(paths[2], "wt") as fh:
        fh.write(f">third\n{make_genome(rng, 700).decode()}\n")
    reads, _ = make_sample(genome, rng, read_len=80, depth=200,
                           major_positions={500: 0.95}, error_rate=0.003)
    fq = str(tmp / "sample.fastq.gz")
    write_fastq(fq, reads)
    return tmp, paths, fq


def assert_index_equal(got, want):
    assert got.k == want.k
    for name in ("keys", "offsets", "post_loc", "post_meta"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert [(f.name, [(s.name, s.length, bytes(s.seq)) for s in f.sequences])
            for f in got.files] == \
           [(f.name, [(s.name, s.length, bytes(s.seq)) for s in f.sequences])
            for f in want.files]


# --- index builder, stores, carrying an index across ---------------------------

@pytest.mark.parametrize("k", [15, 21, 31])
def test_build_index_equals_jax(panel, k):
    _, paths, _ = panel
    got = build.build_index(k, paths)
    assert isinstance(got, BronkoIndex)
    assert_index_equal(got, jax_build.build_index(k, paths))


def _zip_members(path):
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in z.namelist()}


def test_npz_store_equals_jax(panel):
    """The port's .bkdb holds the JAX package's arrays and metadata byte for
    byte (the zip's timestamps aside); each package loads the other's."""
    tmp, paths, _ = panel
    index = build.build_index(21, paths)
    store.save_index(str(tmp / "port"), index)
    jax_store.save_index(str(tmp / "jax"), jax_build.build_index(21, paths))
    port_db, jax_db = str(tmp / "port.bkdb"), str(tmp / "jax.bkdb")
    assert _zip_members(port_db) == _zip_members(jax_db)
    assert_index_equal(store.load_index(jax_db, expect_k=21), index)
    assert_index_equal(jax_store.load_index(port_db), index)
    with pytest.raises(ValueError, match="set -k to 21"):
        store.load_index(port_db, expect_k=15)


def test_bincode_store_equals_jax(panel):
    """The reference-format (bincode) .bkdb: the same bytes, and the same
    index back through either loader (the port's store sniffs it)."""
    tmp, paths, _ = panel
    index = build.build_index(21, paths)
    bincode_compat.save_reference_bkdb(index, str(tmp / "port_ref.bkdb"))
    jax_bincode.save_reference_bkdb(jax_build.build_index(21, paths), str(tmp / "jax_ref"))
    got = open(tmp / "port_ref.bkdb", "rb").read()
    assert got == open(tmp / "jax_ref.bkdb", "rb").read()
    assert bincode_compat.sniff_format(str(tmp / "port_ref.bkdb")) == "bincode"
    back = store.load_index(str(tmp / "port_ref.bkdb"), expect_k=21)
    assert_index_equal(back, jax_bincode.load_reference_bkdb(str(tmp / "port_ref.bkdb")))
    assert_index_equal(back, index)


def test_from_jax_index_maps_identically(panel, tmp_path):
    """A JAX-built index carried across maps and calls as the port's own
    build of the same genomes; the copy shares no array with it."""
    _, paths, fq = panel
    jindex = jax_build.build_index(21, paths)
    carried = from_jax_index(jindex)
    assert isinstance(carried, BronkoIndex)
    assert_index_equal(carried, jindex)
    assert not np.shares_memory(carried.keys, jindex.keys)
    results = {}
    for name, index in (("carried", carried), ("own", build.build_index(21, paths))):
        cfg = config.CallConfig(genomes=paths, reads=[fq], output=str(tmp_path / name),
                                output_pileup=True, batch_size=2048)
        (results[name],) = engine.run_call(cfg, index, build_device_index(index, CPU))
    assert results["carried"].best == results["own"].best
    np.testing.assert_array_equal(results["carried"].tallies, results["own"].tallies)
    np.testing.assert_array_equal(results["carried"].pileup, results["own"].pileup)
    for f in ("sample.vcf", "sample.tsv", "bronko_overview.tsv"):
        assert open(tmp_path / "carried" / f).read() == open(tmp_path / "own" / f).read()


# --- the parser and the config checks -------------------------------------------

ARGV = [
    ["build", "-g", "a.fasta", "-o", "x"],
    ["build", "-g", "a.fasta", "b.fa", "-g", "c.fna", "-k", "31", "--format", "bincode",
     "-t", "2"],
    ["call", "-d", "db.bkdb", "-r", "s.fastq.gz"],
    ["call", "-g", "a.fa", "-1", "r1.fq", "-2", "r2.fq", "--pileup", "--alignment",
     "--min-af", "0.05", "--counter", "device", "--batch-size", "4096"],
    ["call", "-d", "x", "-r", "a.fq", "-r", "b.fq", "--use-full-kmer", "--n-fixed", "3",
     "--strand_odds", "4.5", "--noise-multiplier", "1.7", "--balance-ratio", "0.2",
     "--mesh", "2x1", "--device-build", "off", "--keep-kmer-info", "--no-end-filter",
     "--no-strand-filter", "--no-strand-balance-filter", "--n-per-strand", "3",
     "--min-depth", "10", "--min-variant-depth", "4", "--chunk-reads", "100",
     "--shard-samples", "--profile-dir", "p", "--coordinator", "h:1",
     "--num-processes", "2", "--process-id", "1", "--debug", "--verbose"],
    [],                                         # the sub-command is required
    ["frobnicate"],
    ["call", "--counter", "gpu"],
    ["build", "-k", "abc"],
    ["build", "--format", "xml"],
    ["call", "--device-build", "maybe"],
    ["call", "-r"],
    ["--version"],
    ["call", "--version"],
    ["build", "--help"],
]


def _parse(parser, argv, capsys):
    try:
        out = ("ok", vars(parser.parse_args(argv)))
    except SystemExit as e:
        out = ("exit", e.code)
    return out, capsys.readouterr()


@pytest.mark.parametrize("argv", ARGV, ids=[" ".join(a) or "empty" for a in ARGV])
def test_parser_equals_jax(argv, capsys):
    got = _parse(cli.build_parser(), argv, capsys)
    want = _parse(jax_cli.build_parser(), argv, capsys)
    assert got == want


CONFIGS = [
    dict(kmer=20),
    dict(kmer=33),
    dict(genomes=["a.fasta"], db="x.bkdb"),
    dict(),
    dict(db="x.bkdb", reads=["r.txt"]),
    dict(genomes=["a.txt"]),
    dict(db="x.bkdb", threads=0),
    dict(db="x.bkdb", min_af=1.5),
    dict(db="x.bkdb", min_af=0.005),
    dict(db="x.bkdb", min_af=0.6),
    dict(db="x.bkdb", n_per_strand=21),
    dict(db="x.bkdb", n_per_strand=0),
    dict(db="x.bkdb", strand_balance_ratio=1.5),
    dict(db="x.bkdb", variant_multiplier=0.5),
    dict(db="x.bkdb", variant_multiplier=2.5),
    dict(db="x.bkdb", first_pairs=["a.fq"]),
    dict(db="x.bkdb", counter="gpu"),
    dict(db="x.bkdb", mesh="4"),
    dict(db="x.bkdb", mesh="2x1", shard_samples=True),
    dict(db="x.bkdb", reads=["s.fastq.gz"], min_depth=-1, min_variant_depth=-1),
]


def _validate(cls, kw, caplog):
    caplog.clear()
    try:
        cls(**kw).validate()
        code = None
    except SystemExit as e:
        code = e.code
    return code, [r.getMessage() for r in caplog.records]


@pytest.mark.parametrize("kw", CONFIGS, ids=[repr(c) for c in CONFIGS])
def test_call_config_checks_equal_jax(kw, caplog):
    caplog.set_level(logging.INFO, logger="bronko")
    assert _validate(config.CallConfig, kw, caplog) == _validate(jax_config.CallConfig, kw,
                                                                 caplog)
    assert [f.name for f in dataclasses.fields(config.CallConfig)] == \
           [f.name for f in dataclasses.fields(jax_config.CallConfig)]


@pytest.mark.parametrize("kw", [dict(genomes=[]), dict(genomes=["a.fasta"], kmer=14),
                                dict(genomes=["a.gff"])])
def test_build_config_checks_equal_jax(kw, caplog):
    assert _validate(config.BuildConfig, kw, caplog) == _validate(jax_config.BuildConfig, kw,
                                                                  caplog)


# --- codec helpers, readers, native library, noise, caller ----------------------

def test_codec_tables_equal_jax():
    np.testing.assert_array_equal(tc.NT_TO_BITS, jc.NT_TO_BITS)
    np.testing.assert_array_equal(tc.NT_IS_VALID, jc.NT_IS_VALID)
    np.testing.assert_array_equal(fastq.CODES, jax_fastq.CODES)
    seq = bytes(range(256))
    np.testing.assert_array_equal(tc.seq_bytes_to_bits(seq), jc.seq_bytes_to_bits(seq))


@pytest.mark.parametrize("k", [1, 2, 15, 21, 31])
def test_numpy_codec_and_buckets_equal_jax(k):
    rng = np.random.default_rng(k)
    bits = rng.integers(0, 4, size=(300, k), dtype=np.uint8)
    packed = tc.pack_kmer(bits, k)
    np.testing.assert_array_equal(packed, jc.pack_kmer(bits, k))
    if k == 31:  # near-all-T k-mers: the hash wraps past 2^64
        top = (np.uint64(1) << np.uint64(62)) - np.uint64(1)
        packed = np.concatenate([packed, top - rng.integers(0, 1 << 20, 64, dtype=np.uint64)])
    canon, is_rc = tc.canonical_np(packed, k)
    want_c, want_rc = jc.canonical(packed, k)
    np.testing.assert_array_equal(canon, want_c)
    np.testing.assert_array_equal(is_rc, want_rc)
    with np.errstate(over="ignore"):
        np.testing.assert_array_equal(tb.assign_buckets_np(canon, k),
                                      jb.assign_buckets(canon, k))
    assert [tc.kmer_to_string(x, k) for x in packed[:20]] == \
           [jc.kmer_to_string(x, k) for x in packed[:20]]


def test_filtered_bucket_positions_equal_jax():
    for k in range(1, 32):
        for n_fixed in range(0, 6):
            for full in (False, True):
                assert tb.filtered_bucket_positions(k, n_fixed, full) == \
                       jb.filtered_bucket_positions(k, n_fixed, full)


def test_readers_and_naming_equal_jax(panel):
    _, paths, fq = panel
    for p in paths:
        assert fasta.read_fasta(p) == [fasta.FastaRecord(r.name, r.seq)
                                       for r in jax_fasta.read_fasta(p)]
        assert naming.file_stem(p) == jax_naming.file_stem(p)
    for name in (fq, "x.fq", "a/b.fastq.gz.fastq.gz", "s.fnq", "plain", ".hidden"):
        assert naming.clean_sample_id(name) == jax_naming.clean_sample_id(name)
        assert naming.check_fastq(name) == jax_naming.check_fastq(name)
        assert naming.check_fasta(name) == jax_naming.check_fasta(name)
    for got, want in zip(fastq.read_fastq_chunks(fq, 1000), jax_fastq.read_fastq_chunks(fq, 1000),
                         strict=True):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2]


def test_native_library_equals_jax(panel):
    """The port builds its own copy of the native sources, into its own
    directory, and its reader and counter give the JAX package's results."""
    _, _, fq = panel
    assert native.get_lib() is not None and jax_native.get_lib() is not None
    assert native._SO_PATH.startswith(os.path.dirname(os.path.dirname(native.__file__)))
    assert os.path.exists(native._SO_PATH)
    got = native.native_count_fastq(fq, 21, 3, 1_000_000, threads=2)
    want = jax_native.native_count_fastq(fq, 21, 3, 1_000_000, threads=2)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]
    for g, w in zip(native.native_read_fastq_chunks(fq, 500),
                    jax_native.native_read_fastq_chunks(fq, 500), strict=True):
        np.testing.assert_array_equal(g[0][:g[2]], w[0][:w[2]])
        np.testing.assert_array_equal(g[1], w[1])


@pytest.mark.parametrize("source", ["gzip", "plain", "missing"])
def test_inflated_text_counts_equal_the_path(panel, tmp_path, source):
    """native_read_inflate + native_count_fastq(text=) give the k-mers,
    counts and stats of counting the path, in both packages alike; the
    buffer is closed by the count, on_close fires once however often
    close() is called. A missing file gives no buffer, and the count of
    its path raises OSError in both."""
    _, _, fq = panel
    path = {"gzip": fq, "plain": str(tmp_path / "s.fastq"),
            "missing": str(tmp_path / "none.fastq.gz")}[source]
    if source == "plain":
        with gzip.open(fq, "rb") as src, open(path, "wb") as dst:
            dst.write(src.read())
    got = {}
    for name, mod in (("torch", native), ("jax", jax_native)):
        fired = []
        text = mod.native_read_inflate(path, on_close=lambda: fired.append(1))
        assert (text.handle is None) == (source == "missing")
        if source == "missing":
            with pytest.raises(OSError):
                mod.native_count_fastq(path, 21, 3, 1_000_000, threads=2, text=text)
            text.close()
            got[name] = text.size
            continue
        from_text = mod.native_count_fastq(path, 21, 3, 1_000_000, threads=2, text=text)
        assert text.handle is None and fired == [1]
        text.close()
        assert fired == [1]
        from_path = mod.native_count_fastq(path, 21, 3, 1_000_000, threads=2)
        for a, b in zip(from_text[:2], from_path[:2]):
            np.testing.assert_array_equal(a, b)
        assert from_text[2] == from_path[2]
        got[name] = (text.size, from_text)
    if source == "missing":
        assert got["torch"] == got["jax"]
        return
    assert got["torch"][0] == got["jax"][0] > 0
    for a, b in zip(got["torch"][1][:2], got["jax"][1][:2]):
        np.testing.assert_array_equal(a, b)
    assert got["torch"][1][2] == got["jax"][1][2]


def test_a_failed_mate_releases_its_sibling(panel, tmp_path):
    """A paired sample whose first mate cannot be read: the count raises,
    and the second mate's inflated buffer is closed all the same (its
    on_close fires once), in both packages' _count_job."""
    from concurrent.futures import Future

    import bronko_tpu.call.engine as jax_engine

    _, _, fq = panel
    missing = str(tmp_path / "none.fastq.gz")
    for name, mod in (("torch", native), ("jax", jax_native)):
        fired = []
        texts = []
        for p in (missing, fq):
            f = Future()
            f.set_result(mod.native_read_inflate(p, on_close=lambda p=p: fired.append(p)))
            texts.append(f)
        cfg = (config.CallConfig if name == "torch" else jax_config.CallConfig)(
            genomes=["x.fasta"], counter="host")
        with pytest.raises(OSError):
            if name == "torch":
                engine._count_job([missing, fq], cfg, 21, CPU, threads=2, texts=texts)
            else:
                jax_engine._count_job([missing, fq], cfg, 21, threads=2, texts=texts)
        assert all(f.result().handle is None for f in texts), name
        assert sorted(fired) == sorted([missing, fq]), name


def _pileups(rng, L):
    fwd = rng.integers(0, 400, size=(L, 4)).astype(np.int32)
    rev = rng.integers(0, 400, size=(L, 4)).astype(np.int32)
    fwd[rng.random(L) < 0.1] = 0
    return fwd, rev


@pytest.mark.parametrize("native_scan", [True, False])
def test_noise_scan_equals_jax(native_scan, monkeypatch):
    rng = np.random.default_rng(8)
    fwd, rev = _pileups(rng, 900)
    if not native_scan:
        monkeypatch.setattr(native, "get_lib", lambda: None)
    got = noise.baseline_noise(fwd, rev)
    np.testing.assert_array_equal(got, jax_noise.baseline_noise(fwd, rev))
    np.testing.assert_array_equal(got, jax_noise._baseline_noise_py(jax_noise._minor_freqs(fwd,
                                                                                           rev)))


def test_call_variants_equal_jax():
    rng = np.random.default_rng(12)
    L = 700
    fwd, rev = _pileups(rng, L)
    fwd[:, 0] += 3000
    rev[:, 0] += 3000
    cnt_f = rng.integers(0, 6, size=(L, 4)).astype(np.int32)
    cnt_r = rng.integers(0, 6, size=(L, 4)).astype(np.int32)
    ref = bytes(rng.choice(np.frombuffer(b"ACGTN", np.uint8), L))
    noise_max = noise.baseline_noise(fwd, rev)[:, 0]
    kw = dict(k=21, min_af=0.03, filter_end_seq=True, strand_filter=True,
              no_strand_balance_filter=False, strand_balance_ratio=0.1, strand_odds_max=6.0,
              n_per_strand=2, min_depth=300, min_variant_depth=3, variant_multiplier=1.5)
    got_stats, want_stats = variants.CallStats(), jax_variants.CallStats()
    got = variants.call_variants_for_seq("s", ref, fwd, rev, cnt_f, cnt_r, noise_max,
                                         stats=got_stats, **kw)
    want = jax_variants.call_variants_for_seq("s", ref, fwd, rev, cnt_f, cnt_r, noise_max,
                                              stats=want_stats, **kw)
    assert got and [dataclasses.astuple(r) for r in got] == [dataclasses.astuple(r) for r in want]
    assert dataclasses.astuple(got_stats) == dataclasses.astuple(want_stats)


def test_version_is_the_jax_packages():
    import bronko_tpu
    import bronko_tpu_torch

    assert bronko_tpu_torch.__version__ == bronko_tpu.__version__
    buf = io.StringIO()
    with pytest.raises(SystemExit), contextlib.redirect_stdout(buf):
        cli.build_parser().parse_args(["--version"])
    assert buf.getvalue().strip() == f"bronko-tpu {bronko_tpu.__version__}"
