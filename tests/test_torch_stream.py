"""The port's streamed single-sample path on the CPU against bronko_tpu's:
native_count_fastq_stream partition by partition, run_call's files
(streamed, against JAX's streamed run and the port's classic run), the
resolved genome, tallies and pileup, the probe cap, and a failing file as
the streamed sample. Every comparison is exact (tolerance 0)."""

import logging
import os
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import bronko_tpu.call.engine as je  # noqa: E402
import bronko_tpu.config as jc  # noqa: E402
import bronko_tpu.index.build as jb  # noqa: E402
import bronko_tpu.index.layout as jl  # noqa: E402
import bronko_tpu.io.native as jn  # noqa: E402
import bronko_tpu_torch.call.engine as te  # noqa: E402
from bronko_tpu_torch.config import CallConfig  # noqa: E402
from bronko_tpu_torch.consts import KMER_COUNT_CAP  # noqa: E402
from bronko_tpu_torch.index.layout import build_device_index  # noqa: E402
from bronko_tpu_torch.index.model import from_jax_index  # noqa: E402
from bronko_tpu_torch.io import native  # noqa: E402
from tests.make_synthetic import make_genome, make_sample, write_fasta, write_fastq  # noqa: E402

CPU = torch.device("cpu")
STREAM_ENV = ("BRONKO_STREAM", "BRONKO_NO_STREAM", "BRONKO_STREAM_FIRST")
DEFAULTS = CallConfig()
MIN_KMERS = DEFAULTS.min_kmers


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A 5 kb genome with a single-end sample and a pair of mates (several
    batches a partition at batch_size 1024), and
    a 10-strain panel of a 1.5 kb genome (G > 8: the multi-word histogram)
    with a sample of strain 4; each index in both packages."""
    tmp = tmp_path_factory.mktemp("torch_stream")
    rng = np.random.default_rng(29)
    genome = make_genome(rng, 5000)
    ref = str(tmp / "ref.fasta")
    write_fasta(ref, "sref", genome)
    reads, _ = make_sample(genome, rng, read_len=100, depth=60,
                           major_positions={1200: 0.9, 3100: 0.92},
                           minor_positions={2200: 0.2}, error_rate=0.003)
    fq = str(tmp / "samp.fastq.gz")
    write_fastq(fq, reads)
    mates, _ = make_sample(genome, rng, read_len=100, depth=60,
                           major_positions={1700: 0.9}, error_rate=0.003)
    r1, r2 = str(tmp / "pair_1.fastq.gz"), str(tmp / "pair_2.fastq.gz")
    write_fastq(r1, mates[::2])
    write_fastq(r2, mates[1::2])

    base = make_genome(rng, 1500)
    strains = []
    for i in range(10):
        g = bytearray(base)
        for p in rng.integers(50, 1450, 8):
            g[p] = b"ACGT"[(b"ACGT".index(g[p]) + 1 + i % 3) % 4]
        strains.append(str(tmp / f"strain{i}.fasta"))
        write_fasta(strains[-1], f"strain{i}", bytes(g))
    truth = open(strains[4]).read().split("\n", 1)[1].replace("\n", "").encode()
    preads, _ = make_sample(truth, rng, read_len=90, depth=150,
                            major_positions={400: 0.9, 1000: 0.95}, error_rate=0.003)
    pfq = str(tmp / "panel_samp.fastq.gz")
    write_fastq(pfq, preads)
    jref = jb.build_index(21, [ref])
    jpanel = jb.build_index(21, strains)
    return SimpleNamespace(tmp=tmp, ref=ref, fq=fq, r1=r1, r2=r2, strains=strains, pfq=pfq,
                           jref=jref, jpanel=jpanel)


@pytest.fixture(autouse=True)
def gate(tmp_path, monkeypatch):
    """No calibration file and a fixed round trip in either package; no
    stream variable set."""
    for mod in (te, je):
        monkeypatch.setattr(mod, "_STREAM_CALIB_PATH", str(tmp_path / f"{mod.__name__}.json"))
    monkeypatch.setattr(te, "_DISPATCH_LAT", {"cpu": 0.001})
    monkeypatch.setattr(je, "_DISPATCH_LAT", [0.001])
    for var in STREAM_ENV:
        monkeypatch.delenv(var, raising=False)


CASES = {  # name: (index, run_call keywords)
    "single": ("jref", lambda d: dict(genomes=[d.ref], reads=[d.fq])),
    "paired": ("jref", lambda d: dict(genomes=[d.ref], first_pairs=[d.r1], second_pairs=[d.r2])),
    "multibatch": ("jref", lambda d: dict(genomes=[d.ref], reads=[d.fq], batch_size=1024)),
    "words": ("jpanel", lambda d: dict(genomes=d.strains, reads=[d.pfq])),
}


def _outputs(out):
    return {f: open(os.path.join(out, f), "rb").read() for f in sorted(os.listdir(out))}


def _set_env(monkeypatch, env):
    for var in STREAM_ENV:
        monkeypatch.delenv(var, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)


def _port_run(d, name, out, monkeypatch, env, **extra):
    jindex, kw = CASES[name]
    _set_env(monkeypatch, env)
    index = from_jax_index(getattr(d, jindex))
    cfg = CallConfig(output=str(out), output_pileup=True, **{**kw(d), **extra})
    try:
        res = te.run_call(cfg, index, build_device_index(index, CPU))
    except SystemExit as e:
        res = e.code
    return res, _outputs(out) if os.path.isdir(out) else {}


def _jax_run(d, name, out, monkeypatch, env, **extra):
    jindex, kw = CASES[name]
    _set_env(monkeypatch, env)
    index = getattr(d, jindex)
    cfg = jc.CallConfig(output=str(out), output_pileup=True, **{**kw(d), **extra})
    try:
        res = je.run_call(cfg, index, jl.build_device_index(index))
    except SystemExit as e:
        res = e.code
    return res, _outputs(out) if os.path.isdir(out) else {}


def _streamed(caplog) -> int:
    return sum(r.getMessage().endswith("(streamed)") and r.getMessage().startswith("Processing")
               for r in caplog.records)


# --- the partitioned counter ---------------------------------------------------

@pytest.mark.parametrize("mates", [1, 2], ids=["single", "pair"])
def test_native_count_fastq_stream_matches_jax(data, mates):
    """Each partition's k-mers, counts and stats equal bronko_tpu's; a
    path's partitions in order are its whole count."""
    paths = [data.fq] if mates == 1 else [data.r1, data.r2]
    got = list(native.native_count_fastq_stream(paths, 21, MIN_KMERS, KMER_COUNT_CAP, threads=2))
    want = list(jn.native_count_fastq_stream(paths, 21, MIN_KMERS, KMER_COUNT_CAP, threads=2))
    P = native.NATIVE_COUNT_PARTS
    assert P == jn.NATIVE_COUNT_PARTS and len(got) == len(want) == P * mates
    for (gk, gc, gs), (wk, wc, ws) in zip(got, want, strict=True):
        assert gk.dtype == np.uint64 and gc.dtype == np.int64
        np.testing.assert_array_equal(gk, wk)
        np.testing.assert_array_equal(gc, wc)
        assert gs == ws
    assert sum(k.shape[0] > 0 for k, _, _ in got) >= 2 * mates
    for m, path in enumerate(paths):
        kmers, counts, stats = native.native_count_fastq(path, 21, MIN_KMERS, KMER_COUNT_CAP,
                                                         threads=2)
        mine = got[m * P:(m + 1) * P]
        np.testing.assert_array_equal(np.concatenate([k for k, _, _ in mine]), kmers)
        np.testing.assert_array_equal(np.concatenate([c for _, c, _ in mine]), counts)
        assert [s is None for *_, s in mine] == [True] * (P - 1) + [False]
        assert mine[-1][2] == stats


@pytest.mark.parametrize("parts,threads,floor", [
    *((p, t, "default") for p in (1, 2, 4, 8) for t in (1, 3, 4)),
    (4, 4, "every_kmer_capped"),
], ids=str)
def test_streamed_partitions_are_key_ranges_of_the_classic_count(data, monkeypatch, parts,
                                                                 threads, floor):
    """At any power-of-two partition count and thread count, a path's
    streamed partitions are strictly increasing, each within its own range
    of the top log2(parts) bits of the 2k-bit key, and concatenate to
    native_count_fastq's k-mers and counts; the last carries its stats.
    'every_kmer_capped' (ci 1, cs 1) keeps every k-mer, each at count 1."""
    k = 21
    ci, cs = (MIN_KMERS, KMER_COUNT_CAP) if floor == "default" else (1, 1)
    monkeypatch.setattr(native, "NATIVE_COUNT_PARTS", parts)
    paths = [data.r1, data.r2]
    got = list(native.native_count_fastq_stream(paths, k, ci, cs, threads=threads))
    assert len(got) == parts * len(paths)
    shift = np.uint64(2 * k - (parts.bit_length() - 1))
    for m, path in enumerate(paths):
        mine = got[m * parts:(m + 1) * parts]
        for p, (kmers, counts, _) in enumerate(mine):
            assert np.all(kmers[1:] > kmers[:-1])
            assert np.all(kmers >> shift == p)
            assert counts.shape == kmers.shape
        kmers, counts, stats = native.native_count_fastq(path, k, ci, cs, threads=threads)
        assert kmers.shape[0] > 0
        np.testing.assert_array_equal(np.concatenate([km for km, _, _ in mine]), kmers)
        np.testing.assert_array_equal(np.concatenate([c for _, c, _ in mine]), counts)
        assert [s is None for *_, s in mine] == [True] * (parts - 1) + [False]
        assert mine[-1][2] == stats
        if floor != "default":
            assert np.all(counts == 1) and stats["unique_kmers"] == kmers.shape[0]


def test_finalize_part_refuses_a_partition_outside_its_count(data):
    """finalize_part takes n_parts a power of two in [1, 8] and part in
    [0, n_parts); anything else returns -1 and takes nothing out."""
    lib = native.get_lib()
    h = lib.bronko_counter_create(21, 2)
    try:
        assert lib.bronko_counter_count_fastq(h, data.fq.encode()) == 0
        for part, n_parts in ((0, 0), (0, 3), (0, 16), (-1, 4), (4, 4)):
            assert lib.bronko_counter_finalize_part(h, part, n_parts, MIN_KMERS,
                                                    KMER_COUNT_CAP) == -1
        kmers, _, _ = native.native_count_fastq(data.fq, 21, MIN_KMERS, KMER_COUNT_CAP,
                                                threads=2)
        assert lib.bronko_counter_finalize_part(h, 0, 1, MIN_KMERS,
                                                KMER_COUNT_CAP) == kmers.shape[0]
    finally:
        lib.bronko_counter_destroy(h)


def test_abandoned_stream_closes_its_prefetch(data, tmp_path, monkeypatch):
    """A consumer that stops after the first partition of a pair closes
    the second mate's inflate-ahead buffer. The first mate, gzip counted
    while it inflates, has no buffer; where the counter would not pipe it
    (uncompressed mates), its own buffer, read before its count, is
    closed once it is counted."""
    import gzip
    import shutil

    plain = []
    for p in (data.r1, data.r2):
        plain.append(str(tmp_path / os.path.basename(p)[:-3]))
        with gzip.open(p, "rb") as src, open(plain[-1], "wb") as dst:
            shutil.copyfileobj(src, dst)
    inflate = native.native_read_inflate
    monkeypatch.delenv("BRONKO_WHOLEBUF_MAX", raising=False)
    for r1, r2, first in ((data.r1, data.r2, []), (*plain, [plain[0]])):
        assert native.pipes(r1) == (not first)
        closed = []
        monkeypatch.setattr(native, "native_read_inflate",
                            lambda p, on_close=None: inflate(p, on_close=lambda: closed.append(p)))
        gen = native.native_count_fastq_stream([r1, r2], 21, MIN_KMERS, KMER_COUNT_CAP,
                                               threads=2)
        next(gen)
        assert closed == first
        gen.close()
        assert closed == first + [r2]


# --- run_call ----------------------------------------------------------------------

@pytest.mark.parametrize("name", list(CASES))
def test_streamed_run_call_matches_jax_and_classic(data, tmp_path, monkeypatch, caplog, name):
    """BRONKO_STREAM=1 streams the lone sample in both packages; the port's
    VCF, pileup TSV and overview equal JAX's streamed run and the port's
    classic run (BRONKO_NO_STREAM=1), and so do its tallies, genome and
    pileup. The streamed stages add up: h2d is 0."""
    caplog.set_level(logging.INFO, logger="bronko")
    (res,), got = _port_run(data, name, tmp_path / "torch", monkeypatch, {"BRONKO_STREAM": "1"})
    assert _streamed(caplog) == 1
    caplog.clear()
    (cls,), classic = _port_run(data, name, tmp_path / "classic", monkeypatch,
                                {"BRONKO_NO_STREAM": "1"})
    assert _streamed(caplog) == 0
    caplog.clear()
    _, want = _jax_run(data, name, tmp_path / "jax", monkeypatch, {"BRONKO_STREAM": "1"})
    assert _streamed(caplog) == 1
    mode = "words" if name == "words" else "hist"
    # the classic path: fused on the single histogram word, pass 1 then
    # pass 2 from the saved probe on the multi-word one
    classic_path = (mode, "fused" if mode == "hist" else "saved")
    assert (res.path, cls.path) == ((mode, "streamed"), classic_path)
    assert len(got) == 3 and got == classic == want
    assert res.best == cls.best == (4 if name == "words" else 0)
    np.testing.assert_array_equal(res.tallies, cls.tallies)
    np.testing.assert_array_equal(res.pileup, cls.pileup)
    assert tuple(res.seconds) == te.STAGES + te.SPAN_KEYS and res.seconds["h2d"] == 0.0
    assert all(v >= 0 for v in res.seconds.values()) and res.seconds["count"] > 0


def _jax_resolve(d, name, cfg_kw):
    jindex, kw = CASES[name]
    index = getattr(d, jindex)
    jdev = jl.build_device_index(index)
    cfg = jc.CallConfig(output=str(d.tmp / "unused"), **{**kw(d), **cfg_kw})
    paths = cfg.reads or [cfg.first_pairs[0], cfg.second_pairs[0]]
    pending = je._stream_pass1(paths, index, jdev, cfg)
    best, pileup, triple = pending.resolve(index, jdev, cfg)
    return best, tuple(int(x) for x in triple), np.asarray(pending.tj), np.asarray(pileup)


def _port_pending(d, name, cfg_kw):
    jindex, kw = CASES[name]
    index = from_jax_index(getattr(d, jindex))
    dev = build_device_index(index, CPU)
    cfg = CallConfig(output=str(d.tmp / "unused"), **{**kw(d), **cfg_kw})
    paths = cfg.reads or [cfg.first_pairs[0], cfg.second_pairs[0]]
    return te._stream_pass1(paths, index, dev, cfg, threads=2), index, dev


@pytest.mark.parametrize("name", ["multibatch", "words"])
def test_resolve_matches_jax(data, name):
    """_stream_pass1(...).resolve(...): the genome, the perfect / variant /
    unmapped triple, every genome's tallies and the int32 pileup equal
    bronko_tpu's."""
    pending, index, dev = _port_pending(data, name, {})
    assert all(saved is not None for *_, saved in pending.parts)
    assert (max(len(b) for b, _, _ in pending.parts) > 1) == (name == "multibatch")
    mapped = pending.resolve(index, dev)
    best, triple, tallies, pileup = _jax_resolve(data, name, {})
    assert (mapped.best, mapped.triple) == (best, triple)
    np.testing.assert_array_equal(mapped.tallies, tallies)
    np.testing.assert_array_equal(mapped.pileup, pileup)


def _first_partition_bytes(d, jax: bool, batch_size: int) -> int:
    """Probe bytes the first non-empty partition of d.fq counts against
    PROBE_BYTES_CAP: over the port's unpadded batches, or over JAX's
    padded ones, each as its package reckons them."""
    kmers, counts, _ = next(p for p in native.native_count_fastq_stream(
        [d.fq], 21, MIN_KMERS, KMER_COUNT_CAP, threads=2) if p[0].shape[0])
    if jax:
        jdev = jl.build_device_index(d.jref)
        J = len(jdev.map_config(DEFAULTS.n_fixed, DEFAULTS.use_full_kmer).positions)
        kb, _ = je._prepare_batches(kmers, counts, batch_size, upload=False)
        return kb.size * J * (4 + jdev.hist.dtype.itemsize)
    dev = build_device_index(from_jax_index(d.jref), CPU)
    J = len(dev.map_config(DEFAULTS.n_fixed, DEFAULTS.use_full_kmer).positions)
    return kmers.shape[0] * J * te.probe_bytes_per_query(dev)


@pytest.mark.parametrize("cap", ["1", "between"])
def test_probe_cap_matches_jax(data, tmp_path, monkeypatch, cap):
    """PROBE_BYTES_CAP forced to 1 byte (no partition saves its probe;
    pass 2 re-probes the sub-index for all) and to the first partition's
    bytes (it saves, the others re-probe) in both packages: the resolved
    sample equals JAX's, and run_call's files equal JAX's streamed run and
    the port's classic one."""
    if cap == "1":
        caps = (1, 1)
    else:
        caps = (_first_partition_bytes(data, False, 1 << 18),
                _first_partition_bytes(data, True, 1 << 18))
    monkeypatch.setattr(te, "PROBE_BYTES_CAP", caps[0])
    monkeypatch.setattr(je, "PROBE_BYTES_CAP", caps[1])
    pending, index, dev = _port_pending(data, "single", {})
    saved = [s is not None for *_, s in pending.parts]
    assert len(saved) >= 3 and saved == [cap != "1"] + [False] * (len(saved) - 1)
    mapped = pending.resolve(index, dev)
    best, triple, tallies, pileup = _jax_resolve(data, "single", {})
    assert (mapped.best, mapped.triple) == (best, triple)
    np.testing.assert_array_equal(mapped.tallies, tallies)
    np.testing.assert_array_equal(mapped.pileup, pileup)
    (res,), got = _port_run(data, "single", tmp_path / "torch", monkeypatch,
                            {"BRONKO_STREAM": "1"})
    _, classic = _port_run(data, "single", tmp_path / "classic", monkeypatch,
                           {"BRONKO_NO_STREAM": "1"})
    _, want = _jax_run(data, "single", tmp_path / "jax", monkeypatch, {"BRONKO_STREAM": "1"})
    assert res.path == ("hist", "streamed")
    assert len(got) == 3 and got == classic == want


@pytest.mark.parametrize("where", ["alone", "first_of_cohort"])
def test_failing_file_as_the_streamed_sample(data, tmp_path, monkeypatch, caplog, where):
    """A truncated gzip as the streamed sample: alone, the run fails (exit
    1) in both packages and writes no VCF; first of a cohort
    (BRONKO_STREAM_FIRST=1), it fails alone and the next sample's files
    equal bronko_tpu's."""
    caplog.set_level(logging.INFO, logger="bronko")
    bad = str(tmp_path / "cut.fastq.gz")
    with open(data.fq, "rb") as src, open(bad, "wb") as dst:
        dst.write(src.read()[:4000])
    reads = [bad] if where == "alone" else [bad, data.fq]
    env = {"BRONKO_STREAM": "1"} if where == "alone" else {"BRONKO_STREAM_FIRST": "1"}
    got = _port_run(data, "single", tmp_path / "torch", monkeypatch, env, reads=reads)
    assert _streamed(caplog) == 1
    assert "Sample " + bad + " failed" in caplog.text
    want = _jax_run(data, "single", tmp_path / "jax", monkeypatch, env, reads=reads)
    if where == "alone":
        assert got[0] == want[0] == 1
        assert not any(f.endswith(".vcf") for f in got[1])
    else:
        assert [r.summary.filename for r in got[0]] == [data.fq]
        assert len(want[0]) == 1 and got[1] == want[1] and "samp.vcf" in got[1]
        assert got[0][0].path == ("hist", "fused")
