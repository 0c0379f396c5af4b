"""Native (C++) components vs their Python references."""

import gzip

import numpy as np
import pytest

from bronko_tpu.call.noise import _baseline_noise_py, _minor_freqs, _tau_table
from bronko_tpu.io.fastq import read_fastq_chunks
from bronko_tpu.io.native import (get_lib, native_count_fastq,
                                  native_noise_scan,
                                  native_read_fastq_chunks)

pytestmark = pytest.mark.skipif(get_lib() is None, reason="native lib unavailable")


def test_noise_scan_bitwise_equal():
    rng = np.random.default_rng(0)
    L = 2000
    fwd = rng.integers(0, 500, size=(L, 4)).astype(np.int64)
    rev = rng.integers(0, 500, size=(L, 4)).astype(np.int64)
    # sprinkle zero-depth positions and spikes
    fwd[::17] = 0
    rev[::17] = 0
    fwd[::31, 2] += 5000
    freqs3 = _minor_freqs(fwd, rev)
    py = _baseline_noise_py(freqs3)
    cc = native_noise_scan(freqs3, _tau_table(302))
    assert np.array_equal(py, cc, equal_nan=True)


@pytest.mark.parametrize("gz", [False, True])
def test_fastq_reader_matches_python(tmp_path, gz):
    rng = np.random.default_rng(1)
    reads = []
    for i in range(777):
        ln = int(rng.integers(20, 90))
        reads.append(bytes(rng.choice(np.frombuffer(b"ACGTNacgtn", np.uint8), size=ln)))
    path = str(tmp_path / ("r.fastq" + (".gz" if gz else "")))
    op = gzip.open if gz else open
    with op(path, "wt") as fh:
        for i, r in enumerate(reads):
            fh.write(f"@read{i} extra\n{r.decode()}\n+\n{'I' * len(r)}\n")

    py_chunks = list(read_fastq_chunks(path, chunk_reads=256))
    cc_chunks = list(native_read_fastq_chunks(path, chunk_reads=256, max_len=128))
    py_reads = sum(c[2] for c in py_chunks)
    cc_reads = sum(c[2] for c in cc_chunks)
    assert py_reads == cc_reads == len(reads)

    py_all = np.concatenate([c[0][: c[2], :96] for c in py_chunks])
    cc_all = np.concatenate([c[0][: c[2], :96] for c in cc_chunks])
    assert np.array_equal(py_all, cc_all)
    py_len = np.concatenate([c[1][: c[2]] for c in py_chunks])
    cc_len = np.concatenate([c[1][: c[2]] for c in cc_chunks])
    assert np.array_equal(py_len, cc_len)


def test_fastq_reader_no_trailing_newline(tmp_path):
    path = str(tmp_path / "r.fastq")
    with open(path, "w") as fh:
        fh.write("@a\nACGT\n+\nIIII\n@b\nTTGG\n+\nIIII")  # no final \n
    chunks = list(native_read_fastq_chunks(path, chunk_reads=16, max_len=32))
    total = sum(c[2] for c in chunks)
    assert total == 2
    codes = chunks[0][0]
    assert codes[1, :4].tolist() == [3, 3, 2, 2]


def test_host_counter_matches_oracle(tmp_path):
    import numpy as np

    from bronko_tpu.io.native import native_count_fastq
    from tests.test_count import oracle_count, random_reads

    rng = np.random.default_rng(5)
    reads = random_reads(rng, 400)
    path = str(tmp_path / "c.fastq")
    with open(path, "w") as fh:
        for i, r in enumerate(reads):
            fh.write(f"@r{i}\n{r.decode()}\n+\n{'I' * len(r)}\n")
    k = 21
    expected, total = oracle_count(reads, k)
    kmers, counts, st = native_count_fastq(path, k, 3, 1_000_000)
    assert st["total_reads"] == len(reads)
    assert st["total_kmers"] == total
    assert st["unique_kmers"] == len(expected)
    exp_kept = {km: c for km, c in expected.items() if c >= 3}
    assert st["unique_counted_kmers"] == len(exp_kept)
    assert dict(zip(kmers.tolist(), counts.tolist())) == exp_kept
    assert np.all(np.diff(kmers.astype(np.uint64)) > 0)  # sorted unique


def test_host_counter_cap(tmp_path):
    from bronko_tpu.io.native import native_count_fastq

    path = str(tmp_path / "cap.fastq")
    with open(path, "w") as fh:
        for i in range(5):
            fh.write(f"@r{i}\n{'A'*40}\n+\n{'I'*40}\n")
    kmers, counts, st = native_count_fastq(path, 15, 1, 10)
    assert kmers.tolist() == [0] and counts.tolist() == [10]


def test_host_counter_wholebuf_edge_cases(tmp_path):
    """The whole-buffer front end (libdeflate/zlib one-shot inflate +
    record-aligned slice parsing) must handle multi-member gzip, CRLF line
    endings, N bases, a missing final newline, and lowercase — and agree
    with the plain-file path byte-for-byte."""
    import gzip

    import numpy as np

    from bronko_tpu.io.native import native_count_fastq

    rng = np.random.default_rng(11)
    reads = []
    for i in range(300):
        r = "".join(rng.choice(list("ACGT"), size=60))
        if i % 7 == 0:
            r = r[:20] + "N" + r[21:]
        if i % 11 == 0:
            r = r.lower()
        reads.append(r)
    recs = [f"@r{i}\n{r}\n+\n{'I' * len(r)}\n" for i, r in enumerate(reads)]

    plain = str(tmp_path / "p.fastq")
    with open(plain, "w") as fh:
        fh.write("".join(recs))
    k_ref, c_ref, st_ref = native_count_fastq(plain, 21, 1, 1_000_000)
    assert st_ref["total_reads"] == 300

    # multi-member gzip (e.g. concatenated lane files)
    multi = str(tmp_path / "m.fastq.gz")
    with open(multi, "wb") as fh:
        fh.write(gzip.compress("".join(recs[:100]).encode()))
        fh.write(gzip.compress("".join(recs[100:]).encode()))
    k2, c2, st2 = native_count_fastq(multi, 21, 1, 1_000_000)
    assert st2 == st_ref
    assert np.array_equal(k2, k_ref) and np.array_equal(c2, c_ref)

    # CRLF line endings + no trailing newline on the final quality line
    crlf = str(tmp_path / "c.fastq.gz")
    body = "".join(recs).replace("\n", "\r\n")[:-2]  # strip final \r\n
    with gzip.open(crlf, "wb") as fh:
        fh.write(body.encode())
    k3, c3, st3 = native_count_fastq(crlf, 21, 1, 1_000_000)
    assert st3 == st_ref
    assert np.array_equal(k3, k_ref) and np.array_equal(c3, c_ref)

    # record truncated before its '+' line is dropped, like the streaming path
    trunc = str(tmp_path / "t.fastq")
    with open(trunc, "w") as fh:
        fh.write("".join(recs))
        fh.write("@late\nACGTACGTACGTACGTACGTACGTA")  # header+seq only
    k4, c4, st4 = native_count_fastq(trunc, 21, 1, 1_000_000)
    assert st4["total_reads"] == 300
    assert np.array_equal(k4, k_ref) and np.array_equal(c4, c_ref)

    # malformed: a record not starting with '@'
    bad = str(tmp_path / "bad.fastq")
    with open(bad, "w") as fh:
        fh.write("".join(recs[:10]) + "notaheader\nACGT\n+\nIIII\n")
    with pytest.raises(ValueError):
        native_count_fastq(bad, 21, 1, 1_000_000)


def test_inflate_ahead_matches_plain(tmp_path):
    """native_read_inflate + count_text (the engine's inflate-ahead path)
    must equal the one-call count_fastq path on gz and plain inputs, close
    its buffer, and fall back cleanly on open failure."""
    import gzip

    import numpy as np

    from bronko_tpu.io.native import native_count_fastq, native_read_inflate

    rng = np.random.default_rng(13)
    recs = []
    for i in range(250):
        r = "".join(rng.choice(list("ACGT"), size=70))
        recs.append(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")
    for suffix, op in (("fastq", open), ("fastq.gz", None)):
        path = str(tmp_path / ("x." + suffix))
        if op is None:
            with open(path, "wb") as fh:
                fh.write(gzip.compress("".join(recs).encode()))
        else:
            with op(path, "w") as fh:
                fh.write("".join(recs))
        k_ref, c_ref, st_ref = native_count_fastq(path, 21, 1, 1_000_000)
        text = native_read_inflate(path)
        assert text.handle is not None and text.size > 0
        k2, c2, st2 = native_count_fastq(path, 21, 1, 1_000_000, text=text)
        assert text.handle is None  # closed by the counter
        assert st2 == st_ref
        assert np.array_equal(k2, k_ref) and np.array_equal(c2, c_ref)

    missing = native_read_inflate(str(tmp_path / "nope.fastq.gz"))
    assert missing.handle is None  # caller falls back to the path-based count


def _bgzf_block(data: bytes) -> bytes:
    import struct
    import zlib

    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    cdata = co.compress(data) + co.flush()
    bsize = len(cdata) + 26
    hdr = struct.pack("<4BI2B", 0x1F, 0x8B, 8, 4, 0, 0, 0xFF)
    hdr += struct.pack("<H2B2H", 6, ord("B"), ord("C"), 2, bsize - 1)
    return (hdr + cdata
            + __import__("struct").pack("<II", zlib.crc32(data) & 0xFFFFFFFF,
                                        len(data) & 0xFFFFFFFF))


def test_bgzf_parallel_inflate_matches_plain(tmp_path):
    """BGZF (bgzip/htslib blocked gzip) inflates in parallel via the 'BC'
    block-size subfield scan; counts must equal the plain file's, and a
    corrupted block must be rejected, not silently dropped."""
    import numpy as np

    from bronko_tpu.io.native import native_count_fastq

    rng = np.random.default_rng(7)
    recs = []
    for i in range(4000):
        r = "".join(rng.choice(list("ACGT"), size=80))
        recs.append(f"@r{i}\n{r}\n+\n{'J' * 80}\n")
    text = "".join(recs).encode()

    plain = str(tmp_path / "p.fastq")
    with open(plain, "wb") as fh:
        fh.write(text)
    bg = b"".join(_bgzf_block(text[o:o + 60000])
                  for o in range(0, len(text), 60000)) + _bgzf_block(b"")
    bgzf = str(tmp_path / "b.fastq.gz")
    with open(bgzf, "wb") as fh:
        fh.write(bg)

    k1, c1, s1 = native_count_fastq(plain, 21, 1, 1_000_000)
    k2, c2, s2 = native_count_fastq(bgzf, 21, 1, 1_000_000)
    assert s2 == s1
    assert np.array_equal(k1, k2) and np.array_equal(c1, c2)

    bad = bytearray(bg)
    bad[40] ^= 0xFF  # corrupt the first block's deflate stream
    badp = str(tmp_path / "bad.fastq.gz")
    with open(badp, "wb") as fh:
        fh.write(bytes(bad))
    with pytest.raises(ValueError):
        native_count_fastq(badp, 21, 1, 1_000_000)


def test_streaming_fallback_matches_wholebuf(tmp_path, monkeypatch):
    """BRONKO_WHOLEBUF_MAX=0 forces the large-file streaming path (reader
    emits record-aligned raw blocks; workers parse_count them); results
    must equal the whole-buffer path on gz, CRLF, and truncated inputs,
    and malformed input must still be rejected."""
    import gzip

    import numpy as np

    from bronko_tpu.io.native import native_count_fastq

    rng = np.random.default_rng(17)
    recs = []
    for i in range(600):
        r = "".join(rng.choice(list("ACGTN"), size=int(rng.integers(30, 90)),
                               p=[0.24, 0.24, 0.24, 0.24, 0.04]))
        recs.append(f"@r{i} z\n{r}\n+\n{'I' * len(r)}\n")
    variants = {}
    plain = str(tmp_path / "p.fastq")
    with open(plain, "w") as fh:
        fh.write("".join(recs))
    variants["plain"] = plain
    gz = str(tmp_path / "g.fastq.gz")
    with open(gz, "wb") as fh:
        fh.write(gzip.compress("".join(recs).encode()))
    variants["gz"] = gz
    crlf = str(tmp_path / "c.fastq")
    with open(crlf, "w", newline="") as fh:
        fh.write("".join(recs).replace("\n", "\r\n")[:-2])
    variants["crlf"] = crlf
    trunc = str(tmp_path / "t.fastq")
    with open(trunc, "w") as fh:
        fh.write("".join(recs) + "@late\nACGTACGT")  # dropped partial record
    variants["trunc"] = trunc

    for name, path in variants.items():
        monkeypatch.delenv("BRONKO_WHOLEBUF_MAX", raising=False)
        k_ref, c_ref, s_ref = native_count_fastq(path, 21, 1, 1_000_000)
        monkeypatch.setenv("BRONKO_WHOLEBUF_MAX", "0")
        k2, c2, s2 = native_count_fastq(path, 21, 1, 1_000_000)
        assert s2 == s_ref, name
        assert np.array_equal(k2, k_ref) and np.array_equal(c2, c_ref), name

    bad = str(tmp_path / "bad.fastq")
    with open(bad, "w") as fh:
        fh.write("".join(recs[:5]) + "nothdr\nACGT\n+\nIIII\n" + "".join(recs[5:9]))
    monkeypatch.setenv("BRONKO_WHOLEBUF_MAX", "0")
    with pytest.raises(ValueError):
        native_count_fastq(bad, 21, 1, 1_000_000)
    monkeypatch.delenv("BRONKO_WHOLEBUF_MAX")


def test_corrupt_gzip_rejected_everywhere(tmp_path):
    """Corrupt/truncated gzip must raise on EVERY front end — whole-buffer,
    streaming, chunk reader — never silently count a prefix of the sample
    (the chunk reader used to map gzread errors to EOF)."""
    import gzip as _gzip

    recs = "".join(f"@r{i}\nACGTACGTACGTACGTACGTACGT\n+\n{'I' * 24}\n"
                   for i in range(2000))
    good = str(tmp_path / "good.fastq.gz")
    with open(good, "wb") as fh:
        fh.write(_gzip.compress(recs.encode(), 6))
    blob = open(good, "rb").read()
    trunc = str(tmp_path / "trunc.fastq.gz")
    with open(trunc, "wb") as fh:
        fh.write(blob[: len(blob) // 2])  # mid-stream cut

    # whole-buffer host counter
    with pytest.raises(ValueError):
        native_count_fastq(trunc, 21, 1, 1_000_000)
    # streaming host counter
    import os as _os

    _os.environ["BRONKO_WHOLEBUF_MAX"] = "0"
    try:
        with pytest.raises(ValueError):
            native_count_fastq(trunc, 21, 1, 1_000_000)
    finally:
        del _os.environ["BRONKO_WHOLEBUF_MAX"]
    # chunk reader (device-counter front end)
    from bronko_tpu.io.native import native_read_fastq_chunks

    with pytest.raises(ValueError):
        for _ in native_read_fastq_chunks(trunc, 512):
            pass


def test_truncated_multimember_rejected(tmp_path):
    """cat a.gz b.gz with b truncated: the whole-buffer inflate used to
    accept member a as the full file ('trailing garbage' tolerance too
    broad) — partial counts, wrong VCFs. A truncated REAL member must
    fail; genuine trailing garbage (no gzip magic) stays tolerated."""
    import gzip as _gzip

    recs_a = "".join(f"@a{i}\nACGTACGTACGTACGTACGTACGT\n+\n{'I' * 24}\n"
                     for i in range(1000))
    recs_b = recs_a.replace("@a", "@b")
    a = _gzip.compress(recs_a.encode(), 6)
    b = _gzip.compress(recs_b.encode(), 6)

    cut = str(tmp_path / "cut.fastq.gz")
    with open(cut, "wb") as fh:
        fh.write(a + b[: len(b) // 2])
    with pytest.raises(ValueError):
        native_count_fastq(cut, 21, 1, 1_000_000)

    garbage = str(tmp_path / "garbage.fastq.gz")
    with open(garbage, "wb") as fh:
        fh.write(a + b"\x00" * 37)  # padding junk, no gzip magic
    k1, c1, s1 = native_count_fastq(garbage, 21, 1, 1_000_000)
    clean = str(tmp_path / "clean.fastq.gz")
    with open(clean, "wb") as fh:
        fh.write(a)
    k2, c2, s2 = native_count_fastq(clean, 21, 1, 1_000_000)
    assert s1 == s2 and np.array_equal(k1, k2) and np.array_equal(c1, c2)


def test_counter_rejects_unsupported_k(tmp_path):
    p = str(tmp_path / "x.fastq")
    with open(p, "w") as fh:
        fh.write("@r\nACGT\n+\nIIII\n")
    with pytest.raises(ValueError, match="supported range"):
        native_count_fastq(p, 40, 1, 1_000_000)


# ---- the port's counter: the pipelined front end against the whole buffer ----

PIPED_ENV = ("BRONKO_PARALLEL_GZ", "BRONKO_PARALLEL_GZ_THREADS", "BRONKO_PARALLEL_GZ_MIN",
             "BRONKO_WHOLEBUF_MAX")
# the parallel inflater's gate: shut (off, or auto under 8 threads) or open
# (forced, or auto at 8 threads), each at a minimum size this text passes
GATE_SHUT = [{"BRONKO_PARALLEL_GZ": "0"},
             {"BRONKO_PARALLEL_GZ_THREADS": "4", "BRONKO_PARALLEL_GZ_MIN": "0"}]
GATE_OPEN = [{"BRONKO_PARALLEL_GZ": "1", "BRONKO_PARALLEL_GZ_MIN": "0"},
             {"BRONKO_PARALLEL_GZ_THREADS": "8", "BRONKO_PARALLEL_GZ_MIN": "0"}]


def _libdeflate_loads() -> bool:
    """Whether the names the counter dlopens load here: BGZF then
    inflates in parallel on the whole buffer, else it pipes."""
    import ctypes

    for name in ("libdeflate.so.0", "libdeflate.so"):
        try:
            ctypes.CDLL(name)
            return True
        except OSError:
            pass
    return False


LIBDEFLATE = _libdeflate_loads()


@pytest.fixture(scope="module")
def piped_text():
    """~11 MB of FASTQ (reads of 60-240 bp with N's, some CRLF records)
    and a gzip of it: many of the pipelined reader's 1 MB blocks, so
    records straddle its cuts."""
    import zlib

    rng = np.random.default_rng(23)
    n = 36_000
    lens = rng.integers(60, 241, size=n)
    bases = np.frombuffer(b"ACGTN", np.uint8)[
        rng.choice(5, size=int(lens.sum()), p=[0.245, 0.245, 0.245, 0.245, 0.02])].tobytes()
    recs, o = [], 0
    for i, ln in enumerate(lens.tolist()):
        eol = "\r\n" if i % 97 == 0 else "\n"
        seq = bases[o:o + ln].decode()
        o += ln
        recs.append(f"@r{i} x{eol}{seq}{eol}+{eol}{'I' * ln}{eol}")
    text = "".join(recs).encode()
    co = zlib.compressobj(1, zlib.DEFLATED, 31)
    return text, co.compress(text) + co.flush()


def _set_env(monkeypatch, env):
    for k in PIPED_ENV:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)


def _piped_file(tmp_path, piped_text, kind):
    import gzip

    text, gz = piped_text
    path = str(tmp_path / ("x.fastq" if kind == "plain" else "x.fastq.gz"))
    half = len(text) // 2
    data = {"plain": text, "gzip": gz,
            "multi-member": gzip.compress(text[:half], 1) + gzip.compress(text[half:], 6),
            "bgzf": b"".join(_bgzf_block(text[o:o + 60000])
                             for o in range(0, len(text), 60000)) + _bgzf_block(b"")}[kind]
    with open(path, "wb") as fh:
        fh.write(data)
    return path


@pytest.mark.parametrize("kind,env,piped", [
    *[("gzip", e, True) for e in GATE_SHUT],
    *[("multi-member", e, True) for e in GATE_SHUT],
    ("gzip", {"BRONKO_PARALLEL_GZ_THREADS": "8", "BRONKO_PARALLEL_GZ_MIN": str(1 << 30)}, True),
    *[("gzip", e, True) for e in GATE_OPEN],
    ("multi-member", GATE_OPEN[0], True),
    *[("plain", e, False) for e in GATE_SHUT],
    *[("bgzf", e, not LIBDEFLATE) for e in GATE_SHUT],
    ("plain", {"BRONKO_WHOLEBUF_MAX": "0"}, True),
    ("bgzf", GATE_OPEN[0], not LIBDEFLATE),
    ("bgzf", {"BRONKO_WHOLEBUF_MAX": "0"}, True),
], ids=["gzip-off", "gzip-4threads", "multi-off", "multi-4threads", "gzip-under-min",
        "gzip-forced", "gzip-8threads", "multi-forced", "plain-off", "plain-4threads",
        "bgzf-off", "bgzf-4threads", "plain-past-cap", "bgzf-forced", "bgzf-past-cap"])
def test_gate_picks_the_pipelined_front_end(tmp_path, monkeypatch, piped_text, kind, env, piped):
    """The port's counter counts a file from its path while it inflates
    (the pipelined front end) unless the whole buffer's inflate is
    parallel or absent: every gzip, single- or multi-member, whatever the
    parallel inflater's gate says, BGZF where libdeflate is missing, and
    any file past the whole-buffer cap pipe; uncompressed input, and BGZF
    that libdeflate inflates in parallel, keep the whole buffer. Either
    way the k-mers, counts and stats equal those of the file's inflated
    text, and only a piped file charges its reader's inflate, beside the
    parse."""
    from bronko_tpu_torch.io import native as torch_native

    _set_env(monkeypatch, env)
    path = _piped_file(tmp_path, piped_text, kind)
    assert torch_native.pipes(path) == piped
    seconds, counters = {}, {}
    got = torch_native.native_count_fastq(path, 21, 2, 1_000_000, threads=4,
                                          seconds=seconds, counters=counters)
    assert counters.get("piped", 0) == int(piped)
    assert (seconds.get("inflate_ahead", 0) > 0) == piped and seconds["inflate"] > 0
    _set_env(monkeypatch, {})
    text = torch_native.native_read_inflate(path)
    assert text.size == len(piped_text[0])
    want = torch_native.native_count_fastq(path, 21, 2, 1_000_000, threads=4, text=text)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2] and got[2]["total_reads"] == 36_000


@pytest.mark.parametrize("front_end", ["pipelined", "whole-buffer"])
@pytest.mark.parametrize("tail", ["garbage", "truncated"])
def test_both_front_ends_accept_the_same_gzip(tmp_path, monkeypatch, front_end, tail):
    """A member followed by bytes without gzip magic counts as the member
    alone on both front ends; a real member cut short fails both, never
    counting a prefix of the sample. The whole buffer's inflate is the one
    that reads a text for the count (`native_read_inflate`)."""
    import gzip

    from bronko_tpu_torch.io import native as torch_native

    recs_a = "".join(f"@a{i}\nACGTACGTACGTACGTACGTACGTTTGA\n+\n{'I' * 28}\n" for i in range(3000))
    a = gzip.compress(recs_a.encode(), 6)
    b = gzip.compress(recs_a.replace("@a", "@b").encode(), 6)
    path = str(tmp_path / "x.fastq.gz")
    with open(path, "wb") as fh:
        fh.write(a + (b"\x00" * 37 if tail == "garbage" else b[: len(b) // 2]))
    _set_env(monkeypatch, {})
    assert torch_native.pipes(path)

    def count(p):
        text = None
        if front_end == "whole-buffer":
            text = torch_native.native_read_inflate(p)
            assert text.handle is not None, text.size
        return torch_native.native_count_fastq(p, 21, 1, 1_000_000, threads=4, text=text)

    if tail == "truncated":
        if front_end == "whole-buffer":
            assert torch_native.native_read_inflate(path).size == -2
        else:
            with pytest.raises(ValueError):
                count(path)
        return
    clean = str(tmp_path / "clean.fastq.gz")
    with open(clean, "wb") as fh:
        fh.write(a)
    got = count(path)
    want = count(clean)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2] and got[2]["total_reads"] == 3000


def test_pipelined_record_longer_than_a_block(tmp_path, monkeypatch):
    """Reads longer than the pipelined reader's 1 MB block (a long-read
    run): the block grows until it holds a whole record, and the count
    equals the whole buffer's."""
    import gzip

    from bronko_tpu_torch.io import native as torch_native

    rng = np.random.default_rng(29)
    seqs = [np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)].tobytes()
            for n in (1_500_000, 300, 2_600_000, 80)]
    text = b"".join(b"@long%d\n%s\n+\n%s\n" % (i, s, b"I" * len(s)) for i, s in enumerate(seqs))
    path = str(tmp_path / "long.fastq.gz")
    with open(path, "wb") as fh:
        fh.write(gzip.compress(text, 1))
    _set_env(monkeypatch, GATE_SHUT[0])
    counters = {}
    got = torch_native.native_count_fastq(path, 21, 1, 1_000_000, threads=4, counters=counters)
    assert counters == {"piped": 1}
    want = torch_native.native_count_fastq(path, 21, 1, 1_000_000, threads=4,
                                           text=torch_native.native_read_inflate(path))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2] and got[2]["total_reads"] == 4
