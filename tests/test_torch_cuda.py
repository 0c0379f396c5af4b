"""Kernels K1-K4, (b) probe_tally (the single histogram word and the
multi-word one), (c) walk_scatter (by ranges, the single saved word and
W saved words), (d) walk_hits and probe_scatter on them, the port's main
path (with the host and the device counter), the streamed single-sample
path, the panel paths, the index built on the card, a device-counter
cohort on two count workers and a cohort of samples with the saved probe
(one enqueued under set_sync_debug_mode('error')), on a CUDA
card, against the plain PyTorch versions on the same card, the host
layout and the CPU run. Skipped without a card; on
one: python -m pytest tests/test_torch_cuda.py -m cuda"""

import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from bronko_tpu_torch.call.engine import run_call  # noqa: E402
from bronko_tpu_torch.config import CallConfig  # noqa: E402
from bronko_tpu_torch.consts import KMER_COUNT_CAP  # noqa: E402
from bronko_tpu_torch.index.build import build_index  # noqa: E402
from bronko_tpu_torch.index.layout import build_device_index  # noqa: E402
from bronko_tpu_torch.index.model import BronkoIndex  # noqa: E402
from bronko_tpu_torch.ops.buckets import filtered_bucket_positions  # noqa: E402
from bronko_tpu_torch.call import engine  # noqa: E402
from bronko_tpu_torch.ops import count, cuda_gather, cuda_map  # noqa: E402
from bronko_tpu_torch.ops import map as tm  # noqa: E402
from bronko_tpu_torch.ops import cuda_buckets as cb, cuda_lib  # noqa: E402
from bronko_tpu_torch.ops.codec import from_u64  # noqa: E402
# plain module name (pytest puts tests/ on sys.path): an installed package
# called `tests` can shadow this directory where the card is
from make_synthetic import make_genome, make_sample, write_fasta, write_fastq  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _inputs(k, n, device, seed):
    rng = np.random.default_rng(seed)
    kmers = rng.integers(0, 1 << (2 * k), size=n, dtype=np.uint64)
    if k == 31:  # the u64 wrap of the bucket hash
        top = (np.uint64(1) << np.uint64(62)) - np.uint64(1)
        m = min(n, 1024)
        kmers[:m] = top - rng.integers(0, 1 << 20, size=m, dtype=np.uint64)
    counts = rng.integers(0, 1_000_000, size=n, dtype=np.int32)
    return from_u64(kmers, device), torch.from_numpy(counts).to(device)


@pytest.mark.parametrize("k", [15, 21, 31])
def test_kernels_equal_plain_on_the_card(gpu, k):
    kmers, counts = _inputs(k, 100_003, gpu, k)
    before = dict(cuda_lib.LAUNCHES)
    for positions in (tuple(filtered_bucket_positions(k, 2, False)), tuple(range(k))):
        for got, want in zip(cb.bucket_queries(kmers, k, positions),
                             cb.bucket_queries_plain(kmers, k, positions)):
            assert torch.equal(got, want)
    assert torch.equal(cb.fold_table(kmers, counts, k),
                       cb.fold_table_plain(kmers, counts, k))
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["bucket_queries"] == before["bucket_queries"] + 2
    assert cuda_lib.LAUNCHES["fold_table"] == before["fold_table"] + 1


@pytest.mark.parametrize("B", [1, 127, 128, 129, 152_679])
@pytest.mark.parametrize("k", range(1, 32))
def test_bucket_queries_every_k_and_edge(gpu, k, B):
    """K1 at every k it is built for, with the filtered positions (none at
    k <= 5) and with all of them, at batches around its 128-row block and
    at the main path's batch: equal to the plain version, one launch each."""
    kmers, _ = _inputs(k, B, gpu, 1000 * k + B)
    for positions in (tuple(filtered_bucket_positions(k, 2, False)), tuple(range(k))):
        before = cuda_lib.LAUNCHES["bucket_queries"]
        got = cb.bucket_queries(kmers, k, positions)
        want = cb.bucket_queries_plain(kmers, k, positions)
        torch.cuda.synchronize()
        assert cuda_lib.LAUNCHES["bucket_queries"] == before + 1
        assert got[0].shape == (B, len(positions))
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_wrappers_reject_what_the_kernels_do_not_take(gpu):
    kmers, counts = _inputs(21, 64, gpu, 0)
    with pytest.raises(ValueError):
        cb.bucket_queries(kmers.to(torch.int32), 21, (2, 3))
    with pytest.raises(ValueError):
        cb.bucket_queries(kmers[::2], 21, (2, 3))
    with pytest.raises(ValueError):
        cb.bucket_queries(kmers, 21, (3, 2))
    with pytest.raises(ValueError):
        cb.fold_table(kmers, counts.to(torch.int64), 21)


def _codes(R, L, device, seed):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(R, L)).astype(np.uint8)
    bad = rng.random((R, L)) < 0.02
    codes[bad] = rng.integers(4, 6, size=int(bad.sum()))
    lengths = rng.integers(L - 70, L + 5, size=R).astype(np.int32)
    return torch.from_numpy(codes).to(device), torch.from_numpy(lengths).to(device)


@pytest.mark.parametrize("k", [15, 21, 31])
def test_pack_windows_equals_plain_on_the_card(gpu, k):
    codes, lengths = _codes(20_011, 160, gpu, k)
    before = cuda_lib.LAUNCHES["pack_windows"]
    for got, want in zip(count.pack_windows(codes, lengths, k),
                         count.pack_windows_plain(codes, lengths, k)):
        assert torch.equal(got, want)
    got = count.extract_and_count_chunk(codes, lengths, k)
    want = count.extract_and_count_chunk(codes.cpu(), lengths.cpu(), k)
    torch.cuda.synchronize()
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
    assert got[2] == want[2]
    assert cuda_lib.LAUNCHES["pack_windows"] == before + 2


# K3's row tile (rows a block takes whole), read from its source so the
# edge cases follow it
with open(os.path.join(cuda_lib.CSRC_DIR, "count_kernels.cu")) as _fh:
    PACK_TILE_ROWS = int(re.search(r"constexpr int kTileRows = (\d+);", _fh.read()).group(1))


def _edge_codes(R, L, seed):
    """Codes 0..5 (about 1 in 20 >= 4) with an all-invalid row, and
    lengths from 0 to past L (rows of length 0 and rows longer than L)."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(R, L)).astype(np.uint8)
    bad = rng.random((R, L)) < 0.05
    codes[bad] = rng.integers(4, 6, size=int(bad.sum()))
    lengths = rng.integers(0, L + 8, size=R).astype(np.int32)
    codes[R // 2] = 5
    lengths[0] = L + 3
    if R > 1:
        lengths[-1] = 0
    return codes, lengths


def _pack_once(codes, lengths, k):
    """K3 on the card, held exactly against its plain version, one launch."""
    before = cuda_lib.LAUNCHES["pack_windows"]
    got = count.pack_windows(codes, lengths, k)
    want = count.pack_windows_plain(codes, lengths, k)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["pack_windows"] == before + 1
    assert got[0].shape == got[1].shape == (codes.shape[0], codes.shape[1] - k + 1)
    assert got[1].dtype == torch.bool
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("R", sorted({1, PACK_TILE_ROWS - 1, PACK_TILE_ROWS, PACK_TILE_ROWS + 1}))
@pytest.mark.parametrize("L", ["k", "k+1", 33, 64, 160, 161, 4099])
@pytest.mark.parametrize("k", range(1, 32))
def test_pack_windows_every_k_and_edge(gpu, k, L, R):
    """K3 at every k: one window a row (L = k), two, rows across plane
    words, the device counter's L = 160, an odd L, and rows of 4,099
    codes (column tiles); row counts around the row tile."""
    L = {"k": k, "k+1": k + 1}.get(L, L)
    codes, lengths = _edge_codes(R, L, 100_000 * k + 10 * L + R)
    _pack_once(torch.from_numpy(codes).to(gpu), torch.from_numpy(lengths).to(gpu), k)


@pytest.mark.parametrize("L", [161, 4099])
@pytest.mark.parametrize("offset", [1, 3, 7])
@pytest.mark.parametrize("k", range(1, 32))
def test_pack_windows_on_unaligned_row_slices(gpu, k, offset, L):
    """K3 on a row slice of a larger chunk (as KmerCounter.add_chunk
    packs one) whose codes start `offset` bytes past a 16-byte boundary."""
    lo = next(i for i in range(16) if i * L % 16 == offset)
    R = PACK_TILE_ROWS + 3 if L < 1000 else 5
    codes, lengths = _edge_codes(lo + R + 2, L, 1000 * k + 10 * offset + L)
    codes_t = torch.from_numpy(codes).to(gpu)[lo:lo + R]
    lengths_t = torch.from_numpy(lengths).to(gpu)[lo:lo + R]
    assert codes_t.is_contiguous() and codes_t.data_ptr() % 16 == offset
    _pack_once(codes_t, lengths_t, k)


@pytest.mark.parametrize("B", [1, 127, 128, 129, 152_679])
@pytest.mark.parametrize("k", range(1, 32))
def test_fold_table_every_k_and_edge(gpu, k, B):
    """K2 at every k it is built for, at batches around its 128-k-mer
    block and at the main path's batch, with counts up to 2^31 - 1 (the
    wrap of count << 5): equal to the plain version, one launch each."""
    kmers, _ = _inputs(k, B, gpu, 2000 * k + B)
    rng = np.random.default_rng(k + B)
    counts = rng.integers(0, 2**31 - 1, size=B, dtype=np.int32, endpoint=True)
    counts[0] = 2**31 - 1
    counts = torch.from_numpy(counts).to(gpu)
    before = cuda_lib.LAUNCHES["fold_table"]
    got = cb.fold_table(kmers, counts, k)
    want = cb.fold_table_plain(kmers, counts, k)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["fold_table"] == before + 1
    assert got.shape == (B * k,) and got.dtype == torch.int32
    assert torch.equal(got, want)


def test_gather_equals_plain_on_the_card(gpu):
    rng = np.random.default_rng(4)
    U, N = 1 << 20, (1 << 21) + 3
    tbl = torch.from_numpy(rng.integers(0, 1 << 30, size=U, dtype=np.int32)).to(gpu)
    idx = torch.from_numpy(rng.integers(0, U, size=N, dtype=np.int32)).to(gpu)
    before = cuda_lib.LAUNCHES["gather"]
    assert torch.equal(cuda_gather.gather(tbl, idx), cuda_gather.gather_plain(tbl, idx))
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["gather"] == before + 1


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("N", [1, 3, 5, (1 << 21) + 3])
def test_gather_edges_equal_plain_on_the_card(gpu, N, offset):
    """K4's scalar head and tail: lengths that are no multiple of its
    vector width, and indices starting one element past a 16-byte
    boundary (a view of a larger tensor)."""
    rng = np.random.default_rng(N + offset)
    U = 1 << 20
    tbl = torch.from_numpy(rng.integers(0, 1 << 30, size=U, dtype=np.int32)).to(gpu)
    base = torch.from_numpy(rng.integers(0, U, size=N + offset, dtype=np.int32)).to(gpu)
    idx = base[offset:]
    assert idx.data_ptr() % 16 == 4 * offset
    before = cuda_lib.LAUNCHES["gather"]
    got = cuda_gather.gather(tbl, idx)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["gather"] == before + 1
    assert torch.equal(got, cuda_gather.gather_plain(tbl, idx))


def test_count_and_gather_wrappers_reject_what_the_kernels_do_not_take(gpu):
    codes, lengths = _codes(64, 96, gpu, 0)
    with pytest.raises(ValueError):
        count.pack_windows(codes.to(torch.int32), lengths, 21)
    with pytest.raises(ValueError):
        count.pack_windows(codes[:, ::2], lengths, 21)
    with pytest.raises(ValueError):
        count.pack_windows(codes, lengths.to(torch.int64), 21)
    with pytest.raises(ValueError):
        count.pack_windows(codes, lengths[:10], 21)
    with pytest.raises(ValueError):
        count.pack_windows(codes, lengths.cpu(), 21)
    tbl = torch.arange(100, dtype=torch.int32, device=gpu)
    idx = torch.arange(50, dtype=torch.int32, device=gpu)
    with pytest.raises(ValueError):
        cuda_gather.gather(tbl.to(torch.int64), idx)
    with pytest.raises(ValueError):
        cuda_gather.gather(tbl, idx[::2])
    with pytest.raises(ValueError):
        cuda_gather.gather(tbl, idx.reshape(5, 10))
    with pytest.raises(ValueError):
        cuda_gather.gather(tbl.cpu(), idx)


def test_main_path_on_the_card_equals_the_cpu(gpu, tmp_path):
    rng = np.random.default_rng(41)
    genomes = []
    base = make_genome(rng, 1500)
    for i in range(3):
        g = bytearray(base)
        for p in rng.integers(0, len(g), 8):
            g[p] = b"ACGT"[rng.integers(4)]
        genomes.append(str(tmp_path / f"g{i}.fasta"))
        write_fasta(genomes[-1], f"g{i}", bytes(g))
    reads, _ = make_sample(base, rng, read_len=90, depth=500,
                           major_positions={600: 0.9}, error_rate=0.004)
    fq = str(tmp_path / "s.fastq.gz")
    write_fastq(fq, reads)
    index = build_index(21, genomes)
    results = {}
    for name, device, counter in (("cpu", torch.device("cpu"), "host"),
                                  ("gpu", gpu, "host"), ("gpu_device", gpu, "device")):
        cfg = CallConfig(genomes=genomes, reads=[fq], output=str(tmp_path / name),
                         output_pileup=True, batch_size=4096, counter=counter)
        before = cuda_lib.LAUNCHES["pack_windows"]
        (results[name],) = run_call(cfg, index, build_device_index(index, device))
        assert (cuda_lib.LAUNCHES["pack_windows"] > before) == (name == "gpu_device")
    for name in ("gpu", "gpu_device"):
        assert results[name].best == results["cpu"].best
        np.testing.assert_array_equal(results[name].tallies, results["cpu"].tallies)
        np.testing.assert_array_equal(results[name].pileup, results["cpu"].pileup)
        for f in ("s.vcf", "s.tsv", "bronko_overview.tsv"):
            assert open(tmp_path / name / f).read() == open(tmp_path / "cpu" / f).read()
    assert os.path.getsize(tmp_path / "gpu" / "s.vcf") > 0


@pytest.mark.parametrize("cap", ["default", "mixed"])
def test_streamed_path_on_the_card_equals_classic(gpu, tmp_path, monkeypatch, cap):
    """The streamed single-sample path on the card under --counter host
    (pinned uploads, every
    partition's pass 1 enqueued before the sample's one sync) equals the
    classic card run and the CPU's streamed run: tallies, genome, pileup
    and files. With the probe cap at the first partition's bytes, the
    other partitions re-probe the sub-index (K1 again in pass 2)."""
    from bronko_tpu_torch.call import engine
    from bronko_tpu_torch.io import native

    rng = np.random.default_rng(47)
    genomes = []
    base = make_genome(rng, 3000)
    for i in range(3):
        g = bytearray(base)
        for p in rng.integers(0, len(g), 8):
            g[p] = b"ACGT"[rng.integers(4)]
        genomes.append(str(tmp_path / f"g{i}.fasta"))
        write_fasta(genomes[-1], f"g{i}", bytes(g))
    reads, _ = make_sample(base, rng, read_len=90, depth=300,
                           major_positions={900: 0.9}, error_rate=0.004)
    fq = str(tmp_path / "s.fastq.gz")
    write_fastq(fq, reads)
    index = build_index(21, genomes)
    parts = [p[0].shape[0] for p in native.native_count_fastq_stream(
        [fq], 21, CallConfig().min_kmers, KMER_COUNT_CAP, threads=2)]
    if cap == "mixed":
        dev = build_device_index(index, torch.device("cpu"))
        J = len(dev.map_config(CallConfig().n_fixed, False).positions)
        monkeypatch.setattr(engine, "PROBE_BYTES_CAP",
                            parts[0] * J * engine.probe_bytes_per_query(dev))
    results, launches = {}, {}
    for name, device, env in (("cpu", torch.device("cpu"), "BRONKO_STREAM"),
                              ("gpu", gpu, "BRONKO_STREAM"),
                              ("gpu_classic", gpu, "BRONKO_NO_STREAM")):
        for var in ("BRONKO_STREAM", "BRONKO_NO_STREAM"):
            monkeypatch.delenv(var, raising=False)
        monkeypatch.setenv(env, "1")
        # the host counter's partitions, which the card would not count
        cfg = CallConfig(genomes=genomes, reads=[fq], output=str(tmp_path / name),
                         output_pileup=True, batch_size=1024, counter="host")
        dev = build_device_index(index, device)
        before = dict(cuda_lib.LAUNCHES)
        (results[name],) = run_call(cfg, index, dev)
        torch.cuda.synchronize()
        launches[name] = {k: cuda_lib.LAUNCHES[k] - before[k] for k in before}
    assert results["gpu"].path == results["cpu"].path == ("hist", "streamed")
    assert results["gpu_classic"].path == ("hist", "saved" if cap == "default" else "subindex")
    batches = sum(-(-n // 1024) for n in parts)
    assert launches["gpu"]["bucket_queries"] >= batches > len(parts)
    assert launches["gpu"]["fold_table"] >= 1
    for name in ("gpu", "gpu_classic"):
        assert results[name].best == results["cpu"].best
        np.testing.assert_array_equal(results[name].tallies, results["cpu"].tallies)
        np.testing.assert_array_equal(results[name].pileup, results["cpu"].pileup)
        for f in ("s.vcf", "s.tsv", "bronko_overview.tsv"):
            assert open(tmp_path / name / f).read() == open(tmp_path / "cpu" / f).read()


def _fastq_text(rng, n, case):
    """n FASTQ records of 1-300 bases (ACGT, some N, lowercase and other
    bytes), headers of 1-40 bytes; `case` cuts or breaks the end."""
    recs = []
    for i in range(n):
        L = int(rng.integers(0, 300))
        seq = rng.choice(np.frombuffer(b"ACGTACGTACGTacgtNRY", np.uint8), L).tobytes()
        head = b"@" + rng.choice(np.frombuffer(b"abc 0123:/", np.uint8),
                                 int(rng.integers(0, 40))).tobytes()
        recs.append(head + b"\n" + seq + b"\n+\n" + b"I" * L + b"\n")
    text = b"".join(recs)
    if case == "crlf":
        text = text.replace(b"\n", b"\r\n")
    elif case == "no_final_newline":
        text = text[:-1]
    elif case == "truncated":
        text += b"@cut\nACGTACGTACGTACGTACGTACGTACGTACGT\n"
    elif case == "malformed":
        cut = text.index(b"\n@", len(text) // 2) + 1
        text = text[:cut] + b"x" + text[cut + 1:]
    return text


@pytest.mark.parametrize("offset", [0, 1, 7])
@pytest.mark.parametrize("case", ["plain", "crlf", "no_final_newline", "truncated",
                                  "malformed"])
@pytest.mark.parametrize("k", [1, 5, 19, 21, 31])
def test_fastq_pack_equals_plain_on_the_card(gpu, k, case, offset):
    """The text pack (lines, count and write kernels) against its plain
    version on the card: the same words in text order, reads and
    malformed flag, on texts of many 8,192-byte tiles, with records across
    tile edges, at aligned and unaligned starts."""
    rng = np.random.default_rng(k * 100 + offset)
    text = _fastq_text(rng, 400, case)
    buf = torch.from_numpy(np.frombuffer(b"@" * offset + text, np.uint8).copy()).to(gpu)
    t = buf[offset:]
    before = dict(cuda_lib.LAUNCHES)
    words, reads, bad = count.fastq_pack(t, k)
    torch.cuda.synchronize()
    want, want_reads, want_bad = count.fastq_pack_plain(t, k)
    assert (reads, bad) == (want_reads, want_bad) and bad == (case == "malformed")
    assert torch.equal(words, want)
    assert cuda_lib.LAUNCHES["fastq_lines"] == before["fastq_lines"] + 1
    assert cuda_lib.LAUNCHES["fastq_pack"] == before["fastq_pack"] + 1 + (words.numel() > 0)


@pytest.mark.parametrize("size", [0, 1, 8191, 8192, 8193, 16384 + 31, 3 * 8192 - 1])
def test_fastq_pack_at_the_tile_edges(gpu, size):
    """Texts that end just before, at and past a tile's end, cut from a
    long one (the last record most often truncated), at k = 21."""
    rng = np.random.default_rng(size)
    text = _fastq_text(rng, 200, "plain")[:size]
    t = torch.from_numpy(np.frombuffer(text, np.uint8).copy()).to(gpu)
    words, reads, bad = count.fastq_pack(t, 21)
    want, want_reads, want_bad = count.fastq_pack_plain(t, 21)
    assert (reads, bad) == (want_reads, want_bad)
    assert torch.equal(words, want)


def _panel(tmp_path, rng, n, glen):
    base = make_genome(rng, glen)
    genomes = []
    for i in range(n):
        g = bytearray(base)
        for p in rng.integers(0, len(g), 8):
            g[p] = b"ACGT"[(b"ACGT".index(g[p]) + 1 + i % 3) % 4]
        genomes.append(str(tmp_path / f"g{i}.fasta"))
        write_fasta(genomes[-1], f"g{i}", bytes(g))
    return base, genomes


@pytest.mark.parametrize("case,mode", [("sars2_like", "hist"), ("g16", "words")])
def test_streamed_device_count_on_the_card_equals_the_host_count(gpu, tmp_path, monkeypatch,
                                                                 case, mode):
    """A streamed pair whose mates the card counts (--counter auto) against
    the host count on the card and on the CPU: the same resolved tallies,
    genome, pileup and files, both mates counted on the card through the
    text pack, on the single histogram word (4 strains) and on the words
    (16 strains)."""
    from bronko_tpu_torch.call import device_count

    rng = np.random.default_rng(len(case))
    base, genomes = _panel(tmp_path, rng, 4 if case == "sars2_like" else 16, 3000)
    reads, _ = make_sample(base, rng, read_len=150, depth=400,
                           major_positions={900: 0.9, 2100: 0.85}, error_rate=0.003)
    r1, r2 = str(tmp_path / "s_1.fastq.gz"), str(tmp_path / "s_2.fastq.gz")
    write_fastq(r1, reads[::2])
    write_fastq(r2, reads[1::2])
    index = build_index(21, genomes)
    for var in ("BRONKO_STREAM", "BRONKO_NO_STREAM", "BRONKO_STREAM_FIRST"):
        monkeypatch.delenv(var, raising=False)
    results, launches = {}, {}
    for name, device, counter in (("cpu", torch.device("cpu"), "host"),
                                  ("gpu_host", gpu, "host"), ("gpu_card", gpu, "auto")):
        cfg = CallConfig(genomes=genomes, first_pairs=[r1], second_pairs=[r2],
                         output=str(tmp_path / name), output_pileup=True, batch_size=4096,
                         counter=counter)
        before = dict(cuda_lib.LAUNCHES)
        (results[name],) = run_call(cfg, index, build_device_index(index, device))
        torch.cuda.synchronize()
        launches[name] = {k: cuda_lib.LAUNCHES[k] - before[k] for k in before}
    assert device_count.usable(CallConfig(), gpu)
    assert {r.path for r in results.values()} == {(mode, "streamed")}
    assert [results[n].counts["device_counted"] for n in ("cpu", "gpu_host", "gpu_card")] == \
        [0, 0, 2]
    assert launches["gpu_card"]["fastq_lines"] == 2 and launches["gpu_card"]["fastq_pack"] == 4
    assert launches["gpu_host"]["fastq_pack"] == 0
    for name in ("gpu_host", "gpu_card"):
        assert results[name].best == results["cpu"].best
        np.testing.assert_array_equal(results[name].tallies, results["cpu"].tallies)
        np.testing.assert_array_equal(results[name].pileup, results["cpu"].pileup)
        files = sorted(os.listdir(tmp_path / name))
        assert len(files) == 3 and files == sorted(os.listdir(tmp_path / "cpu"))
        for f in files:
            assert open(tmp_path / name / f).read() == open(tmp_path / "cpu" / f).read()


def test_a_mate_counts_on_the_card_in_parts(gpu, tmp_path, monkeypatch, caplog):
    """Both mates of a streamed pair in parts of 256 KiB: count_mates on the card
    equals its plain version (the CPU taken as a card) and the native
    count in k-mers, counts and stats; run_call under --counter auto counts
    both mates on the card in several parts, with no warning, and writes
    the host count's files."""
    import logging

    from bronko_tpu_torch.call import device_count
    from bronko_tpu_torch.io import native

    rng = np.random.default_rng(29)
    base, genomes = _panel(tmp_path, rng, 8, 3000)
    reads, _ = make_sample(base, rng, read_len=150, depth=600,
                           major_positions={900: 0.9, 2100: 0.85}, error_rate=0.003)
    r1, r2 = str(tmp_path / "s_1.fastq.gz"), str(tmp_path / "s_2.fastq.gz")
    write_fastq(r1, reads[::2])
    write_fastq(r2, reads[1::2])
    index = build_index(21, genomes)
    for var in ("BRONKO_STREAM", "BRONKO_NO_STREAM", "BRONKO_STREAM_FIRST"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(device_count, "PART_BYTES", 256 << 10)
    monkeypatch.setattr(device_count, "BLOCK_BYTES", 64 << 10)
    caplog.set_level(logging.WARNING, logger="bronko")
    counters = {}
    card = list(device_count.count_mates([r1, r2], 21, 3, KMER_COUNT_CAP, gpu,
                                         counters=counters))
    monkeypatch.setattr(device_count, "budget", lambda device: 1 << 40)
    plain = list(device_count.count_mates([r1, r2], 21, 3, KMER_COUNT_CAP,
                                          torch.device("cpu")))
    assert counters["device_counted"] == 2 and counters["count_parts"] > 4
    for (km, ct, st), (pk, pc, ps), path in zip(card, plain, (r1, r2)):
        want_k, want_c, want_st = native.native_count_fastq(path, 21, 3, KMER_COUNT_CAP)
        assert torch.equal(km.cpu(), pk) and torch.equal(ct.cpu(), pc) and st == ps == want_st
        np.testing.assert_array_equal(pk.numpy(), want_k.view(np.int64))
        np.testing.assert_array_equal(pc.numpy(), want_c)
    monkeypatch.undo()
    monkeypatch.setattr(device_count, "PART_BYTES", 256 << 10)
    monkeypatch.setattr(device_count, "BLOCK_BYTES", 64 << 10)
    results = {}
    for name, counter in (("card", "auto"), ("host", "host")):
        cfg = CallConfig(genomes=genomes, first_pairs=[r1], second_pairs=[r2],
                         output=str(tmp_path / name), output_pileup=True, batch_size=4096,
                         counter=counter)
        (results[name],) = run_call(cfg, index, build_device_index(index, gpu))
    assert results["card"].counts["device_counted"] == 2
    assert results["card"].counts["count_parts"] == counters["count_parts"]
    assert "counted on the host" not in caplog.text
    assert results["card"].best == results["host"].best
    np.testing.assert_array_equal(results["card"].tallies, results["host"].tallies)
    np.testing.assert_array_equal(results["card"].pileup, results["host"].pileup)
    files = sorted(os.listdir(tmp_path / "host"))
    assert len(files) == 3 and files == sorted(os.listdir(tmp_path / "card"))
    for f in files:
        assert open(tmp_path / "card" / f).read() == open(tmp_path / "host" / f).read()


@pytest.mark.parametrize("case,path", [
    ("g12", ("words", "saved")), ("polyA9", ("flat", "subindex")),
    ("ungrouped", ("hist", "subindex"))])
def test_panel_paths_on_the_card_equal_the_cpu(gpu, tmp_path, monkeypatch, case, path):
    """Past the single-word histogram on the card: 12 strains (the
    multi-word histogram, saved probe), 9 with a poly-A stretch (flat
    tally, sub-index pass 2), 5 with postings permuted in their buckets
    (single-word tally, sub-index pass 2); each equals the CPU run, with
    K1 and K2 launched."""
    rng = np.random.default_rng(len(case))
    base = make_genome(rng, 1500)
    n = {"g12": 12, "polyA9": 9, "ungrouped": 5}[case]
    genomes = []
    for i in range(n):
        g = bytearray(base)
        for p in rng.integers(0, len(g), 8):
            g[p] = b"ACGT"[(b"ACGT".index(g[p]) + 1) % 4]
        if case == "polyA9":
            g[1200:1200] = b"A" * 300
        genomes.append(str(tmp_path / f"g{i}.fasta"))
        write_fasta(genomes[-1], f"g{i}", bytes(g))
    reads, _ = make_sample(base, rng, read_len=90, depth=300,
                           major_positions={600: 0.9}, error_rate=0.004)
    fq = str(tmp_path / "s.fastq.gz")
    write_fastq(fq, reads)
    index = build_index(21, genomes)
    if case == "ungrouped":
        bucket = np.repeat(np.arange(index.num_buckets), np.diff(index.offsets))
        order = np.lexsort((rng.random(bucket.shape[0]), bucket))
        index = BronkoIndex(k=21, keys=index.keys, offsets=index.offsets,
                            post_loc=index.post_loc[order], post_meta=index.post_meta[order],
                            files=index.files)
    monkeypatch.setenv("BRONKO_NO_STREAM", "1")  # the classic path, which `path` names
    results = {}
    for name, device in (("cpu", torch.device("cpu")), ("gpu", gpu)):
        cfg = CallConfig(genomes=genomes, reads=[fq], output=str(tmp_path / name),
                         output_pileup=True, batch_size=4096)
        before = dict(cuda_lib.LAUNCHES)
        (results[name],) = run_call(cfg, index, build_device_index(index, device))
        assert results[name].path == path
    assert all(cuda_lib.LAUNCHES[k] > before[k] for k in ("bucket_queries", "fold_table"))
    # the path's own kernels: (b) and (c) on the words, (d) on the flat tally
    path_kernels = {"g12": ("probe_tally", "walk_scatter"), "polyA9": ("walk_hits",),
                    "ungrouped": ("probe_tally",)}[case]
    assert all(cuda_lib.LAUNCHES[k] > before[k] for k in path_kernels)
    assert results["gpu"].best == results["cpu"].best
    np.testing.assert_array_equal(results["gpu"].tallies, results["cpu"].tallies)
    np.testing.assert_array_equal(results["gpu"].pileup, results["cpu"].pileup)
    for f in ("s.vcf", "s.tsv", "bronko_overview.tsv"):
        assert open(tmp_path / "gpu" / f).read() == open(tmp_path / "cpu" / f).read()


@pytest.mark.parametrize("case", ["1x1", "4x1", "4x3", "13x2"])
def test_device_build_on_the_card_equals_the_host_layout(gpu, tmp_path, case):
    """The index built on the card (K3 packs the windows, K1 hashes them
    at every position) equals the host layout, every tensor and field."""
    from test_torch_device_build import assert_same_index, panel_paths

    from bronko_tpu_torch.index.device_build import build_device_index_on_device

    paths = panel_paths(tmp_path, case)
    before = dict(cuda_lib.LAUNCHES)
    _, dev = build_device_index_on_device(21, paths, gpu)
    torch.cuda.synchronize()
    assert all(cuda_lib.LAUNCHES[k] > before[k] for k in ("pack_windows", "bucket_queries"))
    assert dev.keys.device.type == "cuda"
    assert_same_index(dev, build_device_index(build_index(21, paths), gpu))


def test_device_counter_cohort_on_two_workers_equals_the_cpu(gpu, tmp_path, monkeypatch):
    """A 3-sample cohort counted on the card by 2 count workers (K3 from
    worker threads, batches uploaded there) writes the CPU run's files."""
    rng = np.random.default_rng(43)
    base = make_genome(rng, 1500)
    ref = str(tmp_path / "ref.fasta")
    write_fasta(ref, "ref", base)
    fqs = []
    for i in range(3):
        reads, _ = make_sample(base, rng, read_len=90, depth=300,
                               major_positions={400 + 300 * i: 0.9}, error_rate=0.004)
        fqs.append(str(tmp_path / f"s{i}.fastq.gz"))
        write_fastq(fqs[-1], reads)
    monkeypatch.setenv("BRONKO_COUNT_WORKERS", "2")
    index = build_index(21, [ref])
    outs = {}
    for name, device in (("cpu", torch.device("cpu")), ("gpu", gpu)):
        cfg = CallConfig(genomes=[ref], reads=fqs, output=str(tmp_path / name),
                         output_pileup=True, batch_size=4096, counter="device")
        before = cuda_lib.LAUNCHES["pack_windows"]
        results = run_call(cfg, index, build_device_index(index, device))
        assert [r.summary.filename for r in results] == fqs
        assert (cuda_lib.LAUNCHES["pack_windows"] > before) == (name == "gpu")
        outs[name] = {f: open(tmp_path / name / f, "rb").read()
                      for f in sorted(os.listdir(tmp_path / name))}
    assert len(outs["gpu"]) == 7 and outs["gpu"] == outs["cpu"]


def _probe_keys(case, rng, U):
    """Sorted uint64 keys (U of them unless the case fixes U) and, for the
    k = 31 case, the (B, J) bucket ids the queries come from."""
    if case == "skewed":  # every key below 2^64-1 in one slot of the directory
        keys = np.unique(rng.integers(0, 1 << 40, size=U, dtype=np.uint64))
    elif case == "u1":
        return np.asarray([0x14F66C5DB506], np.uint64), None
    elif case == "k31_wrap":  # bucket ids of k = 31, past 2^63 and below it
        kmers = rng.integers(0, 1 << 62, size=4_000, dtype=np.uint64)
        kmers[:2_000] = ((np.uint64(1) << np.uint64(62)) - np.uint64(1)
                         - rng.integers(0, 1 << 20, size=2_000, dtype=np.uint64))
        ids, _, _ = cb.bucket_queries_plain(from_u64(kmers, torch.device("cpu")), 31,
                                            tuple(filtered_bucket_positions(31, 2, False)))
        ids = ids.numpy().view(np.uint64)
        return np.unique(ids[rng.random(ids.shape) < 0.6]), ids
    else:
        keys = np.unique(rng.integers(0, 1 << 64, size=U, dtype=np.uint64, endpoint=False))
    keys[-1] = np.uint64(0xFFFFFFFFFFFFFFFF)
    if case == "top_key":  # a real key 2^64-1, then three sentinel rows of it
        keys = np.concatenate([keys, np.full(3, 0xFFFFFFFFFFFFFFFF, np.uint64)])
    return keys, None


def _probe_inputs(case, device, seed, B=20_011, J=16, U=5_000):
    """Sorted keys (bit 63 flipped; by case: random with the last one
    2^64-1, every key below it in one slot, k = 31 bucket ids, a real key
    2^64-1 followed by sentinel rows, one key), their directory, CSR
    starts, histogram words (int32 at G = 4, int64 with bit 63 set at G
    = 8), and (B, J) queries of which about half hit, the first k-mers
    perfect for some genomes, with a quarter of the counts 0 in one case;
    J = 13 sums hits by shared-memory adds, J = 26 (k = 31) too."""
    rng = np.random.default_rng(seed)
    keys, ids = _probe_keys(case, rng, U)
    U = keys.shape[0]
    J = {"j13": 13, "j0": 0}.get(case, J if ids is None else ids.shape[1])
    offsets = np.concatenate([[0], np.cumsum(rng.integers(0, 256, U))]).astype(np.int32)
    G = 8 if case == "g8_signbit" else 4
    hist = rng.integers(0, 1 << 63, size=U, dtype=np.int64) | np.int64(-(1 << 63))
    if G == 4:
        hist = (hist & 0x7F7F7F7F).astype(np.int32)
    B = 0 if case == "empty" else B
    pool = keys if ids is None else ids.reshape(-1)
    q = np.where(rng.random((B, J)) < 0.5, pool[rng.integers(0, pool.shape[0], (B, J))],
                 rng.integers(0, 1 << 64, size=(B, J), dtype=np.uint64, endpoint=False))
    # k-mers whose J queries all hit one key whose bytes are 0 or 1: hits
    # of J (perfect; unique where one genome has it) or 0
    special = rng.integers(0, U, size=min(B, 100))
    hist[special] = ((rng.random((special.shape[0], G)) < 0.4)
                     << (8 * np.arange(G))).sum(axis=1).astype(hist.dtype)
    if J:
        q[:special.shape[0]] = keys[special][:, None]
        q[: min(B, 7), 0] = keys[-1]  # the largest key: its last row, U - 1
    counts = rng.integers(1, 1000, size=B).astype(np.int32)
    if case == "zero_counts":
        counts[rng.random(B) < 0.25] = 0
    to = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    tallies = to(rng.integers(0, 100, size=(G, 3)).astype(np.int32))
    keys_ordered = from_u64(keys, device) ^ cuda_map.SIGN_BIT
    return (from_u64(q.reshape(-1), device).reshape(B, J), to(counts), keys_ordered,
            cuda_map.probe_directory(keys_ordered), to(offsets), to(hist), tallies)


@pytest.mark.parametrize("case", ["int32_words", "g8_signbit", "zero_counts", "empty",
                                  "skewed", "k31_wrap", "top_key", "u1", "j13", "j0"])
def test_probe_tally_equals_plain_on_the_card(gpu, case):
    """Kernel (b) against its plain version: start, h, the batch's lanes
    and the tallies it adds into (from a nonzero start); the largest key
    (2^64-1 but in the k = 31 and one-key cases) is hit at its last row;
    one launch unless the batch is empty. The cases reach every key
    through the directory: one slot of ~5,000 keys, ids past 2^63,
    duplicates of 2^64-1, one key; and both ways of summing a k-mer's
    hits (J = 16 by shuffles; 13 and 26 by shared-memory adds; 0)."""
    q, counts, keys, directory, offsets, hist, tallies = _probe_inputs(case, gpu, len(case))
    want_tallies = tallies.clone()
    before = cuda_lib.LAUNCHES["probe_tally"]
    got = cuda_map.probe_tally(q, counts, keys, directory, offsets, hist, tallies)
    want = cuda_map.probe_tally_plain(q, counts, keys, directory, offsets, hist, want_tallies)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["probe_tally"] == before + (q.shape[0] > 0)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert torch.equal(tallies, want_tallies)
    if q.shape[0] and q.shape[1]:
        assert ((got[1] != 0).any() or not hist.any()) and (got[0][:7, 0] == offsets[-2]).all()
        # the directory's search finds what the search over all keys finds
        rowc, hit = cuda_map._probe(q, keys)
        assert torch.equal(got[0], torch.where(hit, offsets[rowc], 0))
    if case == "g8_signbit":
        assert (got[1] < 0).any()
    if case == "skewed":
        assert directory.widest == keys.shape[0] - 1


def _walk_inputs(post_bytes, device, seed, owner=7, B=3_001, J=16, k=21, T=5_000, G=8,
                 long_rows=False, tail=8):
    """Fold records, starts, row lengths (0 and 255 among them), int64
    histogram words with bit 63 set, and postings inside the pileup, int32
    genome-local or int64 at genome `owner`'s nonzero file base, `tail`
    x 255 of them past the last start. With long_rows, a quarter of the
    rows hold 255 postings and the rest none, by lens and in every byte
    of h."""
    rng = np.random.default_rng(seed)
    rec = (rng.integers(0, 16, size=B * k) | (rng.integers(0, 2, size=B * k) << 4)
           | (rng.integers(0, 1_000_000, size=B * k) << 5)).astype(np.int32)
    lens = rng.integers(0, 6, size=(B, J)).astype(np.int32)
    lens[0, :4] = (0, 255, 255, 0)
    P0 = 200_000
    start = rng.integers(0, P0, size=(B, J)).astype(np.int32)
    h = rng.integers(0, 1 << 63, size=(B, J), dtype=np.int64) | np.int64(-(1 << 63))
    if long_rows:
        full = rng.random((B, J, 8)) < 0.25
        lens = np.where(full[..., 0], 255, 0).astype(np.int32)
        h = (full.astype(np.uint64) * np.uint64(255)
             << (np.uint64(8) * np.arange(8, dtype=np.uint64))).sum(axis=2).view(np.int64)
    P = P0 + tail * 255
    meta = (rng.integers(0, 2, size=P) << 5) | rng.integers(0, k, size=P)
    lpos = rng.integers(0, T, size=P)
    bases = np.arange(G, dtype=np.int64) * 7_919 + 1_000_003
    if post_bytes == 4:
        postings = ((lpos << 6) | meta).astype(np.int32)
    else:
        postings = ((lpos + bases[owner]) << 22) | (owner << 6) | meta
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return (to(rec), to(start), to(lens), to(h), to(postings), to(bases),
            torch.zeros((4, T + 1, 4), dtype=torch.int32, device=device))


@pytest.mark.parametrize("post_bytes", [4, 8])
@pytest.mark.parametrize("mode", ["lens", "saved"])
def test_walk_scatter_equals_plain_on_the_card(gpu, post_bytes, mode):
    """Kernel (c) against its plain version, rows of 0 and 255 lanes among
    them, then a batch of rows of 255 lanes mixed with empty ones (a
    warp's walk crosses rows): by (start, lens), and from the saved
    probe's int64 words with bit 63 set at genome 7 (the top byte) and
    genome 3; int32 postings, and int64 ones at a nonzero file base read
    on the card."""
    for best, long_rows in [(b, long) for long in (False, True)
                            for b in ((None,) if mode == "lens" else (7, 3))]:
        pc, start, lens, h, postings, bases, zero = _walk_inputs(
            post_bytes, gpu, post_bytes, owner=best or 7, long_rows=long_rows)
        file_base = None if post_bytes == 4 else bases
        k = pc.shape[0] // start.shape[0]
        kw = ({"lens": lens} if mode == "lens" else
              {"h": h, "best": torch.full((1,), best, dtype=torch.int64, device=gpu)})
        if mode == "lens" and file_base is not None:
            kw["file_base"] = file_base[7:8]
        elif file_base is not None:
            kw["file_base"] = file_base
        got, want = zero.clone(), zero.clone()
        before = cuda_lib.LAUNCHES["walk_scatter"]
        cuda_map.walk_scatter(got, pc, start, postings, k=k, **kw)
        cuda_map.walk_scatter_plain(want, pc, start, postings, k=k, **kw)
        torch.cuda.synchronize()
        assert cuda_lib.LAUNCHES["walk_scatter"] == before + 1
        assert torch.equal(got, want) and int(got[2:].sum()) > 0


def test_walk_scatter_stops_at_the_postings_end(gpu):
    """A row whose range runs past the postings is walked up to their end
    (nothing is read out of bounds): the plain version with that row's
    length cut there gives the same pileup."""
    pc, start, lens, h, postings, bases, zero = _walk_inputs(4, gpu, 5, B=64)
    P = postings.shape[0]
    start[0, 0], lens[0, 0] = P - 3, 200
    got, want = zero.clone(), zero.clone()
    cuda_map.walk_scatter(got, pc, start, postings, k=21, lens=lens)
    cut = torch.minimum(lens, (P - start).clamp_min(0))
    cuda_map.walk_scatter_plain(want, pc, start, postings, k=21, lens=cut)
    torch.cuda.synchronize()
    assert int(cut[0, 0]) == 3 and torch.equal(got, want)


def test_walk_scatter_walks_a_range_of_2_25_postings_alone(gpu):
    """A (start, lens) row of 2^25 postings (a CSR range; no histogram byte
    is one) beside short rows in its warp: its warp walks every row in
    its own lane instead of sharing the postings, with the same pileup."""
    pc, start, lens, h, postings, bases, zero = _walk_inputs(4, gpu, 9, B=4)
    P = (1 << 25) + 4_096
    rng = np.random.default_rng(9)
    postings = torch.from_numpy(((rng.integers(0, 5_000, size=P) << 6)
                                 | rng.integers(0, 21, size=P)).astype(np.int32)).to(gpu)
    start = torch.from_numpy(rng.integers(0, 4_096, size=start.shape).astype(np.int32)).to(gpu)
    lens[0, 3] = 1 << 25
    got, want = zero.clone(), zero.clone()
    cuda_map.walk_scatter(got, pc, start, postings, k=21, lens=lens)
    cuda_map.walk_scatter_plain(want, pc, start, postings, k=21, lens=lens)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and int(got[2:].sum()) == int(lens.sum())


def test_map_wrappers_reject_what_the_kernels_do_not_take(gpu):
    q, counts, keys, directory, offsets, hist, tallies = _probe_inputs("int32_words", gpu, 0,
                                                                       B=64)
    with pytest.raises(ValueError):
        cuda_map.probe_tally(q, counts, keys, directory, offsets, hist.to(torch.int16),
                             tallies)
    with pytest.raises(ValueError):
        cuda_map.probe_tally(q, counts, keys, directory, offsets, hist,
                             torch.zeros((9, 3), dtype=torch.int32, device=gpu))
    with pytest.raises(ValueError):
        cuda_map.probe_tally(q[:, ::2], counts, keys, directory, offsets, hist, tallies)
    with pytest.raises(ValueError):  # a directory of too few slots for its span
        cuda_map.probe_tally(q, counts, keys, directory._replace(table=directory.table[:2]),
                             offsets, hist, tallies)
    pc, start, lens, h, postings, bases, zero = _walk_inputs(4, gpu, 0, B=8)
    with pytest.raises(ValueError):
        cuda_map.walk_scatter(zero, pc, start, postings, k=21)
    with pytest.raises(ValueError):
        cuda_map.walk_scatter(zero, pc, start, postings, k=21, h=h)
    with pytest.raises(ValueError):
        cuda_map.walk_scatter(zero, pc, start, postings, k=21, lens=lens[:, :3])
    with pytest.raises(ValueError):
        cuda_map.walk_scatter(zero, pc, start, postings.to(torch.int16), k=21, lens=lens)


def test_fused_cohort_on_the_card_equals_two_pass_and_cpu(gpu, tmp_path, monkeypatch):
    """Three samples of a 2-genome panel on the card take ('hist',
    'saved'), launching K1, (b), K2 and (c) once each a batch, every
    stage's seconds kept; their tallies, picks, pileups and files equal
    the sub-index run on the card (the probe cap at 1 byte: ('hist',
    'subindex')) and the CPU run. The first sample's pass 1 and its copy
    enqueue under torch.cuda.set_sync_debug_mode('error') (no host sync),
    and its resolve() equals the cohort's."""
    rng = np.random.default_rng(47)
    base = make_genome(rng, 1500)
    decoy = bytearray(base)
    for p in rng.integers(0, len(decoy), 30):
        decoy[p] = b"ACGT"[(b"ACGT".index(decoy[p]) + 1) % 4]
    refs = [str(tmp_path / "ref.fasta"), str(tmp_path / "decoy.fasta")]
    write_fasta(refs[0], "ref", base)
    write_fasta(refs[1], "decoy", bytes(decoy))
    fqs = []
    for i in range(3):
        reads, _ = make_sample(base, rng, read_len=90, depth=300,
                               major_positions={400 + 300 * i: 0.9}, error_rate=0.004)
        fqs.append(str(tmp_path / f"s{i}.fastq.gz"))
        write_fastq(fqs[-1], reads)
    monkeypatch.setenv("BRONKO_NO_STREAM", "1")
    index = build_index(21, refs)
    runs = {}
    for name, device, cap in (("cpu", torch.device("cpu"), None), ("gpu", gpu, None),
                              ("gpu_two_pass", gpu, 1)):
        with monkeypatch.context() as m:
            if cap is not None:
                m.setattr(engine, "PROBE_BYTES_CAP", cap)
            dev = build_device_index(index, device)
            before = dict(cuda_lib.LAUNCHES)
            results = run_call(CallConfig(genomes=refs, reads=fqs, output=str(tmp_path / name),
                                          output_pileup=True, batch_size=4096), index, dev)
            torch.cuda.synchronize()
        launched = {n: cuda_lib.LAUNCHES[n] - before[n] for n in before}
        want_path = ("hist", "subindex") if cap else ("hist", "saved")
        assert [r.path for r in results] == [want_path] * 3
        if name == "gpu":
            n = launched["bucket_queries"]
            assert n >= 3 and all(launched[k] == n for k in
                                  ("probe_tally", "fold_table", "walk_scatter"))
            for r in results:
                assert tuple(r.seconds) == engine.STAGES + engine.SPAN_KEYS
                assert min(r.seconds.values()) >= 0 and r.seconds["pass1"] > 0
        runs[name] = (results, {f: open(tmp_path / name / f, "rb").read()
                                for f in sorted(os.listdir(tmp_path / name))})
        if name == "gpu":
            cfg = CallConfig(genomes=refs, reads=fqs[:1], output=str(tmp_path / "sync"),
                             batch_size=4096)
            counted = engine._count_job(fqs[:1], cfg, index.k, gpu, upload=True)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                pending = engine._map_one(counted, index, dev, cfg)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            assert isinstance(pending, engine.PendingMap) and pending.path == want_path
            mapped = pending.resolve(index, dev)
            assert mapped.best == results[0].best
            np.testing.assert_array_equal(mapped.tallies, results[0].tallies)
            np.testing.assert_array_equal(mapped.pileup, results[0].pileup)
    for name in ("gpu", "gpu_two_pass"):
        for got, want in zip(runs[name][0], runs["cpu"][0]):
            assert got.best == want.best == 0
            np.testing.assert_array_equal(got.tallies, want.tallies)
            np.testing.assert_array_equal(got.pileup, want.pileup)
        assert runs[name][1] == runs["cpu"][1]


def _words(rng, U, G, device):
    """(U, ceil(G/8)) int64 histogram words: bytes 0 or 1 (so k-mers come
    out perfect, unique and variant), 128-255 in the top byte of every
    word in a tenth of the rows (bit 63 set), zero past genome G."""
    W = -(-G // 8)
    b = (rng.random((U, 8 * W)) < 0.85).astype(np.uint64)
    top = rng.random(U) < 0.1
    b[top, 7::8] = rng.integers(128, 256, size=(int(top.sum()), W))
    b[:, G:] = 0
    words = (b.reshape(U, W, 8) << (np.uint64(8) * np.arange(8, dtype=np.uint64))).sum(axis=2)
    return torch.from_numpy(words.view(np.int64)).to(device)


@pytest.mark.parametrize("W,G,case", [(2, 9, "int32_words"), (2, 16, "j13"),
                                      (4, 32, "int32_words"), (4, 32, "zero_counts"),
                                      (5, 40, "k31_wrap"), (5, 37, "skewed")])
def test_probe_tally_words_equals_plain_on_the_card(gpu, W, G, case):
    """Kernel (b) on the multi-word histogram against its plain version:
    start, h (B, J, W), the batch's lanes and the tallies added into, one
    launch. G = 9, 37: the last word's bytes past G are unused; bit 63 set
    in a tenth of the rows; J = 13 and 26 sum a k-mer's hits by
    shared-memory adds; zero counts; every key below 2^64-1 in one slot."""
    q, counts, keys, directory, offsets, _, _ = _probe_inputs(case, gpu, len(case) + W)
    rng = np.random.default_rng(G)
    hist = _words(rng, keys.shape[0], G, gpu)
    assert hist.shape[1] == W
    # k-mers 10-59 query one key J times (_probe_inputs): that key's row
    # holds one posting of one genome, so the k-mer is perfect and unique
    rows, hit = cuda_map._probe(q[10:60, :1], keys)
    one = torch.from_numpy(rng.integers(0, G, size=50)).to(gpu)
    unique = torch.zeros((50, W), dtype=torch.int64, device=gpu)
    unique[torch.arange(50, device=gpu), one // 8] = 1 << (8 * (one % 8))
    hist[rows[hit[:, 0], 0]] = unique[hit[:, 0]]
    tallies = torch.from_numpy(rng.integers(0, 100, size=(G, 3)).astype(np.int32)).to(gpu)
    want_tallies, tallies0 = tallies.clone(), tallies.clone()
    before = cuda_lib.LAUNCHES["probe_tally"]
    got = cuda_map.probe_tally(q, counts, keys, directory, offsets, hist, tallies)
    want = cuda_map.probe_tally_plain(q, counts, keys, directory, offsets, hist, want_tallies)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["probe_tally"] == before + 1
    assert got[1].shape == (*q.shape, W)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert torch.equal(tallies, want_tallies)
    added = tallies - tallies0
    assert (got[1] < 0).any() and int(added[:, 1].sum()) > 0
    assert int(added[:, 0].sum()) >= int(added[:, 2].sum()) > 0


@pytest.mark.parametrize("post_bytes", [4, 8])
@pytest.mark.parametrize("best", [3, 12, 31])
def test_walk_scatter_words_equals_plain_on_the_card(gpu, post_bytes, best):
    """Kernel (c) from W = 4 saved words a row, genome `best` in the first,
    a middle and the last word: bytes of up to 255 (bit 63 set), so the
    offset (every byte below `best`) passes 255; int32 postings, and
    int64 ones at the genome's file base read on the card."""
    W = 4
    pc, start, _, _, postings, bases, zero = _walk_inputs(
        post_bytes, gpu, best, owner=best, G=8 * W, tail=8 * W)
    rng = np.random.default_rng(best)
    hw = rng.integers(0, 256, size=(*start.shape, 8 * W), dtype=np.uint64)
    hw[rng.random(tuple(start.shape)) < 0.3] = 0
    h = torch.from_numpy((hw.reshape(*start.shape, W, 8)
                          << (np.uint64(8) * np.arange(8, dtype=np.uint64))
                          ).sum(axis=-1).view(np.int64)).to(gpu)
    kw = {"h": h, "best": torch.full((1,), best, dtype=torch.int64, device=gpu),
          "file_base": None if post_bytes == 4 else bases}
    k = pc.shape[0] // start.shape[0]
    got, want = zero.clone(), zero.clone()
    before = cuda_lib.LAUNCHES["walk_scatter"]
    cuda_map.walk_scatter(got, pc, start, postings, k=k, **kw)
    cuda_map.walk_scatter_plain(want, pc, start, postings, k=k, **kw)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["walk_scatter"] == before + 1
    lanes = int(hw[..., best].sum())
    assert torch.equal(got, want) and int(got[2:].sum()) == lanes > 0
    assert (h < 0).any()


def _hits_inputs(G, device, seed, B=3_001, J=16, P=300_000, grouped=True, int64=False):
    """Rows (start, lens) (B, J) int32 over P postings (lengths 0 to 600,
    two fifths empty), and the postings' genomes: int32 ids in runs of
    one genome (grouped buckets) or drawn one by one, or int64 global
    postings carrying them."""
    rng = np.random.default_rng(seed)
    if grouped:
        runs = rng.integers(1, 40, size=P)
        fids = np.repeat(rng.integers(0, G, size=P), runs)[:P]
    else:
        fids = rng.integers(0, G, size=P)
    start = rng.integers(0, P, size=(B, J)).astype(np.int32)
    lens = rng.integers(0, 600, size=(B, J)).astype(np.int32)
    lens[rng.random((B, J)) < 0.4] = 0
    src = fids.astype(np.int32)
    if int64:
        src = ((rng.integers(0, 1 << 30, size=P) << 22) | (fids.astype(np.int64) << 6)
               | rng.integers(0, 64, size=P))
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return to(start), to(lens), to(src)


def _hits_equal_plain(start, lens, src, G):
    before = cuda_lib.LAUNCHES["walk_hits"]
    got = cuda_map.walk_hits(start, lens, src, G)
    want = cuda_map.walk_hits_plain(start, lens, src, G)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["walk_hits"] == before + 1
    assert got.dtype == torch.int32 and torch.equal(got, want)
    return got


@pytest.mark.parametrize("G,case", [
    (4, "grouped"), (32, "grouped"), (32, "ungrouped"), (32, "j13"), (300, "grouped"),
    (300, "int64"), (20_000, "grouped"), (60_000, "grouped"), (60_000, "int64")])
def test_walk_hits_equals_plain_on_the_card(gpu, G, case):
    """Kernel (d) against its plain version, exactly, on each branch: the
    counters of many k-mers a block in shared memory (G = 4, 32, 300), of
    one k-mer a block past 48 KB of dynamic shared memory (G = 20,000),
    and in global memory with atomics (G = 60,000, past 227 KB); int32
    genome ids in one-genome runs (grouped buckets) or drawn one by one,
    and int64 global postings; J = 13."""
    B = 3_001 if G <= 300 else 401
    start, lens, src = _hits_inputs(G, gpu, G, B=B, J=13 if case == "j13" else 16,
                                    grouped=case != "ungrouped", int64=case == "int64")
    got = _hits_equal_plain(start, lens, src, G)
    cut = torch.minimum(lens, src.shape[0] - start)  # ranges stop at the postings' end
    assert int(got.sum()) == int(cut.sum()) and int(got.max()) > 1


def test_walk_hits_edges_on_the_card(gpu):
    """(d) on duplicate rows (hits past J), zero-length and negative-start
    rows, a range past the postings' end (walked up to it), genome ids
    outside [0, G) (counted nowhere), and a batch whose last block holds
    fewer k-mers."""
    start, lens, src = _hits_inputs(32, gpu, 3, B=1_001, P=5_000)
    P = src.shape[0]
    start[0], lens[0] = 7, 300
    start[1, 0], lens[1, 0] = P - 3, 200
    start[2, 0] = -4
    src[:40] = torch.tensor([32, -1, 99] * 13 + [5], dtype=torch.int32)
    got = _hits_equal_plain(start, lens, src, 32)
    assert int(got[0].max()) >= 16 * 2 and int(got.sum()) < int(lens.sum())


def test_walk_hits_walks_a_row_of_2_25_postings(gpu):
    """(d) on a row of 2^25 postings beside short rows: the block shares it
    among its threads; the same hits as the plain version."""
    P = (1 << 25) + 4_096
    start, lens, _ = _hits_inputs(12, gpu, 11, B=64, P=4_096)
    rng = np.random.default_rng(11)
    src = torch.from_numpy(rng.integers(0, 12, size=P).astype(np.int32)).to(gpu)
    lens[5, 3] = 1 << 25
    start[5, 3] = 1_000
    got = _hits_equal_plain(start, lens, src, 12)
    assert int(got[5].sum()) >= 1 << 25 and int(got.sum()) == int(lens.sum())


def _scatter_panel(tmp_path, n, poly_a):
    rng = np.random.default_rng(n)
    base = make_genome(rng, 1500)
    genomes = []
    for i in range(n):
        g = bytearray(base)
        for p in rng.integers(0, len(g), 8):
            g[p] = b"ACGT"[(b"ACGT".index(g[p]) + 1) % 4]
        if poly_a:
            g[1200:1200] = b"A" * 300
        genomes.append(str(tmp_path / f"g{i}.fasta"))
        write_fasta(genomes[-1], f"g{i}", bytes(g))
    # 3,000 windows of the base genome (a tenth with one base changed) as
    # 2-bit k-mer ids, first base highest
    seq = np.frombuffer(base, np.uint8)
    win = seq[rng.integers(0, len(seq) - 21, size=3_000)[:, None] + np.arange(21)]
    codes = np.searchsorted(np.frombuffer(b"ACGT", np.uint8), win).astype(np.uint64)
    mut = rng.random(codes.shape[0]) < 0.1
    codes[mut, 10] = (codes[mut, 10] + np.uint64(1)) % np.uint64(4)
    ids = (codes << (np.uint64(2) * np.arange(20, -1, -1, dtype=np.uint64))).sum(axis=1)
    return build_index(21, genomes), ids


@pytest.mark.parametrize("n,poly_a", [(13, False), (9, True)])
def test_probe_scatter_on_the_card_equals_the_cpu(gpu, tmp_path, n, poly_a):
    """map_batch over the whole index (K1, K2, (c) by ranges on the int64
    global postings and (d) on the same ranges), enqueued under
    set_sync_debug_mode('error'), and the flat tally likewise: equal to
    the CPU run, with (c) and (d) launched once each for the batch."""
    index, ids = _scatter_panel(tmp_path, n, poly_a)
    counts = np.random.default_rng(n).integers(0, 50, size=ids.shape[0]).astype(np.int32)
    out = {}
    for device in (torch.device("cpu"), gpu):
        dev = build_device_index(index, device)
        cfg = dev.map_config(2, False)
        kmers, cts = from_u64(ids, device), torch.from_numpy(counts).to(device)
        postings, _ = dev.global_postings(), dev.posting_fids()
        zero = torch.zeros((4, dev.total_len + 1, 4), dtype=torch.int32, device=device)
        tallies0 = torch.zeros((dev.num_genomes, 3), dtype=torch.int32, device=device)
        before = dict(cuda_lib.LAUNCHES)
        if device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            got = tm.map_batch(kmers, cts, dev.keys_ordered, dev.offsets, postings, zero,
                               tallies0, cfg=cfg)
            flat = tm.tally([(kmers, cts)], dev, cfg, "flat")
        finally:
            torch.cuda.set_sync_debug_mode("default")
        out[device.type] = [t.cpu() for t in (*got, *flat)]
        if device.type == "cuda":
            launched = {k: cuda_lib.LAUNCHES[k] - before[k] for k in before}
            assert launched["walk_scatter"] == 1 and launched["walk_hits"] == 2
    for g, w in zip(out["cuda"], out["cpu"]):
        assert torch.equal(g, w)
    assert int(out["cpu"][1][:, 0].sum()) > 0 and int(out["cpu"][0][2:].sum()) > 0


def test_panel_wrappers_reject_what_the_kernels_do_not_take(gpu):
    """(b) words: int32 words, more genomes than 8W; (c): W int32 words a
    row; (d): J past 256, lens of another shape, int16 genome ids, G = 0.
    The C entries refuse B*J >= 2^31 (and (d) J past 256) before reading
    a pointer."""
    q, counts, keys, directory, offsets, _, tallies = _probe_inputs("int32_words", gpu, 0,
                                                                    B=64)
    hist = _words(np.random.default_rng(0), keys.shape[0], 16, gpu)
    with pytest.raises(ValueError):
        cuda_map.probe_tally(q, counts, keys, directory, offsets, hist.to(torch.int32),
                             tallies)
    with pytest.raises(ValueError):
        cuda_map.probe_tally(q, counts, keys, directory, offsets, hist,
                             torch.zeros((17, 3), dtype=torch.int32, device=gpu))
    pc, start, _, _, postings, _, zero = _walk_inputs(4, gpu, 0, B=8)
    h = torch.zeros((*start.shape, 3), dtype=torch.int32, device=gpu)
    best = torch.zeros(1, dtype=torch.int64, device=gpu)
    with pytest.raises(ValueError):
        cuda_map.walk_scatter(zero, pc, start, postings, k=21, h=h, best=best)
    start, lens, src = _hits_inputs(8, gpu, 0, B=4, J=16)
    wide = torch.zeros((2, 257), dtype=torch.int32, device=gpu)
    for args in ((wide, wide, src, 8), (start, lens[:, :3], src, 8),
                 (start, lens, src.to(torch.int16), 8), (start, lens, src, 0)):
        with pytest.raises(ValueError):
            cuda_map.walk_hits(*args)
    lib = cuda_lib.library()
    assert lib.bronko_probe_tally_words(0, None, None, 1 << 27, 16, None, 1, None, 0, 0, 0,
                                        None, None, 4, 32, None, None, None, None, None) != 0
    assert lib.bronko_probe_tally_words(0, None, None, 8, 16, None, 1, None, 0, 0, 0,
                                        None, None, 2, 17, None, None, None, None, None) != 0
    assert lib.bronko_walk_hits(0, None, None, 1 << 27, 16, None, 4, 0, 8, None, None) != 0
    assert lib.bronko_walk_hits(0, None, None, 4, 257, None, 4, 0, 8, None, None) != 0
    assert lib.bronko_walk_scatter_words(0, None, 21, 16, None, None, None, 4, 3, None, None,
                                         4, 0, None, 0, 16, None, 4, None) != 0
