"""Kernels K1-K4, the port's main path (with the host and the device
counter), the index built on the card and a device-counter cohort on two
count workers, on a CUDA card, against the plain PyTorch versions on the
same card, the host layout and the CPU run. Skipped without a card; on
one: python -m pytest tests/test_torch_cuda.py -m cuda"""

import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from bronko_tpu_torch.call.engine import run_call  # noqa: E402
from bronko_tpu_torch.config import CallConfig  # noqa: E402
from bronko_tpu_torch.index.build import build_index  # noqa: E402
from bronko_tpu_torch.index.layout import build_device_index  # noqa: E402
from bronko_tpu_torch.index.model import BronkoIndex  # noqa: E402
from bronko_tpu_torch.ops.buckets import filtered_bucket_positions  # noqa: E402
from bronko_tpu_torch.ops import count, cuda_gather  # noqa: E402
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


@pytest.mark.parametrize("case,path", [
    ("g12", ("words", "saved")), ("polyA9", ("flat", "subindex")),
    ("ungrouped", ("hist", "subindex"))])
def test_panel_paths_on_the_card_equal_the_cpu(gpu, tmp_path, case, path):
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
    results = {}
    for name, device in (("cpu", torch.device("cpu")), ("gpu", gpu)):
        cfg = CallConfig(genomes=genomes, reads=[fq], output=str(tmp_path / name),
                         output_pileup=True, batch_size=4096)
        before = dict(cuda_lib.LAUNCHES)
        (results[name],) = run_call(cfg, index, build_device_index(index, device))
        assert results[name].path == path
    assert all(cuda_lib.LAUNCHES[k] > before[k] for k in ("bucket_queries", "fold_table"))
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
