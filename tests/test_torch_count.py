"""The port's device k-mer counter (ops/count.py: the plain version of K3,
the chunk count, the sample merge) and the plain version of K4 (gather)
against the JAX package, exactly: every output is an integer array."""

import functools
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from bronko_tpu.io.fastq import _encode_reads  # noqa: E402
from bronko_tpu.ops import count as jax_count  # noqa: E402
from bronko_tpu_torch.ops import count, cuda_gather, cuda_lib  # noqa: E402
from bronko_tpu_torch.ops.codec import to_u64  # noqa: E402
from tests.test_count import random_reads  # noqa: E402


def _codes(rng, R, L):
    """(R, L) codes 0..5 (about 1 in 50 invalid), one all-invalid row, one
    all-valid row, and lengths from below k to above L."""
    codes = rng.integers(0, 4, size=(R, L)).astype(np.uint8)
    bad = rng.random((R, L)) < 0.02
    codes[bad] = rng.integers(4, 6, size=int(bad.sum()))
    codes[R // 2] = 4
    codes[0] = rng.integers(0, 4, size=L)
    lengths = rng.integers(0, L + 20, size=R).astype(np.int32)
    lengths[0], lengths[-1] = L + 7, 3
    return codes, lengths


def _reads(rng, n):
    """tests/test_count.py's reads (half of them repeats), with about 1 base
    in 50 an N, so that windows of every k up to 31 are valid."""
    reads = []
    for r in random_reads(rng, n, lmin=40, lmax=100, with_n=False):
        r = bytearray(r)
        for p in np.flatnonzero(rng.random(len(r)) < 0.02):
            r[p] = ord("N")
        reads.append(bytes(r))
    return reads


def _torch(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


@pytest.mark.parametrize("shape", [(130, 64), (7, 40)])
@pytest.mark.parametrize("k", [15, 21, 31])
def test_pack_windows_plain_matches_xla(k, shape):
    codes, lengths = _codes(np.random.default_rng(k + shape[0]), *shape)
    want_words, want_valid = jax_count._pack_windows_xla(
        jnp.asarray(codes), jnp.asarray(lengths), k)
    words, valid = count.pack_windows_plain(*_torch(codes, lengths), k)
    assert words.dtype == torch.int64 and valid.dtype == torch.bool
    np.testing.assert_array_equal(to_u64(words), np.asarray(want_words))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want_valid))
    assert valid.any() and not valid.all()


@pytest.mark.parametrize("edge", ["L=k", "L=k+1", "L=33", "one row of 4099"])
@pytest.mark.parametrize("k", [15, 21, 31])
def test_pack_windows_plain_matches_xla_at_the_kernel_edges(k, edge):
    """K3's tile edges through its plain version: one window a row, two,
    a row across a 32-code plane word, and one row longer than K3's
    row tile (a column-tiled row on the card)."""
    R, L = {"L=k": (70, k), "L=k+1": (70, k + 1), "L=33": (70, 33),
            "one row of 4099": (1, 4099)}[edge]
    codes, lengths = _codes(np.random.default_rng(k * L), R, L)
    if R == 1:
        lengths[0] = L - 5
    want_words, want_valid = jax_count._pack_windows_xla(
        jnp.asarray(codes), jnp.asarray(lengths), k)
    words, valid = count.pack_windows_plain(*_torch(codes, lengths), k)
    assert words.shape == valid.shape == (R, L - k + 1)
    np.testing.assert_array_equal(to_u64(words), np.asarray(want_words))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want_valid))


@pytest.mark.parametrize("k", [15, 21, 31])
def test_pack_windows_plain_matches_pallas(k):
    """The Pallas kernel in interpret mode, as tests/test_count.py runs it:
    equal validity, equal words on valid windows."""
    from jax.experimental import pallas as pl

    from bronko_tpu.ops import pallas_pack

    rng = np.random.default_rng(3 + k)
    codes = rng.integers(0, 6, size=(64, 96)).astype(np.uint8)
    lengths = rng.integers(10, 96, size=64).astype(np.int32)
    with mock.patch.object(pl, "pallas_call",
                           functools.partial(pl.pallas_call, interpret=True)):
        want_words, want_valid = pallas_pack.pack_windows_pallas(
            jnp.asarray(codes), jnp.asarray(lengths), k)
    words, valid = count.pack_windows_plain(*_torch(codes, lengths), k)
    want_valid = np.asarray(want_valid)
    np.testing.assert_array_equal(valid.numpy(), want_valid)
    np.testing.assert_array_equal(to_u64(words)[want_valid],
                                  np.asarray(want_words)[want_valid])


@pytest.mark.parametrize("k", [15, 21, 31])
def test_extract_and_count_chunk_matches_jax(k):
    rng = np.random.default_rng(40 + k)
    codes, lengths = _encode_reads(_reads(rng, 200))
    want_k, want_c, n_unique, n_total = jax_count.extract_and_count_chunk(
        jnp.asarray(codes), jnp.asarray(lengths), k)
    kmers, counts, total = count.extract_and_count_chunk(*_torch(codes, lengths), k)
    n_unique = int(n_unique)
    assert total == int(n_total) > 0
    assert kmers.numel() == n_unique and counts.dtype == torch.int32
    np.testing.assert_array_equal(to_u64(kmers), np.asarray(want_k)[:n_unique])
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want_c)[:n_unique])
    assert int(counts.max()) > 1  # duplicated reads: counts above 1


def _count_both(chunks, k, min_count, count_cap=None):
    want = jax_count.KmerCounter(k, min_count, count_cap)
    got = count.KmerCounter(k, min_count, count_cap, device=torch.device("cpu"))
    for codes, lengths, n in chunks:
        want.add_chunk(codes, lengths, n)
        got.add_chunk(codes, lengths, n)
    return want.finalize(), want.stats, got.finalize(), got.stats


@pytest.mark.parametrize("case", ["chunks", "count_cap", "row_slices"])
def test_kmer_counter_matches_jax(case, monkeypatch):
    """Several chunks with ci = 3, as tests/test_count.py counts them:
    the merged arrays and all four stats equal JAX's; row_slices packs
    each chunk in slices of a few rows."""
    if case == "row_slices":
        monkeypatch.setattr(count, "MAX_WINDOWS", 500)
    rng = np.random.default_rng(11)
    reads = _reads(rng, 300)
    chunks = [(*_encode_reads(reads[lo:lo + 100]), len(reads[lo:lo + 100]))
              for lo in range(0, len(reads), 100)]
    kw = {"count_cap": 3} if case == "count_cap" else {}
    (wk, wc), wstats, (gk, gc), gstats = _count_both(chunks, 21, 3, **kw)
    assert gk.dtype == np.uint64 and gc.dtype == np.int64
    np.testing.assert_array_equal(gk, wk)
    np.testing.assert_array_equal(gc, wc)
    assert gstats == count.CountStats(**vars(wstats))
    assert gstats.unique_counted_kmers < gstats.unique_kmers
    assert np.all(gk[1:] > gk[:-1])
    if case == "count_cap":
        assert gc.max() == 3


def test_kmer_counter_cap_after_the_sum():
    """tests/test_count.py::test_counter_count_cap: 26 windows x 5 reads of
    poly-A, capped at 10, in two chunks."""
    codes, lengths = _encode_reads([b"A" * 40] * 5)
    chunks = [(codes[:2], lengths[:2], 2), (codes[2:], lengths[2:], 3)]
    (wk, wc), wstats, (gk, gc), gstats = _count_both(chunks, 15, 1, count_cap=10)
    assert gk.tolist() == wk.tolist() == [0]
    assert gc.tolist() == wc.tolist() == [10]
    assert gstats == count.CountStats(**vars(wstats))


@pytest.mark.parametrize("case", ["shorter_than_k", "all_invalid", "empty"])
def test_kmer_counter_without_kmers(case):
    """Chunks that hold no valid k-mer (tests/test_count.py:113-160)
    finalize to empty arrays and count their reads."""
    k, min_count = {"shorter_than_k": (31, 1), "all_invalid": (21, 3), "empty": (21, 1)}[case]
    if case == "shorter_than_k":
        codes = np.full((4, 16), 4, np.uint8)
        codes[:, :10] = 0
        chunks = [(codes, np.full(4, 10, np.int32), 4)]
    elif case == "all_invalid":
        chunks = [(np.full((8, 32), 4, np.uint8), np.full(8, 30, np.int32), 8)]
    else:
        chunks = []
    (wk, wc), wstats, (gk, gc), gstats = _count_both(chunks, k, min_count)
    assert gk.size == gc.size == wk.size == wc.size == 0
    assert gk.dtype == np.uint64 and gc.dtype == np.int64
    assert gstats == count.CountStats(**vars(wstats))
    assert gstats.total_reads == sum(c[2] for c in chunks)


def test_kmer_counter_needs_a_device():
    """No default device: a counter never lands on the CPU unless asked."""
    with pytest.raises(TypeError):
        count.KmerCounter(21, 1)
    assert count.KmerCounter(21, 1, device=torch.device("cpu")).device.type == "cpu"


def test_pack_windows_refuses_rows_narrower_than_k():
    codes = torch.zeros((2, 20), dtype=torch.uint8)
    with pytest.raises(ValueError, match="no 21-mer"):
        count.pack_windows(codes, torch.full((2,), 20, dtype=torch.int32), 21)


@pytest.mark.parametrize("U,N", [(1, 5), (1000, 4099)])
def test_gather_plain_matches_jax(U, N):
    rng = np.random.default_rng(U)
    tbl = rng.integers(-(1 << 30), 1 << 30, size=U, dtype=np.int32)
    idx = rng.integers(0, U, size=N, dtype=np.int32)
    want = np.asarray(jnp.asarray(tbl)[jnp.asarray(idx)])
    got = cuda_gather.gather_plain(*_torch(tbl, idx))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bad", [-1, 8])
def test_gather_plain_raises_outside_the_table(bad):
    tbl = torch.arange(8, dtype=torch.int32)
    with pytest.raises(IndexError):
        cuda_gather.gather_plain(tbl, torch.tensor([0, bad, 3], dtype=torch.int32))


def test_cpu_tensors_take_the_plain_versions_without_a_launch():
    codes, lengths = _codes(np.random.default_rng(2), 9, 40)
    before = dict(cuda_lib.LAUNCHES)
    for got, want in zip(count.pack_windows(*_torch(codes, lengths), 21),
                         count.pack_windows_plain(*_torch(codes, lengths), 21)):
        assert torch.equal(got, want)
    tbl, idx = torch.arange(10, dtype=torch.int32), torch.tensor([9, 0, 4], dtype=torch.int32)
    assert torch.equal(cuda_gather.gather(tbl, idx), cuda_gather.gather_plain(tbl, idx))
    assert cuda_lib.LAUNCHES == before


def test_other_devices_raise_instead_of_falling_back():
    codes = torch.empty((4, 40), dtype=torch.uint8, device="meta")
    lengths = torch.empty(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        count.pack_windows(codes, lengths, 21)
    idx = torch.empty(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        cuda_gather.gather(torch.empty(8, dtype=torch.int32, device="meta"), idx)
