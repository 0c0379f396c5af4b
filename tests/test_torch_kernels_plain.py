"""Plain PyTorch versions of kernels K1 (bucket queries) and K2 (fold
table) against the Pallas kernels they port, run in interpret mode as
tests/test_pallas_buckets.py runs them; and the wrappers' dispatch rule."""

import functools
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from bronko_tpu.ops.buckets import filtered_bucket_positions  # noqa: E402
from bronko_tpu_torch.ops import cuda_buckets as cb, cuda_lib  # noqa: E402
from bronko_tpu_torch.ops.codec import from_u64, to_u64  # noqa: E402

CPU = torch.device("cpu")


def _interpret(fn, *args):
    from jax.experimental import pallas as pl

    orig = pl.pallas_call
    with mock.patch.object(pl, "pallas_call", functools.partial(orig, interpret=True)):
        return fn(*args)


def _pallas_queries(kmers, k, positions):
    from bronko_tpu.ops import pallas_buckets

    q, canon, is_rc = _interpret(pallas_buckets.bucket_queries_pallas,
                                 kmers, k, tuple(positions))
    return np.asarray(q), np.asarray(canon), np.asarray(is_rc)


def _check_queries(kmers, k, positions):
    want = _pallas_queries(kmers, k, positions)
    q, canon, is_rc = cb.bucket_queries_plain(from_u64(kmers, CPU), k, positions)
    np.testing.assert_array_equal(to_u64(q), want[0])
    np.testing.assert_array_equal(to_u64(canon), want[1])
    np.testing.assert_array_equal(is_rc.numpy(), want[2])


@pytest.mark.parametrize("k", [15, 21, 31])
def test_bucket_queries_plain_matches_pallas(k):
    rng = np.random.default_rng(7 + k)
    kmers = rng.integers(0, 1 << (2 * k), size=300, dtype=np.uint64)
    _check_queries(kmers, k, filtered_bucket_positions(k, 3, False))


def test_bucket_queries_plain_k31_wrap():
    rng = np.random.default_rng(99)
    top = (np.uint64(1) << np.uint64(62)) - np.uint64(1)
    kmers = top - rng.integers(0, 1 << 20, size=1024, dtype=np.uint64)
    _check_queries(kmers, 31, filtered_bucket_positions(31, 3, False))


@pytest.mark.parametrize("k", [15, 31])
def test_bucket_queries_plain_full_kmer_positions(k):
    rng = np.random.default_rng(3 + k)
    kmers = rng.integers(0, 1 << (2 * k), size=256, dtype=np.uint64)
    _check_queries(kmers, k, tuple(range(k)))


@pytest.mark.parametrize("k", range(1, 32))
def test_fold_table_plain_matches_pallas(k):
    """Every k the Pallas kernel and K2 take, across the (hi, lo) split at
    k = 16 / 17: the plain version holds K2's edges to the JAX package."""
    from bronko_tpu.ops import pallas_buckets

    rng = np.random.default_rng(13 + k)
    kmers = rng.integers(0, 1 << (2 * k), size=300, dtype=np.uint64)
    counts = rng.integers(0, 1_000_000, size=300, dtype=np.int32)
    want = np.asarray(_interpret(pallas_buckets.fold_table_pallas, kmers, counts, k))
    got = cb.fold_table_plain(from_u64(kmers, CPU), torch.from_numpy(counts), k)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_cpu_tensors_take_the_plain_version_without_a_launch():
    rng = np.random.default_rng(5)
    kmers = from_u64(rng.integers(0, 1 << 42, size=64, dtype=np.uint64), CPU)
    counts = torch.from_numpy(rng.integers(0, 50, size=64, dtype=np.int32))
    before = dict(cuda_lib.LAUNCHES)
    positions = tuple(filtered_bucket_positions(21, 2, False))
    for got, want in zip(cb.bucket_queries(kmers, 21, positions),
                         cb.bucket_queries_plain(kmers, 21, positions)):
        assert torch.equal(got, want)
    assert torch.equal(cb.fold_table(kmers, counts, 21),
                       cb.fold_table_plain(kmers, counts, 21))
    assert cuda_lib.LAUNCHES == before


def test_other_devices_raise_instead_of_falling_back():
    """Only CPU tensors reach the plain version; anything else must be a
    CUDA tensor the kernel takes, or the wrapper raises."""
    kmers = torch.empty(8, dtype=torch.int64, device="meta")
    counts = torch.empty(8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        cb.bucket_queries(kmers, 21, (2, 3))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        cb.fold_table(kmers, counts, 21)


def test_launch_counts_are_exact_across_threads(monkeypatch):
    """Kernels launch from the count workers and the main thread at once:
    8 threads adding through count_launch lose no count."""
    import sys
    import threading

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads as often as the GIL allows
    try:
        monkeypatch.setitem(cuda_lib.LAUNCHES, "pack_windows", 0)
        start = threading.Barrier(8)

        def launch():
            start.wait()
            for _ in range(20_000):
                cuda_lib.count_launch("pack_windows")

        threads = [threading.Thread(target=launch) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert cuda_lib.LAUNCHES["pack_windows"] == 8 * 20_000
    finally:
        sys.setswitchinterval(interval)
