"""The port's codec and bucket hash (int64 tensors holding uint64 bits)
against bronko_tpu.ops.codec / buckets on numpy, exactly."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from bronko_tpu.ops import buckets as jb  # noqa: E402
from bronko_tpu.ops import codec as jc  # noqa: E402
from bronko_tpu_torch.ops import buckets as tb  # noqa: E402
from bronko_tpu_torch.ops import codec as tc  # noqa: E402
from tests.test_buckets import GOLDEN_19  # noqa: E402

CPU = torch.device("cpu")


def _wrap_kmers(rng, n=1024):
    """Near-all-T k=31 k-mers: mu_0 passes 2^63, so the hash wraps."""
    top = (np.uint64(1) << np.uint64(62)) - np.uint64(1)
    return top - rng.integers(0, 1 << 20, size=n, dtype=np.uint64)


def _numpy_buckets(canon, k):
    with np.errstate(over="ignore"):
        return jb.assign_buckets(canon, k, np)


@pytest.mark.parametrize("k", [15, 21, 31])
def test_codec_matches_numpy(k):
    rng = np.random.default_rng(100 + k)
    kmers = rng.integers(0, 1 << (2 * k), size=500, dtype=np.uint64)
    t = tc.from_u64(kmers, CPU)
    np.testing.assert_array_equal(tc.to_u64(tc.revcomp(t, k)), jc.revcomp(kmers, k, np))
    canon, is_rc = tc.canonical(t, k)
    want_c, want_rc = jc.canonical(kmers, k, np)
    np.testing.assert_array_equal(tc.to_u64(canon), want_c)
    np.testing.assert_array_equal(is_rc.numpy(), want_rc)


@pytest.mark.parametrize("k", [15, 21, 31])
def test_assign_buckets_matches_numpy(k):
    rng = np.random.default_rng(200 + k)
    kmers = rng.integers(0, 1 << (2 * k), size=500, dtype=np.uint64)
    if k == 31:
        kmers = np.concatenate([kmers, _wrap_kmers(rng)])
    canon, _ = jc.canonical(kmers, k, np)
    got = tc.to_u64(tb.assign_buckets(tc.from_u64(canon, CPU), k))
    np.testing.assert_array_equal(got, _numpy_buckets(canon, k))


def test_k31_wrap_sets_bit_63():
    """The wrap inputs really produce bucket ids >= 2^63, whose bits the
    int64 arithmetic must keep."""
    rng = np.random.default_rng(99)
    canon, _ = jc.canonical(_wrap_kmers(rng), 31, np)
    got = tc.to_u64(tb.assign_buckets(tc.from_u64(canon, CPU), 31))
    assert (got >= np.uint64(1 << 63)).any()
    np.testing.assert_array_equal(got, _numpy_buckets(canon, 31))


def test_golden_vectors():
    """lcb.rs:147-154 unit vectors, as anchored by tests/test_buckets.py."""
    a = tb.assign_buckets(tc.from_u64(np.array([0], np.uint64), CPU), 4)
    assert tc.to_u64(a)[0].tolist() == [1, 2, 3, 4]
    g = tb.assign_buckets(tc.from_u64(np.array([41547505179], np.uint64), CPU), 19)
    assert tc.to_u64(g)[0].tolist() == GOLDEN_19


def test_word_roundtrip_keeps_bit_63():
    words = np.array([0, 1, (1 << 63) - 1, 1 << 63, (1 << 64) - 1], np.uint64)
    t = tc.from_u64(words, CPU)
    assert t.dtype == torch.int64
    np.testing.assert_array_equal(tc.to_u64(t), words)
