"""The port's genome-sharded index against bronko_tpu's split_index, row by
row on every shard, for 1-4 shards on the four histogram regimes: the
int32 word (G <= 4), the int64 word with bit 63 set (G = 8), the
multi-word histogram (13 strains) and the flat tally (a bucket of more
than 255 postings); and ShardedIndex.from_jax, which carries JAX's padded
shards across."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from bronko_tpu.index.layout import KEY_SENTINEL  # noqa: E402
from bronko_tpu.parallel.pipeline import split_index as jax_split_index  # noqa: E402
from bronko_tpu_torch.index.model import from_jax_index  # noqa: E402
from bronko_tpu_torch.parallel import pipeline  # noqa: E402
from tests.test_map import make_index, random_genome  # noqa: E402

POLY_A = b"A" * 300  # 280 all-A windows a genome: a bucket of 280 postings each


def strains(rng, n, length=300, snps=4, tail=b"", contigs=False):
    """n strains of one random genome, `snps` substitutions each, `tail`
    appended; with `contigs` every third strain gets a second contig."""
    base = random_genome(rng, length)
    files = []
    for i in range(n):
        g = bytearray(base)
        for p in rng.integers(0, length, snps):
            g[p] = b"ACGT"[(b"ACGT".index(g[p]) + 1 + rng.integers(3)) % 4]
        seqs = [(f"s{i}", bytes(g) + tail)]
        if contigs and i % 3 == 0:
            seqs.append((f"s{i}b", random_genome(rng, 60 + i)))
        files.append((f"g{i}", seqs))
    return files


def panel_files(name: str):
    """The four regimes' panels: (genome files, tally mode)."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "g3":  # int32 word; genomes of unequal size balance unevenly
        return [(f"g{i}", [(f"s{i}", random_genome(rng, 200 + 70 * i))]
                 + ([(f"s{i}b", random_genome(rng, 90))] if i == 1 else []))
                for i in range(3)], "hist"
    if name == "g8_signbit":  # genome 7's poly-A buckets set bit 63 of the word
        files = [(f"g{i}", [(f"s{i}", random_genome(rng, 120 + 10 * i))]) for i in range(7)]
        return files + [("g7", [("s7", random_genome(rng, 60) + b"A" * 160)])], "hist"
    if name == "g13":
        return strains(rng, 13, contigs=True), "words"
    if name == "polyA5":
        return strains(rng, 5, length=150, tail=POLY_A), "flat"
    raise ValueError(name)


REGIMES = ("g3", "g8_signbit", "g13", "polyA5")


@pytest.fixture(scope="module")
def indexes(tmp_path_factory):
    out = {}
    for name in REGIMES:
        files, mode = panel_files(name)
        out[name] = (make_index(tmp_path_factory.mktemp(name), files, 21), mode)
    return out


def assert_same_shards(got: pipeline.ShardedIndex, want: pipeline.ShardedIndex) -> None:
    assert got.shard_files == want.shard_files
    np.testing.assert_array_equal(got.shard_len, want.shard_len)
    assert (got.t_pad, got.num_genomes, got.max_bucket, got.k) == \
           (want.t_pad, want.num_genomes, want.max_bucket, want.k)
    assert got.seq_slices == want.seq_slices
    np.testing.assert_array_equal(got.genome_lens, want.genome_lens)
    for a, b in zip(got.shards, want.shards, strict=True):
        for name in ("keys", "offsets", "postings", "hist", "hist_words"):
            x, y = getattr(a, name), getattr(b, name)
            assert (x is None) == (y is None), name
            if x is not None:
                assert x.dtype == y.dtype, name
                np.testing.assert_array_equal(x, y, err_msg=name)


@pytest.mark.parametrize("n_shards", [1, 2, 3, 4])
@pytest.mark.parametrize("name", REGIMES)
def test_split_index_matches_jax(indexes, name, n_shards):
    """Every shard: the file lists, shard_len, t_pad, seq_slices, and the
    real rows of keys, offsets, postings and the histogram equal JAX's
    (whose rows past them are sentinel padding); from_jax of JAX's shards
    equals the port's own split."""
    index, mode = indexes[name]
    want = jax_split_index(index, n_shards)
    got = pipeline.split_index(from_jax_index(index), n_shards)
    assert got.tally_mode() == mode
    assert got.shard_files == want.shard_files
    np.testing.assert_array_equal(got.shard_len, want.shard_len)
    assert (got.t_pad, got.num_genomes, got.max_bucket) == \
           (want.t_pad, want.num_genomes, want.max_bucket)
    assert [(s.file_id, s.seq_id, s.name, s.offset, s.length) for s in got.seq_slices] == \
           [(s.file_id, s.seq_id, s.name, s.offset, s.length) for s in want.seq_slices]
    for s, shard in enumerate(got.shards):
        u, n = shard.keys.shape[0], shard.postings.shape[0]
        np.testing.assert_array_equal(shard.keys, want.keys[s, :u])
        assert (want.keys[s, u:] == KEY_SENTINEL).all()
        np.testing.assert_array_equal(shard.offsets, want.offsets[s, :u + 1])
        np.testing.assert_array_equal(shard.postings, want.postings[s, :n])
        assert (want.postings[s, n:] == 0).all()
        # every shard's genomes, and only those, own its postings
        assert set(((shard.postings & 0x3FFFFF) >> 6).tolist()) <= set(got.shard_files[s])
        if mode == "hist":
            assert shard.hist.dtype == want.hist.dtype and shard.hist_words is None
            np.testing.assert_array_equal(shard.hist, want.hist[s, :u])
        elif mode == "words":
            assert shard.hist is None and want.hist is None
            np.testing.assert_array_equal(shard.hist_words, want.hist_words[s, :u])
        else:
            assert shard.hist is None and shard.hist_words is None
            assert want.hist is None and want.hist_words is None
    if name == "g8_signbit":
        assert any((s.hist < 0).any() for s in got.shards)
    assert sum(s.postings.shape[0] for s in got.shards) == index.num_postings
    assert_same_shards(pipeline.ShardedIndex.from_jax(want), got)


def test_from_jax_keeps_a_real_sentinel_bucket():
    """A shard whose last real bucket is keyed 2^64-1: JAX moves its range
    to the last padded row (fix_sentinel_collision: rows 4-5 of shard 0's
    offsets [0, 2, 3, 5, 5, 5] become 3, 5) and copies its histogram word
    there; from_jax cuts both back to the bucket's own row."""
    class JaxShards:
        k, t_pad, num_genomes, max_bucket = 21, 10, 2, 2
        keys = np.array([[5, 9, KEY_SENTINEL, KEY_SENTINEL, KEY_SENTINEL],
                         [7, KEY_SENTINEL, KEY_SENTINEL, KEY_SENTINEL, KEY_SENTINEL]],
                        np.uint64)
        offsets = np.array([[0, 2, 3, 5, 3, 5], [0, 1, 1, 1, 1, 1]], np.int32)
        postings = np.array([[0, 1, 2, 3, 4], [5, 0, 0, 0, 0]], np.int64)
        hist = np.array([[2, 1, 2, 0, 2], [1, 0, 0, 0, 0]], np.int32)
        hist_words = None
        shard_len = np.array([10, 4])
        shard_files = [[0], [1]]
        seq_slices = []
        genome_lens = np.array([10, 4])

    sh = pipeline.ShardedIndex.from_jax(JaxShards())
    assert sh.shards[0].keys.tolist() == [5, 9, int(KEY_SENTINEL)]
    assert sh.shards[0].offsets.tolist() == [0, 2, 3, 5]
    assert sh.shards[0].postings.tolist() == [0, 1, 2, 3, 4]
    assert sh.shards[0].hist.tolist() == [2, 1, 2]
    assert sh.shards[1].keys.tolist() == [7] and sh.shards[1].offsets.tolist() == [0, 1]
    assert sh.shards[1].postings.tolist() == [5] and sh.tally_mode() == "hist"


@pytest.mark.parametrize("mode", ["hist", "words", "flat"])
def test_upload_shard_of_no_genome(mode):
    """More shards than genomes leaves a shard without buckets; its upload
    holds one empty row that a probe may hit and that adds nothing."""
    W = 2
    shard = pipeline.Shard(
        keys=np.zeros(0, np.uint64), offsets=np.zeros(1, np.int32),
        postings=np.zeros(0, np.int64),
        hist=np.zeros(0, np.int64) if mode == "hist" else None,
        hist_words=np.zeros((0, W), np.int64) if mode == "words" else None)
    ds = pipeline.upload_shard(shard, mode, torch.device("cpu"))
    assert ds.keys_ordered.shape == (1,) and ds.offsets.tolist() == [0, 0]
    if mode == "flat":
        assert ds.hist is None and ds.posting_fids().shape == (0,)
    else:
        assert not ds.hist.any() and ds.hist.shape == ((1,) if mode == "hist" else (1, W))
