"""The slot directory in front of kernel (b)'s key search
(ops/cuda_map.probe_directory) on the CPU: the probe through it
(_probe_dir, which probe_tally_plain searches with) against the full
search `_probe`, row and hit, on the bench fixture's keys, on
hypothesis-drawn key sets (duplicates, 0, 2^64-1, keys on both sides of
2^63, every key in one slot), on one key, and on k = 31 bucket ids past
2^63; the directory's layout and its cache in DeviceIndex; and
probe_tally_plain against JAX's _tally_save_body on a skewed key set.
Every comparison is exact."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from bronko_tpu.ops import map as jm  # noqa: E402
from bronko_tpu_torch.index.build import build_index  # noqa: E402
from bronko_tpu_torch.index.device_build import build_device_index_on_device  # noqa: E402
from bronko_tpu_torch.index.layout import build_device_index  # noqa: E402
from bronko_tpu_torch.ops.buckets import filtered_bucket_positions  # noqa: E402
from bronko_tpu_torch.ops.codec import from_u64  # noqa: E402
from bronko_tpu_torch.ops.cuda_buckets import bucket_queries_plain  # noqa: E402
from bronko_tpu_torch.ops.cuda_map import (  # noqa: E402
    SIGN_BIT, _probe, _probe_dir, probe_directory, probe_tally_plain,
)
from make_synthetic import make_genome, write_fasta  # noqa: E402

CPU = torch.device("cpu")
TOP = (1 << 64) - 1
HALF = 1 << 63
EDGES = [0, 1, HALF - 1, HALF, HALF + 1, TOP - 1, TOP]


def _ordered(keys) -> torch.Tensor:
    """Sorted uint64 keys as the index holds them: int64, bit 63 flipped."""
    return from_u64(np.sort(np.asarray(keys, np.uint64)), CPU) ^ SIGN_BIT


def _queries(keys: np.ndarray, rng, n_random=2_000) -> np.ndarray:
    """Every key, its neighbours (wrapping mod 2^64), the values just below
    the smallest and above the largest, the edges of the uint64 range, and
    random values."""
    keys = np.asarray(keys, np.uint64)
    with np.errstate(over="ignore"):
        near = [keys, keys + np.uint64(1), keys - np.uint64(1),
                np.asarray([keys.min() - np.uint64(1), keys.max() + np.uint64(1)], np.uint64)]
    rand = rng.integers(0, 1 << 64, size=n_random, dtype=np.uint64, endpoint=False)
    return np.concatenate([*near, np.asarray(EDGES, np.uint64), rand])


def assert_probes_equal(keys, queries):
    """_probe_dir equals _probe: the same hits, and the same (last equal)
    row where a query hits. Returns the directory."""
    ko = _ordered(keys)
    directory = probe_directory(ko)
    q = from_u64(np.asarray(queries, np.uint64), CPU).reshape(-1, 1)
    row, hit = _probe(q, ko)
    got_row, got_hit = _probe_dir(q, ko, directory)
    assert torch.equal(got_hit, hit)
    assert torch.equal(got_row, torch.where(hit, row, 0))
    return directory


def assert_layout(directory, keys_ordered):
    """The directory's rule: S slots, at most U of them (more than U/4
    once the keys span more than 2^r), each key in slot (key - lo) >>
    shift, the table the slots' exclusive cumulative counts."""
    U = keys_ordered.shape[0]
    table = directory.table
    S = table.shape[0] - 1
    assert table.dtype == torch.int32 and int(table[0]) == 0 and int(table[-1]) == U
    r = U.bit_length() - 1
    assert directory.shift == max(0, directory.span.bit_length() - r)
    assert S == (directory.span >> directory.shift) + 1 and S <= max(U, 1)
    if directory.span.bit_length() > r:
        assert 4 * S > U
    keys_u = [(k + (1 << 64) if k < 0 else k) ^ HALF for k in keys_ordered.tolist()]
    lo_u = directory.lo + (1 << 64) if directory.lo < 0 else directory.lo
    lo_u ^= HALF
    slots = np.asarray([((k - lo_u) % (1 << 64)) >> directory.shift for k in keys_u])
    np.testing.assert_array_equal(np.diff(table.numpy()), np.bincount(slots, minlength=S))
    assert directory.widest == int(np.diff(table.numpy()).max())
    assert directory.steps() == int(np.ceil(np.log2(directory.widest + 1)))


@pytest.fixture(scope="module")
def fixture_index(tmp_path_factory):
    """The bench fixture's index: 4 random 29,900 bp genomes (seed 2024, as
    chip_smoke.py and bench.py draw them), k = 21, host build + layout,
    and the same genomes built by device_build on the CPU."""
    tmp = tmp_path_factory.mktemp("fixture")
    rng = np.random.default_rng(2024)
    paths = []
    for g in range(4):
        paths.append(str(tmp / f"synth{g}.fasta"))
        write_fasta(paths[-1], f"synth{g}", make_genome(rng, 29_900))
    host = build_device_index(build_index(21, paths), CPU)
    _, dev = build_device_index_on_device(21, paths, CPU)
    return host, dev


def test_directory_on_the_fixture_keys(fixture_index):
    """The fixture's 2.5 M keys: the layout rule, ~2 bytes a key, and the
    probe through it equal to the full search on every key, its
    neighbours and random queries."""
    host, _ = fixture_index
    keys = host.keys.numpy().view(np.uint64)
    directory = assert_probes_equal(keys, _queries(keys, np.random.default_rng(1),
                                                   n_random=200_000))
    assert_layout(directory, host.keys_ordered)
    U, S = keys.shape[0], directory.table.shape[0] - 1
    assert U > 2_000_000 and U // 4 < S <= U and directory.table.numel() * 4 < 3 * U
    assert directory.widest < 100  # the keys are well spread


def test_device_index_caches_the_directory(fixture_index):
    """DeviceIndex.probe_dir builds the directory at first use, keeps it,
    and counts it in device_bytes; the device build's index gives the
    same directory as the host layout's."""
    host, dev = fixture_index
    held = dev.device_bytes()
    directory = dev.probe_dir()
    assert dev.probe_dir() is directory
    assert dev.device_bytes() == held + directory.table.numel() * 4
    want = host.probe_dir()
    assert torch.equal(directory.table, want.table) and directory[1:] == want[1:]


KEY = st.one_of(st.integers(0, TOP), st.sampled_from(EDGES),
                st.integers(HALF - (1 << 20), HALF + (1 << 20)))


@settings(max_examples=200, deadline=None, derandomize=True)
@given(keys=st.lists(KEY, min_size=1, max_size=300),
       dups=st.integers(0, 5), one_slot=st.booleans(), seed=st.integers(0, 2**32 - 1))
def test_directory_probe_equals_probe(keys, dups, one_slot, seed):
    """Drawn key sets: uniform, 0 and 2^64-1, either side of 2^63;
    with duplicates (a query resolves to the last equal row); and with
    every key but one far outlier packed into one slot."""
    rng = np.random.default_rng(seed)
    keys = np.asarray(keys, np.uint64)
    if one_slot:  # within 2^r of the smallest, and one key 2^64-1
        keys = keys.min() + keys % np.uint64(max(1, keys.shape[0]))
        keys[-1] = np.uint64(TOP)
    if dups:
        keys = np.concatenate([keys, rng.choice(keys, size=dups * keys.shape[0] // 2 + 1)])
    directory = assert_probes_equal(keys, _queries(keys, rng))
    assert_layout(directory, _ordered(keys))
    if one_slot and directory.table.shape[0] > 2:
        assert directory.widest >= keys.shape[0] - np.count_nonzero(keys == np.uint64(TOP))


@pytest.mark.parametrize("key", [0, 1, HALF - 1, HALF, 0x14F66C5DB506, TOP - 1, TOP])
def test_directory_of_one_key(key):
    """U = 1 (a shard's one empty row): one slot of one row; the key hits,
    every other query misses."""
    directory = assert_probes_equal([key], _queries(np.asarray([key], np.uint64),
                                                     np.random.default_rng(key % 997)))
    assert directory.table.tolist() == [0, 1] and directory.span == 0
    assert directory.widest == 1 and directory.steps() == 1


def test_directory_of_equal_keys():
    """Keys all equal are one slot of span 0, resolved to the last row."""
    keys = np.full(37, 0xDEADBEEF, np.uint64)
    directory = assert_probes_equal(keys, _queries(keys, np.random.default_rng(3)))
    assert directory.table.tolist() == [0, 37] and directory.steps() == 6


def _bucket_ids(k, n, rng):
    """n random k-mers and their (n, J) bucket ids; at k = 31 half of them
    near-all-T, whose ids pass 2^63 (the u64 wrap of the bucket hash)."""
    kmers = rng.integers(0, 1 << (2 * k), size=n, dtype=np.uint64)
    if k == 31:
        top = (np.uint64(1) << np.uint64(62)) - np.uint64(1)
        kmers[: n // 2] = top - rng.integers(0, 1 << 20, size=n // 2, dtype=np.uint64)
    positions = tuple(filtered_bucket_positions(k, 2, False))
    q, _, _ = bucket_queries_plain(from_u64(kmers, CPU), k, positions)
    return kmers, q


def test_directory_on_k31_ids_past_two_to_the_63():
    """Keys that are k = 31 bucket ids on both sides of 2^63, their span
    past 2^63: the slot shift is logical, so every query resolves as the
    full search does."""
    rng = np.random.default_rng(31)
    _, q = _bucket_ids(31, 4_000, rng)
    ids = q.reshape(-1).numpy().view(np.uint64)
    keys = np.unique(ids[rng.random(ids.shape[0]) < 0.5])
    assert (keys >= np.uint64(HALF)).any() and (keys < np.uint64(HALF)).any()
    directory = assert_probes_equal(keys, np.concatenate([ids, _queries(keys, rng)]))
    assert directory.span >= HALF and directory.shift > 0
    assert_layout(directory, _ordered(keys))


def test_probe_tally_plain_matches_jax_on_a_skewed_set():
    """probe_tally_plain, searching through the directory, against JAX's
    _tally_save_body on a skewed key table: the bucket ids of k-mers
    (k = 21, below 2^45), a real key 2^64-1 and three sentinel rows after
    it (the real bucket's range moved onto the last, as JAX's
    fix_sentinel_collision does), so that every other key shares slot 0.
    Tallies, lanes, CSR starts and words equal; some k-mers perfect."""
    k, G = 21, 4
    rng = np.random.default_rng(12)
    kmers, q = _bucket_ids(k, 600, rng)
    ids = q.numpy().view(np.uint64)
    keep = rng.random(ids.shape) < 0.8
    keep[:100] = True  # every bucket of the first 100 k-mers is in the table
    real = np.unique(np.concatenate([ids[:400][keep[:400]], [np.uint64(TOP)]]))
    U = real.shape[0] + 3
    keys = np.concatenate([real, np.full(3, TOP, np.uint64)])
    sizes = rng.integers(1, 200, U)
    sizes[-3:] = 0
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    offsets[U - 1], offsets[U] = offsets[U - 4], offsets[U - 3]
    # a byte a genome: mostly 1 (a perfect k-mer sums J), sometimes 0 or 2
    per_genome = rng.choice([0, 1, 1, 1, 1, 1, 1, 1, 1, 2], size=(U, G))
    hist = (per_genome << (8 * np.arange(G))).sum(axis=1).astype(np.int32)
    hist[-3:] = 0
    hist[-1] = hist[-4]
    counts = rng.integers(1, 1000, size=kmers.shape[0]).astype(np.int32)
    counts[rng.random(counts.shape[0]) < 0.2] = 0

    ko = _ordered(keys)
    directory = probe_directory(ko)
    assert directory.widest == U - 4  # skewed: all keys below 2^64-1 in one slot
    tallies = torch.zeros((G, 3), dtype=torch.int32)
    start, h, lanes = probe_tally_plain(q, torch.from_numpy(counts), ko, directory,
                                        torch.from_numpy(offsets), torch.from_numpy(hist),
                                        tallies)
    cfg = jm.make_map_config(k=k, n_buckets=U, n_postings=int(offsets[-1]), max_bucket=255,
                             num_genomes=G, total_len=1_000, n_fixed=2, use_full_kmer=False)
    j_tallies, j_lanes, j_start, j_h = jm._tally_save_body(
        jnp.asarray(kmers[None]), jnp.asarray(counts[None]), jnp.asarray(keys),
        jnp.asarray(offsets), jnp.asarray(hist), jnp.zeros((G, 3), jnp.int32), cfg)
    np.testing.assert_array_equal(tallies.numpy(), np.asarray(j_tallies))
    np.testing.assert_array_equal(lanes.numpy(), np.asarray(j_lanes))
    np.testing.assert_array_equal(start.numpy(), np.asarray(j_start)[0])
    np.testing.assert_array_equal(h.numpy(), np.asarray(j_h)[0])
    assert int(tallies[:, 0].sum()) > 0 and int(tallies[:, 1].sum()) > 0
