"""The port's DeviceIndex against bronko_tpu.index.layout.build_device_index:
every field array-equal, built from the host index and carried across from
the JAX arrays (from_jax_arrays); and the layouts past the single-word
main path mapped as bronko_tpu maps them."""

from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from bronko_tpu.call import engine as je  # noqa: E402
from bronko_tpu.index import layout as jl  # noqa: E402
from bronko_tpu.index.model import BronkoIndex, FileMeta, SeqMeta, pack_meta  # noqa: E402
from bronko_tpu.ops.map import tally_save_jit, tally_save_words_jit  # noqa: E402
from bronko_tpu_torch.call import engine as te  # noqa: E402
from bronko_tpu_torch.index import layout as tl  # noqa: E402
from bronko_tpu_torch.index.model import from_jax_index  # noqa: E402
from bronko_tpu_torch.ops.codec import from_u64, to_u64  # noqa: E402
from bronko_tpu_torch.ops.map import _probe  # noqa: E402
from tests.test_map import make_index, random_genome  # noqa: E402
from tests.test_torch_map import _batches  # noqa: E402

CPU = torch.device("cpu")


def _panel(tmp_path, case):
    rng = np.random.default_rng(len(case) * 7 + 1)
    base = random_genome(rng, 240)
    if case == "g1":
        files = [("g0", [("s0", random_genome(rng, 300))])]
    elif case == "g4_contigs":  # similar genomes, two contigs per file
        files = []
        for i in range(4):
            g = bytearray(base)
            for p in rng.integers(0, len(g), 6):
                g[p] = b"ACGT"[rng.integers(4)]
            files.append((f"g{i}", [(f"s{i}a", bytes(g)),
                                    (f"s{i}b", random_genome(rng, 90 + 10 * i))]))
    elif case == "g4_deep":  # a poly-A run: buckets of 128..255 postings
        files = [(f"g{i}", [(f"s{i}", random_genome(rng, 120) + b"A" * 65)])
                 for i in range(4)]
    elif case == "g6":
        files = [(f"g{i}", [(f"s{i}", base[:200 + 5 * i])]) for i in range(6)]
    else:  # g9: past the single-word histogram
        files = [(f"g{i}", [(f"s{i}", random_genome(rng, 150))]) for i in range(9)]
    return make_index(tmp_path, files, 21)


def _jax_arrays(jd):
    jd.ensure_subindex()
    return dict(
        k=jd.k, keys=np.asarray(jd.keys), offsets=np.asarray(jd.offsets),
        hist=None if jd.hist is None else np.asarray(jd.hist),
        hist_words=None if jd.hist_words is None else np.asarray(jd.hist_words),
        postings=np.asarray(jd.postings),
        postings_local32=(None if jd.postings_local32 is None
                          else np.asarray(jd.postings_local32)),
        fid_grouped=jd.fid_grouped, file_bases=jd.file_bases,
        genome_lens=jd.genome_lens, seq_slices=jd.seq_slices,
        max_bucket=jd.max_bucket, total_len=jd.total_len,
        g_keys=np.asarray(jd.g_keys), g_offsets=np.asarray(jd.g_offsets),
        g_postings=np.asarray(jd.g_postings))


def _assert_matches(td, jd):
    np.testing.assert_array_equal(to_u64(td.keys), np.asarray(jd.keys))
    assert td.offsets.dtype == torch.int32
    np.testing.assert_array_equal(td.offsets.numpy(), np.asarray(jd.offsets))
    if jd.hist is None:
        assert td.hist is None
    else:
        assert td.hist.numpy().dtype == np.asarray(jd.hist).dtype
        np.testing.assert_array_equal(td.hist.numpy(), np.asarray(jd.hist))
    if jd.hist_words is None:
        assert td.hist_words is None
    else:
        np.testing.assert_array_equal(td.hist_words.numpy(), np.asarray(jd.hist_words))
    np.testing.assert_array_equal(td.postings_local32.numpy(),
                                  np.asarray(jd.postings_local32))
    assert td.fid_grouped == jd.fid_grouped
    np.testing.assert_array_equal(td.file_bases, jd.file_bases)
    np.testing.assert_array_equal(td.genome_lens, jd.genome_lens)
    assert [(s.file_id, s.seq_id, s.name, s.offset, s.length) for s in td.seq_slices] == \
        [(s.file_id, s.seq_id, s.name, s.offset, s.length) for s in jd.seq_slices]
    assert (td.num_genomes, td.total_len, td.max_bucket, td.g_total_len) == \
        (jd.num_genomes, jd.total_len, jd.max_bucket, jd.g_total_len)


@pytest.mark.parametrize("case,hist_dtype", [
    ("g1", np.int32), ("g4_contigs", np.int32), ("g4_deep", np.int64),
    ("g6", np.int64), ("g9", None)])
def test_device_index_matches_jax(tmp_path, case, hist_dtype):
    index = _panel(tmp_path, case)
    jd = jl.build_device_index(index)
    td = tl.build_device_index(from_jax_index(index), CPU)
    _assert_matches(td, jd)
    _assert_matches(tl.from_jax_arrays(**_jax_arrays(jd), device=CPU), jd)
    if hist_dtype is None:  # nine genomes: the multi-word histogram
        assert td.hist is None and td.hist_words.shape == (index.num_buckets, 2)
        assert td.tally_mode() == "words"
    else:
        assert td.hist.numpy().dtype == hist_dtype
        assert td.tally_mode() == "hist"


def _jax_map(jd, kb, cb, mcfg):
    """bronko_tpu's single-device dispatch (engine.py:780-870): tallies,
    the selected genome and its pileup."""
    kj, cj = jnp.asarray(kb), jnp.asarray(cb)
    if (jd.hist is not None or jd.hist_words is not None) and jd.fid_grouped:
        fn, hist = ((tally_save_jit, jd.hist) if jd.hist is not None
                    else (tally_save_words_jit, jd.hist_words))
        t, lanes, start, h = fn(kj, cj, jd.keys, jd.offsets, hist,
                                jnp.zeros((jd.num_genomes, 3), jnp.int32), mcfg)
        tallies = np.asarray(t).astype(np.int64)
        best = je.pick_best_genome(tallies, jd)
        pileup = je.run_pileup_saved(kj, cj, (start, h), jd, best, mcfg,
                                     exact_lanes=int(lanes[best]))
    else:
        tallies = je.run_tally_pass(kj, cj, jd, mcfg)
        best = je.pick_best_genome(tallies, jd)
        pileup = je.run_pileup_pass(kj, cj, jd, best, mcfg, n_kmers=kb.size)
    return tallies, best, np.asarray(pileup)


@pytest.mark.parametrize("case,path", [
    ("ungrouped", ("hist", "subindex")), ("wide", ("hist", "saved")),
    ("g9", ("words", "saved"))])
def test_unsupported_layouts_are_named(tmp_path, case, path):
    """The layouts the port once refused map as bronko_tpu maps them:
    postings not grouped by genome (the sub-index pass 2), the int64
    postings of a genome of 2^25 bp or more, and nine genomes (the
    multi-word histogram); each carried across from the JAX arrays."""
    index = _panel(tmp_path, "g9" if case == "g9" else "g4_contigs")
    jd = jl.build_device_index(index)
    over = {"ungrouped": {"fid_grouped": False}, "wide": {"postings_local32": None},
            "g9": {}}[case]
    jd = replace(jd, **over)
    td = tl.from_jax_arrays(**{**_jax_arrays(jd), **over}, device=CPU)
    rng = np.random.default_rng(len(case))
    files = [(f.name, [(s.name, s.seq) for s in f.sequences]) for f in index.files]
    kb, cb = _batches(rng, files, 21)
    batches = [(from_u64(kr, CPU), torch.from_numpy(cr)) for kr, cr in zip(kb, cb)]
    pcfg = td.map_config(2, False)
    p1 = te.run_pass1(batches, td, pcfg, kb.size)
    assert p1.path == path
    best = te.pick_best_genome(p1.tallies, td)
    pileup = te.run_pass2(batches, td, pcfg, p1, best).numpy()
    want_tallies, want_best, want_pileup = _jax_map(jd, kb, cb, jd.map_config(2, False))
    np.testing.assert_array_equal(p1.tallies, want_tallies)
    assert best == want_best is not None
    np.testing.assert_array_equal(pileup, want_pileup)


def _index_with_keys(keys, offsets):
    """A hand-made one-genome index: CSR rows over 100 bp, postings at
    locations 0.. with idx 0."""
    P = int(offsets[-1])
    seq = SeqMeta("s", 100, b"A" * 100)
    return BronkoIndex(
        k=21, keys=np.asarray(keys, np.uint64), offsets=np.asarray(offsets, np.int64),
        post_loc=np.arange(P, dtype=np.uint32),
        post_meta=pack_meta(np.zeros(P), 0, 0, np.arange(P) % 2),
        files=[FileMeta("g", [seq])])


def test_last_key_all_ones_still_hits():
    """A real bucket id can be 2^64-1 (the hash wraps at k=31) and ids past
    2^63 sort after the rest as uint64: the sign-bit-flipped search must
    still find them, each at its own CSR range, as the JAX merge probe."""
    from bronko_tpu.ops.map import _merge_probe

    keys = np.array([5, 9, 1 << 63, (1 << 64) - 1], np.uint64)
    offsets = np.array([0, 2, 3, 5, 9])
    index = _index_with_keys(keys, offsets)
    td = tl.build_device_index(from_jax_index(index), CPU)
    _assert_matches(td, jl.build_device_index(index))

    q = np.array([[5, (1 << 64) - 1, 7, 1 << 63, 0, (1 << 64) - 2, 9]], np.uint64)
    row, hit = _probe(from_u64(q, CPU), td.keys_ordered)
    assert hit.tolist() == [[True, True, False, True, False, False, True]]
    start = torch.where(hit, td.offsets[row], 0)
    end = torch.where(hit, td.offsets[row + 1], 0)

    off = jnp.asarray(offsets.astype(np.int32))
    j_start, j_end = _merge_probe(jnp.asarray(q), jnp.asarray(keys), (off[:4], off[1:5]))
    np.testing.assert_array_equal(start.numpy(), np.asarray(j_start))
    np.testing.assert_array_equal(end.numpy(), np.asarray(j_end))


def test_duplicate_keys_resolve_to_the_last_row():
    """A sentinel-padded table with a real 2^64-1 bucket: after the JAX
    layout's fix_sentinel_collision the last equal row carries the real
    range, and the probe (like the JAX merge probe) picks that row."""
    ukeys = np.array([5, 9, (1 << 64) - 1], np.uint64)
    u_max = 6
    keys = np.full(u_max, jl.KEY_SENTINEL, np.uint64)
    keys[:3] = ukeys
    offsets = np.zeros(u_max + 1, np.int32)
    offsets[:4] = [0, 2, 3, 7]
    offsets[4:] = 7
    jl.fix_sentinel_collision(ukeys, offsets, u_max)
    assert tl.KEY_SENTINEL == jl.KEY_SENTINEL

    td = tl.from_jax_arrays(
        k=31, keys=keys, offsets=offsets, hist=np.zeros(u_max, np.int32),
        postings_local32=np.zeros(7, np.int32), fid_grouped=True,
        file_bases=[0], genome_lens=[100], seq_slices=[], max_bucket=4,
        total_len=100, device=CPU)
    row, hit = _probe(from_u64(np.array([[(1 << 64) - 1, 5]], np.uint64), CPU), td.keys_ordered)
    assert row.tolist() == [[u_max - 1, 0]] and hit.all()
    assert td.offsets[row[0, 0] + 1] - td.offsets[row[0, 0]] == 4
