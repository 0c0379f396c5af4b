"""The port's mapper (ops/map.py) against bronko_tpu's tally_save_jit and
pileup_from_saved_jit on the same batches: tallies, saved probe (start,
histogram words), walk lengths and the pass-2 pileup of every genome,
array-equal. Plus genome selection, ties included."""

from dataclasses import replace
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from bronko_tpu.call import engine as je  # noqa: E402
from bronko_tpu.index.layout import build_device_index as jax_build  # noqa: E402
from bronko_tpu.ops.map import pileup_from_saved_jit, tally_save_jit  # noqa: E402
from bronko_tpu_torch.call import engine as te  # noqa: E402
from bronko_tpu_torch.index.layout import build_device_index  # noqa: E402
from bronko_tpu_torch.index.model import from_jax_index  # noqa: E402
from bronko_tpu_torch.ops.codec import from_u64  # noqa: E402
from bronko_tpu_torch.ops.map import pileup_from_saved, tally_save  # noqa: E402
from tests.test_map import make_index, random_genome, sample_kmers  # noqa: E402

CPU = torch.device("cpu")
B = 64


def _files(rng, case):
    base = random_genome(rng, 260)
    if case == "twins":  # identical genomes: tied scores
        return [(f"g{i}", [(f"s{i}", base)]) for i in range(2)]
    if case == "g8_signbit":  # genome 7's poly-A buckets set bit 63
        files = [(f"g{i}", [(f"s{i}", random_genome(rng, 120))]) for i in range(7)]
        return files + [("g7", [("s7", random_genome(rng, 60) + b"A" * 160)])]
    G = int(case[1:])
    files = []
    for i in range(G):  # strains of one base genome: shared k-mers
        g = bytearray(base)
        for p in rng.integers(0, len(g), 5):
            g[p] = b"ACGT"[rng.integers(4)]
        files.append((f"g{i}", [(f"s{i}a", bytes(g)),
                                (f"s{i}b", random_genome(rng, 80 + 7 * i))]))
    return files


def _batches(rng, files, k):
    """(nb, B) k-mers and counts: genome k-mers, mutants, junk, some counts
    zeroed mid-batch and the last batch zero-padded."""
    kc = sample_kmers(rng, files, k, n_exact=150, n_mut=60, n_junk=10)
    kc += [(0, 40), (1, 7)]  # poly-A and a one-off of it
    kmers = np.asarray([x[0] for x in kc], np.uint64)
    counts = np.asarray([x[1] for x in kc], np.int32)
    counts[rng.integers(0, len(counts), 12)] = 0
    nb = -(-len(kmers) // B)
    kb = np.zeros(nb * B, np.uint64)
    cb = np.zeros(nb * B, np.int32)
    kb[:len(kmers)] = kmers
    cb[:len(counts)] = counts
    return kb.reshape(nb, B), cb.reshape(nb, B)


@pytest.mark.parametrize("case,k,full", [
    ("g1", 21, False), ("g4", 21, False), ("g6", 21, False),
    ("g1", 31, False), ("g4", 31, False), ("g6", 31, False),
    ("g4", 21, True), ("twins", 21, False), ("g8_signbit", 21, False)])
def test_passes_match_jax(tmp_path, case, k, full):
    rng = np.random.default_rng(sum(map(ord, case)) + k)
    files = _files(rng, case)
    index = make_index(tmp_path, files, k)
    jd = jax_build(index)
    td = build_device_index(from_jax_index(index), CPU)
    G = td.num_genomes
    assert td.hist is not None and td.fid_grouped
    kb, cb = _batches(rng, files, k)

    mcfg = jd.map_config(2, full)
    kj, cj = jnp.asarray(kb), jnp.asarray(cb)
    j_tallies, j_lanes, j_start, j_h = tally_save_jit(
        kj, cj, jd.keys, jd.offsets, jd.hist, jnp.zeros((G, 3), jnp.int32), mcfg)

    pcfg = td.map_config(2, full)
    batches = [(from_u64(kr, CPU), torch.from_numpy(cr)) for kr, cr in zip(kb, cb)]
    tallies, lanes, saved = tally_save(batches, td, pcfg)
    np.testing.assert_array_equal(tallies.numpy(), np.asarray(j_tallies))
    np.testing.assert_array_equal(torch.stack([s for s, _ in saved]).numpy(),
                                  np.asarray(j_start))
    np.testing.assert_array_equal(torch.stack([h for _, h in saved]).numpy(),
                                  np.asarray(j_h))
    np.testing.assert_array_equal(lanes.max(dim=0).values.numpy(), np.asarray(j_lanes))
    if case == "g8_signbit":
        assert (torch.stack([h for _, h in saved]) < 0).any()
    if case == "twins":
        assert tallies[0, 0] == tallies[1, 0] > 0
    assert te.pick_best_genome(tallies.numpy(), td) == \
        je.pick_best_genome(np.asarray(j_tallies), jd)

    for best in range(G):
        gcfg = replace(mcfg, total_len=jd.g_total_len, max_bucket=jd.g_max_bucket,
                       lane_budget=je._lane_class(int(j_lanes[best]), floor=1 << 10))
        j_pileup, overflow = pileup_from_saved_jit(
            kj, cj, j_start, j_h, jd.postings_local32,
            jnp.zeros((4, jd.g_total_len + 1, 4), jnp.int32), jnp.int32(best),
            jnp.int32(int(jd.file_bases[best])), gcfg)
        assert int(overflow) == 0
        pileup = pileup_from_saved(batches, saved, lanes[:, best].tolist(),
                                   td.postings_local32, best, pcfg, td.g_total_len)
        assert pileup.dtype == torch.int32
        np.testing.assert_array_equal(pileup.numpy(), np.asarray(j_pileup))
        assert int(pileup[2:].sum()) == int(lanes[:, best].sum())  # one add per lane


@pytest.mark.parametrize("perfect,lens,want", [
    ([10, 10], [100, 100], 0),             # exact tie: the first wins
    ([10, 20], [100, 200], 0),             # tie of the ratio
    ([10, 21], [100, 200], 1),
    ([16777216, 16777217], [1000, 1000], 1),  # apart in f64, tied in f32
    ([0, 5, 5], [0, 50, 50], 1),           # a zero-length genome is skipped
    ([0, 0], [10, 10], None),              # no positive score
])
def test_pick_best_genome_matches_jax(perfect, lens, want):
    tallies = np.zeros((len(perfect), 3), np.int64)
    tallies[:, 0] = perfect
    dev = SimpleNamespace(num_genomes=len(perfect), genome_lens=np.asarray(lens))
    assert te.pick_best_genome(tallies, dev) == je.pick_best_genome(tallies, dev) == want
