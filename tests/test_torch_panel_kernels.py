"""The large-panel paths of kernels (b), (c) and (d), through their
wrappers' CPU dispatch (the plain versions), against bronko_tpu on the
same seeded inputs, exactly (array-equal): (b) on the multi-word
histogram against tally_save_words_jit and tally_all_jit('words'), at G =
9, 13, 17 and 40, on the panels' own words and on words with bit 63 set;
(c) on the multi-word saved probe against pileup_from_saved_words_jit,
with the selected genome in a first, a middle and a last word, and on
wide words whose offsets pass 255; (d) against tally_flat and
tally_all_jit('flat') on poly-A and 13- and 40-strain panels, with
postings grouped and ungrouped, by int32 genome ids and by int64 global
postings; probe_scatter and map_batch against JAX's. The kernels
themselves are held against these plain versions on a card in
tests/test_torch_cuda.py."""

import functools
import weakref
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from bronko_tpu.index import layout as jl  # noqa: E402
from bronko_tpu.ops import map as jm  # noqa: E402
from bronko_tpu_torch.index import layout as tl  # noqa: E402
from bronko_tpu_torch.index.model import from_jax_index  # noqa: E402
from bronko_tpu_torch.ops import cuda_map  # noqa: E402
from bronko_tpu_torch.ops import map as tm  # noqa: E402
from bronko_tpu_torch.ops.codec import from_u64  # noqa: E402
from tests.test_torch_panels import (  # noqa: E402
    B, batches_from, jax_arrays, panel, permuted, torch_batches,
)

CPU = torch.device("cpu")


def indexes(tmp_path, name, ungrouped=False, wide=False):
    """(files, JAX DeviceIndex, the port's DeviceIndex) of a test panel;
    `ungrouped` permutes postings inside their buckets, `wide` carries
    the index across with only the int64 global postings."""
    files, index = panel(tmp_path, name)
    if ungrouped:
        index = permuted(index, 3)
    jd = jl.build_device_index(index)
    if wide:
        td = tl.from_jax_arrays(**jax_arrays(jd, postings_local32=None), device=CPU)
    else:
        td = tl.build_device_index(from_jax_index(index), CPU)
    return files, jd, td


def signbit_words(rng, U: int, G: int) -> np.ndarray:
    """(U, W) int64 histogram words: bytes of genomes below G, 0 or 1 in
    most rows (so k-mers come out perfect, unique and variant), 128-255
    in the top byte of every word in a tenth of them (bit 63 set), the
    bytes of genomes past G zero."""
    W = -(-G // 8)
    b = (rng.random((U, 8 * W)) < 0.85).astype(np.uint64)
    top = rng.random(U) < 0.1
    b[top, 7::8] = rng.integers(128, 256, size=(int(top.sum()), W))
    b[:, G:] = 0
    words = (b.reshape(U, W, 8) << (np.uint64(8) * np.arange(8, dtype=np.uint64))).sum(axis=2)
    return words.view(np.int64)


@pytest.mark.parametrize("words", ["panel", "signbit"])
@pytest.mark.parametrize("name,G", [("g9", 9), ("g13", 13), ("g17", 17), ("g40", 40)])
def test_words_probe_matches_jax(tmp_path, name, G, words):
    """(b) on the multi-word histogram (K1 + probe_tally per batch) against
    tally_save_words_jit: tallies, CSR starts, histogram words and walk
    lengths; tally(mode='words') against tally_all_jit. G is not a
    multiple of 8 but at 40; 'signbit' words set bit 63 of every word in
    a tenth of the rows."""
    files, jd, td = indexes(tmp_path, name)
    assert td.tally_mode() == "words" and td.num_genomes == G
    hw = np.asarray(jd.hist_words)
    if words == "signbit":
        hw = signbit_words(np.random.default_rng(G), hw.shape[0], G)
        td.hist_words = torch.from_numpy(hw)
    rng = np.random.default_rng(G + len(words))
    kb, cb = batches_from(rng, files, 21, n_exact=150, n_mut=30, n_junk=5)
    mcfg, pcfg = jd.map_config(2, False), td.map_config(2, False)
    kj, cj = jnp.asarray(kb), jnp.asarray(cb)
    j_t, j_lanes, j_start, j_hw = jm.tally_save_words_jit(
        kj, cj, jd.keys, jd.offsets, jnp.asarray(hw), jnp.zeros((G, 3), jnp.int32), mcfg)
    batches = torch_batches(kb, cb)
    tallies, lanes, saved = tm.tally_save(batches, td, pcfg)
    np.testing.assert_array_equal(tallies.numpy(), np.asarray(j_t))
    np.testing.assert_array_equal(torch.stack([s for s, _ in saved]).numpy(), np.asarray(j_start))
    h = torch.stack([h for _, h in saved])
    assert h.shape[-1] == -(-G // 8)
    np.testing.assert_array_equal(h.numpy(), np.asarray(j_hw))
    np.testing.assert_array_equal(lanes.max(dim=0).values.numpy(), np.asarray(j_lanes))
    assert int(tallies[:, 0].sum()) > 0 and int(tallies[:, 1].sum()) > 0
    if words == "signbit":
        assert (h < 0).any() and int(tallies[:, 2].sum()) > 0

    j_all, overflow = jm.tally_all_jit(kj, cj, jd.keys, jd.offsets, jd.postings,
                                       jnp.asarray(hw), jnp.zeros((G, 3), jnp.int32), mcfg,
                                       "words")
    assert int(overflow) == 0
    w_tallies, w_lanes = tm.tally(batches, td, pcfg, "words")
    np.testing.assert_array_equal(w_tallies.numpy(), np.asarray(j_all))
    assert torch.equal(w_lanes, lanes)


def test_words_tally_without_the_saved_probe_holds_one_batch(tmp_path, monkeypatch):
    """A words sample past PROBE_BYTES_CAP takes pass 1 without the saved
    probe (the engine's pass 1 of a PendingMap part, engine._pass1 ->
    tally(mode='words')): (b)'s start and h of a batch are dropped once
    the next batch is probed, so at most one batch's probe is alive while
    tally runs and none after it; tally_save keeps every batch's. The mode
    names the index's own histogram."""
    from bronko_tpu_torch.call import engine

    files, jd, td = indexes(tmp_path, "g17")
    nb = 5
    kb, cb = batches_from(np.random.default_rng(17), files, 21, nb=nb, n_exact=300, n_mut=40)
    batches, pcfg = torch_batches(kb, cb), td.map_config(2, False)
    probes, alive_at_call = [], []
    plain = tm.probe_tally

    def tracked(*args):
        alive_at_call.append(sum(r() is not None for r in probes))
        start, h, lanes = plain(*args)
        probes.extend((weakref.ref(start), weakref.ref(h)))
        return start, h, lanes

    monkeypatch.setattr(tm, "probe_tally", tracked)
    # one byte short of the sample's probe
    monkeypatch.setattr(engine, "PROBE_BYTES_CAP",
                        kb.size * len(pcfg.positions) * engine.probe_bytes_per_query(td) - 1)
    p1_tallies, (_, p1_lanes, saved), _ = engine._pass1(batches, kb.size, td, pcfg, 0)
    assert saved is None and len(alive_at_call) == nb
    assert max(alive_at_call) <= 2 and not any(r() for r in probes)

    probes.clear()
    alive_at_call.clear()
    tallies, lanes, saved = tm.tally_save(batches, td, pcfg)
    assert alive_at_call == [2 * i for i in range(nb)] and all(r() is not None for r in probes)
    assert torch.equal(p1_tallies, tallies) and torch.equal(p1_lanes, lanes)
    with pytest.raises(ValueError, match="histogram"):
        tm.tally(batches, td, pcfg, "hist")


def pass2_cfg(mcfg, jd, lanes: int):
    return replace(mcfg, total_len=jd.g_total_len, max_bucket=jd.g_max_bucket,
                   lane_budget=max(1 << 12, lanes))


@pytest.mark.parametrize("name,best", [("g17", 2), ("g17", 11), ("g17", 16),
                                       ("g40", 5), ("g40", 20), ("g40", 39)])
def test_words_walk_matches_jax(tmp_path, name, best):
    """(c) on the multi-word saved probe (pileup_from_saved, one walk_scatter
    a batch reading h (B, J, W) and best) against
    pileup_from_saved_words_jit, the selected genome in the first, a
    middle and the last word, on the int32 genome-local postings and on
    the int64 global ones at the genome's file base."""
    files, jd, td = indexes(tmp_path, name)
    kb, cb = batches_from(np.random.default_rng(best), files, 21, n_exact=200, n_mut=40)
    mcfg, pcfg = jd.map_config(2, False), td.map_config(2, False)
    kj, cj = jnp.asarray(kb), jnp.asarray(cb)
    G = td.num_genomes
    _, j_lanes, j_start, j_hw = jm.tally_save_words_jit(
        kj, cj, jd.keys, jd.offsets, jd.hist_words, jnp.zeros((G, 3), jnp.int32), mcfg)
    batches = torch_batches(kb, cb)
    _, lanes, saved = tm.tally_save(batches, td, pcfg)
    gcfg = pass2_cfg(mcfg, jd, int(np.asarray(j_lanes).max()))
    fbase = int(jd.file_bases[best])
    for postings, j_postings, base in ((td.postings_local32, jd.postings_local32, 0),
                                       (td.global_postings(), jd.postings, fbase)):
        j_pileup, overflow = jm.pileup_from_saved_words_jit(
            kj, cj, j_start, j_hw, j_postings,
            jnp.zeros((4, jd.g_total_len + 1, 4), jnp.int32), jnp.int32(best),
            jnp.int32(fbase), gcfg)
        assert int(overflow) == 0
        pileup = tm.pileup_from_saved(batches, saved, lanes[:, best].tolist(), postings, best,
                                      pcfg, td.g_total_len, base)
        np.testing.assert_array_equal(pileup.numpy(), np.asarray(j_pileup))
        assert int(pileup[2:].sum()) == int(lanes[:, best].sum()) > 0


@pytest.mark.parametrize("best", [0, 7, 12, 31])
def test_words_walk_on_wide_words_matches_jax(best):
    """(c) on synthetic saved probes of W = 4 words whose bytes run to 255
    (bit 63 set, offsets past 255 and up to 31 x 255), over postings long
    enough for every range, against pileup_from_saved_words_jit: the
    offset is every byte below `best`, whole words and the partial one."""
    rng = np.random.default_rng(best)
    k, nb, Bw, W, T = 21, 2, 96, 4, 3_000
    jcfg = jm.make_map_config(k=k, n_buckets=1, n_postings=1, max_bucket=255,
                              num_genomes=32, total_len=T, n_fixed=2, use_full_kmer=False)
    J = len(jcfg.positions)
    hw = rng.integers(0, 256, size=(nb, Bw, J, 8 * W), dtype=np.uint64)
    hw[rng.random((nb, Bw, J)) < 0.3] = 0
    hw = (hw.reshape(nb, Bw, J, W, 8) << (np.uint64(8) * np.arange(8, dtype=np.uint64))
          ).sum(axis=-1).view(np.int64)
    start = rng.integers(0, 5_000, size=(nb, Bw, J)).astype(np.int32)
    P = 5_000 + 8 * W * 255
    postings = ((rng.integers(0, T, size=P) << 6) | (rng.integers(0, 2, size=P) << 5)
                | rng.integers(0, k, size=P)).astype(np.int32)
    kmers = rng.integers(0, 1 << (2 * k), size=(nb, Bw), dtype=np.uint64)
    counts = rng.integers(1, 1_000, size=(nb, Bw)).astype(np.int32)
    counts[0, :5] = 0
    lanes = int(((hw.view(np.uint64)[..., best // 8] >> np.uint64(8 * (best % 8)))
                 & np.uint64(255)).sum())
    j_pileup, overflow = jm.pileup_from_saved_words_jit(
        jnp.asarray(kmers), jnp.asarray(counts), jnp.asarray(start), jnp.asarray(hw),
        jnp.asarray(postings), jnp.zeros((4, T + 1, 4), jnp.int32), jnp.int32(best),
        jnp.int32(0), replace(jcfg, lane_budget=lanes + 1))
    assert int(overflow) == 0
    pcfg = tm.make_map_config(k=k, max_bucket=255, num_genomes=32, total_len=T, n_fixed=2,
                              use_full_kmer=False)
    batches = torch_batches(kmers, counts)
    saved = [(torch.from_numpy(s), torch.from_numpy(h)) for s, h in zip(start, hw)]
    pileup = tm.pileup_from_saved(batches, saved, None, torch.from_numpy(postings), best,
                                  pcfg, T)
    np.testing.assert_array_equal(pileup.numpy(), np.asarray(j_pileup))
    assert int(pileup[2:].sum()) == lanes > 0


@functools.lru_cache(maxsize=None)
def _jax_tally_flat(cfg):
    return jax.jit(functools.partial(jm.tally_flat, cfg=cfg))


@pytest.mark.parametrize("genomes", ["fids", "int64"])
@pytest.mark.parametrize("name,ungrouped", [("polyA4", False), ("polyA9", False),
                                            ("polyA9", True), ("g13", False), ("g13", True),
                                            ("g40", False)])
def test_flat_walk_matches_jax(tmp_path, name, ungrouped, genomes):
    """(d) (walk_hits on _ranges) against JAX's tally_flat a batch, hits
    array-equal, with the genome from the int32 ids or the int64 global
    postings; tallies and walk lengths of tally(mode='flat') against
    tally_all_jit('flat') and, where there is one, the words path. The
    plain version's runs of 7 lanes split rows; a poly-A bucket holds 280
    postings a genome. `ungrouped` permutes postings in their buckets."""
    files, jd, td = indexes(tmp_path, name, ungrouped, wide=genomes == "int64")
    assert td.fid_grouped == (not ungrouped)
    rng = np.random.default_rng(len(name) + ungrouped)
    kb, cb = batches_from(rng, files, 21, n_exact=150, n_mut=60, n_junk=10)
    mcfg, pcfg = jd.map_config(2, False), td.map_config(2, False)
    G, J = td.num_genomes, len(pcfg.positions)
    fcfg = replace(mcfg, lane_budget=B * J * jd.max_bucket)
    source = td.posting_fids() if genomes == "fids" else td.global_postings()
    assert source.dtype == (torch.int32 if genomes == "fids" else torch.int64)
    walked = 0
    for (kmers, counts), kr, cr in zip(torch_batches(kb, cb), kb, cb):
        start, lens = tm._ranges(kmers, counts, td.keys_ordered, td.offsets, cfg=pcfg)
        j_hits, overflow = _jax_tally_flat(fcfg)(jnp.asarray(kr), jnp.asarray(cr), jd.keys,
                                                 jd.offsets, jd.postings)
        assert int(overflow) == 0
        for chunk in (7, tm.FLAT_LANE_CHUNK):
            hits = cuda_map.walk_hits(start, lens, source, G, lane_chunk=chunk)
            assert hits.dtype == torch.int32
            np.testing.assert_array_equal(hits.numpy(), np.asarray(j_hits))
        walked += int(lens.sum())
    assert walked > 0
    tallies, lanes = tm.tally(torch_batches(kb, cb), td, pcfg, "flat", lane_chunk=7)
    j_t = jm.tally_all_jit(jnp.asarray(kb), jnp.asarray(cb), jd.keys, jd.offsets,
                           jd.postings, jnp.zeros(1, jnp.int64),
                           jnp.zeros((G, 3), jnp.int32), fcfg, "flat")[0]
    np.testing.assert_array_equal(tallies.numpy(), np.asarray(j_t))
    assert int(lanes.sum()) == walked
    if td.hist_words is not None:
        _, w_lanes = tm.tally(torch_batches(kb, cb), td, pcfg, "words")
        assert torch.equal(lanes, w_lanes)


def test_walk_hits_plain_counts_every_posting():
    """The plain walk against a loop over the rows: duplicate rows count
    twice (hits past J), zero-length and negative-start rows add nothing,
    a range past the postings' end stops there, a genome id outside [0,
    G) counts nowhere, and int64 postings give their genome field."""
    rng = np.random.default_rng(5)
    Bk, J, G, P = 40, 6, 11, 500
    fids = rng.integers(0, G, size=P).astype(np.int32)
    fids[:7] = [G, -1, G + 3, 0, 0, 1, G]
    start = rng.integers(0, P, size=(Bk, J)).astype(np.int32)
    lens = rng.integers(0, 30, size=(Bk, J)).astype(np.int32)
    start[0], lens[0] = 3, 2         # one k-mer's J rows on one range: hits of 2J
    start[1, 0], lens[1, 0] = P - 4, 100
    lens[1, 1:] = 0
    start[2, 0], lens[2, 0] = -5, 10
    start[3, :], lens[3, :] = 0, 7   # the out-of-range ids among them
    lens[4] = 0
    want = np.zeros((Bk, G), np.int32)
    for b in range(Bk):
        for j in range(J):
            if start[b, j] < 0:
                continue
            for g in fids[start[b, j]:min(P, start[b, j] + lens[b, j])]:
                if 0 <= g < G:
                    want[b, g] += 1
    assert want[0].max() == 2 * J and want[1].sum() == 4 and not want[4].any()
    st, ln = torch.from_numpy(start), torch.from_numpy(lens)
    for chunk in (1, 5, 64, tm.FLAT_LANE_CHUNK):
        got = cuda_map.walk_hits(st, ln, torch.from_numpy(fids), G, lane_chunk=chunk)
        np.testing.assert_array_equal(got.numpy(), want)
    postings = ((rng.integers(0, 1 << 20, size=P) << 22) | ((fids.astype(np.int64) & 0xFFFF) << 6)
                | rng.integers(0, 64, size=P))
    got = cuda_map.walk_hits(st, ln, torch.from_numpy(postings), G)
    np.testing.assert_array_equal(got.numpy(), want)
    assert cuda_map.walk_hits(st[:, :0], ln[:, :0], torch.from_numpy(fids), G).sum() == 0


def _jax_probe_scatter(jd, kmers, counts, postings, T):
    cfg = jd.map_config(2, False)
    cfg = replace(cfg, lane_budget=kmers.shape[0] * len(cfg.positions) * jd.max_bucket)
    fn = jax.jit(functools.partial(jm.probe_scatter, cfg=cfg))
    pileup, hits, overflow = fn(jnp.asarray(kmers), jnp.asarray(counts), jd.keys, jd.offsets,
                                postings, jnp.zeros((4, T + 1, 4), jnp.int32))
    assert int(overflow) == 0
    return np.asarray(pileup), np.asarray(hits)


@pytest.mark.parametrize("name,ungrouped", [("polyA9", False), ("g13", False),
                                            ("g13", True), ("g40", False)])
def test_probe_scatter_matches_jax(tmp_path, name, ungrouped):
    """probe_scatter ((c) on the int64 global postings by (start, lens),
    (d) on the same ranges) and map_batch over the whole index against
    JAX's on panels of 9 to 40 genomes: the all-genome pileup, the hits
    by posting genome and the tallies."""
    files, jd, td = indexes(tmp_path, name, ungrouped)
    rng = np.random.default_rng(len(name) + 7 * ungrouped)
    kb, cb = batches_from(rng, files, 21, nb=1, n_exact=200, n_mut=60, n_junk=10)
    kmers, counts = from_u64(kb[0], CPU), torch.from_numpy(cb[0])
    T, G = td.total_len, td.num_genomes
    cfg = td.map_config(2, False)
    zero = torch.zeros((4, T + 1, 4), dtype=torch.int32)
    pileup, hits = tm.probe_scatter(kmers, counts, td.keys_ordered, td.offsets,
                                    td.global_postings(), zero, cfg=cfg)
    j_pileup, j_hits = _jax_probe_scatter(jd, kb[0], cb[0], jd.postings, T)
    np.testing.assert_array_equal(pileup.numpy(), j_pileup)
    np.testing.assert_array_equal(hits.numpy(), j_hits)
    assert int(hits.sum()) == int(pileup[2:].sum()) > 0 and not zero.any()
    tallies0 = torch.zeros((G, 3), dtype=torch.int32)
    m_pileup, m_tallies = tm.map_batch(kmers, counts, td.keys_ordered, td.offsets,
                                       td.global_postings(), zero, tallies0, cfg=cfg)
    j_m = jax.jit(functools.partial(jm.map_batch, cfg=replace(
        jd.map_config(2, False), lane_budget=B * len(cfg.positions) * jd.max_bucket)))(
        jnp.asarray(kb[0]), jnp.asarray(cb[0]), jd.keys, jd.offsets, jd.postings,
        jnp.zeros((4, T + 1, 4), jnp.int32), jnp.zeros((G, 3), jnp.int32))
    assert int(j_m[2]) == 0
    np.testing.assert_array_equal(m_pileup.numpy(), np.asarray(j_m[0]))
    np.testing.assert_array_equal(m_tallies.numpy(), np.asarray(j_m[1]))
