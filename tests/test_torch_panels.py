"""Panels past the single-word histogram, in the port against bronko_tpu,
exactly (array-equal; byte-equal files): the multi-word histogram (G > 8),
the flat tally (a bucket of more than 255 postings), the per-genome
sub-index pass 2 (postings not grouped by genome) and the int64 postings
(a genome of 2^25 bp or more), from the layout up to the CLI."""

import os
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import bronko_tpu.cli as jax_cli  # noqa: E402
from bronko_tpu.call import engine as je  # noqa: E402
from bronko_tpu.index import layout as jl  # noqa: E402
from bronko_tpu.index.bincode_compat import save_reference_bkdb  # noqa: E402
from bronko_tpu.index.build import build_index  # noqa: E402
from bronko_tpu.index.model import BronkoIndex  # noqa: E402
from bronko_tpu.ops.map import (  # noqa: E402
    pileup_all_jit, pileup_from_saved_jit, pileup_from_saved_words_jit, tally_all_jit,
    tally_save_jit, tally_save_words_jit,
)
from bronko_tpu_torch import cli  # noqa: E402
from bronko_tpu_torch.call import engine as te  # noqa: E402
from bronko_tpu_torch.config import CallConfig  # noqa: E402
from bronko_tpu_torch.index import layout as tl  # noqa: E402
from bronko_tpu_torch.index.model import from_jax_index  # noqa: E402
from bronko_tpu_torch.index.store import load_index  # noqa: E402
from bronko_tpu_torch.ops import map as tm  # noqa: E402
from bronko_tpu_torch.ops.codec import from_u64, to_u64  # noqa: E402
from tests.make_synthetic import make_genome, make_sample, write_fasta, write_fastq  # noqa: E402
from tests.test_map import make_index, random_genome, sample_kmers  # noqa: E402

CPU = torch.device("cpu")
B = 64
POLY_A = b"A" * 300  # 280 all-A windows a genome: buckets of 280 x G postings


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


PANELS = {  # name: (strains arguments, G, histogram)
    "g9": (dict(n=9), 9, "words"),
    "g13": (dict(n=13, contigs=True), 13, "words"),
    "g17": (dict(n=17), 17, "words"),
    "polyA4": (dict(n=4, length=150, tail=POLY_A), 4, None),
    "polyA9": (dict(n=9, length=150, tail=POLY_A), 9, None),
    "g40": (dict(n=40, length=120, snps=3), 40, "words"),
}


def panel(tmp_path, name, k=21):
    args, _, _ = PANELS[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    files = strains(rng, **args)
    return files, make_index(tmp_path, files, k)


def permuted(index: BronkoIndex, seed: int) -> BronkoIndex:
    """The same index with every bucket's postings in a random order."""
    rng = np.random.default_rng(seed)
    bucket = np.repeat(np.arange(index.num_buckets), np.diff(index.offsets))
    order = np.lexsort((rng.random(bucket.shape[0]), bucket))
    return BronkoIndex(k=index.k, keys=index.keys, offsets=index.offsets,
                       post_loc=index.post_loc[order], post_meta=index.post_meta[order],
                       files=index.files)


def jax_arrays(jd, **over):
    """A JAX DeviceIndex's arrays as from_jax_arrays takes them."""
    jd.ensure_subindex()
    arrays = dict(
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
    return {**arrays, **over}


def assert_subindex_matches(td, jd):
    """Every genome's sub-index: JAX's padded rows cut to the genome's own
    buckets and postings; int32 postings are JAX's lpos<<22 | meta
    re-packed as lpos<<6 | canon<<5 | idx."""
    jd.ensure_subindex()
    for g in range(td.num_genomes):
        sub = td.subindex(g)
        u, n = sub.keys_ordered.shape[0], sub.postings.shape[0]
        np.testing.assert_array_equal(to_u64(sub.keys_ordered ^ tm.SIGN_BIT),
                                      np.asarray(jd.g_keys[g][:u]))
        assert (np.asarray(jd.g_keys[g][u:]) == tl.KEY_SENTINEL).all()
        np.testing.assert_array_equal(sub.offsets.numpy(), np.asarray(jd.g_offsets[g][:u + 1]))
        want = np.asarray(jd.g_postings[g][:n])
        if sub.postings.dtype == torch.int32:
            want = ((want >> 22) << 6) | (want & 63)
        np.testing.assert_array_equal(sub.postings.numpy(), want)
        assert n == int(np.count_nonzero(
            (np.asarray(jd.postings & 0x3FFFFF) >> 6) == g))


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("name", list(PANELS))
def test_layout_matches_jax(tmp_path, monkeypatch, name, wide):
    """hist_words, the flat tally's genome ids, the int64 postings and every
    genome's sub-index equal the JAX layout's, built here and carried
    across with from_jax_arrays. `wide` builds as for a genome of 2^25 bp
    or more: int64 postings in place of the int32 ones."""
    _, G, hist = PANELS[name]
    _, index = panel(tmp_path, name)
    if wide:
        monkeypatch.setattr(tl, "LOCAL32_LIMIT", 1)
    jd = jl.build_device_index(index)
    td = tl.build_device_index(from_jax_index(index), CPU)
    assert td.num_genomes == G and td.hist is None and jd.hist is None
    assert td.tally_mode() == ("words" if hist else "flat")
    assert (td.max_bucket > 255) == (hist is None)
    if hist:
        assert td.hist_words.shape == (index.num_buckets, -(-G // 8))
        np.testing.assert_array_equal(td.hist_words.numpy(), np.asarray(jd.hist_words))
    else:
        assert td.hist_words is None and jd.hist_words is None
    fids = np.asarray((jd.postings & 0x3FFFFF) >> 6)
    np.testing.assert_array_equal(td.posting_fids().numpy(), fids)
    if wide:
        assert td.postings_local32 is None
        np.testing.assert_array_equal(td.postings.numpy(), np.asarray(jd.postings))
    else:
        assert td.postings is None
        np.testing.assert_array_equal(td.postings_local32.numpy(),
                                      np.asarray(jd.postings_local32))
    assert td.fid_grouped == jd.fid_grouped
    assert_subindex_matches(td, jd)

    over = {"postings_local32": None} if wide else {}
    carried = tl.from_jax_arrays(**jax_arrays(jd, **over), device=CPU)
    np.testing.assert_array_equal(carried.posting_fids().numpy(), fids)
    assert (carried.hist_words is None) == (td.hist_words is None)
    if hist:
        assert torch.equal(carried.hist_words, td.hist_words)
    assert torch.equal(carried.pass2_postings().long(), td.pass2_postings().long())
    for g in range(G):  # carried across, the sub-index keeps JAX's lpos<<22 | meta
        mine, theirs = td.subindex(g), carried.subindex(g)
        assert torch.equal(mine.keys_ordered, theirs.keys_ordered)
        assert torch.equal(mine.offsets, theirs.offsets)
        assert theirs.postings.dtype == torch.int64
        want = theirs.postings if wide else ((theirs.postings >> 22) << 6) | (theirs.postings & 63)
        assert torch.equal(mine.postings.long(), want)


def test_unpad_keeps_a_real_sentinel_bucket():
    """A real bucket keyed 2^64-1 in JAX's padded sub-index: unpadded, each
    row gives what the JAX probe gives. With no pad row it is the last
    real row; with two pads or more fix_sentinel_collision moved its range
    to the last row. With exactly one pad row the fix reads
    offsets_row[u] after overwriting it, so JAX's row is empty and the
    bucket misses, here as there."""
    ukeys = np.array([5, 9, (1 << 64) - 1], np.uint64)
    for u_max, kept in ((3, 3), (4, 2), (6, 3)):
        keys = np.full(u_max, tl.KEY_SENTINEL, np.uint64)
        keys[:3] = ukeys
        offsets = np.full(u_max + 1, 7, np.int32)
        offsets[:4] = [0, 2, 3, 7]
        jl.fix_sentinel_collision(ukeys, offsets, u_max)
        last = int(np.flatnonzero(keys == tl.KEY_SENTINEL)[-1])
        k, o, p = tl._unpad_subindex(keys, offsets, np.arange(9))
        np.testing.assert_array_equal(k, ukeys[:kept])
        np.testing.assert_array_equal(o, [0, 2, 3, 7][:kept + 1])
        assert (offsets[last + 1] - offsets[last] == 4) == (kept == 3)
        np.testing.assert_array_equal(p, np.arange(o[-1]))
    k, o, p = tl._unpad_subindex(np.array([5, 9, tl.KEY_SENTINEL], np.uint64),
                                 np.array([0, 2, 3, 3], np.int32), np.arange(4))
    assert k.tolist() == [5, 9] and o.tolist() == [0, 2, 3] and p.tolist() == [0, 1, 2]


def batches_from(rng, files, k, nb=3, **draw):
    """(nb, B) k-mers and counts drawn from `files`: genome k-mers, mutants,
    junk, some counts zeroed, the tail zero-padded."""
    kc = sample_kmers(rng, files, k, **draw)[:nb * B - 2]
    kc += [(0, 40), (1, 7)]  # poly-A and a one-off of it
    kmers = np.zeros(nb * B, np.uint64)
    counts = np.zeros(nb * B, np.int32)
    kmers[:len(kc)] = [x[0] for x in kc]
    counts[:len(kc)] = [x[1] for x in kc]
    counts[rng.integers(0, len(kc), 8)] = 0
    return kmers.reshape(nb, B), counts.reshape(nb, B)


def torch_batches(kb, cb):
    return [(from_u64(kr, CPU), torch.from_numpy(cr)) for kr, cr in zip(kb, cb)]


def pass2_cfg(mcfg, jd, lanes: int):
    return replace(mcfg, total_len=jd.g_total_len, max_bucket=jd.g_max_bucket,
                   lane_budget=je._lane_class(lanes, floor=1 << 12))


@pytest.mark.parametrize("target", [7, 8, 15, 16])
def test_words_passes_match_jax(tmp_path, target):
    """G = 17, a sample drawn from genome `target` (each side of the word
    boundaries at 8 and 16): pass 1 words (tallies, start, histogram words,
    walk lengths) and pass 2 for every genome equal bronko_tpu's; both
    select `target`."""
    files, index = panel(tmp_path, "g17")
    jd = jl.build_device_index(index)
    td = tl.build_device_index(from_jax_index(index), CPU)
    rng = np.random.default_rng(target)
    kb, cb = batches_from(rng, [files[target]], 21, n_exact=150, n_mut=30, n_junk=5)
    mcfg, pcfg = jd.map_config(2, False), td.map_config(2, False)
    kj, cj = jnp.asarray(kb), jnp.asarray(cb)
    j_t, j_lanes, j_start, j_hw = tally_save_words_jit(
        kj, cj, jd.keys, jd.offsets, jd.hist_words, jnp.zeros((17, 3), jnp.int32), mcfg)

    batches = torch_batches(kb, cb)
    tallies, lanes, saved = tm.tally_save(batches, td, pcfg)
    np.testing.assert_array_equal(tallies.numpy(), np.asarray(j_t))
    np.testing.assert_array_equal(torch.stack([s for s, _ in saved]).numpy(), np.asarray(j_start))
    np.testing.assert_array_equal(torch.stack([h for _, h in saved]).numpy(), np.asarray(j_hw))
    np.testing.assert_array_equal(lanes.max(dim=0).values.numpy(), np.asarray(j_lanes))
    assert te.pick_best_genome(tallies.numpy(), td) == target
    assert je.pick_best_genome(np.asarray(j_t), jd) == target

    gcfg = pass2_cfg(mcfg, jd, int(np.asarray(j_lanes).max()))
    for best in range(17):
        j_pileup, overflow = pileup_from_saved_words_jit(
            kj, cj, j_start, j_hw, jd.postings_local32,
            jnp.zeros((4, jd.g_total_len + 1, 4), jnp.int32), jnp.int32(best),
            jnp.int32(int(jd.file_bases[best])), gcfg)
        assert int(overflow) == 0
        pileup = tm.pileup_from_saved(batches, saved, lanes[:, best].tolist(),
                                      td.postings_local32, best, pcfg, td.g_total_len)
        np.testing.assert_array_equal(pileup.numpy(), np.asarray(j_pileup))
        assert int(pileup[2:].sum()) == int(lanes[:, best].sum())  # one add per lane


def jax_tallies(jd, kj, cj, mcfg, mode):
    if mode == "flat":  # a budget every batch fits: no overflow retry
        mcfg = replace(mcfg, lane_budget=B * len(mcfg.positions) * jd.max_bucket)
    hist = {"hist": jd.hist, "words": jd.hist_words}.get(mode, jnp.zeros(1, jnp.int64))
    t, overflow = tally_all_jit(kj, cj, jd.keys, jd.offsets, jd.postings, hist,
                                jnp.zeros((jd.num_genomes, 3), jnp.int32), mcfg, mode)
    assert int(overflow) == 0
    return np.asarray(t)


@pytest.mark.parametrize("name,mode,ungrouped", [
    ("polyA4", "flat", False), ("polyA9", "flat", False), ("g13", "flat", False),
    ("g13", "words", True), ("g4", "hist", True), ("polyA9", "flat", True)])
def test_tally_and_subindex_pass2_match_jax(tmp_path, name, mode, ungrouped):
    """Pass 1 without a saved probe (tally_all_jit) and the sub-index pass 2
    (pileup_all_jit on JAX's g_keys/g_offsets/g_postings rows) for every
    genome; the flat tally in runs of 7 lanes, so rows split across many
    runs and a poly-A bucket (> 255 postings) runs alone. `ungrouped`
    permutes postings inside their buckets first."""
    if name == "g4":
        rng = np.random.default_rng(4)
        files = strains(rng, 4, contigs=True)
        index = make_index(tmp_path, files, 21)
    else:
        files, index = panel(tmp_path, name)
    if ungrouped:
        index = permuted(index, 3)
    jd = jl.build_device_index(index)
    td = tl.build_device_index(from_jax_index(index), CPU)
    assert td.fid_grouped == jd.fid_grouped == (not ungrouped)
    assert td.tally_mode() == mode or mode == "flat"
    rng = np.random.default_rng(len(name))
    kb, cb = batches_from(rng, files, 21, n_exact=150, n_mut=60, n_junk=10)
    mcfg, pcfg = jd.map_config(2, False), td.map_config(2, False)
    kj, cj = jnp.asarray(kb), jnp.asarray(cb)
    batches = torch_batches(kb, cb)
    tallies, lanes = tm.tally(batches, td, pcfg, mode, lane_chunk=7)
    np.testing.assert_array_equal(tallies.numpy(), jax_tallies(jd, kj, cj, mcfg, mode))
    if mode == "flat" and td.tally_mode() == "words":  # the words' walk lengths too
        _, w_lanes = tm.tally(batches, td, pcfg, "words")
        assert torch.equal(lanes, w_lanes)

    jd.ensure_subindex()
    gcfg = pass2_cfg(mcfg, jd, B * len(mcfg.positions) * jd.g_max_bucket)
    for best in range(td.num_genomes):
        j_pileup, overflow = pileup_all_jit(
            kj, cj, jd.g_keys[best], jd.g_offsets[best], jd.g_postings[best],
            jnp.zeros((4, jd.g_total_len + 1, 4), jnp.int32), gcfg)
        assert int(overflow) == 0
        pileup = tm.pileup_from_subindex(batches, td.subindex(best), lanes[:, best].tolist(),
                                         pcfg, td.g_total_len)
        np.testing.assert_array_equal(pileup.numpy(), np.asarray(j_pileup))
        assert int(pileup[2:].sum()) == int(lanes[:, best].sum())


@pytest.mark.parametrize("name", ["g4", "g13"])
def test_int64_postings_pass2_matches_jax(tmp_path, name):
    """postings_local32 dropped: the saved-probe pass 2 walks the int64
    global postings (pos - file_base, meta = the low 22 bits) and equals
    pileup_from_saved_jit / pileup_from_saved_words_jit on dev.postings."""
    if name == "g4":
        files = strains(np.random.default_rng(14), 4, contigs=True)
        index = make_index(tmp_path, files, 21)
    else:
        files, index = panel(tmp_path, name)
    jd = jl.build_device_index(index)
    td = tl.from_jax_arrays(**jax_arrays(jd, postings_local32=None), device=CPU)
    assert td.pass2_postings().dtype == torch.int64
    kb, cb = batches_from(np.random.default_rng(2), files, 21, n_exact=150, n_mut=60)
    mcfg, pcfg = jd.map_config(2, False), td.map_config(2, False)
    kj, cj = jnp.asarray(kb), jnp.asarray(cb)
    G = td.num_genomes
    if jd.hist is not None:
        j_t, j_lanes, j_start, j_h = tally_save_jit(
            kj, cj, jd.keys, jd.offsets, jd.hist, jnp.zeros((G, 3), jnp.int32), mcfg)
        pass2 = pileup_from_saved_jit
    else:
        j_t, j_lanes, j_start, j_h = tally_save_words_jit(
            kj, cj, jd.keys, jd.offsets, jd.hist_words, jnp.zeros((G, 3), jnp.int32), mcfg)
        pass2 = pileup_from_saved_words_jit
    batches = torch_batches(kb, cb)
    tallies, lanes, saved = tm.tally_save(batches, td, pcfg)
    np.testing.assert_array_equal(tallies.numpy(), np.asarray(j_t))
    gcfg = pass2_cfg(mcfg, jd, int(np.asarray(j_lanes).max()))
    for best in range(G):
        fbase = int(jd.file_bases[best])
        j_pileup, overflow = pass2(kj, cj, j_start, j_h, jd.postings,
                                   jnp.zeros((4, jd.g_total_len + 1, 4), jnp.int32),
                                   jnp.int32(best), jnp.int32(fbase), gcfg)
        assert int(overflow) == 0
        pileup = tm.pileup_from_saved(batches, saved, lanes[:, best].tolist(),
                                      td.pass2_postings(), best, pcfg, td.g_total_len, fbase)
        np.testing.assert_array_equal(pileup.numpy(), np.asarray(j_pileup))


def test_row_chunks_bound_their_lanes():
    """Runs cover every row once, in order; each holds at most the chunk
    plus its longest row, and a row longer than the chunk runs alone."""
    lens = torch.tensor([0, 3, 0, 0, 9, 1, 1, 0, 2, 20, 0, 4], dtype=torch.int32)
    for chunk in (1, 2, 5, 8, 64):
        runs = tm._row_chunks(lens, chunk)
        assert sum(n for _, _, n in runs) == int(lens.sum())
        assert all(int(lens[r0:r1].sum()) == n > 0 for r0, r1, n in runs)
        assert all(r1 <= q0 for (_, r1, _), (q0, _, _) in zip(runs, runs[1:]))
        assert all(n < chunk + int(lens[r0:r1].max()) for r0, r1, n in runs)
    assert tm._row_chunks(torch.zeros(5, dtype=torch.int32), 4) == []


@pytest.fixture(scope="module")
def cli_panels(tmp_path_factory):
    """Three indexes past the single-word histogram and a sample of one of
    their strains with two planted majors: a 13-strain panel, 9 genomes
    with a poly-A stretch (buckets of 2,520 postings), and 6 strains whose
    postings are permuted inside their buckets, written as a reference
    .bkdb (which keeps the in-bucket order)."""
    tmp = tmp_path_factory.mktemp("torch_panels")
    rng = np.random.default_rng(13)
    base = make_genome(rng, 900)
    cases = {}
    for name, n, tail in (("g13", 13, b""), ("polyA9", 9, POLY_A), ("ungrouped", 6, b"")):
        genomes = []
        for i in range(n):
            g = bytearray(base)
            for p in rng.integers(50, 850, 8):
                g[p] = b"ACGT"[(b"ACGT".index(g[p]) + 1) % 4]
            if name == "polyA9":
                g[850:850] = tail
            genomes.append(str(tmp / f"{name}_{i}.fasta"))
            write_fasta(genomes[-1], f"{name}_{i}", bytes(g))
        truth = open(genomes[n // 2]).read().split("\n", 1)[1].replace("\n", "").encode()
        reads, _ = make_sample(truth, rng, read_len=80, depth=120,
                               major_positions={300: 0.95, 700: 0.9}, error_rate=0.002)
        fq = str(tmp / f"{name}.fastq.gz")
        write_fastq(fq, reads)
        db = str(tmp / f"{name}.bkdb")
        index = build_index(21, genomes)
        if name == "ungrouped":
            save_reference_bkdb(permuted(index, 5), db)
        else:
            assert jax_cli.main(["build", "-g", *genomes, "-o", db[:-5]]) == 0
        cases[name] = (db, fq, n // 2)
    return tmp, cases


@pytest.mark.parametrize("name,path", [
    ("g13", ("words", "saved")), ("polyA9", ("flat", "subindex")),
    ("ungrouped", ("hist", "subindex"))])
def test_cli_call_matches_jax(cli_panels, monkeypatch, name, path):
    """`python -m bronko_tpu_torch call --pileup` on the CPU writes
    bronko_tpu's VCF, pileup TSV and overview byte for byte."""
    tmp, cases = cli_panels
    db, fq, truth = cases[name]
    monkeypatch.setenv("BRONKO_PLATFORM", "cpu")
    dev = tl.build_device_index(load_index(db, expect_k=21), CPU)
    assert dev.tally_mode() == path[0] and dev.fid_grouped == (name != "ungrouped")
    out, jout = str(tmp / f"{name}_torch"), str(tmp / f"{name}_jax")
    results = cli.run_call_cmd(cli.call_config(cli.build_parser().parse_args(
        ["call", "-d", db, "-r", fq, "-o", out, "--pileup"])), device=CPU)
    assert [(r.path, r.best) for r in results] == [(path, truth)]
    assert jax_cli.main(["call", "-d", db, "-r", fq, "-o", jout, "--pileup"]) == 0
    files = sorted(os.listdir(jout))
    assert files == sorted(os.listdir(out)) and len(files) == 3
    for f in files:
        with open(os.path.join(out, f), "rb") as got, open(os.path.join(jout, f), "rb") as want:
            assert got.read() == want.read(), f
    vcf = [ln.split("\t") for ln in open(os.path.join(out, f"{name}.vcf"))
           if not ln.startswith("#")]
    assert {"301", "701"} <= {f[1] for f in vcf if f[6] == "PASS"}


def test_run_call_with_int64_postings_matches_jax(cli_panels, monkeypatch):
    """The whole call with the int64 postings (the layout of a genome of
    2^25 bp or more) on the 13-strain panel and on the ungrouped one
    (the sub-index then holds lpos<<22 | meta)."""
    tmp, cases = cli_panels
    monkeypatch.setattr(tl, "LOCAL32_LIMIT", 1)
    for name in ("g13", "ungrouped"):
        db, fq, truth = cases[name]
        index = load_index(db, expect_k=21)
        dev = tl.build_device_index(index, CPU)
        assert dev.postings_local32 is None and dev.postings.dtype == torch.int64
        cfg = CallConfig(db=db, reads=[fq], output=str(tmp / f"{name}_wide"), output_pileup=True)
        (res,) = te.run_call(cfg, index, dev)
        assert res.best == truth
        if name == "ungrouped":
            assert dev.subindex(truth).postings.dtype == torch.int64
        jout = str(tmp / f"{name}_jax")
        if not os.path.exists(jout):
            assert jax_cli.main(["call", "-d", db, "-r", fq, "-o", jout, "--pileup"]) == 0
        for f in sorted(os.listdir(jout)):
            assert open(os.path.join(cfg.output, f)).read() == open(os.path.join(jout, f)).read()
