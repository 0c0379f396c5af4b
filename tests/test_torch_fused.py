"""The port's map with the saved probe on the single histogram word (the
engine's one-part PendingMap: tally_save, the host pick, pileup_from_saved)
on the CPU against bronko_tpu's fused map_fused_jit and run_call:
tallies, walk lengths, the pick and the pileup array-equal; the host pick
against JAX's device pick; a cohort's files byte-equal with its samples
saved, through the sub-index and in JAX; the path chosen by the index
alone; a sample with no positive score; and the plain versions of
kernels (b) and (c) against the JAX bodies they fuse. Every comparison is
exact (tolerance 0)."""

import logging
import os
import shutil
from dataclasses import replace
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import bronko_tpu.call.engine as je  # noqa: E402
import bronko_tpu.config as jc  # noqa: E402
import bronko_tpu.index.build as jb  # noqa: E402
import bronko_tpu.index.layout as jl  # noqa: E402
from bronko_tpu.ops import map as jm  # noqa: E402
import bronko_tpu_torch.call.engine as te  # noqa: E402
from bronko_tpu_torch.config import CallConfig  # noqa: E402
from bronko_tpu_torch.index import layout as tl  # noqa: E402
from bronko_tpu_torch.index.model import from_jax_index  # noqa: E402
from bronko_tpu_torch.ops import map as tm  # noqa: E402
from bronko_tpu_torch.ops.codec import from_u64  # noqa: E402
from bronko_tpu_torch.ops.count import CountStats  # noqa: E402
from bronko_tpu_torch.ops.cuda_buckets import bucket_queries_plain, fold_table_plain  # noqa: E402
from bronko_tpu_torch.ops.cuda_map import probe_tally_plain, walk_scatter_plain  # noqa: E402
from tests.make_synthetic import make_genome, make_sample, write_fasta, write_fastq  # noqa: E402
from tests.test_map import make_index, random_genome  # noqa: E402
from tests.test_torch_layout import _jax_arrays  # noqa: E402
from tests.test_torch_map import _batches, _files  # noqa: E402

CPU = torch.device("cpu")
CASES = [("g1", False), ("g4", False), ("g6", False), ("g8_signbit", False),
         ("twins", False), ("g4", True)]


def _panel(tmp_path, case, wide):
    """(JAX DeviceIndex, the port's on the CPU, the port's index, (nb, B)
    k-mers and counts); `wide` drops the int32 postings, so both walk the
    int64 global ones (a genome of 2^25 bp or more)."""
    rng = np.random.default_rng(sum(map(ord, case)) + 3 * wide)
    files = _files(rng, case)
    index = make_index(tmp_path, files, 21)
    jd = jl.build_device_index(index)
    if wide:
        jd = replace(jd, postings_local32=None)
        td = tl.from_jax_arrays(**{**_jax_arrays(jd), "postings_local32": None}, device=CPU)
        assert td.pass2_postings().dtype == torch.int64
    else:
        td = tl.build_device_index(from_jax_index(index), CPU)
    assert td.hist is not None and td.fid_grouped
    kb, cb = _batches(rng, files, 21)
    return jd, td, from_jax_index(index), kb, cb


def _port_batches(kb, cb):
    return [(from_u64(kr, CPU), torch.from_numpy(cr)) for kr, cr in zip(kb, cb)]


@pytest.mark.parametrize("case,wide", CASES)
def test_map_fused_matches_jax(tmp_path, case, wide):
    """The engine's one-part PendingMap (_map_one: pass 1 with the saved
    probe; its resolve: the host pick, pass 2 from the probe) against
    map_fused_jit with a lane budget no batch overflows: tallies, lane
    totals (JAX keeps the max over batches), the saved probe, the pick
    (the first maximum on a tie) and the pileup."""
    jd, td, tindex, kb, cb = _panel(tmp_path, case, wide)
    batches = _port_batches(kb, cb)
    mcfg = td.map_config(2, False)
    counted = te.Counted(kb.reshape(-1), cb.reshape(-1).astype(np.int64),
                         CountStats(unique_counted_kmers=kb.size), batches, {})
    pending = te._map_one(counted, tindex, td, CallConfig(n_fixed=2, use_full_kmer=False))
    assert isinstance(pending, te.PendingMap) and pending.path == ("hist", "saved")
    ((_, lanes, saved),) = pending.parts
    mapped = pending.resolve(tindex, td)
    tallies, best, pileup = mapped.tallies, mapped.best, mapped.pileup

    jcfg = jd.map_config(2, False)
    gcfg = replace(jcfg, total_len=jd.g_total_len, max_bucket=jd.g_max_bucket,
                   lane_budget=je._lane_class(int(lanes.max()), floor=1 << 10))
    post = jd.postings_local32 if jd.postings_local32 is not None else jd.postings
    out = jm.map_fused_jit(
        jnp.asarray(kb), jnp.asarray(cb), jd.keys, jd.offsets, jd.hist, post,
        jnp.zeros((jd.num_genomes, 3), jnp.int32),
        jnp.asarray(2 * jd.genome_lens.astype(np.int64)),
        jnp.asarray(jd.file_bases.astype(np.int32)), jcfg, gcfg)
    j_tallies, j_lanes, j_best, j_start, j_h, j_pileup, j_overflow = out[:7]
    assert int(j_overflow) == 0
    np.testing.assert_array_equal(tallies, np.asarray(j_tallies))
    np.testing.assert_array_equal(lanes.max(dim=0).values.numpy(), np.asarray(j_lanes))
    assert best == int(j_best)
    np.testing.assert_array_equal(torch.stack([s for s, _ in saved]).numpy(),
                                  np.asarray(j_start))
    np.testing.assert_array_equal(torch.stack([h for _, h in saved]).numpy(),
                                  np.asarray(j_h))
    np.testing.assert_array_equal(pileup, np.asarray(j_pileup))
    assert int(pileup[2:].sum()) == int(lanes[:, best].sum())  # one add per lane
    if case == "twins":
        assert tallies[0, 0] == tallies[1, 0] > 0 and best == 0


@pytest.mark.parametrize("perfect,lens", [
    ([10, 10], [100, 100]), ([10, 20], [100, 200]), ([10, 21], [100, 200]),
    ([16777216, 16777217], [1000, 1000]), ([0, 5, 5], [0, 50, 50]), ([0, 0], [10, 10])])
def test_pick_best_device_matches_jax(perfect, lens):
    """The host pick (engine.pick_best_genome) equals JAX's device pick
    _pick_best_device where a score is positive (ties: the first maximum;
    a genome of length 0 never wins), and is None where none is."""
    tallies = np.zeros((len(perfect), 3), np.int32)
    tallies[:, 0] = perfect
    glen2 = 2 * np.asarray(lens, np.int64)
    want = int(jm._pick_best_device(jnp.asarray(tallies), jnp.asarray(glen2)))
    dev = type("Dev", (), {"num_genomes": len(perfect), "genome_lens": np.asarray(lens)})
    host = te.pick_best_genome(tallies.astype(np.int64), dev)
    positive = any(p > 0 and n > 0 for p, n in zip(perfect, lens))
    assert host == (want if positive else None)


@pytest.mark.parametrize("case,wide", [("g4", False), ("g8_signbit", False), ("g4", True)])
def test_plain_kernels_match_jax_bodies(tmp_path, case, wide):
    """probe_tally_plain after K1's plain version against JAX's
    _tally_save_body, and walk_scatter_plain after K2's against
    _pileup_from_saved_body for every genome, through the saved-probe
    entry and the (start, lens) one."""
    jd, td, _, kb, cb = _panel(tmp_path, case, wide)
    batches = _port_batches(kb, cb)
    mcfg = td.map_config(2, False)
    G, k = td.num_genomes, mcfg.k
    tallies = torch.zeros((G, 3), dtype=torch.int32)
    saved, lanes = [], []
    for kmers, counts in batches:
        q, _, _ = bucket_queries_plain(kmers, k, mcfg.positions)
        start, h, batch_lanes = probe_tally_plain(q, counts, td.keys_ordered, td.probe_dir(),
                                                  td.offsets, td.hist, tallies)
        saved.append((start, h))
        lanes.append(batch_lanes)
    jcfg = jd.map_config(2, False)
    kj, cj = jnp.asarray(kb), jnp.asarray(cb)
    body = jax.jit(partial(jm._tally_save_body, cfg=jcfg))
    j_tallies, j_lanes, j_start, j_h = body(kj, cj, jd.keys, jd.offsets, jd.hist,
                                            jnp.zeros((G, 3), jnp.int32))
    np.testing.assert_array_equal(tallies.numpy(), np.asarray(j_tallies))
    np.testing.assert_array_equal(torch.stack(lanes).max(dim=0).values.numpy(),
                                  np.asarray(j_lanes))
    np.testing.assert_array_equal(torch.stack([s for s, _ in saved]).numpy(),
                                  np.asarray(j_start))
    np.testing.assert_array_equal(torch.stack([h for _, h in saved]).numpy(),
                                  np.asarray(j_h))

    postings = td.pass2_postings()
    bases = torch.from_numpy(td.file_bases)
    post = jd.postings_local32 if jd.postings_local32 is not None else jd.postings
    for best in range(G):
        gcfg = replace(jcfg, total_len=jd.g_total_len, max_bucket=jd.g_max_bucket,
                       lane_budget=je._lane_class(int(j_lanes[best]), floor=1 << 10))
        j_pileup, overflow = jax.jit(partial(jm._pileup_from_saved_body, cfg=gcfg))(
            kj, cj, j_start, j_h, post, jnp.zeros((4, jd.g_total_len + 1, 4), jnp.int32),
            jnp.int32(best), jnp.int32(int(jd.file_bases[best])))
        assert int(overflow) == 0
        best_t = torch.tensor([best])
        by_saved = torch.zeros((4, td.g_total_len + 1, 4), dtype=torch.int32)
        by_rows = torch.zeros_like(by_saved)
        for (kmers, counts), (start, h) in zip(batches, saved):
            pc = fold_table_plain(kmers, counts, k)
            walk_scatter_plain(by_saved, pc, start, postings, k=k, h=h, best=best_t,
                               file_base=bases if wide else None)
            hb = tm._hist_bytes(h)
            walk_scatter_plain(by_rows, pc, start + hb[..., :best].sum(-1, dtype=torch.int32),
                               postings, k=k, lens=hb[..., best].to(torch.int32),
                               file_base=bases[best:best + 1] if wide else None)
        np.testing.assert_array_equal(by_saved.numpy(), np.asarray(j_pileup))
        np.testing.assert_array_equal(by_rows.numpy(), np.asarray(j_pileup))


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    """A 1.2 kb genome and a decoy of it (G = 2, the synth genome first),
    three copies of one deep sample and a sample of an unrelated genome
    (no k-mer maps: no positive score); the index in both packages."""
    tmp = tmp_path_factory.mktemp("torch_fused")
    rng = np.random.default_rng(41)
    genome = make_genome(rng, 1200)
    decoy = bytearray(genome)
    for p in rng.integers(0, len(decoy), 40):
        decoy[p] = b"ACGT"[(b"ACGT".index(decoy[p]) + 1) % 4]
    refs = [str(tmp / "ref.fasta"), str(tmp / "decoy.fasta")]
    write_fasta(refs[0], "sref", genome)
    write_fasta(refs[1], "decoy", bytes(decoy))
    reads, _ = make_sample(genome, rng, read_len=80, depth=240,
                           major_positions={300: 0.92}, minor_positions={700: 0.15},
                           error_rate=0.004)
    fq = str(tmp / "samp.fastq.gz")
    write_fastq(fq, reads)
    fqs = []
    for i in range(3):
        fqs.append(str(tmp / f"fused_{i}.fastq.gz"))
        shutil.copy(fq, fqs[-1])
    other, _ = make_sample(random_genome(rng, 1200), rng, read_len=80, depth=60,
                           major_positions={}, error_rate=0.0)
    junk = str(tmp / "unmapped.fastq.gz")
    write_fastq(junk, other)
    return refs, fqs, junk, jb.build_index(21, refs)


def _outputs(out):
    return {f: open(os.path.join(out, f), "rb").read() for f in sorted(os.listdir(out))}


def _port_run(cohort, reads, out, monkeypatch, cap=None):
    """The port's run_call on the CPU on a fresh DeviceIndex; `cap` sets
    PROBE_BYTES_CAP (1: no probe is saved, so every sample takes the
    sub-index pass 2). Returns (results, files)."""
    refs, _, _, jindex = cohort
    monkeypatch.setenv("BRONKO_NO_STREAM", "1")
    if cap is not None:
        monkeypatch.setattr(te, "PROBE_BYTES_CAP", cap)
    index = from_jax_index(jindex)
    dev = tl.build_device_index(index, CPU)
    res = te.run_call(CallConfig(genomes=refs, reads=reads, output=out, output_pileup=True,
                                 batch_size=4096, chunk_reads=8192), index, dev)
    monkeypatch.undo()
    return res, _outputs(out)


def _jax_run(cohort, reads, out, monkeypatch):
    """bronko_tpu's run_call with its ratio pre-seeded, so every sample
    takes its fused dispatch (tests/test_engine.py:586-589)."""
    refs, _, _, jindex = cohort
    monkeypatch.setenv("BRONKO_NO_STREAM", "1")
    dev = jl.build_device_index(jindex)
    dev.fused_ratio = 8.0
    je.run_call(jc.CallConfig(genomes=refs, reads=reads, output=out, output_pileup=True,
                              batch_size=4096, chunk_reads=8192), jindex, dev)
    monkeypatch.undo()
    return _outputs(out)


def test_fused_cohort_matches_jax_and_two_pass(cohort, tmp_path, monkeypatch, caplog):
    """Three samples on the single histogram word all take ('hist',
    'saved'), the first one too, and write the files of bronko_tpu's
    fused run and of the port's sub-index run (the probe cap at 1 byte:
    ('hist', 'subindex')), byte for byte."""
    _, fqs, _, _ = cohort
    with caplog.at_level(logging.INFO, logger="bronko"):
        saved, files = _port_run(cohort, fqs, str(tmp_path / "saved"), monkeypatch)
        assert sum(r.getMessage().startswith("Tallied") for r in caplog.records) == 3
        caplog.clear()
        want = _jax_run(cohort, fqs, str(tmp_path / "jax"), monkeypatch)
        assert any("(fused)" in r.getMessage() for r in caplog.records)
    subindex, files_2 = _port_run(cohort, fqs, str(tmp_path / "subindex"), monkeypatch, cap=1)
    assert [r.path for r in saved] == [("hist", "saved")] * 3
    assert [r.path for r in subindex] == [("hist", "subindex")] * 3
    assert len(files) == 7 and files == want
    assert files_2 == files
    for a, b in zip(saved, subindex):
        assert a.best == b.best == 0
        np.testing.assert_array_equal(a.tallies, b.tallies)
        np.testing.assert_array_equal(a.pileup, b.pileup)
        assert set(a.seconds) == set(te.STAGES + te.SPAN_KEYS)


def test_path_follows_the_index_alone(cohort, tmp_path, monkeypatch):
    """Which path a sample takes depends on the index, not on what ran
    before it: on one DeviceIndex reused across runs, each run's lone
    sample saves its probe. On the CPU its stage seconds are wall seconds
    (every one present, none negative), the spans' parts beside them."""
    _, fqs, _, jindex = cohort
    index = from_jax_index(jindex)
    dev = tl.build_device_index(index, CPU)
    results = []
    for i in range(2):
        monkeypatch.setenv("BRONKO_NO_STREAM", "1")
        (res,) = te.run_call(CallConfig(genomes=cohort[0], reads=[fqs[i]],
                                        output=str(tmp_path / f"o{i}"), batch_size=4096,
                                        chunk_reads=8192), index, dev)
        results.append(res)
    assert [r.path for r in results] == [("hist", "saved")] * 2
    for r in results:
        assert tuple(r.seconds) == te.STAGES + te.SPAN_KEYS and min(r.seconds.values()) >= 0
        assert r.seconds["pass1"] > 0
    np.testing.assert_array_equal(results[0].pileup, results[1].pileup)


def test_no_positive_score_fails_alone(cohort, tmp_path, monkeypatch, caplog):
    """A sample whose k-mers map nowhere fails alone in its resolve
    ("Unable to pick a best genome"), as in JAX; the others' files equal
    JAX's."""
    _, fqs, junk, _ = cohort
    reads = [fqs[0], junk, fqs[1]]
    with caplog.at_level(logging.INFO, logger="bronko"):
        res, got = _port_run(cohort, reads, str(tmp_path / "torch"), monkeypatch)
    assert "Unable to pick a best genome" in caplog.text
    assert f"Sample {junk} failed" in caplog.text
    assert [r.summary.filename for r in res] == [fqs[0], fqs[1]]
    assert got == _jax_run(cohort, reads, str(tmp_path / "jax"), monkeypatch)
