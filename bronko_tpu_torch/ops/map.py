"""K-mer mapper on torch tensors: genome tallies (pass 1) and the selected
genome's pileup (pass 2).

Counterpart of the single-device paths of `bronko_tpu/ops/map.py`
(tally_save_jit, tally_save_words_jit, tally_all_jit,
pileup_from_saved_jit, pileup_from_saved_words_jit, pileup_all_jit; see
that module's docstring for the reference semantics):

PASS 1 — per batch: K1 canonicalizes the k-mers and computes the J
filtered bucket ids; a binary search over the sorted keys finds each
query's row (the LAST equal row, as the JAX merge probe picks); on either
histogram, over the rows of the query's slot of the index's directory. Per-genome
posting hits then come from the row's histogram — the single packed word
or the multi-word one, both read as bytes, genome g in byte g — or, with
no histogram, from the flat tally: every posting of every hit bucket
counts one for its genome, walked by kernel (d) (ops/cuda_map.walk_hits).
Hits are classified as perfect / variant / unique. On either histogram,
kernel (b) (ops/cuda_map.probe_tally) does the search, the pickup and the
classification in one launch. `tally_save` also keeps each batch's probe
(CSR start, histogram) for pass 2.

PASS 2 — for the selected genome only: K2 builds the per-(k-mer,
position) fold table; kernel (c) (ops/cuda_map.walk_scatter) walks each
(k-mer, bucket)'s exact range of the genome's postings, decodes them and
max-es the k-mer count into the depth planes and adds 1 into the count
planes of the (4, Tg+1, 4) int32 pileup. The range comes from the saved
probe (bucket start + the bytes of the genomes below, when postings are
grouped by genome; (c) reads them from the single word or the W words)
or from a K1 probe of the genome's own sub-index.
Integer max and add give the same result in any order. Every walk is
exact and loops over its own range, so no lane count known on the host
sizes it, and the JAX path's lane budget, overflow retry and dump-row
masking have no job.

WHOLE INDEX — probe_scatter / map_batch (JAX's, the step entry.py and the
mesh's map step drive): one batch's K1 probe, the exact walk of every
genome's postings at their global position by kernel (c), the K2 fold and
the scatter into the all-genome pileup, with hits by posting genome from
kernel (d) on the same ranges. No host sync: the flat tally and
probe_scatter size no walk on the host.

Every function takes tensors on one device; the kernels dispatch on it
(ops/cuda_buckets.py, ops/cuda_map.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from bronko_tpu_torch.ops.buckets import filtered_bucket_positions
from bronko_tpu_torch.ops.cuda_buckets import bucket_queries, fold_table
from bronko_tpu_torch.ops.cuda_map import (  # noqa: F401 — the mapper's names
    FLAT_LANE_CHUNK, PLANE_CNT_FWD, PLANE_CNT_REV, PLANE_DEPTH_FWD, PLANE_DEPTH_REV, SIGN_BIT,
    _hist_bytes, _hist_hits, _probe, _row_chunks, classify_tallies, probe_tally, walk_hits,
    walk_scatter,
)


@dataclass(frozen=True)
class MapConfig:
    k: int
    positions: tuple[int, ...]  # filtered wildcard positions
    max_bucket: int             # E: max bucket size (info only)
    num_genomes: int            # G
    total_len: int              # T: sum of all sequence lengths (all genomes)


def make_map_config(*, k: int, max_bucket: int, num_genomes: int,
                    total_len: int, n_fixed: int, use_full_kmer: bool) -> MapConfig:
    return MapConfig(
        k=k,
        positions=tuple(filtered_bucket_positions(k, n_fixed, use_full_kmer)),
        max_bucket=max_bucket,
        num_genomes=num_genomes,
        total_len=total_len,
    )


def _bucket_q(kmers: torch.Tensor, *, cfg: MapConfig):
    """(q (B, J) int64, canon (B,), is_rc (B,)) through kernel K1."""
    return bucket_queries(kmers, cfg.k, cfg.positions)


def _ranges(kmers, counts, keys_ordered, offsets, *, cfg: MapConfig):
    """Each (k-mer, bucket) query's CSR range in one index: (start, lens)
    (B, J) int32, both zero on a miss and for zero-count k-mers."""
    q, _, _ = _bucket_q(kmers, cfg=cfg)
    rowc, hit = _probe(q, keys_ordered)
    hit &= (counts > 0)[:, None]
    start = offsets[rowc]
    return torch.where(hit, start, 0), torch.where(hit, offsets[rowc + 1] - start, 0)


def _probe_hist(kmers, counts, dev, hist, *, cfg: MapConfig):
    """Probe one batch: returns (h, start): h (B, J) or (B, J, W) rows of
    `hist`, zero on a miss and for zero-count k-mers; start (B, J) int32
    CSR row starts, zero on a miss. `dev` is the port's DeviceIndex."""
    q, _, _ = _bucket_q(kmers, cfg=cfg)
    rowc, hit = _probe(q, dev.keys_ordered)
    valid = hit & (counts > 0)[:, None]
    h = torch.where(valid if hist.dim() == 1 else valid[..., None], hist[rowc], 0)
    return h, torch.where(hit, dev.offsets[rowc], 0)


def _flat_hits(kmers, counts, dev, *, cfg: MapConfig, lane_chunk: int) -> torch.Tensor:
    """(B, G) int32 posting hits without a histogram: every posting of every
    hit bucket adds one at its genome (JAX tally_flat), kernel (d) on the
    probe's ranges and the postings' genome ids (`lane_chunk` sizes the
    plain version's runs)."""
    start, lens = _ranges(kmers, counts, dev.keys_ordered, dev.offsets, cfg=cfg)
    return walk_hits(start, lens, dev.posting_fids(), cfg.num_genomes, lane_chunk)


def _stack_lanes(lanes: list, G: int, device) -> torch.Tensor:
    """The batches' (G,) walk lengths as one (nb, G) int64 tensor."""
    return (torch.stack(lanes) if lanes
            else torch.zeros((0, G), dtype=torch.int64, device=device))


def _tally_probe(batches, dev, cfg: MapConfig, save: bool):
    """Pass 1 on the histogram, the single word or the multi-word one: K1,
    then kernel (b) a batch. Keeps each batch's probe only when `save`,
    so without it one batch's probe is alive at a time."""
    G = cfg.num_genomes
    hist = dev.hist if dev.hist is not None else dev.hist_words
    tallies = torch.zeros((G, 3), dtype=torch.int32, device=dev.device)
    lanes, saved = [], []
    for kmers, counts in batches:
        q, _, _ = _bucket_q(kmers, cfg=cfg)
        start, h, batch_lanes = probe_tally(q, counts, dev.keys_ordered, dev.probe_dir(),
                                            dev.offsets, hist, tallies)
        if save:
            saved.append((start, h))
        lanes.append(batch_lanes)
    return tallies, _stack_lanes(lanes, G, dev.device), saved


def tally_save(batches, dev, cfg: MapConfig):
    """Pass 1 with the saved probe on the histogram, the single word or the
    multi-word one: K1, then kernel (b) a batch. Returns (tallies, lanes)
    as `tally` does, and saved[i] = (start (B, J) int32, h (B, J) or (B,
    J, W)), batch i's probe."""
    return _tally_probe(batches, dev, cfg, save=True)


def tally(batches, dev, cfg: MapConfig, mode: str, lane_chunk: int = FLAT_LANE_CHUNK):
    """Pass 1 without a saved probe over `batches`, a sequence of (kmers
    (B,) int64, counts (B,) int32) pairs; zero counts mark padding. mode:
    'hist' (single-word histogram) or 'words' (multi-word), both kernel
    (b) and each only on an index that holds that histogram, or 'flat'
    (every posting, kernel (d), on any index; its plain version in runs
    of at most `lane_chunk` lanes plus one bucket).

    Returns (tallies (G, 3) int32, lanes (nb, G) int64): lanes[i, g] is
    the number of postings of genome g that batch i's hits cover — the
    exact length of its pass-2 walk."""
    if mode != "flat":
        if mode != dev.tally_mode():
            raise ValueError(f"tally mode {mode!r} on an index whose histogram is "
                             f"{dev.tally_mode()!r}")
        return _tally_probe(batches, dev, cfg, save=False)[:2]
    G = cfg.num_genomes
    tallies = torch.zeros((G, 3), dtype=torch.int32, device=dev.device)
    lanes = []
    for kmers, counts in batches:
        hits = _flat_hits(kmers, counts, dev, cfg=cfg, lane_chunk=lane_chunk)
        tallies += classify_tallies(hits, counts > 0, len(cfg.positions))
        lanes.append(hits.sum(dim=0, dtype=torch.int64))
    return tallies, _stack_lanes(lanes, G, dev.device)


def _fold_table(kmers: torch.Tensor, counts: torch.Tensor, k: int) -> torch.Tensor:
    """(B*k,) int32 fold table through kernel K2."""
    return fold_table(kmers, counts, k)


def _genome_scalar(value: int, device) -> torch.Tensor:
    """(1,) int64 holding `value` on `device`, written there by a fill (no
    host copy, so no sync)."""
    return torch.full((1,), value, dtype=torch.int64, device=device)


def pileup_from_saved(batches, saved, lanes, postings: torch.Tensor,
                      best: int, cfg: MapConfig, total_len: int,
                      file_base: int = 0) -> torch.Tensor:
    """Pass 2 for genome `best` from pass 1's saved probe: the (4,
    total_len+1, 4) int32 pileup in the genome's local coordinates, K2
    and kernel (c) a batch. Genome `best`'s range in a bucket starts after
    the postings of the genomes below it (postings grouped by genome), so
    its length is its histogram byte and its offset the sum of the bytes
    below: (c) derives both from the saved words, one or W a row.
    `lanes` (host ints, or None) only skips the batches whose walk for
    `best` is empty; nothing is sized by it. `postings` are the int32
    genome-local postings, or the int64 global ones with `file_base` the
    genome's global offset."""
    device = postings.device
    pileup = torch.zeros((4, total_len + 1, 4), dtype=torch.int32, device=device)
    best_t = base_t = None
    if postings.dtype == torch.int64:
        base_t = _genome_scalar(file_base, device)
    for i, ((kmers, counts), (start, h)) in enumerate(zip(batches, saved)):
        if lanes is not None and int(lanes[i]) == 0:
            continue
        if best_t is None:
            best_t = _genome_scalar(best, device)
        walk_scatter(pileup, _fold_table(kmers, counts, cfg.k), start, postings, k=cfg.k, h=h,
                     best=best_t, file_base=base_t)
    return pileup


def pileup_from_subindex(batches, sub, lanes, cfg: MapConfig,
                         total_len: int) -> torch.Tensor:
    """Pass 2 through the selected genome's sub-index `sub` (layout
    SubIndex): K1 queries probed over its keys (the last equal row), each
    hit's range walked in its genome-local postings by kernel (c).
    `lanes[i]` (a host int) skips batch i where pass 1 counted no walk
    for the genome; with lanes None every batch is walked, as a rank of
    the mesh walks k-mers pass 1 did not count. No host sync."""
    pileup = torch.zeros((4, total_len + 1, 4), dtype=torch.int32,
                         device=sub.postings.device)
    for i, (kmers, counts) in enumerate(batches):
        if lanes is not None and int(lanes[i]) == 0:
            continue
        start, lens = _ranges(kmers, counts, sub.keys_ordered, sub.offsets, cfg=cfg)
        walk_scatter(pileup, _fold_table(kmers, counts, cfg.k), start, sub.postings,
                     k=cfg.k, lens=lens)
    return pileup


def probe_scatter(kmers, counts, keys_ordered, offsets, postings, pileup, *, cfg: MapConfig):
    """One batch against a whole index, or one genome shard of it (JAX
    probe_scatter, map.py:122-170): K1 probes the keys, each hit bucket's
    postings are walked exactly at their position in the pileup's space,
    K2's fold table decodes them into the depth and count planes of a copy
    of `pileup` ((4, T+1, 4) int32) through kernel (c), and every posting
    counts one hit for its genome through kernel (d) on the same ranges.
    The walks are exact, so there is no lane budget, no overflow flag and
    no host sync. `postings` are int64 pos<<22 | fid<<6 | canon<<5 | idx
    (DeviceIndex.global_postings, or a shard's). Returns (pileup, hits
    (B, G) int32)."""
    start, lens = _ranges(kmers, counts, keys_ordered, offsets, cfg=cfg)
    out = pileup.clone()
    walk_scatter(out, _fold_table(kmers, counts, cfg.k), start, postings, k=cfg.k, lens=lens)
    return out, walk_hits(start, lens, postings, cfg.num_genomes)


def map_batch(kmers, counts, keys_ordered, offsets, postings, pileup, tallies, *,
              cfg: MapConfig):
    """One mapping step over the whole index (JAX map_batch, map.py:343-350):
    probe_scatter, and the batch's perfect / variant / unique counts added
    to `tallies`. Returns (pileup, tallies), both new tensors."""
    pileup, hits = probe_scatter(kmers, counts, keys_ordered, offsets, postings, pileup,
                                 cfg=cfg)
    return pileup, tallies + classify_tallies(hits, counts > 0, len(cfg.positions))
