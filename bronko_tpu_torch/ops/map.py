"""K-mer mapper on torch tensors: genome tallies (pass 1) and the selected
genome's pileup (pass 2).

Counterpart of the single-device paths of `bronko_tpu/ops/map.py`
(tally_save_jit, tally_save_words_jit, tally_all_jit,
pileup_from_saved_jit, pileup_from_saved_words_jit, pileup_all_jit; see
that module's docstring for the reference semantics):

PASS 1 — per batch: K1 canonicalizes the k-mers and computes the J
filtered bucket ids; a binary search over the sorted keys finds each
query's row (the LAST equal row, as the JAX merge probe picks). Per-genome
posting hits then come from the row's histogram — the single packed word
or the multi-word one, both read as bytes, genome g in byte g — or, with
no histogram, from the flat tally: every posting of every hit bucket
counts one for its genome. Hits are classified as perfect / variant /
unique. `tally_save` also keeps each batch's probe (CSR start,
histogram) for pass 2.

PASS 2 — for the selected genome only: K2 builds the per-(k-mer,
position) fold table; each (k-mer, bucket) walks its exact range of the
genome's postings, decodes them and scatter-maxes the k-mer count into
the depth planes and scatter-adds 1 into the count planes of the
(4, Tg+1, 4) int32 pileup. The range comes from the saved probe (bucket
start + the bytes of the genomes below, when postings are grouped by
genome) or from a K1 probe of the genome's own sub-index. Integer max and
add give the same result in any order. Every walk is exact — its length
comes from pass 1 — so the JAX path's lane budget, overflow retry and
dump-row masking have no job.

Every function takes tensors on one device; K1 and K2 dispatch on it
(ops/cuda_buckets.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from bronko_tpu_torch.ops.buckets import filtered_bucket_positions
from bronko_tpu_torch.ops.cuda_buckets import bucket_queries, fold_table

# pileup tensor layout: (n_planes=4, T+1, 4 bases)
# plane 0: depth fwd, 1: depth rev, 2: counts fwd, 3: counts rev
PLANE_DEPTH_FWD = 0
PLANE_DEPTH_REV = 1
PLANE_CNT_FWD = 2
PLANE_CNT_REV = 3

SIGN_BIT = -(1 << 63)  # int64 with only bit 63 set
# lanes the flat tally expands at once (plus at most one bucket's postings)
FLAT_LANE_CHUNK = 1 << 24


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


def _probe(q: torch.Tensor, keys_ordered: torch.Tensor):
    """Key row of each bucket query: (row, hit). A query resolves to the
    LAST row whose key equals it (the JAX merge probe's rule, which the
    sentinel-collision fix relies on); row is 0 where hit is False.
    `keys_ordered` are the sorted keys with bit 63 flipped, which turns
    their unsigned order into searchsorted's signed one, so ids >= 2^63
    (k=31 wraps) order and match correctly."""
    qs = q ^ SIGN_BIT
    row = torch.searchsorted(keys_ordered, qs, right=True) - 1
    rowc = row.clamp_min(0)
    return rowc, (row >= 0) & (keys_ordered[rowc] == qs)


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


def _hist_bytes(h: torch.Tensor) -> torch.Tensor:
    """(B, J) or (B, J, W) histogram words -> (B, J, bytes) uint8: genome g's
    count is byte g (little-endian words, 8 genomes a word)."""
    return (h[..., None] if h.dim() == 2 else h).view(torch.uint8)


def _hist_hits(h: torch.Tensor, G: int) -> torch.Tensor:
    """Histogram words -> (B, G) int32 posting hits: the bytes summed over J."""
    return _hist_bytes(h).sum(dim=1, dtype=torch.int32)[:, :G]


def classify_tallies(hits: torch.Tensor, valid_kmer: torch.Tensor, nb: int) -> torch.Tensor:
    """Perfect / variant / unique-perfect counts per genome, (G, 3) int32
    (call.rs:1390-1418). Duplicate postings within a genome can push hits
    past nb; such a k-mer counts as 'variant', as in the reference."""
    valid = valid_kmer[:, None]
    perfect = (hits == nb) & valid
    variant = (hits > 0) & (hits != nb) & valid
    unique = perfect & (perfect.sum(dim=1, keepdim=True) == 1)
    return torch.stack(
        [perfect.sum(dim=0), variant.sum(dim=0), unique.sum(dim=0)], dim=1
    ).to(torch.int32)


def _walk(startf: torch.Tensor, lensf: torch.Tensor, n_lanes: int):
    """Exact posting walk: lane l of row r reads posting startf[r] + l -
    (the lanes of the rows before r). Returns (row (n_lanes,) of lensf's
    dtype, posting index (n_lanes,) int64); n_lanes must be lensf's sum."""
    own = torch.repeat_interleave(lensf, output_size=n_lanes)
    first_lane = torch.cumsum(lensf, dim=0) - lensf
    lane = torch.arange(n_lanes, dtype=torch.int64, device=lensf.device)
    return own, startf[own] + (lane - first_lane[own])


def _row_chunks(lensf: torch.Tensor, lane_chunk: int):
    """Split the rows into consecutive (r0, r1, lanes) runs: a run holds
    the rows whose first lane falls in one lane_chunk-wide window, so its
    lanes stay below lane_chunk plus the longest row. Two host syncs."""
    cum = torch.cumsum(lensf, dim=0, dtype=torch.int64)
    total = int(cum[-1]) if cum.numel() else 0
    if total == 0:
        return []
    excl = torch.cat([cum - lensf, cum[-1:]])  # first lane of each row, then the end
    targets = torch.arange(lane_chunk, max(total, lane_chunk), lane_chunk, device=lensf.device)
    cuts = torch.searchsorted(excl[:-1], targets)
    edges = torch.cat([cuts.new_zeros(1), cuts, cuts.new_full((1,), lensf.numel())])
    first = torch.stack([edges, excl[edges]]).cpu().tolist()
    return [(r0, r1, l1 - l0) for r0, r1, l0, l1 in zip(first[0], first[0][1:],
                                                        first[1], first[1][1:])
            if l1 > l0]


def _flat_hits(kmers, counts, dev, *, cfg: MapConfig, lane_chunk: int) -> torch.Tensor:
    """(B, G) int32 posting hits without a histogram: every posting of every
    hit bucket adds one at its genome (JAX tally_flat), walked in row runs
    of at most lane_chunk lanes plus one bucket."""
    B, J, G = kmers.shape[0], len(cfg.positions), cfg.num_genomes
    start, lens = _ranges(kmers, counts, dev.keys_ordered, dev.offsets, cfg=cfg)
    startf, lensf = start.reshape(-1), lens.reshape(-1)
    fids = dev.posting_fids()
    hits = torch.zeros(B * G, dtype=torch.int32, device=kmers.device)
    for r0, r1, n_lanes in _row_chunks(lensf, lane_chunk):
        own, post = _walk(startf[r0:r1], lensf[r0:r1], n_lanes)
        at = ((own.long() + r0) // J) * G + fids[post]
        hits.index_add_(0, at, torch.ones_like(at, dtype=torch.int32))
    return hits.reshape(B, G)


def _tally_batches(batches, cfg: MapConfig, hits_of, device):
    G = cfg.num_genomes
    tallies = torch.zeros((G, 3), dtype=torch.int32, device=device)
    lanes = []
    for kmers, counts in batches:
        hits = hits_of(kmers, counts)
        tallies += classify_tallies(hits, counts > 0, len(cfg.positions))
        lanes.append(hits.sum(dim=0, dtype=torch.int64))
    lanes_t = (torch.stack(lanes) if lanes
               else torch.zeros((0, G), dtype=torch.int64, device=device))
    return tallies, lanes_t


def tally(batches, dev, cfg: MapConfig, mode: str, lane_chunk: int = FLAT_LANE_CHUNK):
    """Pass 1 without a saved probe over `batches`, a sequence of (kmers
    (B,) int64, counts (B,) int32) pairs; zero counts mark padding. mode:
    'hist' (single-word histogram), 'words' (multi-word) or 'flat' (every
    posting, in runs of at most `lane_chunk` lanes plus one bucket).

    Returns (tallies (G, 3) int32, lanes (nb, G) int64): lanes[i, g] is
    the number of postings of genome g that batch i's hits cover — the
    exact length of its pass-2 walk."""
    if mode == "flat":
        def hits_of(kmers, counts):
            return _flat_hits(kmers, counts, dev, cfg=cfg, lane_chunk=lane_chunk)
    else:
        hist = {"hist": dev.hist, "words": dev.hist_words}[mode]

        def hits_of(kmers, counts):
            h, _ = _probe_hist(kmers, counts, dev, hist, cfg=cfg)
            return _hist_hits(h, cfg.num_genomes)
    return _tally_batches(batches, cfg, hits_of, dev.device)


def tally_save(batches, dev, cfg: MapConfig):
    """Pass 1 with the saved probe: the single-word histogram, else the
    multi-word one. Returns (tallies, lanes) as `tally` does, and saved[i]
    = (start (B, J) int32, h (B, J) or (B, J, W)), batch i's probe."""
    hist = dev.hist if dev.hist is not None else dev.hist_words
    saved = []

    def hits_of(kmers, counts):
        h, start = _probe_hist(kmers, counts, dev, hist, cfg=cfg)
        saved.append((start, h))
        return _hist_hits(h, cfg.num_genomes)
    tallies, lanes = _tally_batches(batches, cfg, hits_of, dev.device)
    return tallies, lanes, saved


def _fold_table(kmers: torch.Tensor, counts: torch.Tensor, k: int) -> torch.Tensor:
    """(B*k,) int32 fold table through kernel K2."""
    return fold_table(kmers, counts, k)


def _walk_scatter(flat, pc, startf, lensf, n_lanes: int, postings, *, J: int, k: int,
                  row_len: int, file_base: int) -> None:
    """Walk the (k-mer, bucket) rows' posting ranges and scatter into the
    flat pileup: max of the k-mer count into the depth planes, +1 into the
    count planes. int32 postings are genome-local lpos<<6 | canon<<5 |
    idx; int64 ones are pos<<22 | meta, pos shifted by -file_base into
    the genome's local space (JAX _scatter_lanes)."""
    own, at = _walk(startf, lensf, n_lanes)
    post = postings[at]
    if post.dtype == torch.int32:
        pos, meta = post >> 6, post & 63
    else:
        pos, meta = (post >> 22) - file_base, post & 0x3FFFFF
    idx = meta & 31
    is_canon = (meta >> 5) & 1
    v = pc[(own // J) * k + idx]  # mirror bits hold the k-1-idx complement
    base = torch.where(is_canon == 1, (v >> 2) & 3, v & 3)
    fwd = is_canon == ((v >> 4) & 1)
    cell = pos.to(torch.int64) * 4 + base
    depth_at = torch.where(fwd, PLANE_DEPTH_FWD * row_len, PLANE_DEPTH_REV * row_len) + cell
    cnt_at = torch.where(fwd, PLANE_CNT_FWD * row_len, PLANE_CNT_REV * row_len) + cell
    flat.scatter_reduce_(0, depth_at, v >> 5, reduce="amax")
    flat.index_add_(0, cnt_at, torch.ones_like(v))


def pileup_from_saved(batches, saved, lanes, postings: torch.Tensor,
                      best: int, cfg: MapConfig, total_len: int,
                      file_base: int = 0) -> torch.Tensor:
    """Pass 2 for genome `best` from pass 1's saved probe: the (4,
    total_len+1, 4) int32 pileup in the genome's local coordinates.
    Genome `best`'s range in a bucket starts after the postings of the
    genomes below it (postings grouped by genome), so its length is its
    histogram byte and its offset the sum of the bytes below. `lanes[i]`
    (a host int) is batch i's walk length for `best`; `postings` are the
    int32 genome-local postings, or the int64 global ones with
    `file_base` the genome's global offset."""
    k, J = cfg.k, len(cfg.positions)
    row_len = (total_len + 1) * 4
    flat = torch.zeros(4 * row_len, dtype=torch.int32, device=postings.device)
    for (kmers, counts), (start, h), n_lanes in zip(batches, saved, lanes):
        if int(n_lanes) == 0:
            continue
        hb = _hist_bytes(h)
        lens = hb[..., best].to(torch.int32)
        prefix = hb[..., :best].sum(dim=-1, dtype=torch.int32)
        _walk_scatter(flat, _fold_table(kmers, counts, k), (start + prefix).reshape(-1),
                      lens.reshape(-1), int(n_lanes), postings, J=J, k=k,
                      row_len=row_len, file_base=file_base)
    return flat.reshape(4, total_len + 1, 4)


def pileup_from_subindex(batches, sub, lanes, cfg: MapConfig,
                         total_len: int) -> torch.Tensor:
    """Pass 2 through the selected genome's sub-index `sub` (layout
    SubIndex): K1 queries probed over its keys (the last equal row), each
    hit's range walked in its genome-local postings. `lanes[i]` (a host
    int) is batch i's walk length for the genome, as pass 1 counted it."""
    k, J = cfg.k, len(cfg.positions)
    row_len = (total_len + 1) * 4
    flat = torch.zeros(4 * row_len, dtype=torch.int32, device=sub.postings.device)
    for (kmers, counts), n_lanes in zip(batches, lanes):
        if int(n_lanes) == 0:
            continue
        start, lens = _ranges(kmers, counts, sub.keys_ordered, sub.offsets, cfg=cfg)
        _walk_scatter(flat, _fold_table(kmers, counts, k), start.reshape(-1),
                      lens.reshape(-1), int(n_lanes), sub.postings, J=J, k=k,
                      row_len=row_len, file_base=0)
    return flat.reshape(4, total_len + 1, 4)
