"""K-mer mapper on torch tensors: genome tallies (pass 1) and the selected
genome's pileup (pass 2).

Counterpart of the single-word-histogram main path of
`bronko_tpu/ops/map.py` (tally_save_jit, pileup_from_saved_jit; see that
module's docstring for the reference semantics):

PASS 1 (`tally_save`) — per batch: K1 canonicalizes the k-mers and
computes the J filtered bucket ids; a binary search over the sorted keys
finds each query's row (the LAST equal row, as the JAX merge probe picks);
the row's packed genome histogram and CSR start are picked up (zero on a
miss); histogram bytes become per-genome posting hits, classified as
perfect / variant / unique. The start and histogram are saved for pass 2.

PASS 2 (`pileup_from_saved`) — for the selected genome only: K2 builds the
per-(k-mer, position) fold table; each (k-mer, bucket) walks its exact
posting range [start + bytes below `best`, + byte at `best`), decodes the
int32 genome-local postings and scatter-maxes the k-mer count into the
depth planes and scatter-adds 1 into the count planes of the
(4, Tg+1, 4) int32 pileup. Integer max and add give the same result in
any order. The range walk is exact (its length comes from pass 1), so the
JAX path's lane budget, overflow retry and dump-row masking have no job.

Every function takes tensors on one device; K1 and K2 dispatch on it
(ops/cuda_buckets.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from bronko_tpu.ops.buckets import filtered_bucket_positions
from bronko_tpu_torch.ops.cuda_buckets import bucket_queries, fold_table

# pileup tensor layout: (n_planes=4, T+1, 4 bases)
# plane 0: depth fwd, 1: depth rev, 2: counts fwd, 3: counts rev
PLANE_DEPTH_FWD = 0
PLANE_DEPTH_REV = 1
PLANE_CNT_FWD = 2
PLANE_CNT_REV = 3

SIGN_BIT = -(1 << 63)  # int64 with only bit 63 set


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


def _probe(q: torch.Tensor, dev):
    """Key row of each bucket query: (row, hit). A query resolves to the
    LAST row whose key equals it (the JAX merge probe's rule, which the
    sentinel-collision fix relies on); row is 0 where hit is False. The
    sign-bit flip turns the keys' unsigned order into searchsorted's
    signed one, so ids >= 2^63 (k=31 wraps) order and match correctly."""
    qs = q ^ SIGN_BIT
    row = torch.searchsorted(dev.keys_ordered, qs, right=True) - 1
    rowc = row.clamp_min(0)
    return rowc, (row >= 0) & (dev.keys_ordered[rowc] == qs)


def _probe_hist(kmers, counts, dev, *, cfg: MapConfig):
    """Probe one batch: returns (h (B, J) histogram words, zero on a miss
    and for zero-count k-mers; start (B, J) int32 CSR row starts, zero on a
    miss). `dev` is the port's DeviceIndex."""
    q, _, _ = _bucket_q(kmers, cfg=cfg)
    rowc, hit = _probe(q, dev)
    h = torch.where(hit & (counts > 0)[:, None], dev.hist[rowc], 0)
    start = torch.where(hit, dev.offsets[rowc], 0)
    return h, start


def _hist_hits(h: torch.Tensor, G: int) -> torch.Tensor:
    """(B, J) packed histogram words (8 bits per genome) -> (B, G) int32
    hits. The bytes widen to 16-bit slots before summing over J — even
    genomes in one masked word, odd in the other — so no sum carries into
    the next genome's field (J <= 31 keeps each slot < 2^13). The mask
    after each arithmetic shift also clears a sign-extended top byte."""
    mask = 0x00FF00FF if h.dtype == torch.int32 else 0x00FF00FF00FF00FF
    lo = (h & mask).sum(dim=1)          # genomes 0, 2, 4, 6
    hi = ((h >> 8) & mask).sum(dim=1)   # genomes 1, 3, 5, 7
    cols = [((lo, hi)[g & 1] >> ((g >> 1) * 16)) & 0xFFFF for g in range(G)]
    return torch.stack(cols, dim=1).to(torch.int32)


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


def tally_save(batches, dev, cfg: MapConfig):
    """Pass 1 over `batches`, a sequence of (kmers (B,) int64, counts (B,)
    int32) pairs; zero counts mark padding.

    Returns (tallies (G, 3) int32, lanes (nb, G) int64, saved): lanes[i, g]
    is the number of postings of genome g that batch i's hits cover (the
    exact length of its pass-2 walk), and saved[i] = (start, h) is batch
    i's probe for pass 2."""
    G = cfg.num_genomes
    tallies = torch.zeros((G, 3), dtype=torch.int32, device=dev.device)
    lanes, saved = [], []
    for kmers, counts in batches:
        h, start = _probe_hist(kmers, counts, dev, cfg=cfg)
        hits = _hist_hits(h, G)
        tallies += classify_tallies(hits, counts > 0, len(cfg.positions))
        lanes.append(hits.sum(dim=0, dtype=torch.int64))
        saved.append((start, h))
    lanes_t = (torch.stack(lanes) if lanes
               else torch.zeros((0, G), dtype=torch.int64, device=dev.device))
    return tallies, lanes_t, saved


def _saved_lens_prefix(h: torch.Tensor, best: int):
    """The selected genome's in-bucket posting (length, prefix) from the
    saved histogram words: its own byte, and the sum of the bytes below
    it (postings are genome-grouped within a bucket)."""
    shift = 8 * best
    lens = ((h >> shift) & 0xFF).to(torch.int32)
    below = h & ((1 << shift) - 1)
    prefix = torch.zeros_like(lens)
    for byte in range(h.element_size()):
        prefix += ((below >> (8 * byte)) & 0xFF).to(torch.int32)
    return lens, prefix


def _fold_table(kmers: torch.Tensor, counts: torch.Tensor, k: int) -> torch.Tensor:
    """(B*k,) int32 fold table through kernel K2."""
    return fold_table(kmers, counts, k)


def pileup_from_saved(batches, saved, lanes, postings: torch.Tensor,
                      best: int, cfg: MapConfig, total_len: int) -> torch.Tensor:
    """Pass 2 for genome `best`: the (4, total_len+1, 4) int32 pileup in
    the genome's local coordinates. `batches` and `saved` are pass 1's;
    `lanes[i]` (a host int) is batch i's walk length for `best`,
    `postings` the int32 genome-local postings."""
    k, J = cfg.k, len(cfg.positions)
    device = postings.device
    row_len = (total_len + 1) * 4
    flat = torch.zeros(4 * row_len, dtype=torch.int32, device=device)
    for (kmers, counts), (start, h), n_lanes in zip(batches, saved, lanes):
        n_lanes = int(n_lanes)
        if n_lanes == 0:
            continue
        pc = _fold_table(kmers, counts, k)
        lens, prefix = _saved_lens_prefix(h, best)
        startf = (start + prefix).reshape(-1)
        lensf = lens.reshape(-1)
        # walk: lane l of (k-mer, bucket) row r reads posting startf[r] + l
        own = torch.repeat_interleave(lensf, output_size=n_lanes)
        first_lane = torch.cumsum(lensf, dim=0) - lensf
        lane = torch.arange(n_lanes, dtype=torch.int64, device=device)
        post = postings[startf[own] + (lane - first_lane[own])]

        pos = post >> 6
        idx = post & 31
        is_canon = (post >> 5) & 1
        v = pc[(own // J) * k + idx]  # mirror bits hold the k-1-idx complement
        base = torch.where(is_canon == 1, (v >> 2) & 3, v & 3)
        fwd = is_canon == ((v >> 4) & 1)
        cell = pos.to(torch.int64) * 4 + base
        depth_at = torch.where(fwd, PLANE_DEPTH_FWD * row_len, PLANE_DEPTH_REV * row_len) + cell
        cnt_at = torch.where(fwd, PLANE_CNT_FWD * row_len, PLANE_CNT_REV * row_len) + cell
        flat.scatter_reduce_(0, depth_at, v >> 5, reduce="amax")
        flat.index_add_(0, cnt_at, torch.ones_like(v))
    return flat.reshape(4, total_len + 1, 4)
