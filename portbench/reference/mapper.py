"""Counting and mapping, written from bronko's semantics in plain PyTorch.

Counting (KMC as bronko calls it: -b, -ci, -cs): every window of k valid
bases of a read is one k-mer, in the read's own orientation; k-mers
counted fewer than `ci` times are dropped and counts are capped at `cs`.
The mates of a pair are counted apart, and their kept k-mers are mapped
as one list (a k-mer kept in both mates is two rows).

Mapping: a k-mer stands for its canonical form, the smaller of it and its
reverse complement (`is_rc` when the reverse complement is not larger).
The index holds a posting (genome, window, idx, canonical) for every
window of every genome and every idx, under the key of the window's
canonical k-mer with base idx masked out. A row's query at wildcard
position i (i in n_fixed .. k - n_fixed - 2, bronko's asymmetric trim)
takes the key of its canonical k-mer with base i masked: it meets every
posting of a window that equals it everywhere but at i. The keys here are
this module's own, (canonical with base i zeroed) << 5 | i, which
separate (i, other bases) exactly as bronko's bucket hash does.

Pass 1: hits[row, g] counts the postings of genome g met over the row's
queries; a row is perfect for g when hits == J, variant when 0 < hits !=
J, unique-perfect when perfect for g alone. The selected genome has the
largest perfect / length / 2 in float64, strictly positive, the first
on ties.

Pass 2, for the selected genome: every posting met adds, at genome
position window + idx, in the strand plane forward iff posting.canonical
== row.is_rc, the base canonical[idx] (posting not canonical) or the
complement of canonical[k-1-idx] (canonical): 1 to the count plane and
the row's count as a maximum into the depth plane (docs: bronko's
call.rs:1257-1434, as upstream records them).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

LANE_CHUNK = 1 << 26  # posting lanes expanded at once


def pack_windows(codes: torch.Tensor, lengths: torch.Tensor, k: int):
    """(R, L) codes, (R,) lengths -> the valid windows' k-mers (n,) int64,
    first base highest."""
    R, L = codes.shape
    W = L - k + 1
    if W <= 0:
        return torch.zeros(0, dtype=torch.int64, device=codes.device)
    acc = torch.zeros((R, W), dtype=torch.int64, device=codes.device)
    bad = torch.zeros((R, W), dtype=torch.bool, device=codes.device)
    for t in range(k):
        c = codes[:, t:t + W]
        acc = (acc << 2) | (c & 3).to(torch.int64)
        bad |= c > 3
    col = torch.arange(W, device=codes.device)
    bad |= (col[None, :] + k) > lengths[:, None]
    return acc[~bad]


def count_kmers(codes: np.ndarray, lengths: np.ndarray, k: int, ci: int, cs: int,
                device: torch.device, rows: int = 1 << 17):
    """One FASTQ's kept k-mers: (ascending int64 k-mers, int64 counts)."""
    parts = []
    for a in range(0, codes.shape[0], rows):
        c = torch.from_numpy(codes[a:a + rows]).to(device)
        ln = torch.from_numpy(lengths[a:a + rows]).to(device)
        parts.append(pack_windows(c, ln, k))
    km = torch.cat(parts) if parts else torch.zeros(0, dtype=torch.int64, device=device)
    uniq, counts = torch.unique(km, sorted=True, return_counts=True)
    keep = counts >= ci
    return uniq[keep], counts[keep].clamp_max(cs)


def revcomp(kmer: torch.Tensor, k: int) -> torch.Tensor:
    rc = torch.zeros_like(kmer)
    for i in range(k):
        rc = (rc << 2) | (3 - ((kmer >> (2 * i)) & 3))
    return rc


def canonical(kmer: torch.Tensor, k: int):
    rc = revcomp(kmer, k)
    is_rc = kmer >= rc
    return torch.where(is_rc, rc, kmer), is_rc


def positions(k: int, n_fixed: int, use_full_kmer: bool) -> list[int]:
    if use_full_kmer:
        return list(range(k))
    if 2 * n_fixed + 1 >= k:
        return []
    return list(range(n_fixed, k - n_fixed - 1))


def masked_keys(canon: torch.Tensor, k: int, pos: list[int]) -> torch.Tensor:
    """(n,) canonical k-mers -> (n, len(pos)) keys, base i zeroed, i below."""
    if k > 29:
        raise ValueError("the reference's keys hold k <= 29")
    cols = []
    for i in pos:
        mask = ~(3 << (2 * (k - 1 - i)))
        cols.append(((canon & mask) << 5) | i)
    return torch.stack(cols, dim=1)


def base_at(canon: torch.Tensor, k: int, p: torch.Tensor) -> torch.Tensor:
    return (canon >> (2 * (k - 1 - p))) & 3


@dataclass
class Postings:
    """Postings sorted by key: key (P,) int64 and genome, window, idx,
    canonical alongside."""
    key: torch.Tensor
    genome: torch.Tensor
    loc: torch.Tensor | None
    idx: torch.Tensor | None
    canon: torch.Tensor | None


def genome_postings(codes: np.ndarray, g: int, k: int, pos: list[int],
                    device: torch.device):
    """One genome's postings at the query positions, unsorted."""
    c = torch.from_numpy(codes.astype(np.uint8)).to(device)[None, :]
    fwd = pack_windows(c, torch.tensor([codes.shape[0]], device=device), k)
    canon, is_rc = canonical(fwd, k)
    nwin, J = fwd.shape[0], len(pos)
    key = masked_keys(canon, k, pos).reshape(-1)
    loc = torch.arange(nwin, dtype=torch.int32, device=device).repeat_interleave(J)
    idx = torch.tensor(pos, dtype=torch.int32, device=device).repeat(nwin)
    flag = is_rc.repeat_interleave(J)
    genome = torch.full_like(loc, g)
    return key, genome, loc, idx, flag


def build_postings(strains: list[np.ndarray], k: int, pos: list[int], device: torch.device,
                   only: int | None = None) -> Postings:
    """Strain `only`'s postings, sorted by key; with only=None every
    strain's, keeping key and genome alone (pass 1 reads no more)."""
    if only is not None:
        key, genome, loc, idx, flag = genome_postings(strains[only], only, k, pos, device)
        key, order = torch.sort(key)
        return Postings(key, genome[order], loc[order], idx[order], flag[order])
    keys, genomes = [], []
    for g, c in enumerate(strains):
        key, genome, *_ = genome_postings(c, g, k, pos, device)
        keys.append(key)
        genomes.append(genome.to(torch.int16 if len(strains) < 1 << 15 else torch.int32))
    key, order = torch.sort(torch.cat(keys))
    del keys
    return Postings(key, torch.cat(genomes)[order], None, None, None)


def _ranges(post: Postings, q: torch.Tensor):
    lo = torch.searchsorted(post.key, q)
    hi = torch.searchsorted(post.key, q, right=True)
    return lo, hi - lo


def _lane_chunks(lens: torch.Tensor):
    """Row ranges [a, b) of (n, J) lens: the rows whose first lane falls in
    one span of LANE_CHUNK lanes (so a range holds at most LANE_CHUNK
    lanes plus one row's)."""
    per_row = lens.sum(dim=1).cpu().numpy()
    if per_row.size == 0:
        return []
    span = (np.cumsum(per_row) - per_row) // LANE_CHUNK
    cuts = np.flatnonzero(np.diff(span)) + 1
    edges = [0, *cuts.tolist(), per_row.size]
    return list(zip(edges[:-1], edges[1:]))


def _expand(lo: torch.Tensor, lens: torch.Tensor):
    """Lanes of (m,) ranges: (owning range (n_lanes,), posting (n_lanes,))."""
    n = int(lens.sum())
    own = torch.repeat_interleave(torch.arange(lens.shape[0], device=lens.device), lens,
                                  output_size=n)
    first = torch.cumsum(lens, 0) - lens
    lane = torch.arange(n, device=lens.device)
    return own, lo[own] + (lane - first[own])


def tally(post: Postings, q: torch.Tensor, G: int):
    """Pass 1 over (n, J) queries: (tallies (G, 3) int64, work counts)."""
    n, J = q.shape
    lo, lens = _ranges(post, q)
    tallies = torch.zeros((G, 3), dtype=torch.int64, device=q.device)
    for a, b in _lane_chunks(lens):
        own, at = _expand(lo[a:b].reshape(-1), lens[a:b].reshape(-1))
        row = own // J
        hits = torch.bincount(row * G + post.genome[at].long(),
                              minlength=(b - a) * G).reshape(b - a, G)
        perfect = hits == J
        variant = (hits > 0) & ~perfect
        unique = perfect & (perfect.sum(dim=1, keepdim=True) == 1)
        tallies += torch.stack([perfect.sum(0), variant.sum(0), unique.sum(0)], dim=1)
    hit = lens > 0
    work = {"kmers": n, "queries": n * J, "hit_queries": int(hit.sum()),
            "rows_touched": int(torch.unique(q[hit]).numel()),
            "flat_lanes": int(lens.sum())}
    return tallies, work


def pick(tallies: np.ndarray, genome_lens: list[int]) -> int | None:
    best, best_score = None, 0.0
    for g, glen in enumerate(genome_lens):
        if glen == 0:
            continue
        score = float(tallies[g, 0]) / glen / 2.0
        if score > best_score:
            best, best_score = g, score
    return best


def pileup(post: Postings, canon: torch.Tensor, is_rc: torch.Tensor, counts: torch.Tensor,
           q: torch.Tensor, k: int, length: int):
    """Pass 2 over one genome's postings: ((4, length+1, 4) int32 pileup,
    work counts). Planes: depth fwd, depth rev, count fwd, count rev."""
    n, J = q.shape
    lo, lens = _ranges(post, q)
    depth = torch.zeros(2 * (length + 1) * 4, dtype=torch.int64, device=q.device)
    cnt = torch.zeros_like(depth)
    for a, b in _lane_chunks(lens):
        own, at = _expand(lo[a:b].reshape(-1), lens[a:b].reshape(-1))
        row = own // J + a
        idx = post.idx[at].long()
        flag = post.canon[at]
        c = canon[row]
        base = torch.where(flag, 3 - base_at(c, k, k - 1 - idx), base_at(c, k, idx))
        rev = (flag != is_rc[row]).long()
        cell = rev * ((length + 1) * 4) + (post.loc[at].long() + idx) * 4 + base
        depth.scatter_reduce_(0, cell, counts[row], reduce="amax")
        cnt.index_add_(0, cell, torch.ones_like(cell))
    out = torch.cat([depth, cnt]).reshape(4, length + 1, 4)
    if int(out.max()) > np.iinfo(np.int32).max:
        raise OverflowError("a pileup cell exceeds int32")
    work = {"best_queries": int((lens > 0).sum()), "best_lanes": int(lens.sum())}
    out = out.to(torch.int32)
    work["pileup_cells"] = int((out != 0).sum())
    return out, work
