"""Hopper kernels (b) probe_tally, (c) walk_scatter and (d) walk_hits:
wrappers and their plain PyTorch versions, with the pieces of the mapper
they share.

None replaces a Pallas kernel: they fuse the XLA work of the JAX mapper
(`bronko_tpu/ops/map.py`: `_tally_save_body`'s and
`tally_save_words_jit`'s probe and classification;
`_pileup_from_saved_body`'s and `pileup_from_saved_words_jit`'s walk and
scatter; `tally_flat`'s walk). The kernels live in
`bronko_tpu_torch/csrc/map_kernels.cu`, built and loaded with the port's
other kernels by `ops/cuda_lib.py`.

(b) probe_tally: pass 1 after K1 on the histogram, the single word (U,)
or the multi-word one (U, W). Each k-mer's J bucket queries probe the
sorted keys (the LAST equal row) through the slot directory
(`probe_directory`): the query's slot gives the few rows its key can be
in, and a search bounded to them finds the row. A hit gives its CSR
start, and its histogram word(s) where the k-mer's count is positive; the
words' bytes summed over J are the k-mer's posting hits by genome,
classified into the (G, 3) tallies, and summed into the batch's (G,) walk
lengths.

(c) walk_scatter: pass 2's exact walk. Each (k-mer, bucket) row walks its
own range of the postings, given as (start, lens), or as the saved probe
(start, h: one word or W a row) with the selected genome `best` on the
device; each posting adds one to a count plane and raises a depth plane
to the k-mer's count in the (4, T+1, 4) int32 pileup. No host value sizes
the walk.

(d) walk_hits: the flat tally's exact walk. Every posting of every
(k-mer, bucket) row [start, start + lens) adds one to hits[k-mer,
genome], its genome an int32 id or decoded from an int64 global posting.
No lane count on the host: the plain version alone materializes lanes,
in runs of at most FLAT_LANE_CHUNK.

Dispatch follows the input's device: a CPU tensor goes to the plain
version, a CUDA tensor to the kernel. Nothing falls back from one to the
other. Each wrapper adds one to `cuda_lib.LAUNCHES[name]`
(`cuda_lib.count_launch`) where it launches its kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from bronko_tpu_torch.ops.cuda_lib import check_cuda, count_launch, library, raise_on, stream

__all__ = ["ProbeDirectory", "probe_directory", "probe_tally", "probe_tally_plain",
           "walk_scatter", "walk_scatter_plain", "walk_hits", "walk_hits_plain"]

# pileup tensor layout: (n_planes=4, T+1, 4 bases)
# plane 0: depth fwd, 1: depth rev, 2: counts fwd, 3: counts rev
PLANE_DEPTH_FWD = 0
PLANE_DEPTH_REV = 1
PLANE_CNT_FWD = 2
PLANE_CNT_REV = 3

SIGN_BIT = -(1 << 63)  # int64 with only bit 63 set
U64_MASK = (1 << 64) - 1
MAX_WORD_GENOMES = 8   # genomes of the single histogram word
# lanes the plain flat walk expands at once (plus at most one bucket's postings)
FLAT_LANE_CHUNK = 1 << 24
MAX_HITS_J = 256       # (d): a block's 256 threads hold one row each


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


class ProbeDirectory(NamedTuple):
    """The slot directory in front of the key search. A key's slot is
    its unsigned distance from the smallest key, `(key - lo) mod 2^64`,
    shifted right by `shift`; slot s holds rows [table[s], table[s+1]).
    A query farther than `span` (the largest key's distance) from `lo`
    lies outside the keys and misses without a load."""
    table: torch.Tensor  # (S+1,) int32 first row of each slot, then U
    lo: int              # the smallest key of keys_ordered (bit 63 flipped)
    span: int            # the largest key's distance from lo, in [0, 2^64)
    shift: int
    widest: int          # the most rows of one slot

    def steps(self) -> int:
        """Bisection steps that resolve any slot: ceil(log2(widest + 1))."""
        return self.widest.bit_length()


def probe_directory(keys_ordered: torch.Tensor) -> ProbeDirectory:
    """The directory of the sorted keys `keys_ordered` (U,) int64 (bit 63
    flipped), U >= 1 (an index without keys has no histogram to probe).
    shift = max(0, bit_length(span) - r), r = bit_length(U) - 1, so that
    the S slots number at most U (and more than U/4 once the keys span
    more than 2^r): ~2 bytes a key. Two host reads (the end keys) and a
    bincount's."""
    U = keys_ordered.shape[0]
    lo, hi = keys_ordered[[0, -1]].tolist()
    span = (hi - lo) & U64_MASK
    shift = max(0, span.bit_length() - (U.bit_length() - 1))
    counts = torch.bincount(_slot(keys_ordered, lo, shift), minlength=(span >> shift) + 1)
    table = torch.zeros(counts.shape[0] + 1, dtype=torch.int32, device=keys_ordered.device)
    torch.cumsum(counts, dim=0, out=table[1:])
    return ProbeDirectory(table, lo, span, shift, int(counts.max()))


def _slot(qs: torch.Tensor, lo: int, shift: int) -> torch.Tensor:
    """(qs - lo) mod 2^64, logically shifted right by `shift`. torch's >>
    on int64 is arithmetic, so the sign bits it copies are masked off."""
    d = qs - lo  # int64 arithmetic wraps: the unsigned distance's bits
    return (d >> shift) & ((1 << (64 - shift)) - 1) if shift else d


def _as_int64(x: int) -> int:
    """The int64 whose bits are the 64-bit unsigned x."""
    return x - (1 << 64) if x >> 63 else x


def _probe_dir(q: torch.Tensor, keys_ordered: torch.Tensor, directory: ProbeDirectory):
    """_probe through the directory: (row, hit), row 0 on a miss. A query
    outside [lo, lo + span] misses; else a last-<= bisection over its
    slot's rows, directory.steps() steps for every query, finds the last
    row equal to it (equal keys share a slot)."""
    qs = q ^ SIGN_BIT
    # distance <= span as unsigned: both with bit 63 flipped, compared signed
    inside = ((qs - directory.lo) ^ SIGN_BIT) <= _as_int64(directory.span ^ (1 << 63))
    s = torch.where(inside, _slot(qs, directory.lo, directory.shift), 0)
    first = lo = directory.table[s].long()
    hi = torch.where(inside, directory.table[s + 1].long(), lo)
    last = keys_ordered.shape[0] - 1
    for _ in range(directory.steps()):
        mid = (lo + hi) >> 1
        le = keys_ordered[mid.clamp(max=last)] <= qs
        lo, hi = (torch.where((lo < hi) & le, mid + 1, lo),
                  torch.where((lo < hi) & ~le, mid, hi))
    row = lo - 1
    hit = (row >= first) & (keys_ordered[row.clamp(0, last)] == qs)
    return torch.where(hit, row, 0), hit


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


# --- (b): pass 1 after K1 on the histogram --------------------------------

def probe_tally_plain(q, counts, keys_ordered, directory, offsets, hist, tallies):
    """q (B, J) int64 bucket ids (K1's), counts (B,) int32, keys_ordered
    (U,) int64 (bit 63 flipped) and their `directory` (probe_directory's),
    offsets (U+1,) int32, hist (U,) int32 or int64 words, or (U, W) int64
    words (genome g in byte g % 8 of word g // 8). Adds the batch's
    perfect / variant / unique counts into tallies (G, 3) int32 and
    returns (start (B, J) int32, zero on a miss; h (B, J) or (B, J, W)
    words, zero on a miss and for zero-count k-mers; lanes (G,) int64,
    the batch's posting hits by genome: its pass-2 walk lengths)."""
    rowc, hit = _probe_dir(q, keys_ordered, directory)
    valid = hit & (counts > 0)[:, None]
    h = torch.where(valid if hist.dim() == 1 else valid[..., None], hist[rowc], 0)
    start = torch.where(hit, offsets[rowc], 0)
    hits = _hist_hits(h, tallies.shape[0])
    tallies += classify_tallies(hits, counts > 0, q.shape[1])
    return start, h, hits.sum(dim=0, dtype=torch.int64)


def probe_tally(q, counts, keys_ordered, directory, offsets, hist, tallies):
    """Kernel (b). Same result as probe_tally_plain; launches the kernel for
    CUDA tensors (tallies is added into on the card): the single-word
    entry for hist (U,), the multi-word one for (U, W) int64."""
    if q.device.type == "cpu":
        return probe_tally_plain(q, counts, keys_ordered, directory, offsets, hist, tallies)
    check_cuda(q, torch.int64, "q", dim=2)
    check_cuda(counts, torch.int32, "counts")
    check_cuda(keys_ordered, torch.int64, "keys_ordered")
    check_cuda(directory.table, torch.int32, "directory.table")
    check_cuda(offsets, torch.int32, "offsets")
    words = hist.dim() == 2
    if hist.dtype not in ((torch.int64,) if words else (torch.int32, torch.int64)):
        raise ValueError(f"hist must hold int32 or int64 words (int64 in a (U, W) table), "
                         f"got {hist.dtype} of shape {tuple(hist.shape)}")
    check_cuda(hist, hist.dtype, "hist", dim=2 if words else 1)
    check_cuda(tallies, torch.int32, "tallies", dim=2)
    B, J = q.shape
    U, G = keys_ordered.shape[0], tallies.shape[0]
    W = hist.shape[1] if words else 1
    S = directory.table.shape[0] - 1
    if (counts.shape[0] != B or offsets.shape[0] != U + 1 or hist.shape[0] != U
            or tallies.shape[1] != 3 or not 1 <= G <= MAX_WORD_GENOMES * W
            or B * max(J, 1) >= 1 << 31
            or S < 1 or int(directory.span) >> directory.shift >= S
            or not 0 <= directory.shift < 64):
        raise ValueError(f"probe_tally: q {tuple(q.shape)}, counts {tuple(counts.shape)}, "
                         f"keys ({U},), directory of {S} slots (span {directory.span}, "
                         f"shift {directory.shift}), offsets {tuple(offsets.shape)}, hist "
                         f"{tuple(hist.shape)}, tallies {tuple(tallies.shape)}")
    start = torch.empty((B, J), dtype=torch.int32, device=q.device)
    h = torch.empty((B, J, W) if words else (B, J), dtype=hist.dtype, device=q.device)
    lanes = torch.zeros(G, dtype=torch.int64, device=q.device)
    if B:
        lib, common = library(), (
            q.device.index or 0, q.data_ptr(), counts.data_ptr(), B, J,
            keys_ordered.data_ptr(), U, directory.table.data_ptr(), directory.lo,
            _as_int64(directory.span), directory.shift, offsets.data_ptr(), hist.data_ptr())
        out = (G, start.data_ptr(), h.data_ptr(), tallies.data_ptr(), lanes.data_ptr(),
               stream(q))
        if words:
            err = lib.bronko_probe_tally_words(*common, W, *out)
        else:
            err = lib.bronko_probe_tally(*common, hist.element_size(), *out)
        raise_on(err, "probe_tally")
        count_launch("probe_tally")
    return start, h, lanes


# --- (c): pass 2's exact walk and scatter ------------------------------------

def _walk(startf: torch.Tensor, lensf: torch.Tensor, n_lanes: int):
    """Exact posting walk: lane l of row r reads posting startf[r] + l -
    (the lanes of the rows before r). Returns (row (n_lanes,) of lensf's
    dtype, posting index (n_lanes,) int64); n_lanes must be lensf's sum."""
    own = torch.repeat_interleave(lensf, output_size=n_lanes)
    first_lane = torch.cumsum(lensf, dim=0) - lensf
    lane = torch.arange(n_lanes, dtype=torch.int64, device=lensf.device)
    return own, startf[own] + (lane - first_lane[own])


def _walk_scatter(flat, pc, startf, lensf, n_lanes: int, postings, *, J: int, k: int,
                  row_len: int, file_base: int):
    """Walk the (k-mer, bucket) rows' posting ranges and scatter into the
    flat pileup: max of the k-mer count into the depth planes, +1 into the
    count planes. int32 postings are genome-local lpos<<6 | canon<<5 |
    idx; int64 ones are pos<<22 | meta, pos shifted by -file_base into
    the genome's local space (JAX _scatter_lanes). Returns each lane's
    (row, posting)."""
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
    return own, post


def _file_base_of(file_base, best):
    """The genome's base as walk_scatter reads it: file_base[best] for a
    table of several bases and a device `best`, else file_base[0]."""
    if file_base is None:
        return None
    return file_base[best] if best is not None and file_base.numel() > 1 else file_base[:1]


def walk_scatter_plain(pileup, pc, start, postings, *, k, lens=None, h=None, best=None,
                       file_base=None):
    """Walk every (k-mer, bucket) row of one batch into `pileup` ((4, T+1,
    4) int32, added into in place). pc (B*k,) int32 K2 records; start
    (B, J) int32; the rows' lengths are `lens` (B, J) int32, or come from
    the saved probe: `h` (B, J) or (B, J, W) histogram words and `best`
    (1,) int64, the genome whose byte is the length and whose bytes below
    it the offset added to start. postings int32 (genome-local) or int64 (pos<<22 |
    meta); `file_base` (int64, one base, or one a genome read at best)
    moves an int64 posting's pos into the genome's space (None: 0)."""
    J = start.shape[1]
    if lens is None:
        b = int(best)
        hb = _hist_bytes(h)
        lens = hb[..., b].to(torch.int32)
        start = start + hb[..., :b].sum(dim=-1, dtype=torch.int32)
    base = _file_base_of(file_base, best)
    lensf = lens.reshape(-1)
    n_lanes = int(lensf.sum())
    if n_lanes:
        _walk_scatter(pileup.view(-1), pc, start.reshape(-1), lensf, n_lanes, postings, J=J,
                      k=k, row_len=pileup.shape[1] * 4,
                      file_base=0 if base is None else int(base))


def walk_scatter(pileup, pc, start, postings, *, k, lens=None, h=None, best=None,
                 file_base=None):
    """Kernel (c). Same result as walk_scatter_plain; launches the kernel
    for CUDA tensors, reading `best` and the file base on the card."""
    if pileup.device.type == "cpu":
        return walk_scatter_plain(pileup, pc, start, postings, k=k, lens=lens, h=h,
                                  best=best, file_base=file_base)
    check_cuda(pileup, torch.int32, "pileup", dim=3)
    check_cuda(pc, torch.int32, "pc")
    check_cuda(start, torch.int32, "start", dim=2)
    if postings.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"postings must be int32 or int64, got {postings.dtype}")
    check_cuda(postings, postings.dtype, "postings")
    B, J = start.shape
    word_bytes = 0
    if lens is not None:
        check_cuda(lens, torch.int32, "lens", dim=2)
        if lens.shape != start.shape:
            raise ValueError(f"lens {tuple(lens.shape)} and start {tuple(start.shape)} differ")
    else:
        if (h is None or best is None or h.dtype not in (torch.int32, torch.int64)
                or (h.dim() == 3 and h.dtype != torch.int64)):
            raise ValueError("walk_scatter needs lens, or h (int32/int64 words, int64 if W "
                             "a row) and best")
        check_cuda(h, h.dtype, "h", dim=3 if h.dim() == 3 else 2)
        check_cuda(best, torch.int64, "best")
        if h.shape[:2] != start.shape or best.numel() != 1:
            raise ValueError(f"h {tuple(h.shape)} must match start {tuple(start.shape)} "
                             f"and best hold one genome")
        word_bytes = h.element_size()
    by_best = 0
    if file_base is not None:
        check_cuda(file_base, torch.int64, "file_base")
        by_best = int(best is not None and file_base.numel() > 1)
    if pileup.shape[0] != 4 or pileup.shape[2] != 4 or pc.shape[0] != B * k:
        raise ValueError(f"walk_scatter: pileup {tuple(pileup.shape)}, pc "
                         f"{tuple(pc.shape)} for B = {B}, k = {k}")
    if B * J:
        words = h.shape[2] if lens is None and h.dim() == 3 else 1
        err = library().bronko_walk_scatter_words(
            pileup.device.index or 0, pc.data_ptr(), k, J, start.data_ptr(),
            None if lens is None else lens.data_ptr(), None if h is None else h.data_ptr(),
            word_bytes, words, None if best is None else best.data_ptr(), postings.data_ptr(),
            postings.element_size(), postings.shape[0],
            None if file_base is None else file_base.data_ptr(),
            by_best, B * J, pileup.data_ptr(), pileup.shape[1] * 4, stream(pileup))
        raise_on(err, "walk_scatter")
        count_launch("walk_scatter")


# --- (d): the flat tally's exact walk ----------------------------------------

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


def walk_hits_plain(start, lens, genomes, G: int, lane_chunk: int = FLAT_LANE_CHUNK):
    """(B, G) int32 posting hits of the rows start, lens (B, J) int32: every
    posting of row (b, j)'s range [start, start + lens) adds one at (b,
    its genome) (JAX tally_flat). `genomes` are the postings' int32 genome
    ids, or int64 global postings whose genome is (p & 0x3FFFFF) >> 6. A
    range past the postings' end stops there, and a genome outside [0, G)
    counts nowhere (JAX drops it). Walked in row runs of at most
    lane_chunk lanes plus one row."""
    B, J = start.shape
    startf = start.reshape(-1)
    lensf = torch.where(startf < 0, 0, torch.minimum(
        lens.reshape(-1), (genomes.shape[0] - startf).clamp_min(0))).to(lens.dtype)
    hits = torch.zeros(B * G, dtype=torch.int32, device=start.device)
    for r0, r1, n_lanes in _row_chunks(lensf, lane_chunk):
        own, post = _walk(startf[r0:r1], lensf[r0:r1], n_lanes)
        g = genomes[post]
        if g.dtype == torch.int64:
            g = (g & 0x3FFFFF) >> 6
        keep = (g >= 0) & (g < G)
        at = ((own.long() + r0) // J) * G + g
        hits.index_add_(0, at[keep], torch.ones_like(at[keep], dtype=torch.int32))
    return hits.reshape(B, G)


def walk_hits(start, lens, genomes, G: int, lane_chunk: int = FLAT_LANE_CHUNK):
    """Kernel (d). Same result as walk_hits_plain; launches the kernel for
    CUDA tensors, with no host sync (`lane_chunk` sizes only the plain
    version's runs)."""
    if start.device.type == "cpu":
        return walk_hits_plain(start, lens, genomes, G, lane_chunk)
    check_cuda(start, torch.int32, "start", dim=2)
    check_cuda(lens, torch.int32, "lens", dim=2)
    if genomes.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"genomes must be int32 ids or int64 postings, got {genomes.dtype}")
    check_cuda(genomes, genomes.dtype, "genomes")
    B, J = start.shape
    if (lens.shape != start.shape or G < 1 or J > MAX_HITS_J or B * J >= 1 << 31):
        raise ValueError(f"walk_hits: start {tuple(start.shape)}, lens {tuple(lens.shape)}, "
                         f"G = {G} (J at most {MAX_HITS_J}, B * J below 2^31)")
    hits = torch.empty((B, G), dtype=torch.int32, device=start.device)
    if J == 0:
        return hits.zero_()
    if B:
        err = library().bronko_walk_hits(
            start.device.index or 0, start.data_ptr(), lens.data_ptr(), B, J,
            genomes.data_ptr(), genomes.element_size(), genomes.shape[0], G, hits.data_ptr(),
            stream(start))
        raise_on(err, "walk_hits")
        count_launch("walk_hits")
    return hits
