"""The genome-sharded index and the sharded passes over a mesh of ranks.

Counterpart of `bronko_tpu/parallel/pipeline.py`'s split_index,
make_sharded_tally_scan and make_sharded_pileup_scan, as plain loops over
a rank's own batches with torch.distributed collectives between them:

  * split_index cuts the index into G shards of whole genome files,
    greedy and size-balanced, as JAX does; the histogram width is decided
    over all shards. Each shard keeps its own rows only: the port's probe
    needs no common shape, so JAX's sentinel padding and its collision
    fix have no job. A rank uploads only its own shard (`DeviceShard`).
  * sharded_tally (pass 1): K1 probes the rank's shard for each of its
    batches; the histogram words (or the flat hits) sum over the genome
    group before the bytes are summed and classified. Each byte is
    nonzero on one shard only, so the sum is carry-free. Tallies and the
    per-genome walk lengths sum over the data group only: the genome
    ranks of a row hold identical ones.
  * sharded_pileup (pass 2): each rank walks its slice of the k-mers
    through the selected genome's sub-index (K1 + K2), each batch's walk
    length from its own probe; depth planes merge by MAX, count planes
    by SUM over the world. Integer max and add give the same pileup in
    any order.
  * the routed layout (JAX route_split, make_routed_tally_scan and
    make_routed_pileup_scan), for B-split batches: route_split cuts each
    shard's rows into D key-range chunks, rank (d, g) holds chunk d of
    shard g, and each query travels over the data group to the chunk
    that can hold it and back (all_to_all_single with exact split sizes:
    JAX's fixed (D, C) buffer, its budget and its overflow retry have no
    job). routed_tally is pass 1 ('hist' and 'words'); on a Dx1 mesh it
    may save its probe, from which routed_pileup walks each rank's own
    slice with no probe of its own.
  * the whole-index map step (JAX make_sharded_map_step,
    make_sharded_tally_step and make_merge_step), which __graft_entry__'s
    counterpart, bronko_tpu_torch/entry.py, drives.

Collectives run on the calling (main) thread only, in the same order on
every rank.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from bronko_tpu_torch.index.layout import KEY_SENTINEL, SeqSlice, _unpad_subindex
from bronko_tpu_torch.index.model import (
    CANON_SHIFT, FILE_MASK, FILE_SHIFT, IDX_MASK, SEQ_MASK, SEQ_SHIFT, BronkoIndex,
)
from bronko_tpu_torch.ops.codec import from_u64
from bronko_tpu_torch.ops.map import (
    FLAT_LANE_CHUNK, SIGN_BIT, MapConfig, _bucket_q, _flat_hits, _hist_hits, _probe,
    _probe_hist, classify_tallies, pileup_from_saved, pileup_from_subindex, probe_scatter,
)
from bronko_tpu_torch.parallel.distributed import all_reduce, all_to_all

# the multi-word histogram's table limit over all shards (JAX pipeline.py:169)
SHARDED_WORDS_MAX_BYTES = 2 << 30


@dataclass
class Shard:
    """One genome shard's index, its own rows only."""
    keys: np.ndarray               # (U_s,) uint64 sorted bucket ids
    offsets: np.ndarray            # (U_s+1,) int32 CSR row starts
    postings: np.ndarray           # (P_s,) int64 local gpos<<22 | fid<<6 | canon<<5 | idx
    hist: np.ndarray | None        # (U_s,) int32 (G <= 4) / int64 (G <= 8)
    hist_words: np.ndarray | None  # (U_s, ceil(G/8)) int64


@dataclass
class ShardedIndex:
    """The index cut into genome shards; the histogram bytes of a shard
    sit at GLOBAL genome ids, and only its own genomes' bytes are set."""
    k: int
    shards: list[Shard]
    shard_len: np.ndarray          # (S,) int64 pileup length of each shard
    t_pad: int                     # the longest shard's pileup length
    num_genomes: int
    max_bucket: int
    shard_files: list[list[int]]   # genome ids of each shard
    seq_slices: list[SeqSlice]     # offsets local to the shard's pileup space
    genome_lens: np.ndarray

    def tally_mode(self) -> str:
        """'hist', 'words' or 'flat', the same for every shard."""
        first = self.shards[0]
        if first.hist is not None:
            return "hist"
        return "words" if first.hist_words is not None else "flat"

    @classmethod
    def from_jax(cls, obj) -> "ShardedIndex":
        """The JAX package's ShardedIndex (or any object with its fields),
        padded to common shapes, as the port's: each shard cut to its real
        rows, as the JAX probe reads them (layout._unpad_subindex)."""
        shards = []
        for s in range(np.asarray(obj.keys).shape[0]):
            keys, offsets, postings = _unpad_subindex(
                np.asarray(obj.keys[s], np.uint64), np.asarray(obj.offsets[s]),
                np.asarray(obj.postings[s]))
            u = keys.shape[0]
            shards.append(Shard(
                keys=keys, offsets=offsets.astype(np.int32), postings=postings.astype(np.int64),
                hist=None if obj.hist is None else np.array(obj.hist[s][:u]),
                hist_words=(None if obj.hist_words is None
                            else np.array(obj.hist_words[s][:u], np.int64))))
        return cls(k=int(obj.k), shards=shards,
                   shard_len=np.asarray(obj.shard_len, np.int64), t_pad=int(obj.t_pad),
                   num_genomes=int(obj.num_genomes), max_bucket=int(obj.max_bucket),
                   shard_files=[list(map(int, f)) for f in obj.shard_files],
                   seq_slices=[SeqSlice(s.file_id, s.seq_id, s.name, s.offset, s.length)
                               for s in obj.seq_slices],
                   genome_lens=np.asarray(obj.genome_lens, np.int64))


def split_index(index: BronkoIndex, n_shards: int) -> ShardedIndex:
    """Range-partition the index into n_shards genome shards: whole files,
    greedy size-balanced (largest first onto the lightest shard, the
    first lightest on a tie), file order kept within a shard (JAX
    pipeline.py:82-212)."""
    G = len(index.files)
    shard_files: list[list[int]] = [[] for _ in range(n_shards)]
    loads = [0] * n_shards
    for size, fid in sorted(((f.total_len, fid) for fid, f in enumerate(index.files)),
                            reverse=True):
        s = int(np.argmin(loads))
        shard_files[s].append(fid)
        loads[s] += size
    for files in shard_files:
        files.sort()

    file_shard = {}
    seq_slices: list[SeqSlice] = []
    cursor = [0] * n_shards
    local_off = {}
    for s, files in enumerate(shard_files):
        for fid in files:
            file_shard[fid] = s
            for sid, seq in enumerate(index.files[fid].sequences):
                local_off[(fid, sid)] = cursor[s]
                seq_slices.append(SeqSlice(fid, sid, seq.name, cursor[s], seq.length))
                cursor[s] += seq.length

    meta = index.post_meta
    p_idx = (meta & IDX_MASK).astype(np.int64)
    p_seq = ((meta >> SEQ_SHIFT) & SEQ_MASK).astype(np.int64)
    p_fid = ((meta >> FILE_SHIFT) & FILE_MASK).astype(np.int64)
    p_can = ((meta >> CANON_SHIFT) & 1).astype(np.int64)
    post_keys = np.repeat(index.keys, np.diff(index.offsets))
    post_shard = np.zeros(0, np.int64)
    loc_off = np.zeros(meta.shape[0], np.int64)
    if meta.size:
        post_shard = np.asarray([file_shard[f] for f in range(G)], np.int64)[p_fid]
        table = np.zeros((G, int(p_seq.max()) + 1), np.int64)
        for (fid, sid), off in local_off.items():
            if sid < table.shape[1]:
                table[fid, sid] = off
        loc_off = table[p_fid, p_seq]

    parts = []
    U_max = 1
    for s in range(n_shards):
        sel = post_shard == s
        skeys = post_keys[sel]
        order = np.argsort(skeys, kind="stable")
        skeys = skeys[order]
        sfid = p_fid[sel][order]
        sgpos = (loc_off[sel] + index.post_loc[sel].astype(np.int64) + p_idx[sel])[order]
        spost = (sgpos << 22) | (p_idx[sel] | (p_can[sel] << 5) | (p_fid[sel] << 6))[order]
        ukeys, start = np.unique(skeys, return_index=True)
        soff = np.append(start, skeys.shape[0]).astype(np.int32)
        # per-bucket posting counts at GLOBAL genome ids
        counts = np.zeros((ukeys.shape[0], G), np.int64)
        np.add.at(counts, (np.repeat(np.arange(ukeys.shape[0]), np.diff(soff)), sfid), 1)
        parts.append((ukeys, soff, spost, counts))
        U_max = max(U_max, ukeys.shape[0])

    # the histogram's packing, decided over all shards by the rules of
    # the single-device layout; the words table's cap counts every shard
    hmax = max(int(c.max()) if c.size else 0 for *_, c in parts) if parts else 0
    W = -(-G // 8) if G else 1
    mode = "flat"
    if 0 < G <= 4 and (G < 4 or hmax <= 127) and hmax <= 255:
        mode, hdtype = "hist", np.int32
    elif 0 < G <= 8 and hmax <= 255:
        mode, hdtype = "hist", np.int64
    elif 8 < G and hmax <= 255 and n_shards * U_max * W * 8 <= SHARDED_WORDS_MAX_BYTES:
        mode = "words"

    shards = []
    max_bucket = 1
    shifts = 8 * np.arange(8, dtype=np.int64)
    for ukeys, soff, spost, counts in parts:
        if ukeys.shape[0]:
            max_bucket = max(max_bucket, int(np.diff(soff).max()))
        hist = words = None
        if mode != "flat":
            padded = np.zeros((ukeys.shape[0], 8 * W), np.int64)
            padded[:, :G] = counts
            # bytes hold <= 255, so summing the shifted fields is their OR
            words = (padded.reshape(-1, W, 8) << shifts).sum(axis=2)
            if mode == "hist":
                hist, words = words[:, 0].astype(hdtype), None
        shards.append(Shard(ukeys, soff, spost, hist, words))
    return ShardedIndex(
        k=index.k, shards=shards, shard_len=np.asarray(cursor, np.int64),
        t_pad=max(cursor) if cursor else 0, num_genomes=G, max_bucket=max_bucket,
        shard_files=shard_files, seq_slices=seq_slices,
        genome_lens=np.asarray([f.total_len for f in index.files], np.int64))


@dataclass
class DeviceShard:
    """A rank's shard on its device, what pass 1 reads of it: the keys
    (bit 63 flipped, as `ops/map._probe` takes them), the CSR starts, and
    the histogram words or, for the flat tally, each posting's genome;
    the int64 postings only when asked for (the whole-index map step)."""
    keys_ordered: torch.Tensor
    offsets: torch.Tensor
    hist: torch.Tensor | None
    fids: torch.Tensor | None
    postings: torch.Tensor | None = None

    def posting_fids(self) -> torch.Tensor:
        return self.fids


def _own_rows(shard: Shard, mode: str):
    """(keys, offsets, histogram rows or None) of the shard. A shard without
    buckets (more shards than genomes) gets one empty row, as JAX's
    padding gives it: key 0, no postings, a zero histogram, so a query
    that hits it adds nothing."""
    keys, offsets = shard.keys, shard.offsets
    hist = shard.hist if mode == "hist" else shard.hist_words if mode == "words" else None
    if keys.shape[0] == 0:
        keys, offsets = np.zeros(1, np.uint64), np.zeros(2, np.int32)
        if hist is not None:
            hist = np.zeros((1, *hist.shape[1:]), hist.dtype)
    return keys, offsets, hist


def upload_shard(shard: Shard, mode: str, device: torch.device,
                 postings: bool = False) -> DeviceShard:
    """The shard's tensors on `device` (its rows as _own_rows gives them);
    with `postings` also its int64 postings and their genomes."""
    keys, offsets, hist = _own_rows(shard, mode)
    fids = None
    if mode == "flat" or postings:
        fids = ((shard.postings & 0x3FFFFF) >> 6).astype(np.int32)
    return DeviceShard(
        keys_ordered=from_u64(keys, device) ^ SIGN_BIT,
        offsets=torch.from_numpy(np.array(offsets, np.int32)).to(device),
        hist=None if hist is None else torch.from_numpy(np.array(hist)).to(device),
        fids=None if fids is None else torch.from_numpy(fids).to(device),
        postings=torch.from_numpy(np.array(shard.postings, np.int64)).to(device)
        if postings else None)


def sharded_tally(batches, shard: DeviceShard, cfg: MapConfig, mode: str, mesh,
                  lane_chunk: int = FLAT_LANE_CHUNK) -> np.ndarray:
    """Pass 1 of this rank over its batches, (kmers (B,) int64, counts (B,)
    int32) pairs on its device. Returns, identical on every rank, the
    (G, 4) int64 host array of tallies (perfect / variant / unique) and,
    in column 3, each genome's walk length over the whole sample."""
    G, J = cfg.num_genomes, len(cfg.positions)
    device = shard.offsets.device
    out = torch.zeros((G, 4), dtype=torch.int64, device=device)
    for kmers, counts in batches:
        if mode == "flat":
            hits = _flat_hits(kmers, counts, shard, cfg=cfg, lane_chunk=lane_chunk)
            all_reduce(hits, dist.ReduceOp.SUM, mesh.genome_group)
        else:
            h, _ = _probe_hist(kmers, counts, shard, shard.hist, cfg=cfg)
            all_reduce(h, dist.ReduceOp.SUM, mesh.genome_group)
            hits = _hist_hits(h, G)
        out[:, :3] += classify_tallies(hits, counts > 0, J)
        out[:, 3] += hits.sum(dim=0, dtype=torch.int64)
    all_reduce(out, dist.ReduceOp.SUM, mesh.data_group)
    return out.cpu().numpy()


def sharded_pileup(batches, sub, cfg: MapConfig, total_len: int, mesh) -> torch.Tensor:
    """Pass 2 of this rank over its slice of the k-mers through the selected
    genome's sub-index `sub`, merged over the world: the (4, total_len+1,
    4) int32 pileup, identical on every rank."""
    pileup = pileup_from_subindex(batches, sub, None, cfg, total_len)
    all_reduce(pileup[:2], dist.ReduceOp.MAX)
    all_reduce(pileup[2:], dist.ReduceOp.SUM)
    return pileup


@dataclass
class RouteChunk:
    """One of D contiguous runs of a shard's rows, for the routed probe."""
    keys: np.ndarray    # (n,) uint64 sorted bucket ids
    hist: np.ndarray    # (n,) or (n, W) histogram rows
    starts: np.ndarray  # (n,) int32 CSR row starts in the WHOLE shard's postings


def route_split(sharded: ShardedIndex, D: int):
    """Cut each shard's rows into D contiguous chunks of ceil(U_s/D) rows
    for the routed probe (JAX pipeline.py:432-473, on the unpadded shards;
    a shard without buckets holds its one empty row, as upload_shard gives
    it). Returns (chunks, bounds): chunks[s][d] a RouteChunk, bounds (S, D)
    uint64 each chunk's first key. When U_s is short of D chunks' worth of
    rows the last chunks get none: empty chunks trail the full ones, hold
    the sentinel as their bound and take no query (route_dest reads the
    live bounds only), so a real bucket keyed 2^64-1 stays reachable."""
    mode = sharded.tally_mode()
    if mode == "flat":
        raise ValueError("route_split needs the per-shard histogram")
    chunks, bounds = [], np.full((len(sharded.shards), D), KEY_SENTINEL, np.uint64)
    for s, shard in enumerate(sharded.shards):
        keys, offsets, hist = _own_rows(shard, mode)
        U = keys.shape[0]
        c = -(-U // D)
        row = []
        for d in range(D):
            lo, hi = min(d * c, U), min((d + 1) * c, U)
            row.append(RouteChunk(keys[lo:hi], hist[lo:hi], offsets[lo:hi].astype(np.int32)))
            if hi > lo:
                bounds[s, d] = keys[lo]
        chunks.append(row)
    return chunks, bounds


def live_bounds(bounds_row: np.ndarray, chunks_row: list[RouteChunk]) -> np.ndarray:
    """The bounds a query's destination counts: those of the non-empty
    chunks after the first."""
    return bounds_row[1:sum(c.keys.shape[0] > 0 for c in chunks_row)]


def route_dest(q: torch.Tensor, bounds_ordered: torch.Tensor) -> torch.Tensor:
    """Each query's chunk: #(live bounds <= q) in unsigned order, both sides
    with bit 63 flipped into searchsorted's signed order."""
    return torch.searchsorted(bounds_ordered, q ^ SIGN_BIT, right=True)


@dataclass
class DeviceChunk:
    """A rank's chunk of its shard on its device, and its shard's live
    chunk bounds (bit 63 flipped)."""
    keys_ordered: torch.Tensor
    hist: torch.Tensor
    starts: torch.Tensor
    bounds_ordered: torch.Tensor


def upload_chunk(chunks, bounds: np.ndarray, s: int, d: int,
                 device: torch.device) -> DeviceChunk:
    """Chunk d of shard s on `device`, as rank (d, s) of the mesh holds it."""
    c = chunks[s][d]
    return DeviceChunk(
        keys_ordered=from_u64(c.keys, device) ^ SIGN_BIT,
        hist=torch.from_numpy(np.array(c.hist)).to(device),
        starts=torch.from_numpy(np.array(c.starts, np.int32)).to(device),
        bounds_ordered=from_u64(live_bounds(bounds[s], chunks[s]), device) ^ SIGN_BIT)


def _route_probe(kmers, counts, chunk: DeviceChunk, cfg: MapConfig, mesh, save: bool):
    """The routed probe of one batch slice (JAX _route_group, the
    all_to_all, _merge_probe and _unroute, pipeline.py:476-600): each
    query goes to the chunk of its shard that can hold it, over the data
    group, is probed there against the chunk's keys, and its histogram
    row (and, with `save`, its global CSR start; both 0 on a miss) comes
    back into this rank's lane order. Zero-count lanes go nowhere and read
    0. Every rank of the group enters all three (four with `save`)
    exchanges, with exact split sizes. Returns (h, start or None)."""
    D, group = mesh.n_data, mesh.data_group
    q, _, _ = _bucket_q(kmers, cfg=cfg)
    B, J = q.shape
    qf = q.reshape(-1)
    dest = torch.where((counts > 0).repeat_interleave(J), route_dest(qf, chunk.bounds_ordered), D)
    dest_s, order = torch.sort(dest, stable=True)
    send = torch.bincount(dest_s, minlength=D + 1)[:D]
    recv = all_to_all(send, [1] * D, [1] * D, group)
    sizes = torch.cat([send, recv]).tolist()
    send_l, recv_l = sizes[:D], sizes[D:]
    order = order[:sum(send_l)]
    got = all_to_all(qf[order], send_l, recv_l, group)
    row, hit = _probe(got, chunk.keys_ordered)
    hist = chunk.hist
    h_got = torch.where(hit if hist.dim() == 1 else hit[:, None], hist[row], 0)
    h = torch.zeros((B * J, *hist.shape[1:]), dtype=hist.dtype, device=qf.device)
    h.index_copy_(0, order, all_to_all(h_got, recv_l, send_l, group))
    start = None
    if save:
        start = torch.zeros(B * J, dtype=torch.int32, device=qf.device)
        start.index_copy_(0, order, all_to_all(torch.where(hit, chunk.starts[row], 0),
                                               recv_l, send_l, group))
        start = start.reshape(B, J)
    return h.reshape(B, J, *hist.shape[1:]), start


def routed_tally(batches, chunk: DeviceChunk, cfg: MapConfig, mode: str, mesh,
                 save: bool = False):
    """Pass 1 of this rank over its B-split batches through the routed
    probe (JAX make_routed_tally_scan, pipeline.py:603-719), 'hist' or
    'words': the histogram rows sum over the genome group before the
    bytes are summed and classified; tallies and walk lengths sum over the
    data group. Returns (out, saved, own): out as sharded_tally's; with
    `save` saved[i] = batch i's (start, h) in this rank's lane order and
    own (nb, G) int64 this rank's walk length by batch and genome, else
    None and None."""
    if mode not in ("hist", "words"):
        raise ValueError(f"the routed probe reads a histogram, not mode {mode!r}")
    G, J = cfg.num_genomes, len(cfg.positions)
    device = chunk.starts.device
    out = torch.zeros((G, 4), dtype=torch.int64, device=device)
    saved, own = [], []
    for kmers, counts in batches:
        h, start = _route_probe(kmers, counts, chunk, cfg, mesh, save)
        all_reduce(h, dist.ReduceOp.SUM, mesh.genome_group)
        hits = _hist_hits(h, G)
        lanes = hits.sum(dim=0, dtype=torch.int64)
        out[:, :3] += classify_tallies(hits, counts > 0, J)
        out[:, 3] += lanes
        if save:
            saved.append((start, h))
            own.append(lanes)
    all_reduce(out, dist.ReduceOp.SUM, mesh.data_group)
    if not save:
        return out.cpu().numpy(), None, None
    own_t = (torch.stack(own) if own
             else torch.zeros((0, G), dtype=torch.int64, device=device))
    return out.cpu().numpy(), saved, own_t


def routed_pileup(batches, saved, own: torch.Tensor, postings: torch.Tensor, best: int,
                  file_base: int, cfg: MapConfig, total_len: int) -> torch.Tensor:
    """Pass 2 from the routed pass 1's saved probe, on a Dx1 mesh with the
    histogram word and postings grouped by genome (JAX
    make_routed_pileup_scan, pipeline.py:722-781): each rank walks its own
    slice (ops/map.pileup_from_saved over shard 0's int64 postings,
    `file_base` the genome's global offset), each batch's walk length its
    own hits of `best`; depth planes merge by MAX, count planes by SUM
    over the world. Returns the (4, total_len+1, 4) int32 pileup,
    identical on every rank."""
    pileup = pileup_from_saved(batches, saved, own[:, best].tolist(), postings, best, cfg,
                               total_len, file_base)
    all_reduce(pileup[:2], dist.ReduceOp.MAX)
    all_reduce(pileup[2:], dist.ReduceOp.SUM)
    return pileup


def sharded_map_step(kmers, counts, shard: DeviceShard, pileup, tallies, *,
                     cfg: MapConfig, mesh):
    """One step of the whole-index map over the mesh (JAX
    make_sharded_map_step, pipeline.py:215-246): this rank's slice of the
    batch against its genome shard (ops/map.probe_scatter over the shard's
    int64 postings, upload_shard(postings=True)); the hits sum over the
    genome group before classification. Returns (the rank's partial
    pileup in its shard's space, its data row's tallies); merge_step
    merges both."""
    pileup, hits = probe_scatter(kmers, counts, shard.keys_ordered, shard.offsets,
                                 shard.postings, pileup, cfg=cfg)
    all_reduce(hits, dist.ReduceOp.SUM, mesh.genome_group)
    return pileup, tallies + classify_tallies(hits, counts > 0, len(cfg.positions))


def sharded_tally_step(kmers, counts, shard: DeviceShard, cfg: MapConfig, mesh,
                       lane_chunk: int = FLAT_LANE_CHUNK) -> torch.Tensor:
    """The tally-only step (JAX make_sharded_tally_step, pipeline.py:249-279):
    the flat tally of this rank's slice against its shard, hits summed over
    the genome group, tallies over the data group. Returns the (G, 3)
    int32 tallies, identical on every rank."""
    hits = _flat_hits(kmers, counts, shard, cfg=cfg, lane_chunk=lane_chunk)
    all_reduce(hits, dist.ReduceOp.SUM, mesh.genome_group)
    tallies = classify_tallies(hits, counts > 0, len(cfg.positions))
    all_reduce(tallies, dist.ReduceOp.SUM, mesh.data_group)
    return tallies


def merge_step(pileup: torch.Tensor, tallies: torch.Tensor, mesh):
    """Merge the data rows' partial pileups and tallies (JAX make_merge_step,
    pipeline.py:833-850), in place: depth planes by MAX, count planes and
    tallies by SUM over the data group. Returns (pileup, tallies), the
    genome shard's merged pileup and the tallies, on every rank of a
    genome column alike."""
    all_reduce(pileup[:2], dist.ReduceOp.MAX, mesh.data_group)
    all_reduce(pileup[2:], dist.ReduceOp.SUM, mesh.data_group)
    all_reduce(tallies, dist.ReduceOp.SUM, mesh.data_group)
    return pileup, tallies
