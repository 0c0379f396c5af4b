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
    FLAT_LANE_CHUNK, SIGN_BIT, MapConfig, _flat_hits, _hist_hits, _probe_hist,
    classify_tallies, pileup_from_subindex,
)
from bronko_tpu_torch.parallel.distributed import all_reduce

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
    the histogram words or, for the flat tally, each posting's genome."""
    keys_ordered: torch.Tensor
    offsets: torch.Tensor
    hist: torch.Tensor | None
    fids: torch.Tensor | None

    def posting_fids(self) -> torch.Tensor:
        return self.fids


def upload_shard(shard: Shard, mode: str, device: torch.device) -> DeviceShard:
    """The shard's tensors on `device`. A shard without buckets (more
    shards than genomes) gets one empty row, as JAX's padding gives it:
    key 0, no postings, a zero histogram, so a query that hits it adds
    nothing."""
    keys, offsets = shard.keys, shard.offsets
    hist = shard.hist if mode == "hist" else shard.hist_words if mode == "words" else None
    if keys.shape[0] == 0:
        keys, offsets = np.zeros(1, np.uint64), np.zeros(2, np.int32)
        if hist is not None:
            hist = np.zeros((1, *hist.shape[1:]), hist.dtype)
    fids = None
    if mode == "flat":
        fids = ((shard.postings & 0x3FFFFF) >> 6).astype(np.int32)
    return DeviceShard(
        keys_ordered=from_u64(keys, device) ^ SIGN_BIT,
        offsets=torch.from_numpy(np.array(offsets, np.int32)).to(device),
        hist=None if hist is None else torch.from_numpy(np.array(hist)).to(device),
        fids=None if fids is None else torch.from_numpy(fids).to(device))


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
