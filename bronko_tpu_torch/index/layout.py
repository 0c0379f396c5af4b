"""Device-facing index layout on torch tensors.

Counterpart of `bronko_tpu/index/layout.py` (layout.py:135-302). Global
pileup space is every sequence of every genome concatenated; pass 2 works
in the selected genome's local space, `g_total_len` = the longest genome.

Always on the device: the sorted bucket keys and their CSR starts, and
the pass-2 postings — genome-local int32 where every genome is below
2^25 bp, else the int64 global postings. The genome histogram is the
single packed word (G <= 8) or, for larger panels, one int64 word per 8
genomes; neither exists when a bucket holds more than 255 postings.

Built on first use and cached, so an index whose main path does not need
them never uploads them: the per-posting genome ids of the flat tally
(`posting_fids`), the selected genome's sub-index (`subindex`), which
pass 2 probes when the saved probe cannot serve it, the per-genome
bases on the device (`file_bases_t`), and the slot directory of the keys
that kernel (b) searches through (`probe_dir`).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from bronko_tpu_torch.index.model import (
    CANON_SHIFT, FILE_MASK, FILE_SHIFT, IDX_MASK, SEQ_MASK, SEQ_SHIFT, BronkoIndex,
)
from bronko_tpu_torch.ops.codec import from_u64
from bronko_tpu_torch.ops.cuda_map import ProbeDirectory, probe_directory
from bronko_tpu_torch.ops.map import SIGN_BIT, MapConfig, make_map_config

KEY_SENTINEL = np.uint64(0xFFFFFFFFFFFFFFFF)
# genomes at least this long do not fit the int32 lpos<<6 | canon<<5 | idx
LOCAL32_LIMIT = 1 << 25
# the multi-word histogram's table limit (JAX layout.py:201-202)
HIST_WORDS_MAX_BYTES = 2 << 30


@dataclass
class SeqSlice:
    file_id: int
    seq_id: int
    name: str
    offset: int  # offset into the global pileup position space
    length: int


@dataclass
class SubIndex:
    """One genome's own bucket index: its buckets' keys, CSR starts and
    its postings in genome-local coordinates (int32 lpos<<6 | canon<<5 |
    idx, or int64 lpos<<22 | meta for a genome of 2^25 bp or more)."""
    keys_ordered: torch.Tensor  # (U_g,) int64 sorted ids with bit 63 flipped
    offsets: torch.Tensor       # (U_g+1,) int32
    postings: torch.Tensor      # (P_g,) int32 or int64


@dataclass
class DeviceIndex:
    k: int
    keys: torch.Tensor       # (U,) int64: sorted uint64 bucket ids, as bits
    offsets: torch.Tensor    # (U+1,) int32 CSR row starts
    num_genomes: int
    total_len: int           # all genomes' sequences
    max_bucket: int
    seq_slices: list[SeqSlice]
    genome_lens: np.ndarray  # (G,) int64
    file_bases: np.ndarray   # (G,) int64 global offset of each genome
    g_total_len: int         # pass-2 pileup length: the longest genome
    # per-bucket per-genome posting counts, 8 bits per genome: int32 when
    # G <= 4 and the top byte stays below the sign bit, else int64; None
    # when G > 8 or a bucket holds more than 255 postings
    hist: torch.Tensor | None
    # (U, ceil(G/8)) int64, genome g in byte g % 8 of word g // 8; built
    # when G > 8, no bucket holds more than 255 postings and the table
    # stays within HIST_WORDS_MAX_BYTES
    hist_words: torch.Tensor | None
    # postings sorted by genome within every bucket (the saved-probe pass 2
    # derives the selected genome's range from the bucket start + bytes)
    fid_grouped: bool
    # (P,) int32 genome-local lpos<<6 | canonical<<5 | idx; None when a
    # genome is 2^25 bp or longer
    postings_local32: torch.Tensor | None
    # (P,) int64 global gpos<<22 | file_id<<6 | canonical<<5 | idx; only
    # when postings_local32 is None
    postings: torch.Tensor | None
    device: torch.device
    # sources of the arrays built on first use: the (P,) genome id of every
    # posting (host), and genome g's (keys as uint64 bits, offsets,
    # postings), host arrays or tensors (the device build cuts them from
    # its own tensors and passes its genome ids as _fids)
    fid_source: Callable[[], np.ndarray] = field(repr=False, default=None)
    subindex_source: Callable[[int], tuple] = field(repr=False, default=None)
    _fids: torch.Tensor | None = field(repr=False, default=None)
    _subindex: dict = field(repr=False, default_factory=dict)
    # (G,) int64 file_bases on the device, cached at first use
    _fbases: torch.Tensor | None = field(repr=False, default=None)
    # the keys' slot directory, built at the first single-word pass 1
    _probe_dir: ProbeDirectory | None = field(repr=False, default=None)

    def __post_init__(self):
        # the keys are sorted as uint64; flipping bit 63 makes that order
        # the signed int64 order that torch.searchsorted follows
        self.keys_ordered = self.keys ^ SIGN_BIT

    def map_config(self, n_fixed: int, use_full_kmer: bool) -> MapConfig:
        return make_map_config(
            k=self.k, max_bucket=self.max_bucket, num_genomes=self.num_genomes,
            total_len=self.total_len, n_fixed=n_fixed,
            use_full_kmer=use_full_kmer)

    def slices_for_file(self, file_id: int) -> list[SeqSlice]:
        return [s for s in self.seq_slices if s.file_id == file_id]

    def tally_mode(self) -> str:
        """Pass 1's genome counts: 'hist' (single word), 'words', or
        'flat' (every posting of every hit bucket)."""
        if self.hist is not None:
            return "hist"
        return "words" if self.hist_words is not None else "flat"

    def pass2_postings(self) -> torch.Tensor:
        """The postings the saved-probe pass 2 walks."""
        return self.postings_local32 if self.postings_local32 is not None else self.postings

    def posting_fids(self) -> torch.Tensor:
        """(P,) int32 genome id of every posting (the flat tally's)."""
        if self._fids is None:
            self._fids = torch.from_numpy(
                np.ascontiguousarray(self.fid_source(), np.int32)).to(self.device)
        return self._fids

    def global_postings(self) -> torch.Tensor:
        """(P,) int64 gpos<<22 | file_id<<6 | canonical<<5 | idx, the whole
        index's postings in the global pileup space (ops/map.map_batch's):
        the int64 postings, or, where only the genome-local int32 ones
        exist, their position moved by file_bases[file_id]. Not cached."""
        if self.postings is not None:
            return self.postings
        fids = self.posting_fids().long()
        local = self.postings_local32.long()
        bases = torch.from_numpy(self.file_bases).to(self.device)[fids]
        return (((local >> 6) + bases) << 22) | (fids << 6) | (local & 63)

    def file_bases_t(self) -> torch.Tensor:
        """(G,) int64 file_bases on the device: kernel (c)'s file base read
        at the selected genome on the int64 postings."""
        if self._fbases is None:
            self._fbases = _put_async(self.file_bases, self.device)
        return self._fbases

    def probe_dir(self) -> ProbeDirectory:
        """The slot directory of keys_ordered (ops/cuda_map.probe_directory),
        which kernel (b) and its plain version search through."""
        if self._probe_dir is None:
            self._probe_dir = probe_directory(self.keys_ordered)
        return self._probe_dir

    def subindex(self, g: int) -> SubIndex:
        """Genome g's sub-index, from subindex_source at first use (host
        arrays are uploaded), then cached."""
        if g not in self._subindex:
            self._subindex[g] = load_subindex(self.subindex_source(g), self.device)
        return self._subindex[g]

    def device_bytes(self) -> int:
        """Bytes of every tensor this index holds on its device now."""
        tensors = [self.keys, self.keys_ordered, self.offsets, self.hist, self.hist_words,
                   self.postings_local32, self.postings, self._fids, self._fbases,
                   None if self._probe_dir is None else self._probe_dir.table]
        for sub in self._subindex.values():
            tensors += [sub.keys_ordered, sub.offsets, sub.postings]
        return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def _put_async(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """An int64 host array on `device`: on a CUDA device through page-locked
    memory, enqueued without a host sync."""
    t = torch.from_numpy(np.ascontiguousarray(a, np.int64))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def load_subindex(parts: tuple, device: torch.device) -> SubIndex:
    """A subindex_source's (keys as uint64 bits, offsets, postings), host
    arrays or tensors, as a SubIndex on `device`."""
    keys, offsets, postings = parts
    if not isinstance(keys, torch.Tensor):  # host arrays
        keys = from_u64(np.asarray(keys, np.uint64), device)
        offsets = torch.from_numpy(np.array(offsets, np.int32))
        postings = torch.from_numpy(np.array(postings))
    return SubIndex(keys_ordered=keys.to(device) ^ SIGN_BIT,
                    offsets=offsets.to(device, torch.int32), postings=postings.to(device))


def _hist_dtype(G: int, E: int):
    """The JAX layout's histogram word: int32 for G <= 4 with the top byte
    below the sign bit (E <= 127 for a 4th genome), else int64."""
    return np.int32 if G <= 4 and (G < 4 or E <= 127) else np.int64


def _histograms(bucket_of_post, file_id, U: int, G: int, E: int):
    """(hist, hist_words) as JAX packs them (layout.py:191-215): each
    bucket's posting count per genome, one byte a genome."""
    W = -(-G // 8)
    if E > 255 or (G > 8 and U * W * 8 > HIST_WORDS_MAX_BYTES):
        return None, None
    h = np.bincount(bucket_of_post * (8 * W) + file_id, minlength=U * 8 * W)
    # bytes hold <= 255, so summing the shifted fields is their OR (a top
    # byte may wrap the int64, which keeps its bits)
    words = (h.reshape(U, W, 8) << (8 * np.arange(8, dtype=np.int64))).sum(axis=2)
    if G <= 8:
        return words[:, 0].astype(_hist_dtype(G, E)), None
    return None, words


def build_device_index(index: BronkoIndex, device: torch.device) -> DeviceIndex:
    """Host BronkoIndex -> DeviceIndex on `device` (layout.py:135-302)."""
    seq_slices: list[SeqSlice] = []
    offset_table: dict[tuple[int, int], int] = {}
    cursor = 0
    for file_id, f in enumerate(index.files):
        for seq_id, s in enumerate(f.sequences):
            offset_table[(file_id, seq_id)] = cursor
            seq_slices.append(SeqSlice(file_id, seq_id, s.name, cursor, s.length))
            cursor += s.length

    meta = index.post_meta
    idx = (meta & IDX_MASK).astype(np.int64)
    seq_id = ((meta >> SEQ_SHIFT) & SEQ_MASK).astype(np.int64)
    file_id = ((meta >> FILE_SHIFT) & FILE_MASK).astype(np.int64)
    canon = ((meta >> CANON_SHIFT) & 1).astype(np.int64)

    max_seq = int(seq_id.max()) + 1 if seq_id.size else 1
    table = np.zeros((len(index.files), max_seq), np.int64)
    for (fid, sid), off in offset_table.items():
        if sid < max_seq:
            table[fid, sid] = off
    seq_off = table[file_id, seq_id] if meta.size else np.zeros(0, np.int64)
    gpos = seq_off + index.post_loc.astype(np.int64) + idx

    G = len(index.files)
    genome_lens = np.asarray([f.total_len for f in index.files], np.int64)
    file_bases = (np.concatenate([[0], np.cumsum(genome_lens)[:-1]]).astype(np.int64)
                  if G else np.zeros(0, np.int64))
    fold_bits = (canon << 5) | idx
    lpos = gpos - file_bases[file_id] if meta.size else gpos
    postings_local32 = postings = None
    if meta.size and int(genome_lens.max()) < LOCAL32_LIMIT:
        postings_local32 = ((lpos << 6) | fold_bits).astype(np.int32)
    elif meta.size:
        postings = (gpos << 22) | (file_id << 6) | fold_bits

    E = index.max_postings_per_bucket
    U = index.num_buckets
    hist = hist_words = None
    fid_grouped = False
    if meta.size:
        bucket_of_post = np.repeat(np.arange(U, dtype=np.int64), np.diff(index.offsets))
        same_bucket = bucket_of_post[1:] == bucket_of_post[:-1]
        fid_grouped = bool(np.all(file_id[1:][same_bucket] >= file_id[:-1][same_bucket]))
        hist, hist_words = _histograms(bucket_of_post, file_id, U, G, E)

    post_fids = file_id.astype(np.int32)
    # the sub-index's postings: the int32 layout, else JAX's lpos<<22 | meta
    local = (postings_local32 if postings_local32 is not None
             else (lpos << 22) | (file_id << 6) | fold_bits)

    def subindex_source(g: int):
        # the global postings are sorted by key, so genome g's, taken in
        # that order, are too, each bucket keeping its in-bucket order
        sel = post_fids == g
        skeys = np.repeat(index.keys, np.diff(index.offsets))[sel]
        ukeys, start = np.unique(skeys, return_index=True)
        return ukeys, np.append(start, skeys.shape[0]), local[sel]

    return _device_index(
        k=index.k, keys=index.keys, offsets=index.offsets, hist=hist,
        hist_words=hist_words, postings_local32=postings_local32, postings=postings,
        fid_grouped=fid_grouped, file_bases=file_bases, genome_lens=genome_lens,
        seq_slices=seq_slices, max_bucket=E, total_len=cursor, device=device,
        fid_source=lambda: post_fids, subindex_source=subindex_source)


def _unpad_subindex(keys: np.ndarray, offsets: np.ndarray, postings: np.ndarray):
    """One genome's row of the JAX layout's padded sub-index -> its own
    arrays. Pad rows carry the sentinel key and an empty range; a real
    bucket keyed 2^64-1 had its range moved to the last row
    (fix_sentinel_collision), so the last row is non-empty then."""
    u_max = keys.shape[0]
    u = int(np.count_nonzero(keys != KEY_SENTINEL))
    if u < u_max and offsets[u_max] > offsets[u_max - 1]:
        u += 1
    n = int(offsets[u_max])
    return keys[:u], np.append(offsets[:u], n), postings[:n]


def from_jax_arrays(*, k: int, keys: np.ndarray, offsets: np.ndarray,
                    hist: np.ndarray | None, postings_local32: np.ndarray | None,
                    fid_grouped: bool, file_bases: np.ndarray,
                    genome_lens: np.ndarray, seq_slices, max_bucket: int,
                    total_len: int, device: torch.device,
                    hist_words: np.ndarray | None = None,
                    postings: np.ndarray | None = None,
                    g_keys: np.ndarray | None = None,
                    g_offsets: np.ndarray | None = None,
                    g_postings: np.ndarray | None = None) -> DeviceIndex:
    """The state carried across from the JAX package: a `bronko_tpu`
    DeviceIndex's arrays, passed as numpy (keys as uint64), become the
    port's DeviceIndex on `device`. `seq_slices` may be the JAX package's
    own SeqSlice objects. `postings` (the int64 global postings) give the
    flat tally's genome ids, and pass 2's postings when postings_local32
    is None; g_keys, g_offsets and g_postings are the padded per-genome
    sub-index, each row unpadded here."""
    fid_source = subindex_source = None
    if postings is not None:
        postings = np.asarray(postings, np.int64)
        fid_source = lambda: (postings & 0x3FFFFF) >> 6  # noqa: E731
    if g_keys is not None:
        def subindex_source(g: int):
            return _unpad_subindex(np.asarray(g_keys[g], np.uint64),
                                   np.asarray(g_offsets[g]), np.asarray(g_postings[g]))
    return _device_index(
        k=k, keys=keys, offsets=offsets, hist=hist, hist_words=hist_words,
        postings_local32=postings_local32,
        postings=postings if postings_local32 is None else None,
        fid_grouped=fid_grouped, file_bases=file_bases, genome_lens=genome_lens,
        seq_slices=seq_slices, max_bucket=max_bucket, total_len=total_len,
        device=device, fid_source=fid_source, subindex_source=subindex_source)


def _device_index(*, k, keys, offsets, hist, hist_words, postings_local32, postings,
                  fid_grouped, file_bases, genome_lens, seq_slices, max_bucket,
                  total_len, device, fid_source, subindex_source) -> DeviceIndex:
    genome_lens = np.asarray(genome_lens, np.int64)

    def put(a, dtype):
        return None if a is None else torch.from_numpy(np.array(a, dtype)).to(device)

    hist_dtype = None if hist is None else np.asarray(hist).dtype
    if hist_dtype is not None and hist_dtype not in (np.int32, np.int64):
        raise ValueError(f"hist must be int32 or int64, got {hist_dtype}")
    return DeviceIndex(
        k=int(k),
        keys=from_u64(np.asarray(keys, np.uint64), device),
        offsets=put(offsets, np.int32),
        num_genomes=int(genome_lens.shape[0]),
        total_len=int(total_len),
        max_bucket=int(max_bucket),
        seq_slices=[SeqSlice(s.file_id, s.seq_id, s.name, s.offset, s.length)
                    for s in seq_slices],
        genome_lens=genome_lens,
        file_bases=np.asarray(file_bases, np.int64),
        g_total_len=int(genome_lens.max()) if genome_lens.size else 0,
        hist=put(hist, hist_dtype),
        hist_words=put(hist_words, np.int64),
        fid_grouped=bool(fid_grouped),
        postings_local32=put(postings_local32, np.int32),
        postings=put(postings, np.int64),
        device=device,
        fid_source=fid_source,
        subindex_source=subindex_source,
    )
