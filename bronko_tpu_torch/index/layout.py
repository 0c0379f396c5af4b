"""Device-facing index layout on torch tensors.

Counterpart of `bronko_tpu/index/layout.py`, reduced to what the
single-sample main path reads (layout.py:135-302): the sorted bucket keys,
their CSR starts, the packed per-bucket genome histogram (pass 1) and the
genome-local int32 postings (pass 2). Global pileup space is every
sequence of every genome concatenated; pass 2 works in the selected
genome's local space, `g_total_len` = the longest genome.

Not carried: the int64 global postings, the multi-word histogram and the
per-genome sub-index. `unsupported_reason` names the index shapes that
need them, and the port refuses those (ROADMAP.md lists the work).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from bronko_tpu.index.model import (
    CANON_SHIFT, FILE_MASK, FILE_SHIFT, IDX_MASK, SEQ_MASK, SEQ_SHIFT, BronkoIndex,
)
from bronko_tpu_torch.ops.codec import from_u64
from bronko_tpu_torch.ops.map import SIGN_BIT, MapConfig, make_map_config

KEY_SENTINEL = np.uint64(0xFFFFFFFFFFFFFFFF)


def fix_sentinel_collision(ukeys: np.ndarray, offsets_row: np.ndarray,
                           u_max: int) -> None:
    """Padded key tables carry the sentinel 2^64-1 with empty CSR rows —
    but the bucket hash wraps mod 2^64, so a REAL bucket can equal the
    sentinel. The probe resolves duplicate keys to the LAST equal row,
    which would be an empty pad row; move the real bucket's CSR range
    onto that last row (the in-between duplicates are never selected)."""
    u = ukeys.shape[0]
    if u and u < u_max and ukeys[-1] == KEY_SENTINEL:
        offsets_row[u_max - 1] = offsets_row[u - 1]
        offsets_row[u_max] = offsets_row[u]


@dataclass
class SeqSlice:
    file_id: int
    seq_id: int
    name: str
    offset: int  # offset into the global pileup position space
    length: int


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
    # postings sorted by genome within every bucket (pass 2 derives the
    # selected genome's range from the bucket start + histogram bytes)
    fid_grouped: bool
    # (P,) int32 genome-local lpos<<6 | canonical<<5 | idx; None when a
    # genome is 2^25 bp or longer
    postings_local32: torch.Tensor | None
    device: torch.device

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


def unsupported_reason(dev: DeviceIndex) -> str | None:
    """Why the main path cannot map against this index, or None."""
    if dev.hist is None:
        return ("the index needs the multi-word histogram or the flat tally "
                f"({dev.num_genomes} genomes, largest bucket {dev.max_bucket}; "
                "the single-word histogram takes <= 8 genomes and <= 255)")
    if not dev.fid_grouped:
        return ("the index's postings are not grouped by genome within a "
                "bucket (needs the per-genome sub-index)")
    if dev.postings_local32 is None:
        return "a genome of 2^25 bp or more (needs the int64 posting layout)"
    return None


def _hist_dtype(G: int, E: int):
    """The JAX layout's histogram word: int32 for G <= 4 with the top byte
    below the sign bit (E <= 127 for a 4th genome), else int64."""
    return np.int32 if G <= 4 and (G < 4 or E <= 127) else np.int64


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
    postings_local32 = None
    if meta.size and G and int(genome_lens.max()) < (1 << 25):
        lpos = gpos - file_bases[file_id]
        postings_local32 = ((lpos << 6) | (canon << 5) | idx).astype(np.int32)

    E = index.max_postings_per_bucket
    U = index.num_buckets
    hist = None
    fid_grouped = False
    if meta.size:
        bucket_of_post = np.repeat(np.arange(U, dtype=np.int64), np.diff(index.offsets))
        same_bucket = bucket_of_post[1:] == bucket_of_post[:-1]
        fid_grouped = bool(np.all(file_id[1:][same_bucket] >= file_id[:-1][same_bucket]))
        if 0 < G <= 8 and E <= 255:
            h = np.zeros((U, G), np.int64)
            np.add.at(h, (bucket_of_post, file_id), 1)
            hist = (h << (8 * np.arange(G, dtype=np.int64))).sum(axis=1).astype(
                _hist_dtype(G, E))

    return from_jax_arrays(
        k=index.k, keys=index.keys, offsets=index.offsets.astype(np.int32),
        hist=hist, postings_local32=postings_local32, fid_grouped=fid_grouped,
        file_bases=file_bases, genome_lens=genome_lens, seq_slices=seq_slices,
        max_bucket=E, total_len=cursor, device=device)


def from_jax_arrays(*, k: int, keys: np.ndarray, offsets: np.ndarray,
                    hist: np.ndarray | None, postings_local32: np.ndarray | None,
                    fid_grouped: bool, file_bases: np.ndarray,
                    genome_lens: np.ndarray, seq_slices, max_bucket: int,
                    total_len: int, device: torch.device) -> DeviceIndex:
    """The state carried across from the JAX package: a `bronko_tpu`
    DeviceIndex's arrays, passed as numpy (keys as uint64), become the
    port's DeviceIndex on `device`. `seq_slices` may be the JAX package's
    own SeqSlice objects."""
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
        fid_grouped=bool(fid_grouped),
        postings_local32=put(postings_local32, np.int32),
        device=device,
    )
