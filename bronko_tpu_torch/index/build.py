"""Index builder: FASTA genomes -> sorted-CSR bucket index.

Behavior-parity notes vs the reference builder (build.rs:145-231):
  * every window of every sequence is indexed, including windows containing
    non-ACGT bytes, which encode as 'A' (the reference packs via nt_to_bits
    which maps unknown bytes to 0, lcb.rs:53);
  * canonicalization and bucket assignment happen on the canonical form;
  * sequences shorter than k are skipped (the reference would panic there);
  * posting order within a bucket preserves (file, seq, window, idx) append
    order via a stable sort, so downstream iteration-order-sensitive results
    match.

The build is fully vectorized NumPy on host: index construction is an
offline, genome-scale (~kb..Mb) task; the device-facing layout is derived
in index/layout.py.
"""

from __future__ import annotations

import logging

import numpy as np

from bronko_tpu_torch.index.model import SEQ_MASK, BronkoIndex, FileMeta, SeqMeta, pack_meta
from bronko_tpu_torch.io.fasta import read_fasta
from bronko_tpu_torch.io.naming import file_stem
from bronko_tpu_torch.ops.buckets import assign_buckets_np
from bronko_tpu_torch.ops.codec import canonical_np, pack_kmer, seq_bytes_to_bits

log = logging.getLogger("bronko")


def _index_one_sequence(bits: np.ndarray, k: int):
    """Return (keys, loc, idx, canon_flags) posting columns for one sequence."""
    nwin = bits.shape[0] - k + 1
    windows = np.lib.stride_tricks.sliding_window_view(bits, k).astype(np.uint64)
    fwd = pack_kmer(windows, k)  # golden-anchored packing (ops/codec.py)
    canon, is_rc = canonical_np(fwd, k)
    buckets = assign_buckets_np(canon, k)  # (nwin, k)
    keys = buckets.reshape(-1)
    loc = np.repeat(np.arange(nwin, dtype=np.uint32), k)
    idx = np.tile(np.arange(k, dtype=np.uint32), nwin)
    canon_flags = np.repeat(is_rc.astype(np.uint32), k)
    return keys, loc, idx, canon_flags


def parse_genomes(genome_paths: list[str]) -> list[FileMeta]:
    """FASTA paths -> FileMeta list with capacity validation."""
    if len(genome_paths) > 65535:
        raise ValueError("at most 65535 genome files are supported (u16 file ids)")
    files: list[FileMeta] = []
    for path in genome_paths:
        records = read_fasta(path)
        if len(records) > SEQ_MASK + 1:
            # seq ids are 10-bit in the posting layout (wider than the
            # reference's u8, build.rs:55); fail loudly instead of
            # corrupting genome attribution
            raise ValueError(
                f"{path} has {len(records)} sequences; at most {SEQ_MASK + 1} "
                f"per file are supported"
            )
        files.append(FileMeta(
            file_stem(path),
            [SeqMeta(rec.name, len(rec.seq), rec.seq) for rec in records]))
        log.info("indexed %s: %d sequence(s)", path, len(records))
    return files


def build_index(k: int, genome_paths: list[str]) -> BronkoIndex:
    return build_index_from_files(k, parse_genomes(genome_paths))


def build_index_from_files(k: int, files: list[FileMeta]) -> BronkoIndex:
    all_keys, all_loc, all_meta = [], [], []
    for file_id, fmeta in enumerate(files):
        for seq_id, rec in enumerate(fmeta.sequences):
            if rec.length < k:
                log.warning("sequence %s shorter than k=%d, skipped", rec.name, k)
                continue
            bits = seq_bytes_to_bits(rec.seq)
            keys, loc, idx, canon_flags = _index_one_sequence(bits, k)
            all_keys.append(keys)
            all_loc.append(loc)
            all_meta.append(pack_meta(idx, np.uint32(seq_id), np.uint32(file_id), canon_flags))

    if all_keys:
        keys = np.concatenate(all_keys)
        loc = np.concatenate(all_loc)
        meta = np.concatenate(all_meta)
    else:
        keys = np.empty(0, np.uint64)
        loc = np.empty(0, np.uint32)
        meta = np.empty(0, np.uint32)

    order = np.argsort(keys, kind="stable")
    keys = keys[order]
    loc = loc[order]
    meta = meta[order]

    uniq_keys, start_idx = np.unique(keys, return_index=True)
    offsets = np.concatenate([start_idx.astype(np.int64), [keys.shape[0]]])

    log.info(
        "index built: %d postings, %d buckets, max bucket size %d",
        keys.shape[0], uniq_keys.shape[0],
        int(np.max(np.diff(offsets))) if uniq_keys.size else 0,
    )
    return BronkoIndex(k=k, keys=uniq_keys, offsets=offsets,
                       post_loc=loc, post_meta=meta, files=files)
