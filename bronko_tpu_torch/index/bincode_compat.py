"""Reader for the reference bronko's bincode .bkdb databases.

The reference serializes BronkoIndex{k, FxHashMap<u64, Vec<BucketInfo>>,
ViralMetadata} with bincode's standard config (build.rs:122-143): little-
endian, variable-length integer encoding. This loader lets existing bronko
databases be used directly with bronko-tpu.

Bincode 2 standard-config wire format:
  * unsigned ints (u16/u32/u64/usize): varint — one byte < 251, or a
    discriminant byte 251/252/253 followed by a LE u16/u32/u64;
  * u8: single raw byte; bool: 1 byte;
  * collections/strings: varint length then elements/UTF-8 bytes;
  * struct fields in declaration order.

Schema (build.rs:23-60):
  BronkoIndex { k: usize, global_index: Map<u64, Vec<BucketInfo>>,
                metadata: ViralMetadata }
  BucketInfo  { file_id: u16, seq_id: u8, location: u32, idx: u8,
                canonical: bool }
  ViralMetadata { files: Vec<FileMeta>, k: usize }
  FileMeta    { name: String, sequences: Vec<SeqMeta> }
  SeqMeta     { name: String, len: usize, seq: Vec<u8> }
"""

from __future__ import annotations

import struct

import numpy as np

from bronko_tpu_torch.index.model import BronkoIndex, FileMeta, SeqMeta, pack_meta


class _Reader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def byte(self) -> int:
        b = self.buf[self.pos]
        self.pos += 1
        return b

    def varint(self) -> int:
        b = self.buf[self.pos]
        self.pos += 1
        if b < 251:
            return b
        if b == 251:
            v = struct.unpack_from("<H", self.buf, self.pos)[0]
            self.pos += 2
            return v
        if b == 252:
            v = struct.unpack_from("<I", self.buf, self.pos)[0]
            self.pos += 4
            return v
        if b == 253:
            v = struct.unpack_from("<Q", self.buf, self.pos)[0]
            self.pos += 8
            return v
        raise ValueError(f"unsupported varint discriminant {b}")

    def bytes_(self, n: int) -> bytes:
        out = self.buf[self.pos:self.pos + n]
        if len(out) != n:  # truncated mid-payload: fail loudly — a short
            # sequence blob would otherwise load 'successfully' and shift
            # every downstream coordinate
            raise ValueError("truncated bincode payload")
        self.pos += n
        return out

    def string(self) -> str:
        return self.bytes_(self.varint()).decode()


def load_reference_bkdb(path: str) -> BronkoIndex:
    with open(path, "rb") as fh:
        r = _Reader(fh.read())

    k = r.varint()

    n_buckets = r.varint()
    keys = np.empty(n_buckets, np.uint64)
    # postings accumulate as (key_rank, structured columns)
    all_fid, all_sid, all_loc, all_idx, all_can = [], [], [], [], []
    bucket_sizes = np.empty(n_buckets, np.int64)
    for i in range(n_buckets):
        keys[i] = r.varint()
        n = r.varint()
        bucket_sizes[i] = n
        fid = np.empty(n, np.uint32)
        sid = np.empty(n, np.uint32)
        loc = np.empty(n, np.uint32)
        idxa = np.empty(n, np.uint32)
        can = np.empty(n, np.uint32)
        for j in range(n):
            fid[j] = r.varint()     # u16
            sid[j] = r.byte()       # u8
            loc[j] = r.varint()     # u32
            idxa[j] = r.byte()      # u8
            can[j] = r.byte()       # bool
        all_fid.append(fid)
        all_sid.append(sid)
        all_loc.append(loc)
        all_idx.append(idxa)
        all_can.append(can)

    # metadata
    n_files = r.varint()
    files: list[FileMeta] = []
    for _ in range(n_files):
        name = r.string()
        n_seqs = r.varint()
        seqs = []
        for _ in range(n_seqs):
            sname = r.string()
            slen = r.varint()
            sbytes = r.bytes_(r.varint())
            seqs.append(SeqMeta(sname, slen, sbytes))
        files.append(FileMeta(name, seqs))
    meta_k = r.varint()
    if meta_k != k:
        raise ValueError(
            f"corrupt .bkdb: index k={k} but metadata k={meta_k}")
    if r.pos != len(r.buf):
        raise ValueError(
            f"corrupt .bkdb: {len(r.buf) - r.pos} trailing bytes")

    # assemble sorted-CSR (hashmap order -> sorted key order, stable)
    fid = np.concatenate(all_fid) if all_fid else np.empty(0, np.uint32)
    sid = np.concatenate(all_sid) if all_sid else np.empty(0, np.uint32)
    loc = np.concatenate(all_loc) if all_loc else np.empty(0, np.uint32)
    idxa = np.concatenate(all_idx) if all_idx else np.empty(0, np.uint32)
    can = np.concatenate(all_can) if all_can else np.empty(0, np.uint32)
    post_key = np.repeat(keys, bucket_sizes)

    order = np.argsort(post_key, kind="stable")
    post_key = post_key[order]
    post_loc = loc[order]
    post_meta = pack_meta(idxa[order], sid[order], fid[order], can[order])

    uniq, start = np.unique(post_key, return_index=True)
    offsets = np.concatenate([start.astype(np.int64), [post_key.shape[0]]])

    return BronkoIndex(k=k, keys=uniq, offsets=offsets,
                       post_loc=post_loc, post_meta=post_meta, files=files)


class _Writer:
    __slots__ = ("parts",)

    def __init__(self) -> None:
        self.parts: list[bytes] = []

    def byte(self, v: int) -> None:
        self.parts.append(bytes((v,)))

    def varint(self, v: int) -> None:
        # bincode 2 standard config: magnitude-based variable encoding
        if v < 251:
            self.parts.append(bytes((v,)))
        elif v < (1 << 16):
            self.parts.append(b"\xfb" + struct.pack("<H", v))
        elif v < (1 << 32):
            self.parts.append(b"\xfc" + struct.pack("<I", v))
        else:
            self.parts.append(b"\xfd" + struct.pack("<Q", v))

    def string(self, s: str) -> None:
        b = s.encode()
        self.varint(len(b))
        self.parts.append(b)


def save_reference_bkdb(index: BronkoIndex, path: str) -> None:
    """Write a reference-format (bincode) .bkdb the reference binary can
    load — the inverse of load_reference_bkdb, completing two-way
    database interop (build here, call there, or vice versa).

    Buckets are emitted in sorted-key order (the reference deserializes
    into a HashMap, so order is semantically irrelevant); postings keep
    their in-bucket order. The reference's BucketInfo stores seq_id as u8
    (build.rs:55) — an index using bronko-tpu's extended 10-bit seq ids
    (>256 contigs per file) cannot be represented and raises ValueError."""
    from bronko_tpu_torch.index.model import (
        CANON_SHIFT, FILE_MASK, FILE_SHIFT, IDX_MASK, SEQ_MASK, SEQ_SHIFT,
    )

    meta = index.post_meta
    p_idx = (meta & IDX_MASK).astype(np.int64)
    p_seq = ((meta >> SEQ_SHIFT) & SEQ_MASK).astype(np.int64)
    p_fid = ((meta >> FILE_SHIFT) & FILE_MASK).astype(np.int64)
    p_can = ((meta >> CANON_SHIFT) & 1).astype(np.int64)
    if meta.size and int(p_seq.max()) > 0xFF:
        raise ValueError(
            "index uses >256 sequences per file; the reference .bkdb "
            "format stores seq_id as u8 and cannot represent it")

    w = _Writer()
    w.varint(int(index.k))
    U = int(index.keys.shape[0])
    w.varint(U)
    # plain-list views: numpy scalar extraction per posting costs ~10x a
    # list access, and large panels have millions of postings
    keys = index.keys.tolist()
    offsets = index.offsets.tolist()
    loc = index.post_loc.tolist()
    l_fid, l_seq = p_fid.tolist(), p_seq.tolist()
    l_idx, l_can = p_idx.tolist(), p_can.tolist()
    for i in range(U):
        w.varint(keys[i])
        lo, hi = offsets[i], offsets[i + 1]
        w.varint(hi - lo)
        for j in range(lo, hi):
            w.varint(l_fid[j])   # u16
            w.byte(l_seq[j])     # u8
            w.varint(loc[j])     # u32
            w.byte(l_idx[j])     # u8
            w.byte(l_can[j])     # bool
    w.varint(len(index.files))
    for f in index.files:
        w.string(f.name)
        w.varint(len(f.sequences))
        for s in f.sequences:
            w.string(s.name)
            w.varint(int(s.length))
            sb = bytes(s.seq)
            w.varint(len(sb))
            w.parts.append(sb)
    w.varint(int(index.k))  # ViralMetadata.k (build.rs:49)

    out = path if path.endswith(".bkdb") else path + ".bkdb"
    with open(out, "wb") as fh:
        fh.write(b"".join(w.parts))


def sniff_format(path: str) -> str:
    """'npz' for bronko-tpu databases, 'bincode' for reference databases."""
    with open(path, "rb") as fh:
        magic = fh.read(4)
    return "npz" if magic[:2] == b"PK" else "bincode"
