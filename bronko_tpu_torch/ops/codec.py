"""2-bit nucleotide codec: packing, reverse complement and canonical form.

Counterpart of `bronko_tpu/ops/codec.py` (lcb.rs:47-104 semantics):
A/a=0, C/c=1, G/g=2, T/t=3, any other byte 0; k-mers pack big-endian
(first base in the highest bits); the canonical form is min(fwd, revcomp),
is_rc True when fwd >= revcomp (odd k has no palindromes).

Two forms of the same functions. The host's, on numpy uint64 arrays, feed
the index builder, the FASTQ parser and the caller (`*_np`, the byte
tables, `pack_kmer`, `seq_bytes_to_bits`, `kmer_to_string`). The
device's, on torch tensors: torch has no usable uint64 (shifts,
comparisons and searches raise on it), so a 64-bit word is an int64
tensor that carries the uint64 bit pattern. A packed k-mer is < 4^k <=
2^62, so its arithmetic shifts and signed comparisons agree with the
unsigned ones.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["NT_TO_BITS", "NT_IS_VALID", "seq_bytes_to_bits", "pack_kmer",
           "canonical_np", "kmer_to_string",
           "from_u64", "to_u64", "revcomp", "canonical"]

# Byte-indexed lookup: A/a,C/c,G/g,T/t -> 0..3, everything else -> 0
# (the reference maps unknown bases to 0 too: lcb.rs:53).
NT_TO_BITS = np.zeros(256, dtype=np.uint8)
for _c, _b in ((b"Aa", 0), (b"Cc", 1), (b"Gg", 2), (b"Tt", 3)):
    NT_TO_BITS[_c[0]] = _b
    NT_TO_BITS[_c[1]] = _b

# Separate validity lookup: the counters (like KMC) must skip k-mers
# containing a non-ACGT byte, while the index builder encodes them as 'A';
# io/fastq.py derives its 0..3-or-4 CODES table from these two.
NT_IS_VALID = np.zeros(256, dtype=np.bool_)
for _c in b"AaCcGgTt":
    NT_IS_VALID[_c] = True


def seq_bytes_to_bits(seq: bytes | np.ndarray) -> np.ndarray:
    """Map a byte sequence to 2-bit codes (invalid bytes -> 0)."""
    arr = (np.frombuffer(seq, dtype=np.uint8) if isinstance(seq, (bytes, bytearray))
           else np.asarray(seq, dtype=np.uint8))
    return NT_TO_BITS[arr]


def pack_kmer(bits: np.ndarray, k: int) -> np.ndarray:
    """Pack (..., k) 2-bit base codes into uint64 words, first base highest
    (kmer_to_u64, lcb.rs:67-74)."""
    bits = np.asarray(bits).astype(np.uint64)
    shifts = np.arange(k - 1, -1, -1, dtype=np.uint64) * np.uint64(2)
    return np.sum(bits << shifts, axis=-1, dtype=np.uint64)


def canonical_np(kmer: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """(canonical k-mer, is_rc) of uint64 packed k-mers (lcb.rs:76-104)."""
    kmer = np.asarray(kmer, dtype=np.uint64)
    rc = np.zeros_like(kmer)
    three = np.uint64(3)
    for i in range(k):
        rc = (rc << np.uint64(2)) | (((kmer >> np.uint64(2 * i)) & three) ^ three)
    is_rc = kmer >= rc
    return np.where(is_rc, rc, kmer), is_rc


def kmer_to_string(kmer: int, k: int) -> str:
    """Unpack a packed k-mer to its string."""
    kmer = int(kmer)
    return "".join("ACGT"[(kmer >> (2 * (k - 1 - i))) & 3] for i in range(k))


def from_u64(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """uint64 numpy array -> int64 tensor with the same bits on `device`
    (on the CPU it shares the array's memory unless that is read-only)."""
    a = np.ascontiguousarray(a, np.uint64)
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a.view(np.int64)).to(device)


def to_u64(t: torch.Tensor) -> np.ndarray:
    """int64 tensor -> uint64 numpy array with the same bits."""
    return t.cpu().numpy().view(np.uint64)


def revcomp(kmer: torch.Tensor, k: int) -> torch.Tensor:
    """Reverse complement of (...,) int64 packed k-mers (lcb.rs:76-85)."""
    rc = torch.zeros_like(kmer)
    for i in range(k):
        base = (kmer >> (2 * i)) & 3
        rc = (rc << 2) | (base ^ 3)
    return rc


def canonical(kmer: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(canonical k-mer, is_rc) as in canonical_kmer_u64 (lcb.rs:97-104):
    is_rc is True when fwd >= revcomp (odd k has no palindromes)."""
    rc = revcomp(kmer, k)
    is_rc = kmer >= rc
    return torch.where(is_rc, rc, kmer), is_rc
