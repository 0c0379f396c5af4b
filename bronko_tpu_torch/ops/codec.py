"""Reverse complement and canonical form of packed k-mers, on torch tensors.

Counterpart of `bronko_tpu/ops/codec.py` (lcb.rs:76-104 semantics). torch
has no usable uint64 (shifts, comparisons and searches raise on it), so a
64-bit word is an int64 tensor that carries the uint64 bit pattern. A
packed k-mer is < 4^k <= 2^62, so its arithmetic shifts and signed
comparisons agree with the unsigned ones.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["from_u64", "to_u64", "revcomp", "canonical"]


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
