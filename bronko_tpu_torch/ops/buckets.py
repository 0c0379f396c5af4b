"""Locality-collapsing bucket hash, on numpy uint64 and on int64 tensors.

Counterpart of `bronko_tpu/ops/buckets.py`: bucket i of a k-mer is a
collision-free hash of (wildcard position i, the k-1 bases other than
position i) (lcb.rs:1-45), in closed form:

  shift_i = 2*(k-1-i);  cur_i = c_i << shift_i;  p_i = 1 << shift_i
  val_i   = kmer & (p_i - 1)
  mu_i    = p_i + (cur_i >> 2)*(k-1-i)  if c_i != 0 else val_i
  num_a_i = #{ j < i : c_j == 0 }
  bucket_i = sum(mu) - mu_i + val_i - num_a_i*cur_i + 1 + num_a_i

The host's form (`assign_buckets_np`, the index builder's) works in uint64
with wrap-around. The device's (`assign_buckets`) works in int64: two's
complement add, subtract and multiply give the bits of uint64 wrap-around,
so the result is the uint64 bucket id's bit pattern even at k=31, where
sum(mu) passes 2^63. Only the canonical k-mer (< 2^62) is ever shifted.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["assign_buckets", "assign_buckets_np", "filtered_bucket_positions"]


def assign_buckets_np(kmer: np.ndarray, k: int) -> np.ndarray:
    """All k bucket ids of (...,) uint64 canonical k-mers -> (..., k)
    uint64; bucket j is the wildcard at position j, counted from the
    leftmost (highest-bit) base."""
    kmer = np.asarray(kmer, dtype=np.uint64)[..., None]
    shifts = np.uint64(2) * np.arange(k - 1, -1, -1, dtype=np.uint64)
    one = np.uint64(1)
    bases = (kmer >> shifts) & np.uint64(3)
    cur = bases << shifts
    p = one << shifts
    val = kmer & (p - one)
    weights = np.arange(k - 1, -1, -1, dtype=np.uint64)
    mu = np.where(bases != 0, p + (cur >> np.uint64(2)) * weights, val)
    sum_mu = np.sum(mu, axis=-1, keepdims=True, dtype=np.uint64)
    is_a = (bases == 0).astype(np.uint64)
    num_a = np.cumsum(is_a, axis=-1, dtype=np.uint64) - is_a
    return sum_mu - mu + val - num_a * cur + one + num_a


def assign_buckets(kmer: torch.Tensor, k: int) -> torch.Tensor:
    """All k bucket ids of (...,) int64 canonical k-mers -> (..., k) int64.

    Bucket j is the wildcard at position j, counted from the leftmost
    (highest-bit) base."""
    dev = kmer.device
    kmer = kmer[..., None]
    shifts = 2 * torch.arange(k - 1, -1, -1, dtype=torch.int64, device=dev)
    bases = (kmer >> shifts) & 3
    cur = bases << shifts
    p = torch.ones_like(shifts) << shifts
    val = kmer & (p - 1)
    weights = torch.arange(k - 1, -1, -1, dtype=torch.int64, device=dev)
    mu = torch.where(bases != 0, p + (cur >> 2) * weights, val)
    sum_mu = mu.sum(dim=-1, keepdim=True)
    is_a = (bases == 0).to(torch.int64)
    num_a = torch.cumsum(is_a, dim=-1) - is_a  # exclusive prefix count of 'A'
    return sum_mu - mu + val - num_a * cur + 1 + num_a


def filtered_bucket_positions(k: int, n_fixed: int, use_full_kmer: bool) -> list[int]:
    """Wildcard positions kept by the mapper's end-trim (call.rs:1291-1300):
    positions n_fixed .. k - n_fixed - 2, i.e. n_fixed dropped at the front
    and n_fixed + 1 at the back (the reference's asymmetry, kept for output
    parity); [] when the trim would consume the whole k-mer."""
    if use_full_kmer:
        return list(range(k))
    if n_fixed * 2 + 1 >= k:
        return []
    return list(range(n_fixed, k - n_fixed - 1))
