"""Locality-collapsing bucket hash on int64 tensors.

Counterpart of `bronko_tpu/ops/buckets.py`: the same closed forms
(buckets.py:34-58, lcb.rs:1-45 semantics), evaluated in int64. Two's
complement add, subtract and multiply give the bits of uint64 wrap-around,
so the result is the uint64 bucket id's bit pattern even at k=31, where
sum(mu) passes 2^63. Only the canonical k-mer (< 2^62) is ever shifted.
"""

from __future__ import annotations

import torch

from bronko_tpu.ops.buckets import filtered_bucket_positions

__all__ = ["assign_buckets", "filtered_bucket_positions"]


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
