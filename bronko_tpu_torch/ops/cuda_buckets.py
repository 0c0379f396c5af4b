"""Hopper kernels K1 (bucket queries) and K2 (fold table): wrappers and
their plain PyTorch versions.

Counterpart of `bronko_tpu/ops/pallas_buckets.py`. The kernels live in
`bronko_tpu_torch/csrc/bucket_kernels.cu`, built and loaded with the
port's other kernels by `ops/cuda_lib.py`.

Dispatch follows the input's device: a CPU tensor goes to the plain
version, a CUDA tensor to the kernel. Nothing falls back from one to the
other. Each wrapper adds one to `cuda_lib.LAUNCHES[name]`
(`cuda_lib.count_launch`) where it launches its kernel.
"""

from __future__ import annotations

import torch

from bronko_tpu_torch.ops.buckets import assign_buckets
from bronko_tpu_torch.ops.codec import canonical
from bronko_tpu_torch.ops.cuda_lib import (
    check_cuda, check_k, count_launch, library, raise_on, stream,
)

__all__ = ["bucket_queries", "bucket_queries_plain", "fold_table", "fold_table_plain"]


# --- K1: canonical form + filtered bucket queries ---------------------------

def bucket_queries_plain(kmers: torch.Tensor, k: int, positions: tuple[int, ...]):
    """(B,) int64 k-mers -> (q (B, J) int64, canon (B,) int64, is_rc (B,) bool):
    q[:, j] is the bucket id at wildcard position positions[j] of the
    canonical k-mer, as the uint64 bit pattern."""
    canon, is_rc = canonical(kmers, k)
    q = assign_buckets(canon, k)[:, list(positions)]
    return q, canon, is_rc


def bucket_queries(kmers: torch.Tensor, k: int, positions: tuple[int, ...]):
    """K1. Same result as bucket_queries_plain; launches the kernel for a
    CUDA tensor. `positions` must be strictly increasing (the kernel takes
    them as a bit mask and writes them in position order)."""
    if kmers.device.type == "cpu":
        return bucket_queries_plain(kmers, k, positions)
    check_cuda(kmers, torch.int64, "kmers")
    check_k(k)
    if any(not 0 <= p < k for p in positions) or list(positions) != sorted(set(positions)):
        raise ValueError(f"positions must be strictly increasing in [0, {k}): {positions}")
    B, J = kmers.shape[0], len(positions)
    q = torch.empty((B, J), dtype=torch.int64, device=kmers.device)
    canon = torch.empty_like(kmers)
    is_rc = torch.empty(B, dtype=torch.bool, device=kmers.device)
    if B:
        keep = sum(1 << p for p in positions)
        err = library().bronko_bucket_queries(
            kmers.device.index or 0, kmers.data_ptr(), B, k, keep, J,
            q.data_ptr(), canon.data_ptr(), is_rc.data_ptr(), stream(kmers))
        raise_on(err, "bucket_queries")
        count_launch("bucket_queries")
    return q, canon, is_rc


# --- K2: pass-2 fold table ---------------------------------------------------

def fold_table_plain(kmers: torch.Tensor, counts: torch.Tensor, k: int) -> torch.Tensor:
    """(B,) int64 k-mers + (B,) int32 counts -> (B*k,) int32 records, k-mer
    major: canonical base i (bits 0-1), complement of canonical base k-1-i
    (bits 2-3), is_rc (bit 4), count (bits 5 and up) — as
    bronko_tpu.ops.map._fold_table."""
    canon, is_rc = canonical(kmers, k)
    shifts = 2 * torch.arange(k - 1, -1, -1, dtype=torch.int64, device=kmers.device)
    bases = (canon[:, None] >> shifts) & 3
    mirror = 3 - bases.flip(1)
    rec = (bases | (mirror << 2) | (is_rc.to(torch.int64) << 4)[:, None]
           | (counts.to(torch.int64) << 5)[:, None])
    return rec.to(torch.int32).reshape(-1)


def fold_table(kmers: torch.Tensor, counts: torch.Tensor, k: int) -> torch.Tensor:
    """K2. Same result as fold_table_plain; launches the kernel for CUDA
    tensors."""
    if kmers.device.type == "cpu":
        return fold_table_plain(kmers, counts, k)
    check_cuda(kmers, torch.int64, "kmers")
    check_cuda(counts, torch.int32, "counts")
    check_k(k)
    if counts.shape != kmers.shape or counts.device != kmers.device:
        raise ValueError("kmers and counts must have the same shape and device")
    B = kmers.shape[0]
    out = torch.empty(B * k, dtype=torch.int32, device=kmers.device)
    if B:
        err = library().bronko_fold_table(
            kmers.device.index or 0, kmers.data_ptr(), counts.data_ptr(), B, k,
            out.data_ptr(), stream(kmers))
        raise_on(err, "fold_table")
        count_launch("fold_table")
    return out
