"""The device k-mer counter (`call --counter device`): window pack, sort,
segment counts, then a merge of the chunks with the ci floor and cs cap.

Counterpart of `bronko_tpu/ops/count.py` (KMC `-b -ci -cs` semantics):

  reads (R, L) base codes --K3 pack--> (R, W) k-mer words + validity
  --drop invalid--> --sorted unique with counts--> (k-mer, count)

K3 (`pack_windows`) is the Hopper kernel of `csrc/count_kernels.cu`, in
place of the TPU's Pallas pack; its plain version is the XLA pack in
torch. The JAX counter marks invalid windows with an all-ones sentinel
and counts segments with a stable sort on a boundary key, because 64-bit
scatters were slow on the TPU. Here invalid windows are dropped before
the sort instead: the sentinel is -1 as an int64 and would sort first,
while every real word is below 2^62, so signed order is unsigned order.
`torch.unique(sorted=True, return_counts=True)` does the rest (a sort of
the keys alone, then run lengths), as XLA did outside the Pallas kernel.

Per-chunk counts stay on the counter's device (int32) and are merged
there at `finalize` in int64, capped after the sum, then floored; one
copy brings the sample's k-mers back to the host, sorted ascending as
the native counter's are.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from bronko_tpu_torch.consts import KMER_COUNT_CAP
from bronko_tpu_torch.ops.codec import to_u64
from bronko_tpu_torch.ops.cuda_lib import (
    check_cuda, check_k, count_launch, library, raise_on, stream,
)

__all__ = ["CountStats", "KmerCounter", "extract_and_count_chunk",
           "pack_windows", "pack_windows_plain"]

# windows one pack covers: a chunk with more is packed and sorted in row
# slices (a default chunk of 150 bp reads has 36.7M; one of 10 kbp reads
# on the Python parser 2.6e9, which would not fit a card)
MAX_WINDOWS = 1 << 26


@dataclass
class CountStats:
    total_reads: int = 0
    total_kmers: int = 0
    unique_kmers: int = 0
    unique_counted_kmers: int = 0


def pack_windows_plain(codes: torch.Tensor, lengths: torch.Tensor, k: int):
    """(R, L) uint8 codes (0..3 = ACGT, >= 4 invalid) + (R,) int32 lengths
    -> (R, W = L-k+1) int64 words, first base highest, and (R, W) bool
    validity: all k codes < 4 and col + k <= length. Every window's word
    packs `code & 3`, valid or not (bronko_tpu.ops.count._pack_windows_xla)."""
    R, L = codes.shape
    W = L - k + 1
    c64 = (codes & 3).to(torch.int64)
    acc = torch.zeros((R, W), dtype=torch.int64, device=codes.device)
    for t in range(k):
        acc.bitwise_left_shift_(2).bitwise_or_(c64[:, t:t + W])
    bad = (codes >= 4).to(torch.int32)
    badps = torch.cat([torch.zeros((R, 1), dtype=torch.int32, device=codes.device),
                       bad.cumsum(1, dtype=torch.int32)], 1)
    nbad = badps[:, k:] - badps[:, :W]
    in_read = torch.arange(W, dtype=torch.int32, device=codes.device)[None, :] + k \
        <= lengths[:, None]
    return acc, (nbad == 0) & in_read


def pack_windows(codes: torch.Tensor, lengths: torch.Tensor, k: int):
    """K3. Same result as pack_windows_plain; launches the kernel for CUDA
    tensors (contiguous (R, L) uint8 codes, (R,) int32 lengths)."""
    if codes.shape[-1] < k:
        raise ValueError(f"rows of {codes.shape[-1]} codes hold no {k}-mer window")
    if codes.device.type == "cpu":
        return pack_windows_plain(codes, lengths, k)
    check_cuda(codes, torch.uint8, "codes", dim=2)
    check_cuda(lengths, torch.int32, "lengths")
    check_k(k)
    R, L = codes.shape
    if lengths.shape[0] != R or lengths.device != codes.device:
        raise ValueError("lengths must hold one entry per row of codes, on its device")
    W = L - k + 1
    words = torch.empty((R, W), dtype=torch.int64, device=codes.device)
    valid = torch.empty((R, W), dtype=torch.bool, device=codes.device)
    if R:
        err = library().bronko_pack_windows(
            codes.device.index or 0, codes.data_ptr(), lengths.data_ptr(), R, L, k,
            words.data_ptr(), valid.data_ptr(), stream(codes))
        raise_on(err, "pack_windows")
        count_launch("pack_windows")
    return words, valid


def extract_and_count_chunk(codes: torch.Tensor, lengths: torch.Tensor, k: int):
    """Count the k-mers of one read chunk on its device. Returns (ascending
    unique int64 k-mers, their int32 counts, the number of valid windows)."""
    words, valid = pack_windows(codes, lengths, k)
    flat = words[valid]
    del words, valid
    kmers, counts = torch.unique(flat, sorted=True, return_counts=True)
    return kmers, counts.to(torch.int32), flat.numel()


class KmerCounter:
    """Sample-level counter: chunks are counted on `device` (no default:
    the caller names the card or the CPU) and merged at finalize (the ci
    floor needs sample-wide counts)."""

    def __init__(self, k: int, min_count: int, count_cap: int | None = None, *,
                 device: torch.device):
        self.k = k
        self.min_count = min_count
        self.count_cap = KMER_COUNT_CAP if count_cap is None else count_cap
        self.device = device
        self._chunks: list[tuple[torch.Tensor, torch.Tensor]] = []
        self.stats = CountStats()

    def add_chunk(self, codes: np.ndarray, lengths: np.ndarray, n_reads: int) -> None:
        """(R, L) uint8 codes and (R,) int32 lengths of n_reads reads (rows
        past n_reads have length 0) go to the device in one copy each."""
        self.stats.total_reads += n_reads
        if codes.shape[1] < self.k:
            return  # every read shorter than k: zero k-mers, like KMC
        codes_t = torch.from_numpy(np.ascontiguousarray(codes, np.uint8)).to(self.device)
        lengths_t = torch.from_numpy(np.ascontiguousarray(lengths, np.int32)).to(self.device)
        rows = max(1, MAX_WINDOWS // (codes.shape[1] - self.k + 1))
        for lo in range(0, codes_t.shape[0], rows):
            kmers, counts, n_total = extract_and_count_chunk(
                codes_t[lo:lo + rows], lengths_t[lo:lo + rows], self.k)
            self.stats.total_kmers += n_total
            self._chunks.append((kmers, counts))

    def finalize(self) -> tuple[np.ndarray, np.ndarray]:
        """Merge the chunks: sum the counts in int64, cap at count_cap, keep
        counts >= min_count; fill the unique-k-mer stats. Returns ascending
        uint64 k-mers and their int64 counts."""
        chunks, self._chunks = self._chunks, []
        kmers = torch.cat([c[0] for c in chunks]) if chunks else torch.empty(0, dtype=torch.int64)
        if kmers.numel() == 0:
            return np.empty(0, np.uint64), np.empty(0, np.int64)
        counts = torch.cat([c[1] for c in chunks]).to(torch.int64)
        if len(chunks) > 1:
            kmers, order = torch.sort(kmers)
            counts = counts[order]
        uniq, seg = torch.unique_consecutive(kmers, return_counts=True)
        ends = counts.cumsum(0)[seg.cumsum(0) - 1]
        sums = torch.diff(ends, prepend=ends.new_zeros(1)).clamp_max_(self.count_cap)
        keep = sums >= self.min_count
        self.stats.unique_kmers = int(uniq.numel())
        self.stats.unique_counted_kmers = int(keep.sum())
        return to_u64(uniq[keep]), sums[keep].cpu().numpy()
