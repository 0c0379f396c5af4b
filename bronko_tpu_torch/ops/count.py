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

A streamed lone sample counts each mate on the card from its FASTQ text
instead (call/device_count.py), in parts that end at a record's end
(`fastq_records_end`) where the text is large: the text pack
(`fastq_pack`, kernels of `csrc/count_kernels.cu`; its plain version
`fastq_pack_plain`) emits every window the native counter counts, each
part's windows are sorted into runs of (k-mer, count) (`reduce_words`),
and `merge_runs` (plain version `merge_runs_plain`) sums the runs of all
parts in int64, then caps, then floors, once, as `finalize` merges the
chunks; the kept k-mers and counts stay on the device. `count_words` is
that count of one whole text.
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

__all__ = ["CountStats", "KmerCounter", "count_words", "extract_and_count_chunk",
           "fastq_pack", "fastq_pack_plain", "fastq_records_end", "merge_runs",
           "merge_runs_plain", "pack_windows", "pack_windows_plain", "reduce_words"]

# text bytes a block of the text pack takes (kTextTile in csrc/count_kernels.cu)
TEXT_TILE = 8192
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
    kmers, counts = reduce_words(flat)
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
        if sum(c[0].numel() for c in chunks) == 0:
            return np.empty(0, np.uint64), np.empty(0, np.int64)
        kmers, sums, distinct = merge_runs(chunks, self.min_count, self.count_cap)
        self.stats.unique_kmers = distinct
        self.stats.unique_counted_kmers = int(kmers.numel())
        return to_u64(kmers), sums.cpu().numpy()


def _text_codes(text: torch.Tensor) -> torch.Tensor:
    """Each byte's base code: 0..3 for ACGT and acgt, 4 for any other."""
    code = torch.full(text.shape, 4, dtype=torch.int64, device=text.device)
    lower = text | 0x20
    for c, b in enumerate(b"acgt"):
        code[lower == b] = c
    return code


def fastq_pack_plain(text: torch.Tensor, k: int) -> tuple[torch.Tensor, int, bool]:
    """(S,) uint8 FASTQ text -> (the int64 word of every window the native
    counter counts, in text order; reads; whether the text is malformed).
    Record r is lines 4r..4r+3; it is kept when the newline ending line
    4r+2 exists, so N newlines keep (N + 1) // 4 reads; a window is k bytes
    of ACGTacgt in a kept record's line 4r+1, first base highest; a header
    that does not start with '@' makes the text malformed (the native
    counter's parse_count and count_seq)."""
    S = text.numel()
    if S == 0:
        return torch.empty(0, dtype=torch.int64, device=text.device), 0, False
    nl = text == 10
    n_lines = int(nl.sum())
    reads = (n_lines + 1) // 4
    line = torch.cumsum(nl, 0) - nl.to(torch.int64)  # the newlines before each byte
    after = torch.nonzero(nl[:-1] & ((line[:-1] + 1) % 4 == 0)).squeeze(1) + 1
    malformed = bool(text[0] != ord("@")) or bool((text[after] != ord("@")).any())
    W = S - k + 1
    if W <= 0:
        return torch.empty(0, dtype=torch.int64, device=text.device), reads, malformed
    code = _text_codes(text)
    n_bad = torch.cat([torch.zeros(1, dtype=torch.int64, device=text.device),
                       torch.cumsum(code >= 4, 0)])
    words = torch.zeros(W, dtype=torch.int64, device=text.device)
    for t in range(k):
        words.bitwise_left_shift_(2).bitwise_or_(code[t:t + W] & 3)
    start = line[:W]
    valid = (n_bad[k:] == n_bad[:W]) & (start % 4 == 1) & (start // 4 < reads)
    return words[valid], reads, malformed


def fastq_records_end(text: torch.Tensor) -> int:
    """The bytes of whole records at the start of `text` (uint8 FASTQ that
    starts at a record's start): up to and with its (4R)-th newline, the
    one ending record R's quality line, R its newlines // 4; 0 with fewer
    than four. What follows starts a record that goes on past the text."""
    nl = torch.nonzero(text == 10).squeeze(1)
    whole = nl.numel() // 4 * 4
    return int(nl[whole - 1]) + 1 if whole else 0


def _to_host_ints(t: torch.Tensor) -> list[int]:
    """A small int64 device vector on the host: a copy to page-locked
    memory behind an event, waited for (the only host sync it makes)."""
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(t.device))
    done.synchronize()
    return host.tolist()


def fastq_pack(text: torch.Tensor, k: int) -> tuple[torch.Tensor, int, bool]:
    """The text pack: fastq_pack_plain's result, from the kernels of
    csrc/count_kernels.cu for a contiguous CUDA uint8 text (the lines
    pass, the count pass, then the write pass into words sized by the
    count, which the host reads in one small copy)."""
    if text.device.type == "cpu":
        return fastq_pack_plain(text, k)
    check_cuda(text, torch.uint8, "text")
    check_k(k)
    S = text.numel()
    if S == 0:
        return torch.empty(0, dtype=torch.int64, device=text.device), 0, False
    lib, device, st = library(), text.device.index or 0, stream(text)
    tiles = -(-S // TEXT_TILE)
    nl = torch.empty(tiles, dtype=torch.int32, device=text.device)
    raise_on(lib.bronko_fastq_lines(device, text.data_ptr(), S, nl.data_ptr(), st),
             "fastq_lines")
    count_launch("fastq_lines")
    nl_incl = nl.cumsum(0, dtype=torch.int64)
    win = torch.empty(tiles, dtype=torch.int32, device=text.device)
    flag = torch.zeros(1, dtype=torch.int32, device=text.device)
    raise_on(lib.bronko_fastq_pack(device, text.data_ptr(), S, k, nl_incl.data_ptr(), None,
                                   win.data_ptr(), flag.data_ptr(), None, st), "fastq_pack")
    count_launch("fastq_pack")
    win_incl = win.cumsum(0, dtype=torch.int64)
    n_lines, n, malformed = _to_host_ints(
        torch.cat([nl_incl[-1:], win_incl[-1:], flag.to(torch.int64)]))
    words = torch.empty(n, dtype=torch.int64, device=text.device)
    if n:
        raise_on(lib.bronko_fastq_pack(device, text.data_ptr(), S, k, nl_incl.data_ptr(),
                                       win_incl.data_ptr(), None, None, words.data_ptr(), st),
                 "fastq_pack")
        count_launch("fastq_pack")
    return words, (n_lines + 1) // 4, bool(malformed)


def reduce_words(words: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Packed windows (a text's or a read chunk's) -> their runs: the
    ascending distinct int64 k-mers and their int64 counts (one sort with
    run lengths, torch.unique), each in storage of its own size (on a card
    torch.unique's outputs keep storage of the windows' size, which runs
    held until a merge would pile up)."""
    kmers, counts = torch.unique(words, sorted=True, return_counts=True)
    return kmers.clone(), counts.clone()


def merge_runs(runs: list[tuple[torch.Tensor, torch.Tensor]], min_count: int,
               count_cap: int = KMER_COUNT_CAP):
    """Merge the runs of one stream's parts (each ascending distinct
    k-mers and their counts) as KMC -ci -cs applies to the total: the
    counts of a k-mer summed over the parts in int64, then capped at
    count_cap, then kept where at least min_count. Returns (the kept
    ascending k-mers, their int64 counts, the distinct k-mers before the
    floor)."""
    if len(runs) == 1:
        kmers, sums = runs[0][0], runs[0][1].to(torch.int64).clamp_max(count_cap)
    else:
        kmers, order = torch.sort(torch.cat([r[0] for r in runs]))
        counts = torch.cat([r[1].to(torch.int64) for r in runs])[order]
        kmers, seg = torch.unique_consecutive(kmers, return_counts=True)
        ends = counts.cumsum(0)[seg.cumsum(0) - 1]
        sums = torch.diff(ends, prepend=ends.new_zeros(1)).clamp_max_(count_cap)
    keep = torch.nonzero(sums >= min_count).squeeze(1)
    return kmers[keep], sums[keep], kmers.numel()


def merge_runs_plain(runs: list[tuple[torch.Tensor, torch.Tensor]], min_count: int,
                     count_cap: int = KMER_COUNT_CAP):
    """merge_runs' result the plain way: every k-mer's counts added into
    its slot among the distinct k-mers (index_add_ in int64)."""
    kmers, slot = torch.unique(torch.cat([r[0] for r in runs]), sorted=True,
                               return_inverse=True)
    sums = torch.zeros(kmers.numel(), dtype=torch.int64, device=kmers.device)
    sums.index_add_(0, slot, torch.cat([r[1].to(torch.int64) for r in runs]))
    sums.clamp_max_(count_cap)
    keep = sums >= min_count
    return kmers[keep], sums[keep], kmers.numel()


def count_words(words: torch.Tensor, reads: int, min_count: int,
                count_cap: int = KMER_COUNT_CAP):
    """Count the packed windows of one FASTQ text on their device (KMC -b
    -ci -cs, as the native counter): its runs (reduce_words), the cap,
    then the floor (merge_runs). Returns (ascending int64 k-mers, their
    int32 counts), both on the device, and the CountStats of `reads`
    reads."""
    kmers, counts, distinct = merge_runs([reduce_words(words)], min_count, count_cap)
    return kmers, counts.to(torch.int32), CountStats(reads, words.numel(), distinct,
                                                     kmers.numel())
