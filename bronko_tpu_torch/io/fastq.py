"""FASTQ reading: host-side chunked parser feeding the device counter.

Parses gzip or plain FASTQ into padded (R, L) base-code matrices
(0..3 = ACGT upper/lower, 4 = anything else) entirely with NumPy — the
per-read Python loop is replaced by one flat scatter. A C++ reader can
slot in behind the same iterator interface later; this path already
sustains hundreds of MB/s of parsed bases per core.
"""

from __future__ import annotations

import gzip
from collections.abc import Iterator

import numpy as np

from bronko_tpu_torch.ops.codec import NT_IS_VALID, NT_TO_BITS

# ACGT/acgt -> 0..3, everything else (incl. N, pad) -> 4; derived from the
# codec's golden-anchored tables so the two byte maps cannot drift
CODES = np.where(NT_IS_VALID, NT_TO_BITS, np.uint8(4)).astype(np.uint8)


def _open(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rb")
    return open(path, "rb")


def _encode_reads(seqs: list[bytes], pad_to_multiple: int = 8):
    """Pack a list of read sequences into a padded (R, L) code matrix."""
    n = len(seqs)
    lengths = np.fromiter((len(s) for s in seqs), dtype=np.int32, count=n)
    lmax = int(lengths.max()) if n else 0
    lmax = max(lmax, 1)
    if pad_to_multiple > 1:
        lmax = -(-lmax // pad_to_multiple) * pad_to_multiple
    arr = np.full((n, lmax), 4, dtype=np.uint8)
    flat = np.frombuffer(b"".join(seqs), dtype=np.uint8)
    rows = np.repeat(np.arange(n, dtype=np.int64), lengths)
    starts = np.concatenate([[0], np.cumsum(lengths[:-1], dtype=np.int64)])
    cols = np.arange(flat.shape[0], dtype=np.int64) - np.repeat(starts, lengths)
    arr[rows, cols] = CODES[flat]
    return arr, lengths


def read_fastq_chunks(
    path: str, chunk_reads: int = 262_144
) -> Iterator[tuple[np.ndarray, np.ndarray, int]]:
    """Yield (codes, lengths, n_reads) chunks from a FASTQ file.

    Reads records as 4-line groups (the common, KMC-compatible layout).
    The '@'/'+' record markers are validated: a wrapped sequence, missing
    quality line, or stray blank line would otherwise silently
    desynchronize the 4-line state machine and corrupt every subsequent
    record (the native C++ reader raises on the same inputs).
    """
    seqs: list[bytes] = []
    with _open(path) as fh:
        state = 0  # 0: header, 1: seq, 2: plus, 3: qual
        for lineno, raw in enumerate(fh, 1):
            if state == 0 and not raw.startswith(b"@"):
                raise ValueError(
                    f"malformed FASTQ: {path}:{lineno}: header must start with '@'")
            if state == 2 and not raw.startswith(b"+"):
                raise ValueError(
                    f"malformed FASTQ: {path}:{lineno}: separator must start with '+'")
            if state == 1:
                seqs.append(raw.rstrip(b"\r\n"))
                if len(seqs) >= chunk_reads:
                    codes, lengths = _encode_reads(seqs)
                    yield codes, lengths, len(seqs)
                    seqs = []
            state = (state + 1) & 3
    if seqs:
        codes, lengths = _encode_reads(seqs)
        yield codes, lengths, len(seqs)
