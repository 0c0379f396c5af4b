"""FASTQ (plain or gzip) to a padded matrix of 2-bit codes.

Every record's sequence line (line 1 of each four), A/C/G/T in either
case as 0..3, any other byte as 4 (a window over it is not counted);
positions past a read's end are 4 too.
"""

from __future__ import annotations

import zlib

import numpy as np

CODES = np.full(256, 4, np.uint8)
for _c, _v in zip(b"ACGT", range(4)):
    CODES[_c] = _v
    CODES[_c + 32] = _v


def read_codes(path: str) -> tuple[np.ndarray, np.ndarray]:
    """(codes (R, Lmax) uint8, lengths (R,) int64) of one FASTQ file."""
    with open(path, "rb") as fh:
        raw = fh.read()
    if raw[:2] == b"\x1f\x8b":
        d = zlib.decompressobj(47)
        parts = []
        while raw:
            parts.append(d.decompress(raw))
            raw = d.unused_data  # further gzip members
            if raw:
                d = zlib.decompressobj(47)
        raw = b"".join(parts)
    buf = np.frombuffer(raw, np.uint8)
    nl = np.flatnonzero(buf == 10)
    if buf.size and buf[-1] != 10:
        nl = np.append(nl, buf.size)
    n_lines = nl.size - nl.size % 4
    line_start = np.concatenate([[0], nl[:-1] + 1])[:n_lines]
    starts = line_start[1::4]
    ends = nl[:n_lines][1::4]
    if buf.size and np.any(buf[line_start[0::4]] != ord("@")):
        raise ValueError(f"{path}: a record does not start with '@'")
    lengths = (ends - starts).astype(np.int64)
    # a carriage return before the newline is not a base
    cr = (lengths > 0) & (buf[np.maximum(ends - 1, 0)] == 13)
    lengths -= cr
    width = int(lengths.max()) if lengths.size else 0
    cols = np.arange(width, dtype=np.int64)
    inside = cols[None, :] < lengths[:, None]
    at = np.where(inside, starts[:, None] + cols[None, :], 0)
    codes = np.where(inside, CODES[buf[at]], 4).astype(np.uint8)
    return codes, lengths
