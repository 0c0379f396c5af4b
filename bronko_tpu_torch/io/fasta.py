"""FASTA parsing (plain or gzip), host-side.

Produces raw sequence bytes; the index keeps them verbatim (the reference
stores raw bytes in SeqMeta.seq, build.rs:185-189, so lowercase/N survive
into pileup/VCF output paths)."""

from __future__ import annotations

import gzip
from dataclasses import dataclass


@dataclass
class FastaRecord:
    name: str  # first whitespace token of the header (build.rs:178-182)
    seq: bytes


def _open(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rb")
    return open(path, "rb")


def read_fasta(path: str) -> list[FastaRecord]:
    records: list[FastaRecord] = []
    name: str | None = None
    chunks: list[bytes] = []
    with _open(path) as fh:
        for line in fh:
            line = line.rstrip(b"\r\n")
            if line.startswith(b">"):
                if name is not None:
                    records.append(FastaRecord(name, b"".join(chunks)))
                header = line[1:].decode("utf-8", errors="replace")
                name = header.split()[0] if header.split() else ""
                chunks = []
            elif line:
                chunks.append(line)
    if name is not None:
        records.append(FastaRecord(name, b"".join(chunks)))
    return records
