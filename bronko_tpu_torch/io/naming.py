"""File-type checks and sample-id derivation (reference: src/util.rs:4-50)."""

from __future__ import annotations

import os

_FASTQ_SUFFIXES = (".fq", ".fastq", ".fq.gz", "fastq.gz", "fnq", "fnq.gz")
_FASTA_SUFFIXES = (".fa", ".fasta", ".fa.gz", "fasta.gz", "fna", "fna.gz")

# Ordered longest-first, exactly as util.rs:36 (note some entries lack the dot).
_SAMPLE_SUFFIXES = (
    ".fastq.gz", ".fasta.gz", "fna.gz", "fnq.gz", ".fq.gz",
    ".fastq", ".fasta", ".fnq", ".fna", ".fa", ".fq",
)


def check_fastq(path: str) -> bool:
    return path.endswith(_FASTQ_SUFFIXES)


def check_fasta(path: str) -> bool:
    return path.endswith(_FASTA_SUFFIXES)


def clean_sample_id(path: str) -> str:
    """Strip known read-file suffixes from a basename (util.rs:30-50).

    Mirrors Rust's trim_end_matches, which strips the suffix *repeatedly*.
    """
    filename = os.path.basename(path) or "unknown"
    for suffix in _SAMPLE_SUFFIXES:
        if filename.endswith(suffix):
            while filename.endswith(suffix):
                filename = filename[: -len(suffix)]
            return filename
    stem, _ = os.path.splitext(filename)
    return stem or "unknown"


def file_stem(path: str) -> str:
    """Rust Path::file_stem semantics: strip only the final extension
    (so 'x.fasta.gz' -> 'x.fasta'), used for genome display names
    (build.rs:161-165)."""
    base = os.path.basename(path)
    stem, ext = os.path.splitext(base)
    return stem if stem else base
