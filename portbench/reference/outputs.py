"""bronko's VCF and overview rows as text, and its sample ids.

A frozen copy of the port's writers (bronko_tpu_torch/call/outputs.py and
io/naming.py; upstream print_output call.rs:735-774, print_output_info
call.rs:698-732, util.rs:30-50), returning text instead of writing it.
"""

from __future__ import annotations

import os

VERSION = "0.1.0"  # the program's version string in the VCF header
_BITS_TO_CHAR = "ACGT"
_SAMPLE_SUFFIXES = (
    ".fastq.gz", ".fasta.gz", "fna.gz", "fnq.gz", ".fq.gz",
    ".fastq", ".fasta", ".fnq", ".fna", ".fa", ".fq",
)
OVERVIEW_HEADER = (
    "filename\tselected_genome\tnum_major_variants\tnum_minor_variants\t"
    "breadth_coverage\tdepth_coverage\tnum_perfect_kmers\t"
    "num_variant_kmers\tnum_unmapped_kmers\n")


def fmt(x: float, prec: int) -> str:
    if x != x:
        return "NaN"
    return f"{x:.{prec}f}"


def clean_sample_id(path: str) -> str:
    """Known read-file suffixes stripped from the basename, repeatedly."""
    filename = os.path.basename(path) or "unknown"
    for suffix in _SAMPLE_SUFFIXES:
        if filename.endswith(suffix):
            while filename.endswith(suffix):
                filename = filename[: -len(suffix)]
            return filename
    stem, _ = os.path.splitext(filename)
    return stem or "unknown"


def vcf_text(reads_path: str, records, sequences: list[tuple[str, int]]) -> str:
    """The VCF of one sample; `sequences` are the selected genome's (name,
    length) records."""
    out = ["##fileformat=VCFv4.5\n", f"##source=bronko-v{VERSION}\n",
           f"##reference=file://{reads_path}\n"]
    for name, length in sequences:
        contig = name.split()[0] if name.split() else ""
        out.append(f"##contig=<ID={contig},length={length}>\n")
    out += ['##INFO=<ID=DP,Number=1,Type=Integer,Description="Total Depth">\n',
            '##INFO=<ID=AF,Number=1,Type=Float,Description="Allele Frequency">\n',
            '##INFO=<ID=DP4,Number=4,Type=Integer,Description="Fwd_ref,Rev_ref,Fwd_alt,Rev_alt">\n',
            '##INFO=<ID=SOR,Number=4,Type=Float,Description="SOR">\n',
            "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n"]
    for v in records:
        seq_out = v.seq.split()[0] if v.seq.split() else ""
        out.append(
            f"{seq_out}\t{v.pos}\t.\t{_BITS_TO_CHAR[v.ref_base]}\t"
            f"{_BITS_TO_CHAR[v.alt_base]}\t.\tPASS\t"
            f"DP={v.depth};AF={fmt(v.af, 3)};"
            f"DP4={v.fwd_ref},{v.rev_ref},{v.fwd_alt},{v.rev_alt};"
            f"SOR={fmt(v.sor, 3)}\n")
    return "".join(out)


def overview_fields(genome: str, stats, n_perfect: int, n_variant: int,
                    n_unmapped: int) -> tuple:
    """An overview row's fields after the filename, as written."""
    return (genome, str(stats.num_major), str(stats.num_minor), fmt(stats.breadth, 4),
            fmt(stats.depth, 4), str(n_perfect), str(n_variant), str(n_unmapped))


def overview_text(rows: list[tuple[str, tuple]]) -> str:
    """bronko_overview.tsv from (filename, overview_fields) rows."""
    return OVERVIEW_HEADER + "".join("\t".join((name, *f)) + "\n" for name, f in rows)
