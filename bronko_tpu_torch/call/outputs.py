"""Output writers: VCF, pileup TSV, overview TSV, multi-sample alignment.

Formats match the reference byte-for-byte where order is deterministic
(print_output call.rs:735-774, print_pileup call.rs:648-695, print_output_info
call.rs:698-732, build_alignment_fasta call.rs:560-628). Where the reference's
row order depends on hashmap iteration (multi-contig VCFs, .mfa sample rows)
we emit metadata/input order instead — a deterministic superset of the same
content.
"""

from __future__ import annotations

import os

from bronko_tpu_torch.consts import BRONKO_TPU_VERSION
from bronko_tpu_torch.call.variants import CallStats, VCFRecord
from bronko_tpu_torch.index.model import FileMeta
from bronko_tpu_torch.io.naming import clean_sample_id

_BITS_TO_CHAR = "ACGT"


def _fmt(x: float, prec: int) -> str:
    if x != x:  # NaN formats as "NaN" in Rust
        return "NaN"
    return f"{x:.{prec}f}"


def write_vcf(
    out_dir: str,
    reads_path: str,
    variants: list[VCFRecord],
    file_meta: FileMeta,
) -> str:
    path = os.path.join(out_dir, clean_sample_id(reads_path) + ".vcf")
    with open(path, "w") as fh:
        fh.write("##fileformat=VCFv4.5\n")
        fh.write(f"##source=bronko-v{BRONKO_TPU_VERSION}\n")
        # quirk kept from call.rs:755 — records the reads file
        fh.write(f"##reference=file://{reads_path}\n")
        for s in file_meta.sequences:
            contig = s.name.split()[0] if s.name.split() else ""
            fh.write(f"##contig=<ID={contig},length={s.length}>\n")
        fh.write('##INFO=<ID=DP,Number=1,Type=Integer,Description="Total Depth">\n')
        fh.write('##INFO=<ID=AF,Number=1,Type=Float,Description="Allele Frequency">\n')
        fh.write('##INFO=<ID=DP4,Number=4,Type=Integer,Description="Fwd_ref,Rev_ref,Fwd_alt,Rev_alt">\n')
        fh.write('##INFO=<ID=SOR,Number=4,Type=Float,Description="SOR">\n')
        fh.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        for v in variants:
            seq_out = v.seq.split()[0] if v.seq.split() else ""
            fh.write(
                f"{seq_out}\t{v.pos}\t.\t{_BITS_TO_CHAR[v.ref_base]}\t"
                f"{_BITS_TO_CHAR[v.alt_base]}\t.\tPASS\t"
                f"DP={v.depth};AF={_fmt(v.af, 3)};"
                f"DP4={v.fwd_ref},{v.rev_ref},{v.fwd_alt},{v.rev_alt};"
                f"SOR={_fmt(v.sor, 3)}\n"
            )
    return path


def write_pileup(
    out_dir: str,
    reads_path: str,
    file_meta: FileMeta,
    seq_pileups: dict[str, tuple],  # name -> (fwd_depth, rev_depth) (L,4) arrays
) -> str:
    import numpy as np

    path = os.path.join(out_dir, clean_sample_id(reads_path) + ".tsv")
    with open(path, "w") as fh:
        fh.write("reference\tindex\tref\tA\tC\tG\tT\ta\tc\tg\tt\n")
        for s in file_meta.sequences:
            if s.length == 0:
                continue  # the reference's per-position loop writes
                          # nothing for empty records (call.rs:676)
            fwd, rev = seq_pileups[s.name]
            # vectorized row build (a per-position f-string loop measured
            # seconds per Mb on the call worker): one bytes-join per column
            cols = [
                np.char.array([s.name]).repeat(s.length),
                (np.arange(1, s.length + 1)).astype("U"),
                np.frombuffer(s.seq, np.uint8).view("S1").astype("U1"),
            ] + [np.asarray(fwd[:, b]).astype("U") for b in range(4)] \
              + [np.asarray(rev[:, b]).astype("U") for b in range(4)]
            rows = cols[0]
            for col in cols[1:]:
                rows = np.char.add(np.char.add(rows, "\t"), col)
            fh.write("\n".join(rows.tolist()))
            fh.write("\n")
    return path


class SampleSummary:
    def __init__(self, filename: str, selected_genome: str, stats: CallStats,
                 n_perfect: int, n_variant: int, n_unmapped: int):
        self.filename = filename
        self.selected_genome = selected_genome
        self.stats = stats
        self.n_perfect = n_perfect
        self.n_variant = n_variant
        self.n_unmapped = n_unmapped


def write_overview(out_dir: str, summaries: list[SampleSummary]) -> str:
    path = os.path.join(out_dir, "bronko_overview.tsv")
    with open(path, "w") as fh:
        fh.write(
            "filename\tselected_genome\tnum_major_variants\tnum_minor_variants\t"
            "breadth_coverage\tdepth_coverage\tnum_perfect_kmers\t"
            "num_variant_kmers\tnum_unmapped_kmers\n"
        )
        for s in summaries:
            fh.write(
                f"{s.filename}\t{s.selected_genome}\t{s.stats.num_major}\t"
                f"{s.stats.num_minor}\t{_fmt(s.stats.breadth, 4)}\t"
                f"{_fmt(s.stats.depth, 4)}\t{s.n_perfect}\t{s.n_variant}\t"
                f"{s.n_unmapped}\n"
            )
    return path


def write_alignments(
    out_dir: str,
    summaries: list[SampleSummary],
    variant_info: list[tuple[str, list[VCFRecord]]],
    files: list[FileMeta],
    log=None,
) -> list[str]:
    """Multi-sample major-variant alignment (.mfa) per genome
    (call.rs:504-628): samples with breadth >= 0.90 grouped by selected
    genome; groups of >= 3 emit ref row + per-sample rows over the union of
    major-variant positions."""
    variant_map = dict(variant_info)
    genome_map: dict[str, list[tuple[str, list[VCFRecord]]]] = {}
    for s in summaries:
        if s.stats.breadth < 0.90:
            if log:
                log.info("Skipping %s (breadth of coverage = %s)", s.filename, s.stats.breadth)
            continue
        if s.filename in variant_map:
            genome_map.setdefault(s.selected_genome, []).append(
                (s.filename, variant_map[s.filename])
            )

    written = []
    for genome_name, samples in genome_map.items():
        if len(samples) < 3:
            if log:
                log.info("Skipping %s (only %d samples)", genome_name, len(samples))
            continue
        file_meta = next((f for f in files if f.name == genome_name), None)
        if file_meta is None:
            continue

        all_positions: dict[tuple[str, int], int] = {}
        sample_positions: dict[str, dict[tuple[str, int], int]] = {}
        for sample, records in samples:
            smap: dict[tuple[str, int], int] = {}
            sample_positions[sample] = smap
            for v in records:
                if v.af >= 0.5:
                    all_positions[(v.seq, v.pos)] = v.ref_base
                    smap[(v.seq, v.pos)] = v.alt_base
        positions = sorted(all_positions.keys())

        path = os.path.join(out_dir, f"{file_meta.name}.mfa")
        with open(path, "w") as fh:
            fh.write(f">{file_meta.name}\n")
            fh.write("".join(_BITS_TO_CHAR[all_positions[p]] for p in positions) + "\n")
            for sample, smap in sample_positions.items():
                row = "".join(
                    _BITS_TO_CHAR[smap.get(p, all_positions[p])] for p in positions
                )
                fh.write(f">{clean_sample_id(sample)}\n{row}\n")
        written.append(path)
    return written
