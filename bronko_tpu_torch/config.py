"""Run configuration dataclasses + validation.

Flag surface, defaults, and fatal-vs-warn semantics mirror the reference CLI
(cli.rs:29-166, call.rs:30-136, build.rs:62-100) so a bronko user can switch
without relearning anything.
"""

from __future__ import annotations

import logging
import sys
from dataclasses import dataclass, field

from bronko_tpu_torch import consts
from bronko_tpu_torch.io.naming import check_fasta, check_fastq

log = logging.getLogger("bronko")


class ConfigError(SystemExit):
    pass


def _fatal(msg: str) -> None:
    log.error(msg)
    raise ConfigError(1)


def _check_k(k: int) -> None:
    if k % 2 != 1 or k > consts.MAX_KMER_SIZE or k < consts.MIN_KMER_SIZE:
        _fatal(
            f"Invalid kmer size, must be odd and between "
            f"[{consts.MIN_KMER_SIZE}-{consts.MAX_KMER_SIZE}]"
        )


def _check_threads(threads: int) -> None:
    """Shared by build (build.rs:95-98) and call (call.rs:80-83)."""
    if threads <= 0:
        _fatal("Number of threads must be greater than 0")
    import os as _os

    available = _os.cpu_count() or 1
    if threads > available:
        _fatal(
            f"You requested {threads} threads but only have "
            f"{available} available on your system"
        )


@dataclass
class BuildConfig:
    genomes: list[str]
    kmer: int = consts.DEFAULT_KMER_SIZE
    output: str = consts.DEFAULT_INDEX_OUTPUT
    threads: int = 4
    debug: bool = False
    verbose: bool = False
    bkdb_format: str = "npz"  # 'bincode' = reference-binary-readable

    def validate(self) -> None:
        _check_k(self.kmer)
        if not self.genomes:
            # the reference shows help and exits for a bare `bronko build`
            # (cli.rs:30 arg_required_else_help); an empty index written
            # with exit 0 would be a silent footgun
            _fatal("No genome files provided (use -g)")
        for f in self.genomes:
            if not check_fasta(f):
                _fatal(
                    f"{f} does not appear to be a fasta file "
                    f"(must be .fa(.gz)/.fasta(.gz)/.fna(.gz))"
                )
        _check_threads(self.threads)  # build.rs:95-98


@dataclass
class CallConfig:
    genomes: list[str] | None = None
    db: str | None = None
    reads: list[str] = field(default_factory=list)
    first_pairs: list[str] = field(default_factory=list)
    second_pairs: list[str] = field(default_factory=list)
    kmer: int = consts.DEFAULT_KMER_SIZE
    min_kmers: int = consts.MIN_KMER_COUNT
    use_full_kmer: bool = consts.DEFAULT_USE_FULL_KMER
    n_fixed: int = consts.DEFAULT_N_FIXED
    min_af: float = consts.DEFAULT_MIN_AF
    no_end_filter: bool = consts.DEFAULT_NO_FILTER_ENDS
    no_strand_filter: bool = consts.DEFAULT_NO_STRAND_FILTER
    no_strand_balance_filter: bool = consts.DEFAULT_NO_STRAND_BALANCE_FILTER
    strand_balance_ratio: float = consts.DEFAULT_STRAND_BALANCE_RATIO
    n_per_strand: int = consts.DEFAULT_N_KMERS_PER_STRAND
    strand_odds_max: float = consts.DEFAULT_MAX_STRAND_ODDS
    min_depth: int = consts.DEFAULT_MIN_DEPTH
    min_variant_depth: int = consts.MIN_KMER_COUNT
    variant_multiplier: float = consts.DEFAULT_NOISE_MULTIPLIER
    output: str = consts.DEFAULT_OUT_FOLDER
    output_pileup: bool = consts.DEFAULT_TSV_PILEUP
    output_alignment: bool = consts.DEFAULT_ALIGNMENT
    keep_kmer_counts: bool = consts.DEFAULT_KEEP_KMER_INFO
    threads: int = 4
    debug: bool = False
    verbose: bool = False
    # TPU-specific knobs (no reference equivalent)
    batch_size: int = 1 << 18
    chunk_reads: int = 1 << 18
    counter: str = "auto"  # 'auto' | 'host' (C++ hash) | 'device' (TPU sort)
    mesh: str | None = None  # 'DxG' device mesh, e.g. '4x2' = 4-way data
    #  parallel x 2-way genome index sharding for the WHOLE mapping
    #  pipeline (tally pass 1 + pileup pass 2); None = 1 device
    profile_dir: str | None = None  # write a jax.profiler trace here
    device_build: str = "auto"  # 'auto'|'on'|'off': derive the device index
    #  on-chip from ~1MB of genome codes instead of uploading the host-built
    #  arrays (auto = on for TPU backends; forced off under --mesh, whose
    #  splitter needs the host arrays)
    shard_samples: bool = False  # multi-host cohort mode: PARTITION samples
    #  round-robin across processes (each runs the single-host pipeline on
    #  its share and writes its own VCF/pileup; summaries gather to every
    #  process and rank 0 writes overview/alignment). Higher cohort
    #  throughput than SPMD-within-sample: zero per-sample collectives.
    #  Assumes a shared output filesystem; exclusive with --mesh.

    def validate(self) -> None:  # mirrors call.rs:30-136
        _check_k(self.kmer)
        for f in self.reads:
            if not check_fastq(f):
                _fatal(
                    f"{f} does not appear to be a fastq file "
                    f"(must be .fq(.gz)/.fastq(.gz)/.fnq(.gz))"
                )
        if self.genomes and self.db:
            _fatal("Please provide either a db or the genomes you would like to index, not both.")
        if not self.genomes and not self.db:
            _fatal("Please provide either a db or the genomes you would like to index.")
        if self.genomes:
            for f in self.genomes:
                if not check_fasta(f):
                    _fatal(
                        f"{f} does not appear to be a fasta file "
                        f"(must be .fa(.gz)/.fasta(.gz)/.fna(.gz))"
                    )
        _check_threads(self.threads)  # call.rs:80-83
        if self.min_af < 0.01:
            log.warning(
                "Minimum allele frequency set below 0.01, more false positive variants "
                "will be returned. We suggest setting this to a more realistic threshold (0.01-0.05)"
            )
        elif self.min_af > 1.0:
            _fatal("Minimum allele frequency set above 1, please set between 0-1 (recommended between 0.01-0.05)")
        elif self.min_af >= 0.5:
            log.warning("Minimum allele frequency set equal to or greater than 0.5, no minor variants will be returned")
        if self.n_per_strand <= 0:
            log.warning("Number of kmers per strand set to 0, this is equivalent to no strand filtering")
        elif self.n_per_strand >= self.kmer:
            _fatal("Number of kmers per strand set >= k, please set lower value (recommended 2-4, default 2)")
        elif self.n_per_strand >= 5:
            log.warning("Number of kmers per strand set very high, only strongly supported variants will be returned")
        if self.strand_balance_ratio < 0.0:
            _fatal("Strand balance ratio is set to below 0, must be between 0.0 and 1.0")
        elif self.strand_balance_ratio > 1.0:
            _fatal("Strand balance ratio is set above 1, must be between 0.0 and 1.0")
        elif self.strand_balance_ratio == 1.0:
            log.warning("Strand balance ratio is set to 1, all variants will pass this filter")
        if self.min_variant_depth < 0:  # call.rs:114-116
            log.warning(
                "Minimum variant depth set below 0, all variants will be returned "
                "if passing other thresholds"
            )
        if self.min_depth < 0:  # call.rs:118-120
            log.warning(
                "Minimum total depth for minor variant calling set below 0, all "
                "variants will be returned if passing other thresholds"
            )
        if self.variant_multiplier < 1.0:
            _fatal(
                "Noise multiplier for variant detection is set to below 1.0, must be "
                "greater than 1.0 (recommended between 1.3-2.0)"
            )
        elif self.variant_multiplier > 2.0:
            # reference text says "Strand balance ratio" here — a wording slip
            # in call.rs:126 replicated verbatim for log parity
            log.warning("Strand balance ratio is set above 2, may experience a drop in recall (we recommend ~1.5)")
        elif self.variant_multiplier == 1.0:  # call.rs:127-128
            log.warning("Noise multiplier for variant detection set to 1.0, all variants will pass this filter")
        if len(self.first_pairs) != len(self.second_pairs):
            _fatal("Number of paired end sequences do not match, exiting.")
        if self.counter not in ("auto", "host", "device"):
            _fatal(f"Unknown counter '{self.counter}' (must be auto|host|device)")
        if self.device_build not in ("auto", "on", "off"):
            _fatal(f"Unknown device-build mode '{self.device_build}' (must be auto|on|off)")
        if self.mesh is not None:
            parts = self.mesh.split("x")
            if len(parts) != 2 or not all(p.isdigit() and int(p) > 0 for p in parts):
                _fatal(f"Invalid mesh '{self.mesh}' (expected DxG, e.g. 4x2)")
            if self.shard_samples:
                _fatal("--shard-samples partitions whole samples per process "
                       "and cannot combine with --mesh (which spans every "
                       "process's devices within one sample)")
            if self.device_build == "on":
                _fatal("--device-build on cannot combine with --mesh "
                       "(the mesh splitter consumes the host-built arrays); "
                       "use --device-build auto or off")


def setup_logging(debug: bool, verbose: bool) -> None:
    level = logging.DEBUG if (debug or verbose) else logging.INFO
    logging.basicConfig(
        level=level,
        format="%(asctime)s %(levelname)s [%(name)s] %(message)s",
        datefmt="%Y-%m-%dT%H:%M:%S",
        stream=sys.stderr,
        force=True,
    )
