"""Command-line interface: `python -m bronko_tpu_torch build|call`.

Counterpart of `bronko_tpu/cli.py`, with a copy of its parser (the same
flags, defaults and error exits) and of its `build`. The device comes from
BRONKO_PLATFORM, as in the JAX package: `gpu` (the
default) runs on the current CUDA device and exits 1 when there is none;
`cpu` runs the kernels' plain PyTorch versions on the CPU.

Several processes, one a device, join through torch.distributed
(parallel/distributed.py): launched by torchrun (`python -m
torch.distributed.run --nproc-per-node N -m bronko_tpu_torch call ...`)
or given --coordinator host:port --num-processes N --process-id R each.
Each rank then runs on its own device; `--mesh DxG` shards one sample's
mapping over the D*G ranks, `--shard-samples` spreads the samples.
"""

from __future__ import annotations

import argparse
import logging
import sys
import time

import torch

from bronko_tpu_torch import consts
from bronko_tpu_torch.config import BuildConfig, CallConfig, _fatal, setup_logging
from bronko_tpu_torch.index.bincode_compat import save_reference_bkdb
from bronko_tpu_torch.index.build import build_index
from bronko_tpu_torch.index.store import load_index, save_index
from bronko_tpu_torch.parallel import distributed
from bronko_tpu_torch.parallel.distributed import init_distributed

log = logging.getLogger("bronko")


def _add_common(p: argparse.ArgumentParser) -> None:
    # clap propagates --version to subcommands (cli.rs:17 propagate_version)
    p.add_argument("-V", "--version", action="version",
                   version=f"bronko-tpu {consts.BRONKO_TPU_VERSION}")
    p.add_argument("-t", "--threads", type=int, default=4, help="Number of threads")
    p.add_argument("--debug", action="store_true", help="Debug output")
    p.add_argument("--verbose", action="store_true", help="Verbose output")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="bronko-tpu",
        description="TPU-native ultra-rapid mapping-free viral variant calling",
    )
    # clap's #[command(version)] surface (cli.rs:16)
    ap.add_argument("-V", "--version", action="version",
                    version=f"bronko-tpu {consts.BRONKO_TPU_VERSION}")
    sub = ap.add_subparsers(dest="mode", required=True)

    b = sub.add_parser("build", help="Create a bronko index of viral references")
    b.add_argument("-g", "--genomes", nargs="+", action="extend", default=[],
                   help="Genome files to be built into index (fasta/gzip)")
    b.add_argument("-k", "--kmer-size", dest="kmer", type=int,
                   default=consts.DEFAULT_KMER_SIZE, help="Kmer size")
    b.add_argument("-o", "--output", default=consts.DEFAULT_INDEX_OUTPUT,
                   help="Name of index file (.bkdb will be added)")
    b.add_argument("--format", dest="bkdb_format", choices=("npz", "bincode"),
                   default="npz",
                   help="Database format: npz (bronko-tpu native, "
                        "device-ready) or bincode (readable by the "
                        "reference bronko binary; bronko-tpu reads both)")
    _add_common(b)

    c = sub.add_parser("call", help="Perform rapid viral variant calling")
    c.add_argument("-g", "--genomes", nargs="+", action="extend", default=None,
                   help="Genome fasta(.gz) files to use as references")
    c.add_argument("-d", "--db", default=None, help="Use a prebuilt bronko db (.bkdb)")
    c.add_argument("-r", "--reads", nargs="+", action="extend", default=[],
                   help="Input single-end reads (fastq/gzip)")
    c.add_argument("-1", "--first-pairs", dest="first_pairs", nargs="+", action="extend", default=[],
                   help="First pairs for raw paired-end reads (fastq/gzip)")
    c.add_argument("-2", "--second-pairs", dest="second_pairs", nargs="+", action="extend", default=[],
                   help="Second pairs for raw paired-end reads (fastq/gzip)")
    c.add_argument("-k", "--kmer-size", dest="kmer", type=int,
                   default=consts.DEFAULT_KMER_SIZE, help="Kmer size used for analysis")
    c.add_argument("--min-kmers", type=int, default=consts.MIN_KMER_COUNT,
                   help="Minimum times a kmer must occur in sequencing data to be used")
    c.add_argument("--use-full-kmer", action="store_true",
                   default=consts.DEFAULT_USE_FULL_KMER,
                   help="Use the entire kmer length for variant positions")
    c.add_argument("--n-fixed", type=int, default=consts.DEFAULT_N_FIXED,
                   help="Number of fixed positions at each end of the kmer")
    c.add_argument("--min-af", type=float, default=consts.DEFAULT_MIN_AF,
                   help="Minimum minor allele frequency to be reported")
    c.add_argument("--no-end-filter", action="store_true",
                   default=consts.DEFAULT_NO_FILTER_ENDS,
                   help="Do not filter variants from the ends of each segment")
    c.add_argument("--no-strand-filter", action="store_true",
                   default=consts.DEFAULT_NO_STRAND_FILTER,
                   help="Do not use the SOR strand filter")
    c.add_argument("--no-strand-balance-filter", action="store_true",
                   default=consts.DEFAULT_NO_STRAND_BALANCE_FILTER,
                   help="Allow extremely strand-unbalanced variants past the SOR check")
    c.add_argument("--balance-ratio", dest="strand_balance_ratio", type=float,
                   default=consts.DEFAULT_STRAND_BALANCE_RATIO,
                   help="Max fraction of depth on one strand to call it unbalanced")
    c.add_argument("--n-per-strand", type=int, default=consts.DEFAULT_N_KMERS_PER_STRAND,
                   help="Min unique kmers per strand to call a variant")
    c.add_argument("--strand_odds", dest="strand_odds_max", type=float,
                   default=consts.DEFAULT_MAX_STRAND_ODDS,
                   help="Maximum strand odds ratio to pass strand filtering")
    c.add_argument("--min-depth", type=int, default=consts.DEFAULT_MIN_DEPTH,
                   help="Minimum total depth to call a minor variant")
    c.add_argument("--min-variant-depth", type=int, default=consts.MIN_KMER_COUNT,
                   help="Minimum depth of a minor variant to be called")
    c.add_argument("--noise-multiplier", dest="variant_multiplier", type=float,
                   default=consts.DEFAULT_NOISE_MULTIPLIER,
                   help="Required multiple above estimated baseline noise")
    c.add_argument("-o", "--output", default=consts.DEFAULT_OUT_FOLDER,
                   help="Folder to output all resulting files")
    c.add_argument("--pileup", dest="output_pileup", action="store_true",
                   default=consts.DEFAULT_TSV_PILEUP,
                   help="Also output a tsv of the approximate pileup")
    c.add_argument("--alignment", dest="output_alignment", action="store_true",
                   default=consts.DEFAULT_ALIGNMENT,
                   help="Output a multifasta alignment of all samples")
    c.add_argument("--keep-kmer-info", dest="keep_kmer_counts", action="store_true",
                   default=consts.DEFAULT_KEEP_KMER_INFO,
                   help="Keep kmer count information")
    c.add_argument("--batch-size", type=int, default=1 << 18,
                   help="Device mapping batch size (k-mers)")
    c.add_argument("--chunk-reads", type=int, default=1 << 18,
                   help="Reads per device-counter chunk")
    c.add_argument("--counter", choices=("auto", "host", "device"), default="auto",
                   help="K-mer counter: host C++ hash, sort on the device, or auto")
    c.add_argument("--mesh", default=None,
                   help="Mesh 'DxG' of D*G ranks, one device each (data-parallel "
                        "x genome shards), e.g. 4x2")
    c.add_argument("--shard-samples", dest="shard_samples", action="store_true",
                   help="Cohorts over several ranks: partition samples across "
                        "them (each runs its share end-to-end on its device; "
                        "rank 0 writes overview/alignment). Exclusive "
                        "with --mesh; assumes a shared output filesystem")
    c.add_argument("--profile-dir", dest="profile_dir", default=None,
                   help="Write a torch.profiler trace of the run to this directory")
    c.add_argument("--device-build", dest="device_build", default="auto",
                   choices=("auto", "on", "off"),
                   help="Build the device index on-chip from genome codes "
                        "(auto: on for CUDA devices; off under --mesh)")
    c.add_argument("--coordinator", default=None,
                   help="torch.distributed rendezvous address host:port, "
                        "served by rank 0 (omit under torchrun, whose "
                        "environment names it)")
    c.add_argument("--num-processes", dest="num_processes", type=int, default=None,
                   help="Total rank count, one process a device")
    c.add_argument("--process-id", dest="process_id", type=int, default=None,
                   help="This process's rank")
    _add_common(c)
    return ap


def run_build(cfg: BuildConfig) -> None:
    cfg.validate()
    index = build_index(cfg.kmer, cfg.genomes)
    out = cfg.output + ".bkdb"
    log.info("Saving index to %s", out)
    if cfg.bkdb_format == "bincode":
        save_reference_bkdb(index, out)
    else:
        save_index(out, index)


def call_config(args) -> CallConfig:
    return CallConfig(**{f: getattr(args, f) for f in CallConfig.__dataclass_fields__
                         if hasattr(args, f)})


def builds_on_device(cfg: CallConfig, device: torch.device) -> bool:
    """--device-build: 'on' builds the device index on `device`, 'off' on
    the host; 'auto' on the device when it is a CUDA device, the rule of
    the JAX package, whose auto builds on every backend but the CPU, and
    never under --mesh, whose splitter consumes the host arrays
    (bronko_tpu/cli.py:165-172; config.py refuses 'on' with --mesh)."""
    if cfg.device_build == "auto":
        return device.type == "cuda" and cfg.mesh is None
    return cfg.device_build == "on"


def run_call_cmd(cfg: CallConfig, device: torch.device | None = None):
    """Validate, build the index (on the host, or from the genomes'
    sequences on `device`: index/device_build.py), map and call every
    sample on `device` (default: this rank's, distributed.rank_device()).
    Under --mesh the full layout stays on the host and each rank uploads
    its shard. Returns the engine's per-sample results; exits 2 when some
    samples failed."""
    from bronko_tpu_torch.call.engine import run_call
    from bronko_tpu_torch.index.device_build import (
        build_device_index_on_device, device_build,
    )
    from bronko_tpu_torch.index.layout import build_device_index

    cfg.validate()
    if device is None:
        device = distributed.rank_device()
    on_device = builds_on_device(cfg, device)
    try:
        if cfg.genomes:
            log.info("Creating bronko index from provided reference genomes")
            if on_device:
                index, dev = build_device_index_on_device(cfg.kmer, cfg.genomes, device)
            else:
                index = build_index(cfg.kmer, cfg.genomes)
        else:
            log.info("Reading in provided bronko index")
            index = load_index(cfg.db, expect_k=cfg.kmer)
            if on_device:
                dev = device_build(index, device)
    except Exception as e:  # noqa: BLE001 — corrupt/truncated .bkdb files
        # raise IndexError/struct.error/BadZipFile from the decoders; every
        # load failure gets the reference's clean error + exit 1
        log.error("%s | Unable to build/read index, exiting", e)
        raise SystemExit(1) from None
    if not on_device:
        dev = build_device_index(index, torch.device("cpu") if cfg.mesh else device)
    results = run_call(cfg, index, dev, device)
    if len(results) < len(cfg.reads) + len(cfg.first_pairs):
        raise SystemExit(2)  # partial failure: some samples were skipped
    return results


def main(argv: list[str] | None = None) -> int:
    print(f"bronko-tpu-torch v{consts.BRONKO_TPU_VERSION}")
    print("PyTorch/CUDA port of the bronko-tpu viral variant caller\n")
    t0 = time.time()
    args = build_parser().parse_args(argv)
    setup_logging(args.debug, args.verbose)
    if args.mode == "build":
        run_build(BuildConfig(
            genomes=args.genomes, kmer=args.kmer, output=args.output,
            threads=args.threads, debug=args.debug, verbose=args.verbose,
            bkdb_format=args.bkdb_format,
        ))
    else:
        flags = (args.coordinator, args.num_processes, args.process_id)
        if any(f is not None for f in flags) and any(f is None for f in flags):
            _fatal("--coordinator, --num-processes and --process-id must be given together")
        # before the device is resolved: a rank's device is its own
        started = init_distributed(*flags)
        try:
            run_call_cmd(call_config(args))
        finally:
            if started:
                distributed.shutdown()
    print(f"\nbronko-tpu-torch v{consts.BRONKO_TPU_VERSION} finished in "
          f"{time.time() - t0:.1f}s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
