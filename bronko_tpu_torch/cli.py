"""Command-line interface: `python -m bronko_tpu_torch build|call`.

Counterpart of `bronko_tpu/cli.py`, with the same parser and `build`. The
device comes from BRONKO_PLATFORM, as in the JAX package: `gpu` (the
default) runs on the current CUDA device and exits 1 when there is none;
`cpu` runs the kernels' plain PyTorch versions on the CPU. Flags outside
this port's slice exit 1 and point to ROADMAP.md.
"""

from __future__ import annotations

import logging
import os
import sys
import time

import torch

from bronko_tpu import consts
from bronko_tpu.cli import build_parser, run_build
from bronko_tpu.config import BuildConfig, CallConfig, setup_logging

log = logging.getLogger("bronko")


def _refuse(what: str) -> None:
    log.error("%s is not supported by bronko_tpu_torch yet (see ROADMAP.md)", what)
    raise SystemExit(1)


def resolve_device() -> torch.device:
    """The device BRONKO_PLATFORM names: gpu (default) or cpu."""
    platform = os.environ.get("BRONKO_PLATFORM", "").strip().lower() or "gpu"
    if platform == "cpu":
        return torch.device("cpu")
    if platform != "gpu":
        _refuse(f"BRONKO_PLATFORM={platform} (use gpu or cpu)")
    if not torch.cuda.is_available():
        log.error("BRONKO_PLATFORM=gpu but no CUDA device is available; set "
                  "BRONKO_PLATFORM=cpu to run the plain PyTorch versions on the CPU")
        raise SystemExit(1)
    return torch.device("cuda", torch.cuda.current_device())


def call_config(args) -> CallConfig:
    return CallConfig(**{f: getattr(args, f) for f in CallConfig.__dataclass_fields__
                         if hasattr(args, f)})


def run_call_cmd(cfg: CallConfig, device: torch.device | None = None):
    """Validate, build the index on the host, map and call every sample on
    `device` (default: resolve_device()). Returns the engine's per-sample
    results; exits 2 when some samples failed."""
    from bronko_tpu.index.build import build_index
    from bronko_tpu.index.store import load_index
    from bronko_tpu_torch.call.engine import run_call
    from bronko_tpu_torch.index.layout import build_device_index

    cfg.validate()
    if cfg.mesh is not None:
        _refuse("--mesh")
    if cfg.shard_samples:
        _refuse("--shard-samples")
    if cfg.device_build == "on":
        _refuse("--device-build on")
    if cfg.profile_dir:
        _refuse("--profile-dir")
    if device is None:
        device = resolve_device()
    try:
        if cfg.genomes:
            log.info("Creating bronko index from provided reference genomes")
            index = build_index(cfg.kmer, cfg.genomes)
        else:
            log.info("Reading in provided bronko index")
            index = load_index(cfg.db, expect_k=cfg.kmer)
    except Exception as e:  # noqa: BLE001 — corrupt/truncated .bkdb files
        # raise IndexError/struct.error/BadZipFile from the decoders; every
        # load failure gets the reference's clean error + exit 1
        log.error("%s | Unable to build/read index, exiting", e)
        raise SystemExit(1) from None
    dev = build_device_index(index, device)
    results = run_call(cfg, index, dev)
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
        if any(getattr(args, f) is not None
               for f in ("coordinator", "num_processes", "process_id")):
            _refuse("--coordinator/--num-processes/--process-id")
        run_call_cmd(call_config(args))
    print(f"\nbronko-tpu-torch v{consts.BRONKO_TPU_VERSION} finished in "
          f"{time.time() - t0:.1f}s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
