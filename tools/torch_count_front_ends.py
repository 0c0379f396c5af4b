"""Time the port's host counter on one gzip FASTQ mate through its front ends.

    python tools/torch_count_front_ends.py [--pairs N] [--genome-len L] [--rounds R]
        [--threads T] [--seed S] [--out DIR] [--parent DIR] [--parallel-gz 0|1] [--bgzf]

Writes one mate of N reads of 150 bp, drawn from a random genome of L bp
with 0.3% substitutions and gzip level 1 (the benchmark's traffic:
portbench/gen.py), or BGZF blocks of 60,000 bytes with --bgzf, into DIR
(default: a temporary directory), then times in turns, R rounds, with
BRONKO_PARALLEL_GZ set to --parallel-gz (0, the default, as the
lone-sample traffic sets it; 1 opens the parallel inflater's gate):

  whole:  `native_read_inflate` then the count of its text on T threads,
          the whole-buffer front end;
  piped:  the count from the path with BRONKO_WHOLEBUF_MAX=0, so the
          pipelined front end (one reader inflating, T-1 threads parsing)
          whatever the gate would pick;
  parent: with --parent, the `whole` flow of another checkout's native
          library (DIR holds its `bronko_tpu_torch/`).

Each count's k-mers, counts and stats must equal the first's. Prints
whether libdeflate loads on this host (the whole buffer's serial inflate
and its BGZF inflate use it when it does, zlib otherwise), the host's
CPU count, each round with the parallel inflates it ran and, last, one
JSON line of the medians. Runs on the CPU; no card.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import statistics
import struct
import sys
import tempfile
import time
import zlib

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def bgzf_block(data: bytes) -> bytes:
    """One BGZF member (a gzip member with the 'BC' block-size subfield)."""
    co = zlib.compressobj(1, zlib.DEFLATED, -15)
    cdata = co.compress(data) + co.flush()
    hdr = struct.pack("<4BI2BH2B2H", 0x1F, 0x8B, 8, 4, 0, 0, 0xFF, 6, ord("B"), ord("C"), 2,
                      len(cdata) + 25)
    return hdr + cdata + struct.pack("<II", zlib.crc32(data), len(data) & 0xFFFFFFFF)


def write_mate(path: str, pairs: int, genome_len: int, seed: int, bgzf: bool) -> int:
    """One mate's gzip (or BGZF) FASTQ at `path`; returns its text's bytes."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, genome_len, dtype=np.uint8)
    rl = 150
    start = rng.integers(0, genome_len - rl + 1, pairs)
    codes = genome[start[:, None] + np.arange(rl)]
    flat = codes.reshape(-1)
    n_err = int(rng.binomial(flat.size, 0.003))
    at = rng.integers(0, flat.size, n_err)
    flat[at] = (flat[at] + rng.integers(1, 4, n_err)) % 4
    head = np.frombuffer(b"@r", np.uint8)
    ids = np.char.zfill(np.arange(pairs).astype(str), 7).astype("S7").view(np.uint8)
    rec = np.empty((pairs, 2 + 7 + 1 + rl + 3 + rl + 1), np.uint8)
    rec[:, :2] = head
    rec[:, 2:9] = ids.reshape(pairs, 7)
    rec[:, 9] = 10
    rec[:, 10:10 + rl] = np.frombuffer(b"ACGT", np.uint8)[codes]
    rec[:, 10 + rl:13 + rl] = np.frombuffer(b"\n+\n", np.uint8)
    rec[:, 13 + rl:13 + 2 * rl] = ord("I")
    rec[:, -1] = 10
    text = rec.tobytes()
    with open(path, "wb") as fh:
        if bgzf:
            for o in range(0, len(text), 60_000):
                fh.write(bgzf_block(text[o:o + 60_000]))
            fh.write(bgzf_block(b""))
        else:
            c = zlib.compressobj(1, zlib.DEFLATED, 31)
            fh.write(c.compress(text) + c.flush())
    return len(text)


def load_native(root: str, name: str):
    """The io/native.py module of the checkout at `root`, under `name`."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(root, "bronko_tpu_torch", "io", "native.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.get_lib() is not None, f"no native library in {root}"
    return mod


def libdeflate_loads() -> bool:
    for name in ("libdeflate.so.0", "libdeflate.so"):
        try:
            ctypes.CDLL(name)
            return True
        except OSError:
            pass
    return False


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=400_000)
    ap.add_argument("--genome-len", type=int, default=197_209)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--seed", type=int, default=3218000001)
    ap.add_argument("--out", default=None)
    ap.add_argument("--parent", default=None)
    ap.add_argument("--parallel-gz", choices=("0", "1"), default="0")
    ap.add_argument("--bgzf", action="store_true")
    args = ap.parse_args()
    os.environ["BRONKO_PARALLEL_GZ"] = args.parallel_gz
    os.environ.pop("BRONKO_WHOLEBUF_MAX", None)

    from bronko_tpu_torch.io import native

    flows = {"whole": native, "piped": native}
    if args.parent:
        flows["parent"] = load_native(os.path.abspath(args.parent), "parent_native")
    out = args.out or tempfile.mkdtemp()
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, "mate1.fastq.gz")
    text_bytes = write_mate(path, args.pairs, args.genome_len, args.seed, args.bgzf)
    lib = native.get_lib()
    lib.bronko_gz_parallel_runs.restype = ctypes.c_int64
    print(f"host: {os.cpu_count()} CPUs, libdeflate loads: {libdeflate_loads()}; "
          f"mate: {args.pairs} reads, {text_bytes} bytes of text, "
          f"{os.path.getsize(path)} of {'BGZF' if args.bgzf else 'gzip'}, "
          f"BRONKO_PARALLEL_GZ={args.parallel_gz}; the gate pipes it: {native.pipes(path)}",
          flush=True)

    times: dict[str, list[float]] = {f: [] for f in flows}
    parts: dict[str, list[dict]] = {f: [] for f in flows}
    first = None
    for r in range(args.rounds):
        for flow, mod in flows.items():
            seconds, counters = {}, {}
            runs0 = lib.bronko_gz_parallel_runs()
            if flow == "piped":
                os.environ["BRONKO_WHOLEBUF_MAX"] = "0"
            t0 = time.perf_counter()
            text = mod.native_read_inflate(path) if flow != "piped" else None
            got = mod.native_count_fastq(path, 21, 3, 1_000_000, threads=args.threads,
                                         text=text, seconds=seconds,
                                         **({"counters": counters} if flow != "parent" else {}))
            wall = time.perf_counter() - t0
            os.environ.pop("BRONKO_WHOLEBUF_MAX", None)
            counters["parallel_inflates"] = lib.bronko_gz_parallel_runs() - runs0
            if first is None:
                first = got
            assert np.array_equal(got[0], first[0]) and np.array_equal(got[1], first[1])
            assert got[2] == first[2], (got[2], first[2])
            times[flow].append(wall)
            parts[flow].append(seconds)
            print(f"round {r} {flow}: {wall:.4f} s {json.dumps(seconds)} {counters}", flush=True)
    result = {"host_cpus": os.cpu_count(), "libdeflate": libdeflate_loads(),
              "parallel_gz": args.parallel_gz, "bgzf": args.bgzf, "reads": args.pairs, "text_bytes": text_bytes, "stats": first[2]}
    for flow in flows:
        result[f"{flow}_s"] = statistics.median(times[flow])
        for key in ("inflate", "parse", "finalize"):
            vals = [p.get(key, 0.0) for p in parts[flow]]
            result[f"{flow}_{key}_s"] = statistics.median(vals)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
