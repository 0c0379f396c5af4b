"""Time variants of the port's kernels against each other on one CUDA card.

    python tools/torch_kernel_variants.py [--out DIR] [--parent DIR]

Each variant is a kernel source of `bronko_tpu_torch/csrc/` with text
substitutions (a block size, a vector width, a cache hint, a copy
mechanism), compiled by nvcc into a library of its own (all at once) and
loaded with ctypes beside the others. With --parent, the same source of
another checkout (DIR holds its `bronko_tpu_torch/csrc/`) joins as one
more variant, so an earlier design is timed in the same turns. Every variant is held against the plain PyTorch version
(exact) and timed as `chip_smoke.py` times a kernel: a run of 20 launches
per CUDA event pair, enqueued behind a spin on the card, median of 5 runs;
the variants (and torch's own gathers, for K4) take turns over three
rounds, and each prints the median of its rounds. Kernels: K4 gather,
K1 bucket queries, K3 pack windows (row tile, cp.async or a TMA bulk
copy, 4- or 16-byte validity stores), K2 fold table (block size). Needs a card and nvcc;
exits non-zero without them.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from bronko_tpu_torch.ops import count, cuda_buckets, cuda_lib  # noqa: E402
from bronko_tpu_torch.ops.buckets import filtered_bucket_positions  # noqa: E402

CSRC = os.path.join(REPO, "bronko_tpu_torch", "csrc")
HOLD_CYCLES = 20_000_000
ROUNDS = 3
P, I32, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64  # ctypes argument types

GATHER = ("gather_kernel.cu", {
    "kVec=2 (committed)": [],
    "kVec=1": [("constexpr int kVec = 2;", "constexpr int kVec = 1;")],
    "kVec=4": [("constexpr int kVec = 2;", "constexpr int kVec = 4;")],
    "kVec=8, 128 threads": [("constexpr int kVec = 2;", "constexpr int kVec = 8;"),
                            ("constexpr int kThreads = 256;", "constexpr int kThreads = 128;")],
    "kVec=2, streaming hints": [("iv[v] :", "__ldcs(iv + v) :"),
                                ("ov[v] = res[j];", "__stcs(ov + v, res[j]);")],
})
BUCKETS = ("bucket_kernels.cu", {
    "kRows=128 (committed)": [],
    "kRows=64": [("constexpr int kRows = 128;", "constexpr int kRows = 64;")],
})
PACK = ("count_kernels.cu", {
    "RT=32, TMA bulk copy, 16-byte validity (committed)": [],
    "RT=16": [("constexpr int kTileRows = 32;", "constexpr int kTileRows = 16;")],
    "RT=64": [("constexpr int kTileRows = 32;", "constexpr int kTileRows = 64;")],
    "RT=128": [("constexpr int kTileRows = 32;", "constexpr int kTileRows = 128;")],
    "cp.async": [("constexpr bool kBulkCopy = true;", "constexpr bool kBulkCopy = false;")],
    "cp.async, RT=64": [("constexpr bool kBulkCopy = true;", "constexpr bool kBulkCopy = false;"),
                        ("constexpr int kTileRows = 32;", "constexpr int kTileRows = 64;")],
    "4-byte validity": [("constexpr int kValidBytes = 16;", "constexpr int kValidBytes = 4;")],
})
FOLD = ("bucket_kernels.cu", {
    "kFoldRows=128 (committed)": [],
    "kFoldRows=64": [("constexpr int kFoldRows = 128;", "constexpr int kFoldRows = 64;")],
    "kFoldRows=256": [("constexpr int kFoldRows = 128;", "constexpr int kFoldRows = 256;")],
})


def build(out: str, tag: str, source: str, variants: dict, parent: str | None = None) -> dict:
    """Compile every variant of `source` at once (and the parent's copy of
    it, given a checkout); returns name -> CDLL."""
    text = open(os.path.join(CSRC, source)).read()
    texts = {}
    for name, subs in variants.items():
        src = text
        for old, new in subs:
            if old not in src:
                raise SystemExit(f"{source}: {old!r} not found for variant {name!r}")
            src = src.replace(old, new)
        texts[name] = src
    if parent:
        with open(os.path.join(parent, "bronko_tpu_torch", "csrc", source)) as fh:
            texts[f"parent ({parent})"] = fh.read()
    procs = {}
    for i, (name, src) in enumerate(texts.items()):
        path = os.path.join(out, f"{tag}_{i}.cu")
        with open(path, "w") as fh:
            fh.write(src)
        procs[name] = (path[:-3] + ".so", subprocess.Popen(
            [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-shared", "-o", path[:-3] + ".so", path],
            stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        err = proc.communicate()[1]
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name!r}:\n{err}")
        libs[name] = ctypes.CDLL(so)
    return libs


def timed_ms(fn) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(HOLD_CYCLES)
        start.record()
        for _ in range(20):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 20)
    return statistics.median(times)


def in_turns(calls: dict, label: str, smi: str) -> None:
    times = {name: [] for name in calls}
    for r in range(ROUNDS):
        for name in (list(calls) if r % 2 == 0 else list(calls)[::-1]):
            times[name].append(timed_ms(calls[name]))
    for name, t in times.items():
        print(f"{label} {name}: {statistics.median(t):.4f} ms "
              f"(rounds {', '.join(f'{x:.4f}' for x in t)}; {smi})", flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=os.path.join(CSRC, "build", "variants"),
                        help="directory for the variants' sources and libraries")
    parser.add_argument("--parent", default=None,
                        help="a checkout whose K3 and K2 sources join as a variant")
    parser.add_argument("--kernels", default="gather,bucket_queries,pack_windows,fold_table",
                        help="comma-separated kernels to time (default: all four)")
    args = parser.parse_args()
    only = set(args.kernels.split(","))
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    os.makedirs(args.out, exist_ok=True)
    dev = torch.device("cuda", 0)
    st = torch.cuda.current_stream(dev).cuda_stream
    rng = np.random.default_rng(2024)

    if "gather" in only:
        time_gather(args, dev, st, rng, smi)
    if "bucket_queries" in only:
        time_bucket_queries(args, dev, st, rng, smi)
    if "pack_windows" in only:
        time_pack_windows(args, dev, st, rng, smi)
    if "fold_table" in only:
        time_fold_table(args, dev, st, rng, smi)
    return 0



def time_gather(args, dev, st, rng, smi) -> None:
    """K4 at the gather probe's shapes, beside torch's two gathers."""
    U, N = 1 << 20, 1 << 21
    tbl = torch.from_numpy(rng.integers(0, 1 << 30, size=U, dtype=np.int32)).to(dev)
    idx = torch.from_numpy(rng.integers(0, U, size=N, dtype=np.int32)).to(dev)
    want = tbl[idx.long()]
    calls = {}
    for name, lib in build(args.out, "gather", *GATHER).items():
        fn = lib.bronko_gather
        fn.restype, fn.argtypes = I32, [I32, P, I64, P, I64, P, P]
        out = torch.empty_like(idx)
        call = (lambda fn=fn, out=out:
                fn(0, tbl.data_ptr(), U, idx.data_ptr(), N, out.data_ptr(), st))
        if call() != 0 or not torch.equal(out, want):
            raise SystemExit(f"gather variant {name!r} failed or differs")
        calls[name] = call
    idx64 = idx.long()
    calls["torch tbl[idx64]"] = lambda: tbl[idx64]
    calls["torch.index_select"] = lambda: torch.index_select(tbl, 0, idx)
    in_turns(calls, f"[gather U={U} N={N}]", smi)


def time_bucket_queries(args, dev, st, rng, smi) -> None:
    """K1 at the bench's k-mer batch and at the main path's."""
    libs = build(args.out, "buckets", *BUCKETS)
    for k, B in ((21, 1_000_003), (21, 152_679), (31, 1_000_003)):
        kmers = torch.from_numpy(rng.integers(0, 1 << (2 * k), size=B, dtype=np.uint64)
                                 .view(np.int64)).to(dev)
        positions = tuple(filtered_bucket_positions(k, 2, False))
        keep, J = sum(1 << i for i in positions), len(positions)
        want = cuda_buckets.bucket_queries_plain(kmers, k, positions)
        calls = {}
        for name, lib in libs.items():
            fn = lib.bronko_bucket_queries
            fn.restype = I32
            fn.argtypes = [I32, P, I64, I32, ctypes.c_uint32, I32, P, P, P, P]
            q = torch.empty((B, J), dtype=torch.int64, device=dev)
            canon, is_rc = torch.empty_like(kmers), torch.empty(B, dtype=torch.bool, device=dev)
            call = (lambda fn=fn, q=q, canon=canon, is_rc=is_rc:
                    fn(0, kmers.data_ptr(), B, k, keep, J, q.data_ptr(), canon.data_ptr(),
                       is_rc.data_ptr(), st))
            if call() != 0 or not all(torch.equal(a, b) for a, b in zip((q, canon, is_rc), want)):
                raise SystemExit(f"bucket_queries variant {name!r} failed or differs")
            calls[name] = call
        in_turns(calls, f"[bucket_queries k={k} B={B}]", smi)


def time_pack_windows(args, dev, st, rng, smi) -> None:
    """K3 at the device counter's chunks, on rows long enough for column
    tiles, and on 64 rows (launch and one or two blocks: the floor)."""
    libs = build(args.out, "pack", *PACK, parent=args.parent)
    for R, L, k in ((262_144, 160, 21), (262_144, 160, 15), (262_144, 160, 31),
                    (37_852, 160, 21), (4_096, 4_099, 21), (64, 160, 21)):
        codes = rng.integers(0, 4, size=(R, L), dtype=np.uint8)
        bad = rng.random((R, L), dtype=np.float32) < 0.02
        codes[bad] = rng.integers(4, 6, size=int(bad.sum()), dtype=np.uint8)
        codes = torch.from_numpy(codes).to(dev)
        lengths = torch.from_numpy(rng.integers(100, L + 1, size=R, dtype=np.int32)).to(dev)
        want = count.pack_windows_plain(codes, lengths, k)
        calls = {}
        for name, lib in libs.items():
            fn = lib.bronko_pack_windows
            fn.restype, fn.argtypes = I32, [I32, P, P, I64, I64, I32, P, P, P]
            words = torch.empty((R, L - k + 1), dtype=torch.int64, device=dev)
            valid = torch.empty((R, L - k + 1), dtype=torch.bool, device=dev)
            call = (lambda fn=fn, words=words, valid=valid:
                    fn(0, codes.data_ptr(), lengths.data_ptr(), R, L, k, words.data_ptr(),
                       valid.data_ptr(), st))
            if call() != 0 or not (torch.equal(words, want[0]) and torch.equal(valid, want[1])):
                raise SystemExit(f"pack_windows variant {name!r} failed or differs")
            calls[name] = call
        in_turns(calls, f"[pack_windows k={k} R={R} L={L}]", smi)


def time_fold_table(args, dev, st, rng, smi) -> None:
    """K2 at the bench's batch, the main path's, and one block of 128
    k-mers (launch and one block: the floor)."""
    libs = build(args.out, "fold", *FOLD, parent=args.parent)
    for k, B in ((21, 1_000_003), (21, 152_679), (15, 1_000_003), (31, 1_000_003), (21, 128)):
        kmers = torch.from_numpy(rng.integers(0, 1 << (2 * k), size=B, dtype=np.uint64)
                                 .view(np.int64)).to(dev)
        counts = torch.from_numpy(rng.integers(0, 1_000_000, size=B, dtype=np.int32)).to(dev)
        want = cuda_buckets.fold_table_plain(kmers, counts, k)
        calls = {}
        for name, lib in libs.items():
            fn = lib.bronko_fold_table
            fn.restype, fn.argtypes = I32, [I32, P, P, I64, I32, P, P]
            out = torch.empty(B * k, dtype=torch.int32, device=dev)
            call = (lambda fn=fn, out=out:
                    fn(0, kmers.data_ptr(), counts.data_ptr(), B, k, out.data_ptr(), st))
            if call() != 0 or not torch.equal(out, want):
                raise SystemExit(f"fold_table variant {name!r} failed or differs")
            calls[name] = call
        in_turns(calls, f"[fold_table k={k} B={B}]", smi)


if __name__ == "__main__":
    raise SystemExit(main())
