"""Time variants of the port's kernels against each other on one CUDA card.

    python tools/torch_kernel_variants.py [--out DIR] [--parent DIR] [--kernels K,...]

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
copy, 4- or 16-byte validity stores), K2 fold table (block size), and
(b) probe_tally (a k-mer's hits by shuffles or by shared-memory adds) and
(c) walk_scatter at s0's batch on the bench fixture's index
(chip_smoke.py's fixture, drawn into .smoke_cache/ when missing, ~140 s);
beside (c), its floor: a kernel with the same posting reads, record reads
and two reductions a lane on addresses computed beforehand, and no walk
logic. For (b) and (c) it prints ptxas's registers and what the two
pileup updates compile to (cuobjdump -sass: RED, not ATOM). Needs a card
and nvcc; exits non-zero without them.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from bronko_tpu_torch.call import engine  # noqa: E402
from bronko_tpu_torch.index.build import build_index  # noqa: E402
from bronko_tpu_torch.index.layout import build_device_index  # noqa: E402
from bronko_tpu_torch.ops import count, cuda_buckets, cuda_lib, cuda_map  # noqa: E402
from bronko_tpu_torch.ops.buckets import filtered_bucket_positions  # noqa: E402

CSRC = os.path.join(REPO, "bronko_tpu_torch", "csrc")
HOLD_CYCLES = 20_000_000
ROUNDS = 3
HBM = 3.35e12  # H100 SXM device memory, bytes a second (NVIDIA's data sheet)
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
MAP = ("map_kernels.cu", {
    "committed": [],
    "(b) sums a k-mer's hits by shared-memory adds only": [
        ("if (J > 0 && 32 % J == 0) {", "if (false) {")],
    "(c) the warp shares every posting, none walked by its own row's lane": [
        ("constexpr bool kOwnFirst = true;", "constexpr bool kOwnFirst = false;")],
})
# The floor of kernel (c): walk_scatter's posting read, record read and two
# pileup reductions a lane, on each lane's posting and record base
# computed beforehand (by the plain walk), with no walk logic.
WALK_FLOOR = r"""
#include <cstdint>
#include <cuda_runtime.h>
template <typename Post>
__global__ void __launch_bounds__(256)
    walk_floor_kernel(const int32_t* __restrict__ pc, int k, const int32_t* __restrict__ at,
                      const int32_t* __restrict__ rec, const Post* __restrict__ postings,
                      int64_t file_base, int64_t n, int32_t* __restrict__ pileup,
                      int64_t row_len) {
  const int64_t l = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= n) return;
  const Post p = postings[at[l]];
  int64_t pos;
  uint32_t meta;
  if constexpr (sizeof(Post) == 4) {
    pos = (int64_t)(p >> 6);
    meta = (uint32_t)p & 63u;
  } else {
    pos = (int64_t)(p >> 22) - file_base;
    meta = (uint32_t)((uint64_t)p & 0x3FFFFFu);
  }
  const uint32_t idx = meta & 31u;
  if (idx >= (uint32_t)k) return;
  const bool is_canon = (meta >> 5) & 1u;
  const int32_t v = pc[rec[l] + idx];
  const int64_t base = is_canon ? (v >> 2) & 3 : v & 3;
  const bool fwd = is_canon == (bool)((v >> 4) & 1);
  const int64_t cell = pos * 4 + base;
  if (cell < 0 || cell >= row_len) return;
  atomicMax(&pileup[(fwd ? 0 : 1) * row_len + cell], v >> 5);
  atomicAdd(&pileup[(fwd ? 2 : 3) * row_len + cell], 1);
}
extern "C" int bronko_walk_floor(int device, const int32_t* pc, int k, const int32_t* at,
                                 const int32_t* rec, const void* postings, int post_bytes,
                                 int64_t file_base, int64_t n, int32_t* pileup,
                                 int64_t row_len, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    const unsigned blocks = (unsigned)((n + 255) / 256);
    if (post_bytes == 8) {
      walk_floor_kernel<int64_t><<<blocks, 256, 0, stream>>>(
          pc, k, at, rec, static_cast<const int64_t*>(postings), file_base, n, pileup, row_len);
    } else {
      walk_floor_kernel<int32_t><<<blocks, 256, 0, stream>>>(
          pc, k, at, rec, static_cast<const int32_t*>(postings), file_base, n, pileup, row_len);
    }
  }
  return (int)cudaGetLastError();
}
"""
FOLD = ("bucket_kernels.cu", {
    "kFoldRows=128 (committed)": [],
    "kFoldRows=64": [("constexpr int kFoldRows = 128;", "constexpr int kFoldRows = 64;")],
    "kFoldRows=256": [("constexpr int kFoldRows = 128;", "constexpr int kFoldRows = 256;")],
})


PTXAS = {}  # variant name -> nvcc's report (-Xptxas -v)


def compile_sources(out: str, tag: str, texts: dict) -> dict:
    """Compile each source text (name -> text) into a library of its own,
    all at once; returns name -> (CDLL, path of the library)."""
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
        PTXAS[name] = proc.communicate()[1]
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name!r}:\n{PTXAS[name]}")
        libs[name] = (ctypes.CDLL(so), so)
    return libs


def build(out: str, tag: str, source: str, variants: dict, parent: str | None = None,
          paths: dict | None = None) -> dict:
    """Compile every variant of `source` at once (and the parent's copy of
    it, given a checkout); returns name -> CDLL (and fills `paths`, name
    -> library path, when given)."""
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
    built = compile_sources(out, tag, texts)
    if paths is not None:
        paths.update({name: so for name, (_, so) in built.items()})
    return {name: lib for name, (lib, _) in built.items()}


def make_walk_floor(out: str):
    """Build the floor of kernel (c) (WALK_FLOOR); returns floor(pileup,
    pc, k, at, rec, postings, file_base): each lane l reads posting at[l]
    and K2's record rec[l] + idx and updates the pileup, as walk_scatter
    does. Exact: the same pileup as the walk over the same lanes."""
    os.makedirs(out, exist_ok=True)
    lib, _ = compile_sources(out, "walk_floor", {"walk floor": WALK_FLOOR})["walk floor"]
    fn = lib.bronko_walk_floor
    fn.restype, fn.argtypes = I32, [I32, P, I32, P, P, P, I32, I64, I64, P, I64, P]

    def floor(pileup, pc, k, at, rec, postings, file_base=0):
        err = fn(pileup.device.index or 0, pc.data_ptr(), k, at.data_ptr(), rec.data_ptr(),
                 postings.data_ptr(), postings.element_size(), file_base, at.shape[0],
                 pileup.data_ptr(), pileup.shape[1] * 4,
                 torch.cuda.current_stream(pileup.device).cuda_stream)
        if err:
            raise RuntimeError(f"walk floor: CUDA error {err}")
        return pileup
    return floor


def saved_ranges(start, h, best: int):
    """The saved probe's rows for genome `best` as (start, lens), both (B, J)
    int32: the offset past the bytes of the genomes below, and its byte."""
    hb = cuda_map._hist_bytes(h)
    return (start + hb[..., :best].sum(dim=-1, dtype=torch.int32),
            hb[..., best].to(torch.int32))


def walk_addresses(start, lens, k: int):
    """The walk of rows (start, lens) computed beforehand, as the floor
    takes it: (at, rec) (n_lanes,) int32, each lane's posting and its
    k-mer's first K2 record (the plain walk, cuda_map._walk)."""
    J = start.shape[1]
    lensf = lens.reshape(-1)
    own, at = cuda_map._walk(start.reshape(-1), lensf, int(lensf.sum()))
    return at.to(torch.int32), ((own.long() // J) * k).to(torch.int32)


def sass_updates(so: str) -> dict:
    """Per kernel of (b), (c) and the floor in library `so`: how many
    reductions whose result is not read (RED, REDG), global or generic
    atomics (ATOM, ATOMG) and shared ones (ATOMS) its SASS holds
    (cuobjdump -sass)."""
    cuobjdump = os.path.join(os.path.dirname(cuda_lib._nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", so], capture_output=True, text=True,
                          check=True).stdout
    kinds = {"RED": "RED", "REDG": "RED", "ATOM": "ATOM", "ATOMG": "ATOM", "ATOMS": "ATOMS"}
    out = {}
    for part in text.split("Function : ")[1:]:
        name = part.split("\n", 1)[0].strip()
        kernel = next((n for n in ("probe_tally_kernel", "walk_scatter_kernel",
                                   "walk_floor_kernel") if n in name), None)
        if kernel is None:
            continue
        found = dict.fromkeys(("RED", "ATOM", "ATOMS"), 0)
        for ln in part.splitlines():
            code = ln.strip()
            if not (code.startswith("/*") and "*/" in code and ";" in code):
                continue
            words = code.split("*/", 1)[1].split()
            words = words[1:] if words and words[0].startswith("@") else words
            if words and words[0].split(".")[0] in kinds:
                found[kinds[words[0].split(".")[0]]] += 1
        out[name] = found
    return out


def ptxas_lines(report: str, names=("probe_tally_kernel", "walk_scatter_kernel",
                                    "walk_floor_kernel")) -> list[str]:
    """ptxas's register and shared-memory line of each kernel named."""
    lines, current = [], None
    for ln in report.splitlines():
        if "Compiling entry function" in ln:
            current = next((n for n in names if n in ln), None)
            entry = ln.split("'")[1] if "'" in ln else ln
        elif current and "Used" in ln and "registers" in ln:
            lines.append(f"{current} ({entry[:48]}...): {ln.split(':', 1)[1].strip()}")
            current = None
    return lines


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
                        help="a checkout whose K3, K2, (b) and (c) sources join as a variant")
    parser.add_argument("--kernels",
                        default="gather,bucket_queries,pack_windows,fold_table,map",
                        help="comma-separated kernels to time: gather, bucket_queries, "
                             "pack_windows, fold_table, map ((b) and (c)); default all")
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
    if "map" in only:
        time_map_kernels(args, dev, st, smi)
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


def _fixture_batch(out: str, dev):
    """s0's batch on the bench fixture's index, as chip_smoke.py's main path
    gets it (its fixture, drawn into .smoke_cache/ when missing): returns
    (the DeviceIndex on `dev`, kmers, counts)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    genome_paths, fastqs, _ = smoke.make_fixture()
    index = build_index(smoke.REPORT_K, genome_paths)
    cfg = smoke.call_args(genome_paths, fastqs[0], os.path.join(out, "call"), "host")
    counted = engine._count_job([fastqs[0]], cfg, index.k, dev, upload=True)
    kmers, counts = counted.batches[0]
    return build_device_index(index, dev), kmers, counts


def long_rows(di, pc, n_kmers: int = 16_384):
    """Kernel (c)'s case of long rows at s0's K2 records `pc`: the first
    n_kmers k-mers' rows by (start, lens), a quarter of them 255 postings
    long and the rest empty. Returns (pc of those k-mers, start, lens)."""
    rng = np.random.default_rng(2024 + 13)
    P = di.pass2_postings().shape[0]
    J = len(filtered_bucket_positions(di.k, 2, False))
    lens = np.where(rng.random((n_kmers, J)) < 0.25, 255, 0).astype(np.int32)
    start = rng.integers(0, P - 255, size=(n_kmers, J)).astype(np.int32)
    return (pc[:n_kmers * di.k], torch.from_numpy(start).to(pc.device),
            torch.from_numpy(lens).to(pc.device))


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def time_map_kernels(args, dev, st, smi) -> None:
    """(b) probe_tally and (c) walk_scatter at s0's batch on the bench
    fixture's index, every variant (and the parent's kernels) held exactly
    against the plain version, beside torch.searchsorted alone for (b)
    and the floor for (c); the byte bounds as chip_smoke.py counts them."""
    paths = {}
    libs = build(args.out, "map", *MAP, parent=args.parent, paths=paths)
    parent_has_directory = args.parent is not None and "def probe_directory" in open(
        os.path.join(args.parent, "bronko_tpu_torch", "ops", "cuda_map.py")).read()
    for name in libs:
        for line in ptxas_lines(PTXAS[name]):
            print(f"[ptxas {name}] {line}", flush=True)
        for fn, ops in sass_updates(paths[name]).items():
            print(f"[sass {name}] {fn}: {ops}", flush=True)
    floor = make_walk_floor(args.out)
    for line in ptxas_lines(PTXAS["walk floor"]):
        print(f"[ptxas walk floor] {line}", flush=True)
    di, kmers, counts = _fixture_batch(args.out, dev)
    k = di.k
    q, _, _ = cuda_buckets.bucket_queries(kmers, k, tuple(filtered_bucket_positions(k, 2, False)))
    directory = di.probe_dir()
    B, J = q.shape
    U = di.keys.shape[0]
    hist8 = torch.from_numpy(np.random.default_rng(2024 + 11).integers(
        0, 1 << 63, size=U, dtype=np.int64) | np.int64(-(1 << 63))).to(dev)
    saved = None
    for label, hist in ((f"G={di.num_genomes} {str(di.hist.dtype)[6:]} words", di.hist),
                        ("G=8 int64 words, bit 63 set", hist8)):
        G = di.num_genomes if hist is di.hist else 8
        want_t = torch.zeros((G, 3), dtype=torch.int32, device=dev)
        want = cuda_map.probe_tally_plain(q, counts, di.keys_ordered, directory, di.offsets,
                                          hist, want_t)
        start = torch.empty((B, J), dtype=torch.int32, device=dev)
        h = torch.empty((B, J), dtype=hist.dtype, device=dev)
        tallies = torch.zeros((G, 3), dtype=torch.int32, device=dev)
        lanes = torch.zeros(G, dtype=torch.int64, device=dev)
        ptrs = (q.data_ptr(), counts.data_ptr(), B, J, di.keys_ordered.data_ptr(), U)
        tail = (di.offsets.data_ptr(), hist.data_ptr(), hist.element_size(), G,
                start.data_ptr(), h.data_ptr(), tallies.data_ptr(), lanes.data_ptr(), st)
        calls = {}
        for name, lib in libs.items():
            fn = lib.bronko_probe_tally
            fn.restype = I32
            if name.startswith("parent") and not parent_has_directory:
                # a checkout from before the slot directory searches all U keys
                fn.argtypes = [I32, P, P, I64, I32, P, I64, P, P, I32, I32, P, P, P, P, P]
                call_args = (0, *ptrs, *tail)
            else:
                fn.argtypes = [I32, P, P, I64, I32, P, I64, P, I64, I64, I32, P, P, I32, I32,
                               P, P, P, P, P]
                call_args = (0, *ptrs, directory.table.data_ptr(), directory.lo,
                             cuda_map._as_int64(directory.span), directory.shift, *tail)
            tallies.zero_()
            lanes.zero_()
            call = lambda fn=fn, a=call_args: fn(*a)  # noqa: E731
            if call() != 0 or not all(torch.equal(a, b) for a, b in
                                      zip((start, h, lanes, tallies), (*want, want_t))):
                raise SystemExit(f"probe_tally variant {name!r} failed or differs at {label}")
            calls[name] = call
        qs = q ^ cuda_map.SIGN_BIT
        calls["torch.searchsorted alone"] = (
            lambda: torch.searchsorted(di.keys_ordered, qs, right=True))
        bound = _nbytes(q, counts, di.keys_ordered, di.offsets, hist, *want, want_t) / HBM
        print(f"[probe_tally {label}] B={B} J={J} U={U}: every variant equal to the plain "
              f"version; byte bound {bound * 1e3:.4f} ms; directory {directory.table.numel()} "
              f"entries, widest slot {directory.widest} ({smi})", flush=True)
        in_turns(calls, f"[probe_tally {label}]", smi)
        if hist is di.hist:
            saved, best = want[:2], engine.pick_best_genome(want_t.cpu().numpy(), di)

    start, h = saved
    pc = cuda_buckets.fold_table(kmers, counts, k)
    best_t = torch.full((1,), best, dtype=torch.int64, device=dev)
    long_pc, long_start, long_lens = long_rows(di, pc)
    row_len = (di.g_total_len + 1) * 4
    for label, postings, base in (
            ("int32 postings", di.pass2_postings(), None),
            ("int64 global postings, file base on the card", di.global_postings(),
             di.file_bases_t()),
            ("long rows: 255 postings or none, by (start, lens)", di.pass2_postings(), None)):
        long = label.startswith("long")
        rows = ((long_pc, long_start, long_lens, None) if long else (pc, start, None, h))
        want = torch.zeros((4, di.g_total_len + 1, 4), dtype=torch.int32, device=dev)
        cuda_map.walk_scatter_plain(want, rows[0], rows[1], postings, k=k, lens=rows[2],
                                    h=rows[3], best=None if long else best_t, file_base=base)
        pileup = torch.zeros_like(want)
        by_best = int(base is not None and base.numel() > 1)
        calls = {}
        for name, lib in libs.items():
            # (c) of one word; a checkout from before the multi-word rows
            # names the entry bronko_walk_scatter and takes no word count
            words = hasattr(lib, "bronko_walk_scatter_words")
            fn = lib.bronko_walk_scatter_words if words else lib.bronko_walk_scatter
            fn.restype = I32
            fn.argtypes = [I32, P, I32, I32, P, P, P, I32, *([I64] if words else []), P, P,
                           I32, I64, P, I32, I64, P, I64, P]
            call = (lambda fn=fn, words=words, postings=postings, base=base, by_best=by_best,
                    rows=rows:
                    fn(0, rows[0].data_ptr(), k, J, rows[1].data_ptr(),
                       None if rows[2] is None else rows[2].data_ptr(),
                       None if rows[3] is None else rows[3].data_ptr(), h.element_size(),
                       *([1] if words else []), best_t.data_ptr(), postings.data_ptr(),
                       postings.element_size(), postings.shape[0],
                       None if base is None else base.data_ptr(), by_best, rows[1].numel(),
                       pileup.data_ptr(), row_len, st))
            pileup.zero_()
            if call() != 0 or not torch.equal(pileup, want):
                raise SystemExit(f"walk_scatter variant {name!r} failed or differs at {label}")
            calls[name] = call
        at, rec = walk_addresses(*((long_start, long_lens) if long
                                   else saved_ranges(start, h, best)), k)
        file_base = 0 if base is None else int(di.file_bases[best])
        calls["floor: addresses computed beforehand"] = (
            lambda postings=postings, file_base=file_base, at=at, rec=rec, pc_=rows[0]:
            floor(pileup, pc_, k, at, rec, postings, file_base))
        pileup.zero_()
        if not torch.equal(calls["floor: addresses computed beforehand"](), want):
            raise SystemExit(f"the walk floor differs from the plain walk at {label}")
        inputs = rows[:3] if long else (pc, start, h, best_t)
        bound = (_nbytes(*inputs, want) + at.shape[0] * postings.element_size()) / HBM
        print(f"[walk_scatter {label}] {at.shape[0]} lanes over {rows[1].numel()} rows: every "
              f"variant and the floor equal to the plain version; byte bound "
              f"{bound * 1e3:.4f} ms ({smi})", flush=True)
        in_turns(calls, f"[walk_scatter {label}]", smi)


if __name__ == "__main__":
    raise SystemExit(main())
