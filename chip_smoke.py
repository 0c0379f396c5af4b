"""Smoke test of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero:
  1. device: a CUDA card must be present; prints its name and power limit;
  2. build: compiles the port's kernels (bronko_tpu_torch/csrc) with nvcc;
  3. kernels: K1 bucket_queries and K2 fold_table on the card against their
     plain PyTorch versions on the same inputs (exact: torch.equal), at
     k = 15, 21, 31, B = 1,000,003 k-mers with the k=31 wrap inputs, and
     their median times from CUDA events;
  4. main path: the bench fixture (4 synthetic 29,900 bp genomes, 300,000
     x 150 bp reads, ~1,500x, seed 2024; cached in .smoke_cache/) through
     the port's CLI entry: `build`, then `call -d -r --pileup` on the card,
     with every kernel's launch count read around that run;
  5. check: every planted major variant is a PASS row of the VCF, and the
     card's tallies, selected genome and int32 pileup equal the same
     pipeline run on the CPU (the plain versions);
  6. the last stdout line: {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import sys

# The port reuses bronko_tpu's host modules, whose package __init__ imports
# jax when it can; block it so this run provably needs nothing of JAX.
sys.modules["jax"] = None

import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bronko_tpu_torch import cli  # noqa: E402
from bronko_tpu_torch.ops import cuda_buckets  # noqa: E402
from bronko_tpu_torch.ops.buckets import filtered_bucket_positions  # noqa: E402
from bronko_tpu_torch.ops.codec import from_u64  # noqa: E402

REPO = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(REPO, ".smoke_cache")
SEED = 2024
N_GENOMES = 4
GENOME_LEN = 29_900
N_READS = 300_000
READ_LEN = 150
KERNEL_B = 1_000_003  # a multiple of no block size
KERNEL_KS = (15, 21, 31)
REPORT_K = 21  # the default k: the kernels line reports this k's times
REPS = 20
KERNELS = {
    "bucket_queries": "bronko_tpu/ops/pallas_buckets.py:83",
    "fold_table": "bronko_tpu/ops/pallas_buckets.py:197",
}


def fail(phase: str, msg: str) -> None:
    raise SystemExit(f"[{phase}] FAILED: {msg}")


def median_ms(fn) -> float:
    """Median of REPS CUDA-event timings of fn(), after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_abs_err(got, want) -> float:
    return max(0.0 if torch.equal(a, b) else
               float((a.double() - b.double()).abs().max()) for a, b in zip(got, want))


def phase_device() -> tuple[str, str]:
    if not torch.cuda.is_available():
        fail("device", "torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    kind = torch.cuda.get_device_name(0)
    print(f"[device] {kind} x{torch.cuda.device_count()}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}: {smi}", flush=True)
    return kind, smi


def phase_build() -> None:
    t0 = time.perf_counter()
    report = cuda_buckets.build()
    took = time.perf_counter() - t0
    regs = [ln.strip() for ln in (report or "").splitlines() if "registers" in ln]
    print(f"[build] {'compiled' if report is not None else 'up to date'} "
          f"{cuda_buckets.LIB_PATH} in {took:.2f}s; {'; '.join(regs)}", flush=True)


def _kernel_inputs(k: int, rng, device):
    kmers = rng.integers(0, 1 << (2 * k), size=KERNEL_B, dtype=np.uint64)
    if k == 31:  # near-all-T k-mers push mu_0 past 2^63: the u64 wrap
        top = (np.uint64(1) << np.uint64(62)) - np.uint64(1)
        kmers[:1024] = top - rng.integers(0, 1 << 20, size=1024, dtype=np.uint64)
    counts = rng.integers(0, 1_000_000, size=KERNEL_B, dtype=np.int32)
    return from_u64(kmers, device), torch.from_numpy(counts).to(device)


def phase_kernels(smi: str) -> dict:
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)
    rows = {name: {"max_abs_err": 0.0} for name in KERNELS}
    for k in KERNEL_KS:
        kmers, counts = _kernel_inputs(k, rng, dev)
        positions = tuple(filtered_bucket_positions(k, 2, False))
        cases = {
            "bucket_queries": (
                lambda: cuda_buckets.bucket_queries(kmers, k, positions),
                lambda: cuda_buckets.bucket_queries_plain(kmers, k, positions)),
            "fold_table": (
                lambda: (cuda_buckets.fold_table(kmers, counts, k),),
                lambda: (cuda_buckets.fold_table_plain(kmers, counts, k),)),
        }
        full = tuple(range(k))  # --use-full-kmer keeps every position
        if not torch.equal(cuda_buckets.bucket_queries(kmers, k, full)[0],
                           cuda_buckets.bucket_queries_plain(kmers, k, full)[0]):
            fail("kernels", f"bucket_queries differs at k={k} with all positions")
        for name, (kernel, plain) in cases.items():
            err = max_abs_err(kernel(), plain())
            torch.cuda.synchronize()
            rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], err)
            if err != 0.0:
                fail("kernels", f"{name} differs from its plain version at k={k}")
            ms, plain_ms = median_ms(kernel), median_ms(plain)
            print(f"[kernels] {name} k={k} B={KERNEL_B}: equal; kernel {ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms (median of {REPS}; {smi})", flush=True)
            if k == REPORT_K:
                rows[name].update(ms=ms, plain_ms=plain_ms)
    return rows


def make_fixture() -> tuple[list[str], str, list[int]]:
    """The bench fixture (bench.py's synthetic branch, first sample):
    returns genome paths, the FASTQ path and the planted major positions
    (0-based). Draws from the seed in bench.py's order even when cached."""
    # by path: tests/ has no __init__.py, and an installed package named
    # `tests` would shadow the namespace package
    spec = importlib.util.spec_from_file_location(
        "make_synthetic", os.path.join(REPO, "tests", "make_synthetic.py"))
    synth = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(synth)

    os.makedirs(CACHE, exist_ok=True)
    rng = np.random.default_rng(SEED)
    genome_paths, genomes = [], []
    for g in range(N_GENOMES):
        seq = synth.make_genome(rng, GENOME_LEN)
        path = os.path.join(CACHE, f"synth{g}.fasta")
        if not os.path.exists(path):
            synth.write_fasta(path, f"synth{g}", seq)
        genome_paths.append(path)
        genomes.append(seq)
    depth = N_READS * READ_LEN // GENOME_LEN
    majors = {int(p): 0.9 for p in rng.integers(1000, GENOME_LEN - 1000, 8)}
    minors = {int(p): float(f) for p, f in zip(
        rng.integers(1000, GENOME_LEN - 1000, 12), 0.05 + 0.2 * rng.random(12))}
    fastq = os.path.join(CACHE, f"deep_{N_READS}_s0.fastq.gz")
    if not os.path.exists(fastq):
        reads, _ = synth.make_sample(
            genomes[0], rng, read_len=READ_LEN, depth=depth, major_positions=majors,
            minor_positions=minors, error_rate=0.003)
        synth.write_fastq(fastq + ".tmp.gz", reads[:N_READS])
        os.replace(fastq + ".tmp.gz", fastq)
    # a minor drawn on a major's position overrides its fraction
    return genome_paths, fastq, sorted(p for p in majors if p not in minors)


def run_call(db: str, fastq: str, out: str, device: torch.device):
    args = cli.build_parser().parse_args(
        ["call", "-d", db, "-r", fastq, "-o", out, "--pileup"])
    results = cli.run_call_cmd(cli.call_config(args), device=device)
    if len(results) != 1:
        fail("main", f"expected one sample result, got {len(results)}")
    return results[0]


def read_vcf(out: str) -> str:
    (name,) = [f for f in os.listdir(out) if f.endswith(".vcf")]
    with open(os.path.join(out, name)) as fh:
        return fh.read()


def stage_line(tag: str, res, smi: str) -> str:
    total = sum(res.seconds.values())
    stages = ", ".join(f"{s} {v:.4f}" for s, v in res.seconds.items())
    return (f"[{tag}] seconds: {stages}; total {total:.4f} -> "
            f"{res.reads / total:.0f} reads/s ({res.reads} reads; {smi})")


def main() -> int:
    kind, smi = phase_device()
    phase_build()
    rows = phase_kernels(smi)

    t0 = time.perf_counter()
    genome_paths, fastq, planted = make_fixture()
    print(f"[main] fixture ready in {time.perf_counter() - t0:.1f}s: "
          f"{N_GENOMES} x {GENOME_LEN} bp genomes, {fastq}", flush=True)
    work = os.path.join(CACHE, "run")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    db = os.path.join(work, "panel")
    os.environ["BRONKO_PLATFORM"] = "gpu"
    if cli.main(["build", "-g", *genome_paths, "-o", db]) != 0:
        fail("main", "build failed")

    gpu = torch.device("cuda", 0)
    for name in cuda_buckets.LAUNCHES:
        cuda_buckets.LAUNCHES[name] = 0
    torch.cuda.reset_peak_memory_stats(gpu)
    res = run_call(db + ".bkdb", fastq, os.path.join(work, "gpu"), None)
    launches = dict(cuda_buckets.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(gpu)
    print(stage_line("main", res, smi), flush=True)
    print(f"[main] launches {launches}; peak device memory {peak} bytes "
          f"({peak / 2**20:.1f} MiB; {smi})", flush=True)
    missing = [n for n, c in launches.items() if c == 0]
    if missing:
        fail("main", f"kernels never launched on the main path: {missing}")

    vcf = read_vcf(os.path.join(work, "gpu"))
    passing = {int(f[1]) for f in (ln.split("\t") for ln in vcf.splitlines()
                                   if ln and not ln.startswith("#")) if f[6] == "PASS"}
    absent = [p + 1 for p in planted if p + 1 not in passing]
    if absent:
        fail("check", f"planted majors missing from the VCF: {absent}")
    ref = run_call(db + ".bkdb", fastq, os.path.join(work, "cpu"), torch.device("cpu"))
    if res.best != ref.best:
        fail("check", f"selected genome {res.best} on the card, {ref.best} on the CPU")
    if not np.array_equal(res.tallies, ref.tallies):
        fail("check", "tallies differ between the card and the CPU")
    if not np.array_equal(res.pileup, ref.pileup):
        fail("check", "pileups differ between the card and the CPU")
    if vcf != read_vcf(os.path.join(work, "cpu")):
        fail("check", "VCFs differ between the card and the CPU")
    print(f"[check] {len(planted)} planted majors PASS; tallies, best genome "
          f"{res.best} and the {tuple(res.pileup.shape)} pileup equal the CPU run; "
          f"CPU {stage_line('cpu', ref, 'host CPU')}", flush=True)
    warm = run_call(db + ".bkdb", fastq, os.path.join(work, "gpu2"), None)
    print(stage_line("warm", warm, smi), flush=True)

    kernels = [{
        "name": name, "route": "cuda",
        "source": "bronko_tpu_torch/csrc/bucket_kernels.cu",
        "replaces": KERNELS[name], "launches": launches[name],
        "max_abs_err": rows[name]["max_abs_err"],
        "ms": rows[name]["ms"], "plain_ms": rows[name]["plain_ms"],
    } for name in KERNELS]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
