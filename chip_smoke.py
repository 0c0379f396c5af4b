"""Smoke test of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py [--warm N]

Phases, one line each; any failure exits non-zero:
  1. device: a CUDA card must be present; prints its name and power limit;
     a child process starts drawing the bench fixture (phase 5) meanwhile;
  2. build: compiles the port's kernels (bronko_tpu_torch/csrc) with nvcc;
  3. kernels: each kernel on the card against its plain PyTorch version on
     the same inputs (exact: torch.equal), with times from CUDA events
     (median_ms) and the bound of each call (bound_ms): K1 bucket_queries
     and K2 fold_table at k = 15, 21, 31, B = 1,000,003 k-mers with the
     k=31 wrap inputs, and at the main path's batch (B = 152,679, k = 21);
     K3 pack_windows at k = 15, 21, 31 on a chunk of 262,144 reads x 160
     codes, at k = 21 on the device counter's second chunk (37,852 reads)
     and on a row slice of 161-code rows that starts an odd byte past a
     16-byte boundary;
  4. gather: the gather probe (K4 against its plain version at 2^21
     indices into 2^20 entries, and against torch's own gathers, the
     faster of which is its library_ms), its launches read around the
     probe;
  5. main: the bench fixture (4 synthetic 29,900 bp genomes and bench.py's
     three samples s0, s1, s2 of 300,000 x 150 bp reads, ~1,500x, seed
     2024, drawn in bench.py's order; cached in .smoke_cache/) through the
     port's CLI entry: `build`, then `call -d -r --pileup` of s0 on the card
     with the host counter (the index built on the card: --device-build
     auto), every kernel's launch count read around that run;
  6. check: every planted major variant is a PASS row of the VCF, and the
     card's tallies, selected genome and int32 pileup equal the same
     pipeline run on the CPU (the plain versions);
  7. count: `call -d -r --pileup --counter device` on the card, launch
     counts read around it: its k-mers, counts and stats, tallies, genome,
     pileup and output files equal the host counter's on the card;
  8. panel: the 32-strain panel (strains of synth0, 60 substitutions each,
     synth0 itself as strain 17; G = 32, so the multi-word histogram with
     W = 4 words): `build`, then `call -d -r --pileup` on the card, which
     takes the saved-probe words path, selects strain 17, calls every
     planted major PASS and equals the same call on the CPU; then, on the
     same sample's device batches, the flat tally and the sub-index
     pass 2 for strain 17 equal the words path, K1 and K2 launched there
     too; stage seconds, device peaks and index bytes;
  9. cohort: s0, s1 and s2, each under three names (9 samples), through
     `call` with the host counter on 2 count workers: each sample's VCF
     data lines, pileup TSV and overview row equal its own single-sample
     card run; again with a missing, a truncated, a malformed and an empty
     file among them (exit 2, the good samples' files unchanged, the
     overview theirs in input order); s0-s2 with `--counter device` (K3 on
     the count workers) equal the host counter's files; cohort wall
     seconds and samples per hour with 1 and 2 count workers in turns,
     beside the single-sample totals and the host's core count;
 10. profile: one sample with `--profile-dir`: the trace names K1's and
     K2's kernels, and the outputs equal the run without it;
 11. device build: the index built on the card (`--device-build on`) against the
     host build + layout (`off`) for the fixture's 4 genomes and the
     32-strain panel: every DeviceIndex tensor equal, medians of 5 of each
     route in turns, K1 and K3 launches and the device peak of the card's
     build; then `call -g strain*.fasta --device-build on` equals phase
     8's files;
 12. warm: N (default 1) more samples with each counter, in turns, with
     their stage seconds;
 13. the script's own wall time, the kernels line, the card's name and
     power limit, and the last stdout line: {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import sys

# Block JAX and the JAX package, so this run shows that the port needs
# nothing of either: importing one now raises ImportError.
sys.modules["jax"] = None
sys.modules["bronko_tpu"] = None

import argparse  # noqa: E402
import gzip  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import time  # noqa: E402
from contextlib import contextmanager  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bronko_tpu_torch import cli  # noqa: E402
from bronko_tpu_torch.call import engine  # noqa: E402
from bronko_tpu_torch.index.build import build_index  # noqa: E402
from bronko_tpu_torch.index.device_build import build_device_index_on_device  # noqa: E402
from bronko_tpu_torch.index.layout import build_device_index  # noqa: E402
from bronko_tpu_torch.index.store import load_index  # noqa: E402
from bronko_tpu_torch.ops import count, cuda_buckets, cuda_gather, cuda_lib  # noqa: E402
from bronko_tpu_torch.ops import map as tmap  # noqa: E402
from bronko_tpu_torch.ops.buckets import filtered_bucket_positions  # noqa: E402
from bronko_tpu_torch.ops.codec import from_u64  # noqa: E402

REPO = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(REPO, ".smoke_cache")
SEED = 2024
N_GENOMES = 4
GENOME_LEN = 29_900
N_READS = 300_000
READ_LEN = 150
N_SAMPLES = 3  # bench.py's cohort: s0, s1, s2
COHORT_COPIES = "abc"  # each sample under three names: a cohort of 9
COHORT_REPS = 3  # cohort timings per worker count, in turns
BUILD_REPS = 5
KERNEL_B = 1_000_003  # a multiple of no block size
KERNEL_KS = (15, 21, 31)
PACK_R, PACK_L = 262_144, 160  # a default chunk of 150 bp reads, trimmed
PACK_R2 = 37_852  # the bench fixture's second chunk with the device counter
PACK_ODD_L = 161  # rows of 161 codes: row 1 starts 1 byte past a 16-byte boundary
MAIN_B = 152_679  # the bench fixture's unique k-mers: the main path's one batch
PROBE_U, PROBE_N = 1 << 20, 1 << 21  # the gather probe: tests/profile_gather.py
REPORT_K = 21  # the default k: the kernels line reports this k's times
LAUNCHES_PER_RUN = 20  # launches between one pair of CUDA events
RUNS = 5
# a spin of ~10 ms on the card (at ~2 GHz) ahead of each timed run: the
# host enqueues the whole run meanwhile, so a call whose Python wrapper
# takes longer than its kernel is timed on the card, not on the host
HOLD_CYCLES = 20_000_000
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA's data sheet)
PANEL_STRAINS = 32  # README's SARS-scale panel: 4 histogram words of 8 genomes
PANEL_SNPS = 60     # about 0.2% of 29,900 bp, as between lineages
PANEL_SELF = 17     # synth0 itself: its byte sits in word 2, after two whole words
PANEL_REPS = 5
CARD = torch.device("cuda", 0)
KERNELS = {  # name: (TPU kernel it replaces, source)
    "bucket_queries": ("bronko_tpu/ops/pallas_buckets.py:83",
                       "bronko_tpu_torch/csrc/bucket_kernels.cu"),
    "fold_table": ("bronko_tpu/ops/pallas_buckets.py:197",
                   "bronko_tpu_torch/csrc/bucket_kernels.cu"),
    "pack_windows": ("bronko_tpu/ops/pallas_pack.py:27",
                     "bronko_tpu_torch/csrc/count_kernels.cu"),
    "gather": ("tests/profile_gather.py:46",
               "bronko_tpu_torch/csrc/gather_kernel.cu"),
}


def fail(phase: str, msg: str) -> None:
    raise SystemExit(f"[{phase}] FAILED: {msg}")


def median_ms(fn) -> float:
    """fn()'s time on the card: one CUDA event pair around a run of
    LAUNCHES_PER_RUN back-to-back calls, divided by the count; the median
    of RUNS such runs, after one warm-up call. Each run is enqueued while
    the card spins (HOLD_CYCLES), so it runs back to back; a call that
    synchronises with the host still waits for it."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(RUNS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(HOLD_CYCLES)
        start.record()
        for _ in range(LAUNCHES_PER_RUN):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / LAUNCHES_PER_RUN)
    return statistics.median(times)


def bound_ms(inputs, outputs) -> float:
    """The least time the card could take for a call that reads each input
    once and writes each output once, at the device memory's rate: every
    kernel here is bound by bytes (integer work, no tensor-core type)."""
    nbytes = sum(t.numel() * t.element_size() for t in (*inputs, *outputs))
    return nbytes / HBM_BYTES_PER_S * 1e3


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


def drive(fn):
    """Run one path of the port with every launch count set to 0 just
    before it; returns (fn's result, the counts read just after)."""
    for name in cuda_lib.LAUNCHES:
        cuda_lib.LAUNCHES[name] = 0
    out = fn()
    return out, dict(cuda_lib.LAUNCHES)


def phase_build() -> None:
    t0 = time.perf_counter()
    report = cuda_lib.build()
    took = time.perf_counter() - t0
    regs = [ln.strip() for ln in (report or "").splitlines() if "registers" in ln]
    print(f"[build] {'compiled' if report is not None else 'up to date'} "
          f"{cuda_lib.LIB_PATH} in {took:.2f}s; {'; '.join(regs)}", flush=True)


def _kernel_inputs(k: int, rng, device):
    kmers = rng.integers(0, 1 << (2 * k), size=KERNEL_B, dtype=np.uint64)
    if k == 31:  # near-all-T k-mers push mu_0 past 2^63: the u64 wrap
        top = (np.uint64(1) << np.uint64(62)) - np.uint64(1)
        kmers[:1024] = top - rng.integers(0, 1 << 20, size=1024, dtype=np.uint64)
    counts = rng.integers(0, 1_000_000, size=KERNEL_B, dtype=np.int32)
    return from_u64(kmers, device), torch.from_numpy(counts).to(device)


def _pack_inputs(rng, device, R=PACK_R, L=PACK_L):
    """A chunk of reads as the device counter gets it: codes 0..5 with
    about 2% >= 4, lengths 100..L."""
    codes = rng.integers(0, 4, size=(R, L), dtype=np.uint8)
    bad = rng.random((R, L), dtype=np.float32) < 0.02
    codes[bad] = rng.integers(4, 6, size=int(bad.sum()), dtype=np.uint8)
    lengths = rng.integers(100, L + 1, size=R, dtype=np.int32)
    return torch.from_numpy(codes).to(device), torch.from_numpy(lengths).to(device)


def _check_and_time(name: str, label: str, kernel, plain, inputs, smi: str, row: dict) -> dict:
    """Hold kernel() against plain() (exact), time both and give the bound
    of the kernel's call; prints one line and returns the numbers."""
    got = kernel()
    err = max_abs_err(got, plain())
    torch.cuda.synchronize()
    row["max_abs_err"] = max(row["max_abs_err"], err)
    if err != 0.0:
        fail("kernels", f"{name} differs from its plain version at {label}")
    out = {"ms": median_ms(kernel), "plain_ms": median_ms(plain),
           "bound_ms": bound_ms(inputs, got)}
    print(f"[kernels] {name} {label}: equal; kernel {out['ms']:.4f} ms, plain "
          f"{out['plain_ms']:.4f} ms, bound {out['bound_ms']:.4f} ms (share "
          f"{out['bound_ms'] / out['ms']:.3f}; mean of {LAUNCHES_PER_RUN} launches, "
          f"median of {RUNS} runs; {smi})", flush=True)
    return out


def phase_kernels(smi: str) -> dict:
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)
    rows = {name: {"max_abs_err": 0.0, "library_ms": None} for name in KERNELS}
    codes, lengths = _pack_inputs(rng, dev)
    for k in KERNEL_KS:
        kmers, counts = _kernel_inputs(k, rng, dev)
        positions = tuple(filtered_bucket_positions(k, 2, False))
        cases = {
            "bucket_queries": (
                lambda: cuda_buckets.bucket_queries(kmers, k, positions),
                lambda: cuda_buckets.bucket_queries_plain(kmers, k, positions), (kmers,)),
            "fold_table": (
                lambda: (cuda_buckets.fold_table(kmers, counts, k),),
                lambda: (cuda_buckets.fold_table_plain(kmers, counts, k),), (kmers, counts)),
            "pack_windows": (
                lambda: count.pack_windows(codes, lengths, k),
                lambda: count.pack_windows_plain(codes, lengths, k), (codes, lengths)),
        }
        full = tuple(range(k))  # --use-full-kmer keeps every position
        for got, want in zip(cuda_buckets.bucket_queries(kmers, k, full),
                             cuda_buckets.bucket_queries_plain(kmers, k, full)):
            if not torch.equal(got, want):
                fail("kernels", f"bucket_queries differs at k={k} with all positions")
        for name, (kernel, plain, inputs) in cases.items():
            shape = f"R={PACK_R} L={PACK_L}" if name == "pack_windows" else f"B={KERNEL_B}"
            out = _check_and_time(name, f"k={k} {shape}", kernel, plain, inputs, smi,
                                  rows[name])
            if k == REPORT_K:
                rows[name].update(out)
    # K3 at the device counter's second chunk, and on a row slice (as
    # KmerCounter.add_chunk packs one) whose codes start at an odd byte
    k = REPORT_K
    second = (codes[:PACK_R2], lengths[:PACK_R2])
    big = _pack_inputs(rng, dev, PACK_R2 + 1, PACK_ODD_L)
    odd = (big[0][1:], big[1][1:])
    if odd[0].data_ptr() % 2 != 1:
        fail("kernels", "the row slice of 161-code rows does not start at an odd byte")
    for (c, ln), label in ((second, f"R={PACK_R2} L={PACK_L}"),
                           (odd, f"R={PACK_R2} L={PACK_ODD_L} at byte "
                                 f"{odd[0].data_ptr() % 16} past a 16-byte boundary")):
        _check_and_time("pack_windows", f"k={k} {label}",
                        lambda c=c, ln=ln: count.pack_windows(c, ln, k),
                        lambda c=c, ln=ln: count.pack_windows_plain(c, ln, k),
                        (c, ln), smi, rows["pack_windows"])
    # K1 and K2 at the main path's batch: the fixture's one batch of k-mers
    kmers, counts = (t[:MAIN_B] for t in _kernel_inputs(REPORT_K, rng, dev))
    positions = tuple(filtered_bucket_positions(REPORT_K, 2, False))
    _check_and_time("bucket_queries", f"k={REPORT_K} B={MAIN_B}",
                    lambda: cuda_buckets.bucket_queries(kmers, REPORT_K, positions),
                    lambda: cuda_buckets.bucket_queries_plain(kmers, REPORT_K, positions),
                    (kmers,), smi, rows["bucket_queries"])
    _check_and_time("fold_table", f"k={REPORT_K} B={MAIN_B}",
                    lambda: (cuda_buckets.fold_table(kmers, counts, REPORT_K),),
                    lambda: (cuda_buckets.fold_table_plain(kmers, counts, REPORT_K),),
                    (kmers, counts), smi, rows["fold_table"])
    return rows


def phase_gather(smi: str) -> dict:
    """The gather probe (tests/profile_gather.py's shapes): K4 against its
    plain version, launches counted around the probe's own gathers; torch's
    two gathers of the same function timed beside it, in turns."""
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)
    U, N = PROBE_U, PROBE_N
    tbl = torch.from_numpy(rng.integers(0, 1 << 30, size=U, dtype=np.int32)).to(dev)
    idx = torch.from_numpy(rng.integers(0, U, size=N, dtype=np.int32)).to(dev)
    got = cuda_gather.gather(tbl, idx)
    err = max_abs_err((got,), (cuda_gather.gather_plain(tbl, idx),))
    torch.cuda.synchronize()
    if err != 0.0:
        fail("gather", "gather differs from its plain version")
    idx64 = idx.long()  # torch's own indexing gather, without the range check
    calls = {
        "kernel": lambda: cuda_gather.gather(tbl, idx),
        "tbl[idx64]": lambda: tbl[idx64],
        "index_select": lambda: torch.index_select(tbl, 0, idx),
    }
    times = {name: [] for name in calls}
    launches = {"gather": 0}
    for i in range(2):  # kernel, torch, torch, kernel
        for name in calls if i == 0 else reversed(list(calls)):
            if name == "kernel":
                ms, counted = drive(lambda: median_ms(calls["kernel"]))
                launches["gather"] += counted["gather"]
            else:
                ms = median_ms(calls[name])
            times[name].append(ms)
    if launches["gather"] == 0:
        fail("gather", "the gather probe never launched its kernel")
    ms = {name: statistics.median(t) for name, t in times.items()}
    plain_ms = median_ms(lambda: cuda_gather.gather_plain(tbl, idx))
    library_ms = min(ms["tbl[idx64]"], ms["index_select"])
    bound = bound_ms((tbl, idx), (got,))
    print(f"[gather] U={U} N={N}: equal; kernel {ms['kernel']:.4f} ms, plain {plain_ms:.4f} "
          f"ms, torch tbl[idx64] {ms['tbl[idx64]']:.4f} ms, torch.index_select "
          f"{ms['index_select']:.4f} ms, bound {bound:.4f} ms (share "
          f"{bound / ms['kernel']:.3f}; each the mean of two medians of {RUNS} runs of "
          f"{LAUNCHES_PER_RUN} launches, kernel and torch in turns; {smi}); launches "
          f"{launches['gather']}", flush=True)
    return {"max_abs_err": err, "ms": ms["kernel"], "plain_ms": plain_ms, "bound_ms": bound,
            "library_ms": library_ms, "launches": launches["gather"]}


def _synthetic():
    """tests/make_synthetic.py, loaded by path: tests/ has no __init__.py,
    and an installed package named `tests` would shadow the namespace
    package."""
    spec = importlib.util.spec_from_file_location(
        "make_synthetic", os.path.join(REPO, "tests", "make_synthetic.py"))
    synth = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(synth)
    return synth


def make_fixture() -> tuple[list[str], list[str], list[int]]:
    """The bench fixture (bench.py's synthetic branch): returns the genome
    paths, the FASTQ paths of samples s0, s1 and s2 and s0's planted major
    positions (0-based). Draws from the seed in bench.py's order; a cached
    sample is drawn again only when a later one is missing."""
    synth = _synthetic()
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
    fastqs = [os.path.join(CACHE, f"deep_{N_READS}_s{s}.fastq.gz") for s in range(N_SAMPLES)]
    planted = []
    for s, fastq in enumerate(fastqs):
        majors = {int(p): 0.9 for p in rng.integers(1000, GENOME_LEN - 1000, 8)}
        minors = {int(p): float(f) for p, f in zip(
            rng.integers(1000, GENOME_LEN - 1000, 12), 0.05 + 0.2 * rng.random(12))}
        if s == 0:  # a minor drawn on a major's position overrides its fraction
            planted = sorted(p for p in majors if p not in minors)
        if all(os.path.exists(f) for f in fastqs[s:]):
            break
        reads, _ = synth.make_sample(
            genomes[0], rng, read_len=READ_LEN, depth=depth, major_positions=majors,
            minor_positions=minors, error_rate=0.003)
        if not os.path.exists(fastq):
            synth.write_fastq(fastq + ".tmp.gz", reads[:N_READS])
            os.replace(fastq + ".tmp.gz", fastq)
    return genome_paths, fastqs, planted


def call_args(ref: str | list[str], fastqs: str | list[str], out: str, counter: str,
              *extra: str):
    """The config of `call -d ref` (or `-g ref...` for a list) on the
    given samples, `--pileup --counter counter`, plus `extra`."""
    refs = ["-g", *ref] if isinstance(ref, list) else ["-d", ref]
    fastqs = [fastqs] if isinstance(fastqs, str) else fastqs
    return cli.call_config(cli.build_parser().parse_args(
        ["call", *refs, "-r", *fastqs, "-o", out, "--pileup", "--counter", counter, *extra]))


def run_call(db, fastq: str, out: str, device: torch.device | None, counter: str,
             *extra: str):
    results = cli.run_call_cmd(call_args(db, fastq, out, counter, *extra), device=device)
    if len(results) != 1:
        fail("main", f"expected one sample result, got {len(results)}")
    return results[0]


def read_vcf(out: str) -> str:
    (name,) = [f for f in os.listdir(out) if f.endswith(".vcf")]
    with open(os.path.join(out, name)) as fh:
        return fh.read()


def read_outputs(out: str) -> dict[str, bytes]:
    outputs = {}
    for f in sorted(os.listdir(out)):
        with open(os.path.join(out, f), "rb") as fh:
            outputs[f] = fh.read()
    return outputs


def stage_line(tag: str, res, smi: str) -> str:
    total = sum(res.seconds.values())
    stages = ", ".join(f"{s} {v:.4f}" for s, v in res.seconds.items())
    return (f"[{tag}] seconds: {stages}; total {total:.4f} -> "
            f"{res.reads / total:.0f} reads/s ({res.reads} reads; {smi})")


def phase_count(db: str, fastq: str, work: str, host, smi: str) -> dict:
    """`call --counter device` on the card, held against the host counter's
    card run `host`."""
    gpu = torch.device("cuda", 0)
    torch.cuda.reset_peak_memory_stats(gpu)
    out = os.path.join(work, "gpu_device")
    res, launches = drive(lambda: run_call(db, fastq, out, None, "device"))
    peak = torch.cuda.max_memory_allocated(gpu)
    print(stage_line("count", res, smi), flush=True)
    print(f"[count] launches {launches}; peak device memory {peak} bytes "
          f"({peak / 2**20:.1f} MiB; {smi})", flush=True)
    missing = [n for n in ("pack_windows", "bucket_queries", "fold_table") if launches[n] == 0]
    if missing:
        fail("count", f"kernels never launched on the device-counter path: {missing}")

    counted = {}
    for counter in ("host", "device"):
        cfg = call_args(db, fastq, out, counter)
        c = engine._count_job([fastq], cfg, cfg.kmer, gpu)
        counted[counter] = (c.kmers, c.counts, c.cstats)
    (hk, hc, hs), (dk, dc, ds) = counted["host"], counted["device"]
    if not (np.array_equal(hk, dk) and np.array_equal(hc, dc)):
        fail("count", "the device counter's k-mers or counts differ from the host counter's")
    if hs != ds:
        fail("count", f"count stats differ: host {hs}, device {ds}")
    if res.best != host.best or not np.array_equal(res.tallies, host.tallies):
        fail("count", "tallies or the selected genome differ from the host counter's")
    if not np.array_equal(res.pileup, host.pileup):
        fail("count", "pileups differ from the host counter's")
    want = read_outputs(os.path.join(work, "gpu"))
    if read_outputs(out) != want:
        fail("count", "output files differ from the host counter's")
    print(f"[count] {dk.shape[0]} k-mers, counts and stats {ds} equal the host "
          f"counter's; tallies, best genome {res.best}, pileup and "
          f"{', '.join(want)} equal the host counter's card run", flush=True)
    return launches


def make_panel(synth0: str) -> list[str]:
    """The 32-strain panel: strains of synth0 with PANEL_SNPS seeded
    substitutions each, synth0 itself as strain PANEL_SELF; cached."""
    synth = _synthetic()
    with open(synth0) as fh:
        seq = fh.read().split("\n", 1)[1].replace("\n", "").encode()
    rng = np.random.default_rng(SEED + PANEL_STRAINS)
    os.makedirs(os.path.join(CACHE, "panel"), exist_ok=True)
    paths = []
    for i in range(PANEL_STRAINS):
        strain = bytearray(seq)
        sites = rng.choice(len(seq), PANEL_SNPS, replace=False)
        shifts = rng.integers(1, 4, PANEL_SNPS)
        if i != PANEL_SELF:
            for p, d in zip(sites, shifts):
                strain[p] = b"ACGT"[(b"ACGT".index(strain[p]) + int(d)) % 4]
        paths.append(os.path.join(CACHE, "panel", f"strain{i:02d}.fasta"))
        if not os.path.exists(paths[-1]):
            synth.write_fasta(paths[-1] + ".tmp", f"strain{i:02d}", bytes(strain))
            os.replace(paths[-1] + ".tmp", paths[-1])
    return paths


def passing_majors(vcf: str) -> set[int]:
    return {int(f[1]) for f in (ln.split("\t") for ln in vcf.splitlines()
                                if ln and not ln.startswith("#")) if f[6] == "PASS"}


def _timed(fn) -> tuple[object, float]:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_panel(synth0: str, fastq: str, planted: list[int], work: str, smi: str) -> None:
    """The 32-strain panel through `build` and `call` on the card (the
    saved-probe words path), held against the CPU; then the flat tally and
    the sub-index pass 2 on the same device batches, held against it."""
    gpu = torch.device("cuda", 0)
    t0 = time.perf_counter()
    paths = make_panel(synth0)
    db = os.path.join(work, "panel32")
    if cli.main(["build", "-g", *paths, "-o", db]) != 0:
        fail("panel", "build failed")
    build_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(gpu)
    res, launches = drive(lambda: run_call(db + ".bkdb", fastq, os.path.join(work, "panel_gpu"),
                                           None, "host"))
    peak = torch.cuda.max_memory_allocated(gpu)
    print(stage_line("panel", res, smi), flush=True)
    print(f"[panel] {PANEL_STRAINS} strains built in {build_s:.2f}s; path {res.path}; launches "
          f"{launches}; peak device memory {peak} bytes ({peak / 2**20:.1f} MiB; {smi})",
          flush=True)
    missing = [n for n in ("bucket_queries", "fold_table") if launches[n] == 0]
    if missing:
        fail("panel", f"kernels never launched on the panel's path: {missing}")
    if res.path != ("words", "saved"):
        fail("panel", f"expected the saved-probe words path, took {res.path}")
    if res.best != PANEL_SELF:
        fail("panel", f"selected strain {res.best}, not {PANEL_SELF}")
    vcf = read_vcf(os.path.join(work, "panel_gpu"))
    absent = [p + 1 for p in planted if p + 1 not in passing_majors(vcf)]
    if absent:
        fail("panel", f"planted majors missing from the VCF: {absent}")
    ref = run_call(db + ".bkdb", fastq, os.path.join(work, "panel_cpu"), torch.device("cpu"),
                   "host")
    if (res.best, res.path) != (ref.best, ref.path) or not np.array_equal(res.tallies,
                                                                        ref.tallies):
        fail("panel", "tallies, selected strain or path differ between the card and the CPU")
    if not np.array_equal(res.pileup, ref.pileup):
        fail("panel", "pileups differ between the card and the CPU")
    if vcf != read_vcf(os.path.join(work, "panel_cpu")):
        fail("panel", "VCFs differ between the card and the CPU")
    print(f"[panel] strain {res.best} selected; {len(planted)} planted majors PASS; tallies, "
          f"pileup and VCF equal the CPU run; CPU {stage_line('cpu', ref, 'host CPU')}",
          flush=True)

    t0 = time.perf_counter()
    dev = build_device_index(load_index(db + ".bkdb"), gpu)
    layout_s = time.perf_counter() - t0
    W = None if dev.hist_words is None else dev.hist_words.shape[1]
    if dev.hist is not None or W != -(-PANEL_STRAINS // 8) or not dev.fid_grouped:
        fail("panel", f"expected the multi-word histogram with W = 4, grouped; got hist "
                      f"{dev.hist is not None}, W = {W}, grouped {dev.fid_grouped}")
    index_bytes = dev.device_bytes()
    cfg = call_args(db + ".bkdb", fastq, work, "host")
    counted = engine._count_job([fastq], cfg, cfg.kmer, gpu)
    kmers = counted.kmers
    batches = engine.to_batches(kmers, counted.counts, cfg.batch_size, gpu)
    mcfg = dev.map_config(cfg.n_fixed, cfg.use_full_kmer)

    def words():
        def pass1():
            tallies, lanes, saved = tmap.tally_save(batches, dev, mcfg)
            return tallies, lanes[:, PANEL_SELF].tolist(), saved
        (tallies, walk, saved), pass1_s = _timed(pass1)
        pileup, pass2_s = _timed(lambda: tmap.pileup_from_saved(
            batches, saved, walk, dev.postings_local32, PANEL_SELF, mcfg, dev.g_total_len))
        return (tallies, pileup), (pass1_s, pass2_s), sum(walk)

    def flat():
        def pass1():
            tallies, lanes = tmap.tally(batches, dev, mcfg, "flat")
            return tallies, lanes[:, PANEL_SELF].tolist(), int(lanes.sum())
        (tallies, walk, n_lanes), pass1_s = _timed(pass1)
        pileup, pass2_s = _timed(lambda: tmap.pileup_from_subindex(
            batches, dev.subindex(PANEL_SELF), walk, mcfg, dev.g_total_len))
        return (tallies, pileup), (pass1_s, pass2_s), (n_lanes, sum(walk))

    torch.cuda.reset_peak_memory_stats(gpu)
    (out, cold, (flat_lanes, walk_lanes)), flat_launches = drive(flat)
    flat_peak = torch.cuda.max_memory_allocated(gpu)
    missing = [n for n in ("bucket_queries", "fold_table") if flat_launches[n] == 0]
    if missing:
        fail("panel", f"kernels never launched on the flat / sub-index path: {missing}")
    if not np.array_equal(out[0].cpu().numpy(), res.tallies):
        fail("panel", "the flat tally differs from the words path's tallies")
    if not np.array_equal(out[1].cpu().numpy(), res.pileup):
        fail("panel", "the sub-index pass 2 differs from the words path's pileup")
    times = {"words": [], "flat": []}
    for i in range(PANEL_REPS):
        for name in ("words", "flat") if i % 2 == 0 else ("flat", "words"):
            times[name].append((words if name == "words" else flat)()[1])
    med = {name: [statistics.median(t[j] for t in v) for j in (0, 1)]
           for name, v in times.items()}
    print(f"[panel] {kmers.shape[0]} k-mers, {len(batches)} batch(es); flat tally + sub-index "
          f"pass 2 equal the words path (launches {flat_launches}); the flat tally walked "
          f"{flat_lanes} postings, pass 2 {walk_lanes} for strain {PANEL_SELF}; first "
          f"run pass 1 {cold[0]:.4f}s, pass 2 {cold[1]:.4f}s (uploads the genome ids, builds "
          f"the sub-index); warm medians of {PANEL_REPS}, interleaved, pass 1 + pass 2: words "
          f"{med['words'][0]:.6f} + {med['words'][1]:.6f}s, flat + sub-index "
          f"{med['flat'][0]:.6f} + {med['flat'][1]:.6f}s; peak device memory of the flat run "
          f"{flat_peak} bytes; index {index_bytes} bytes on the card ({dev.device_bytes()} with "
          f"the genome ids and the sub-index), host layout {layout_s:.2f}s ({smi})", flush=True)


@contextmanager
def count_workers(n: int):
    """BRONKO_COUNT_WORKERS=n for the duration."""
    old = os.environ.get("BRONKO_COUNT_WORKERS")
    os.environ["BRONKO_COUNT_WORKERS"] = str(n)
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("BRONKO_COUNT_WORKERS")
        else:
            os.environ["BRONKO_COUNT_WORKERS"] = old


def run_cohort(db: str, fastqs: list[str], out: str, counter: str = "host"):
    """`call` on a cohort through the CLI entry on the card. Returns (its
    results or the SystemExit code, wall seconds)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        res = cli.run_call_cmd(call_args(db, fastqs, out, counter))
    except SystemExit as e:
        res = e.code
    return res, time.perf_counter() - t0


def data_lines(vcf: bytes) -> bytes:
    return b"".join(ln for ln in vcf.splitlines(keepends=True) if not ln.startswith(b"#"))


def overview_rows(outputs: dict[str, bytes]) -> dict[str, list[str]]:
    """The overview's rows by sample path: [path, the other columns]."""
    lines = outputs["bronko_overview.tsv"].decode().splitlines()[1:]
    return {ln.split("\t", 1)[0]: ln.split("\t", 1)[1] for ln in lines}


def stem(path: str) -> str:
    return os.path.basename(path).split(".")[0]


def phase_cohort(db: str, fastqs: list[str], work: str, smi: str) -> dict:
    """bench.py's three samples, each under three names, through `call`:
    held against their single-sample card runs, with failures among them,
    with the device counter, and timed with 1 and 2 count workers."""
    singles = {}
    for fq in fastqs:
        out = os.path.join(work, f"single_{stem(fq)}")
        res = run_call(db, fq, out, None, "host")
        singles[fq] = (read_outputs(out), sum(res.seconds.values()))
    cohort_in = os.path.join(work, "cohort_in")
    os.makedirs(cohort_in)
    jobs, source = [], {}
    for c in COHORT_COPIES:
        for s, fq in enumerate(fastqs):
            jobs.append(os.path.join(cohort_in, f"s{s}{c}.fastq.gz"))
            shutil.copyfile(fq, jobs[-1])
            source[jobs[-1]] = fq

    def check(outputs: dict[str, bytes], good: list[str], what: str) -> None:
        rows = overview_rows(outputs)
        if list(rows) != good:
            fail("cohort", f"{what}: the overview lists {list(rows)}, not {good}")
        for job in good:
            want, _ = singles[source[job]]
            (want_row,) = overview_rows(want).values()
            name = stem(source[job])
            if (data_lines(outputs[stem(job) + ".vcf"]) != data_lines(want[name + ".vcf"])
                    or outputs[stem(job) + ".tsv"] != want[name + ".tsv"]
                    or rows[job] != want_row):
                fail("cohort", f"{what}: {job} differs from its single-sample run")

    out = os.path.join(work, "cohort")
    with count_workers(2):
        (res, wall), launches = drive(lambda: run_cohort(db, jobs, out))
    if isinstance(res, int) or [r.summary.filename for r in res] != jobs:
        fail("cohort", f"the 9-sample cohort returned {res}")
    cohort = read_outputs(out)
    check(cohort, jobs, "9 samples, 2 count workers")
    print(f"[cohort] {len(jobs)} samples ({len(fastqs)} x {len(COHORT_COPIES)} names), host "
          f"counter, 2 count workers: {wall:.4f}s; each sample's VCF data lines, pileup and "
          f"overview row equal its single-sample card run; launches {launches}", flush=True)

    bad = {"missing": os.path.join(cohort_in, "missing.fastq.gz"),
           "truncated": os.path.join(cohort_in, "trunc.fastq.gz"),
           "malformed": os.path.join(cohort_in, "bad.fastq.gz"),
           "empty": os.path.join(cohort_in, "empty.fastq.gz")}
    with open(fastqs[0], "rb") as src, open(bad["truncated"], "wb") as dst:
        dst.write(src.read()[:200])  # a gzip stream cut mid-way
    with gzip.open(bad["malformed"], "wt") as fh:
        fh.write("this is not\na fastq at all\n")
    with gzip.open(bad["empty"], "wt") as fh:
        fh.write("")
    good = jobs[:5]
    mixed = [good[0], bad["missing"], good[1], bad["truncated"], good[2], bad["malformed"],
             good[3], bad["empty"], good[4]]
    out = os.path.join(work, "cohort_failures")
    with count_workers(2):
        code, _ = run_cohort(db, mixed, out)
    if code != 2:
        fail("cohort", f"a cohort with failing samples exited {code}, not 2")
    got = read_outputs(out)
    check(got, good, "with failures")
    if any(got[f] != cohort[f] for f in got if f != "bronko_overview.tsv"):
        fail("cohort", "the good samples' files differ from the cohort without failures")
    print(f"[cohort] with a missing, a truncated, a malformed and an empty file among "
          f"{len(good)} good samples: exit 2, the good samples' files unchanged, the overview "
          f"lists them in input order", flush=True)

    out = os.path.join(work, "cohort_device")
    torch.cuda.reset_peak_memory_stats()
    with count_workers(2):
        (res, wall_dev), dev_launches = drive(lambda: run_cohort(db, jobs[:3], out, "device"))
    peak = torch.cuda.max_memory_allocated()
    if isinstance(res, int) or len(res) != 3:
        fail("cohort", f"the device-counter cohort returned {res}")
    missing = [n for n in ("pack_windows", "bucket_queries", "fold_table")
               if dev_launches[n] == 0]
    if missing:
        fail("cohort", f"kernels never launched on the device-counter cohort: {missing}")
    got = read_outputs(out)
    rows = overview_rows(cohort)
    if (overview_rows(got) != {j: rows[j] for j in jobs[:3]}
            or any(got[f] != cohort[f] for f in got if f != "bronko_overview.tsv")):
        fail("cohort", "the device-counter cohort's files differ from the host counter's")
    print(f"[cohort] {jobs[:3]} with --counter device on 2 count workers: {wall_dev:.4f}s, "
          f"files equal the host counter's; launches {dev_launches}; peak device memory "
          f"{peak} bytes ({smi})", flush=True)

    times = {1: [], 2: []}
    for i in range(COHORT_REPS):
        for n in (1, 2) if i % 2 == 0 else (2, 1):
            with count_workers(n):
                res, wall = run_cohort(db, jobs, os.path.join(work, f"cohort_w{n}_{i}"))
            if isinstance(res, int) or len(res) != len(jobs):
                fail("cohort", f"the timed cohort with {n} count workers returned {res}")
            times[n].append(wall)
    single_sum = sum(singles[source[j]][1] for j in jobs)
    per_hour = {n: len(jobs) / statistics.median(t) * 3600 for n, t in times.items()}
    print(f"[cohort] {len(jobs)} samples, wall seconds with 1 count worker "
          f"{', '.join(f'{t:.4f}' for t in times[1])} -> {per_hour[1]:.0f} samples/h, with 2 "
          f"{', '.join(f'{t:.4f}' for t in times[2])} -> {per_hour[2]:.0f} samples/h (medians; "
          f"in turns); the same samples' single-sample totals sum to {single_sum:.4f}s -> "
          f"{len(jobs) / single_sum * 3600:.0f} samples/h; os.cpu_count() {os.cpu_count()}; "
          f"{smi}", flush=True)
    return dev_launches


def phase_profile(db: str, fastq: str, work: str, smi: str) -> None:
    """One sample with --profile-dir: a Chrome trace that names K1's and
    K2's kernels, and the outputs of the run without the profiler."""
    prof = os.path.join(work, "profile")
    out = os.path.join(work, "profiled")
    t0 = time.perf_counter()
    run_call(db, fastq, out, None, "host", "--profile-dir", prof)
    took = time.perf_counter() - t0
    traces = [f for f in os.listdir(prof) if f.endswith(".pt.trace.json")]
    if len(traces) != 1:
        fail("profile", f"expected one trace in {prof}, found {traces}")
    with open(os.path.join(prof, traces[0])) as fh:
        trace = json.load(fh)
    kernels = {e.get("name", "") for e in trace.get("traceEvents", [])
               if e.get("cat") == "kernel"}
    for name in ("bucket_queries_kernel", "fold_table_kernel"):
        if not any(name in k for k in kernels):
            fail("profile", f"the trace names no {name} among {len(kernels)} kernels")
    if read_outputs(out) != read_outputs(os.path.join(work, f"single_{stem(fastq)}")):
        fail("profile", "the profiled run's files differ from the run without the profiler")
    print(f"[profile] {traces[0]}: {len(trace['traceEvents'])} events, {len(kernels)} kernel "
          f"names, K1 and K2 among them; files equal the run without the profiler; the "
          f"profiled call took {took:.4f}s ({smi})", flush=True)


def same_index(got, want) -> list[str]:
    """The DeviceIndex tensors and fields that differ (none: equal); the
    genome ids of the postings and genomes 0 and G-1's sub-indexes too."""
    bad = []
    for name in ("keys", "keys_ordered", "offsets", "hist", "hist_words",
                 "postings_local32", "postings"):
        a, b = getattr(got, name), getattr(want, name)
        if (a is None) != (b is None) or (a is not None and (
                a.dtype != b.dtype or not torch.equal(a, b))):
            bad.append(name)
    for name in ("k", "num_genomes", "total_len", "max_bucket", "g_total_len",
                 "fid_grouped", "seq_slices"):
        if getattr(got, name) != getattr(want, name):
            bad.append(name)
    for name in ("genome_lens", "file_bases"):
        if not np.array_equal(getattr(got, name), getattr(want, name)):
            bad.append(name)
    if not torch.equal(got.posting_fids(), want.posting_fids()):
        bad.append("posting_fids")
    for g in sorted({0, want.num_genomes - 1}):
        a, b = got.subindex(g), want.subindex(g)
        for name in ("keys_ordered", "offsets", "postings"):
            x, y = getattr(a, name), getattr(b, name)
            if x.dtype != y.dtype or not torch.equal(x, y):
                bad.append(f"subindex({g}).{name}")
    return bad


def phase_device_build(genome_paths: list[str], panel: list[str], fastq: str, work: str,
                       smi: str) -> dict:
    """The index built on the card against the host build + layout, for
    the fixture's genomes and the 32-strain panel; then a `call -g` of the
    panel with the card's build."""
    gpu = CARD
    k = 21

    def host():
        return build_device_index(build_index(k, paths), gpu)

    def card():
        return build_device_index_on_device(k, paths, gpu)[1]

    launches = {}
    for label, paths in (("fixture", genome_paths), ("panel32", panel)):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(gpu)
        torch.cuda.reset_peak_memory_stats(gpu)
        dev, launches[label] = drive(card)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(gpu) - base
        missing = [n for n in ("pack_windows", "bucket_queries") if launches[label][n] == 0]
        if missing:
            fail("device build", f"kernels never launched on the card's build of {label}: {missing}")
        bad = same_index(dev, host())
        if bad:
            fail("device build", f"{label}: the card's build differs from the host's in {bad}")
        held = dev.device_bytes()
        del dev
        times = {"host": [], "card": []}
        for i in range(BUILD_REPS):
            for route in ("host", "card") if i % 2 == 0 else ("card", "host"):
                _, sec = _timed(host if route == "host" else card)
                times[route].append(sec)
        med = {r: statistics.median(t) for r, t in times.items()}
        print(f"[device build] {label}: {len(paths)} genomes; every DeviceIndex tensor and field "
              f"equal; seconds (medians of {BUILD_REPS}, in turns) host build + layout "
              f"{med['host']:.4f} ({', '.join(f'{t:.4f}' for t in times['host'])}), card "
              f"{med['card']:.4f} ({', '.join(f'{t:.4f}' for t in times['card'])}); the card's "
              f"build: launches {launches[label]}, peak device memory above what was held "
              f"before {peak} bytes, index {held} bytes ({smi})", flush=True)

    out = os.path.join(work, "panel_device_build")
    res = run_call(panel, fastq, out, None, "host", "--device-build", "on")
    if read_outputs(out) != read_outputs(os.path.join(work, "panel_gpu")):
        fail("device build", "`call -g` with the card's build differs from the panel phase's files")
    print(f"[device build] `call -g` of the 32 strains with --device-build on: strain {res.best}, "
          f"files equal the panel phase's; {stage_line('device build', res, smi)}", flush=True)
    return launches


def phase_warm(db: str, fastq: str, work: str, n: int, smi: str) -> None:
    """n more samples with each counter, in turns (host, device, device,
    host, ...); with n > 1 also each stage's median (q1, q3)."""
    runs = {"host": [], "device": []}
    for i in range(n):
        for counter in ("host", "device") if i % 2 == 0 else ("device", "host"):
            res = run_call(db, fastq, os.path.join(work, f"warm_{counter}"), None, counter)
            runs[counter].append(res)
            print(stage_line(f"warm {counter}", res, smi), flush=True)
    if n > 1:
        def quartiles(values):
            q1, med, q3 = statistics.quantiles(values, n=4)
            return f"{med:.6f} ({q1:.6f}, {q3:.6f})", med

        for counter, results in runs.items():
            stages = [f"{s} {quartiles([r.seconds[s] for r in results])[0]}"
                      for s in engine.STAGES]
            total, med = quartiles([sum(r.seconds.values()) for r in results])
            print(f"[warm {counter}] median (q1, q3) of {n}: {', '.join(stages)}; "
                  f"total {total} -> {results[0].reads / med:.0f} reads/s ({smi})", flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--warm", type=int, default=1,
                        help="warm samples per counter after the checks")
    parser.add_argument("--fixture-only", action="store_true",
                        help="draw the bench fixture into .smoke_cache/ and exit")
    args = parser.parse_args()
    if args.fixture_only:
        make_fixture()
        return 0
    t_start = time.perf_counter()
    kind, smi = phase_device()
    # the fixture's reads are drawn by a child process while the kernels
    # build and run on the card
    drawing = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--fixture-only"])
    try:
        return run_phases(args, kind, smi, drawing, t_start)
    finally:
        if drawing.poll() is None:
            drawing.kill()
            drawing.wait()


def run_phases(args, kind: str, smi: str, drawing: subprocess.Popen, t_start: float) -> int:
    phase_build()
    rows = phase_kernels(smi)
    rows["gather"] = phase_gather(smi)

    t0 = time.perf_counter()
    if drawing.wait() != 0:
        fail("main", f"drawing the fixture exited {drawing.returncode}")
    genome_paths, fastqs, planted = make_fixture()
    fastq = fastqs[0]
    print(f"[main] fixture ready {time.perf_counter() - t0:.1f}s after the kernel phases: "
          f"{N_GENOMES} x {GENOME_LEN} bp genomes, {', '.join(fastqs)}", flush=True)
    work = os.path.join(CACHE, "run")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    db = os.path.join(work, "panel")
    os.environ["BRONKO_PLATFORM"] = "gpu"
    if cli.main(["build", "-g", *genome_paths, "-o", db]) != 0:
        fail("main", "build failed")

    gpu = torch.device("cuda", 0)
    torch.cuda.reset_peak_memory_stats(gpu)
    res, launches = drive(lambda: run_call(db + ".bkdb", fastq, os.path.join(work, "gpu"),
                                           None, "host"))
    peak = torch.cuda.max_memory_allocated(gpu)
    print(stage_line("main", res, smi), flush=True)
    print(f"[main] launches {launches}; peak device memory {peak} bytes "
          f"({peak / 2**20:.1f} MiB; {smi})", flush=True)
    missing = [n for n in ("bucket_queries", "fold_table") if launches[n] == 0]
    if missing:
        fail("main", f"kernels never launched on the main path: {missing}")

    vcf = read_vcf(os.path.join(work, "gpu"))
    absent = [p + 1 for p in planted if p + 1 not in passing_majors(vcf)]
    if absent:
        fail("check", f"planted majors missing from the VCF: {absent}")
    ref = run_call(db + ".bkdb", fastq, os.path.join(work, "cpu"), torch.device("cpu"),
                   "host")
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
    count_launches = phase_count(db + ".bkdb", fastq, work, res, smi)
    phase_panel(genome_paths[0], fastq, planted, work, smi)
    cohort_launches = phase_cohort(db + ".bkdb", fastqs, work, smi)
    phase_profile(db + ".bkdb", fastq, work, smi)
    build_launches = phase_device_build(genome_paths, make_panel(genome_paths[0]), fastq, work,
                                        smi)
    phase_warm(db + ".bkdb", fastq, work, args.warm, smi)

    # each kernel's launches on its own path: K1 and K2 on the main path,
    # K3 on the device counter's, K4 on the gather probe's
    launches["pack_windows"] = count_launches["pack_windows"]
    launches["gather"] = rows["gather"]["launches"]
    print(f"[launches] main path {launches} (K3: the device counter's path); device-counter "
          f"cohort {cohort_launches}; the card's index builds {build_launches}", flush=True)
    kernels = [{
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches[name], "max_abs_err": rows[name]["max_abs_err"],
        "ms": rows[name]["ms"], "plain_ms": rows[name]["plain_ms"],
        "bound_ms": rows[name]["bound_ms"], "bound_by": "bytes",
        "library_ms": rows[name]["library_ms"],
    } for name, (replaces, source) in KERNELS.items()]
    print(f"[wall] chip_smoke.py took {time.perf_counter() - t_start:.1f}s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
