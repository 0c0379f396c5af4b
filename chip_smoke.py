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
     too; the words path launches (b) and (c) once a batch, the flat tally
     (d); a flat tally and a probe_scatter batch (the whole index, G = 32)
     enqueue under torch.cuda.set_sync_debug_mode('error') and equal their
     plain versions on the card; (b) on the W = 4 words, (c) from them,
     (d) on the genome ids and on the int64 global postings, and
     probe_scatter, each against its plain version and timed with its byte
     bound (torch.searchsorted alone beside (b)); stage seconds, device
     peaks and index bytes;
 8b. panel_flat: a panel past the words guard, 300 strains of synth0 made
     as the 32 (synth0 itself as strain 17; cached), through `call -g
     strain*.fasta --device-build on` on the card: the bytes reckoned
     first, then E > 255, path ('flat', 'subindex'), strain 17 selected,
     every planted major PASS, (d) launched once a batch; on the same
     sample's batches (d)'s hits, the tallies and the walk lengths equal
     the plain version's on the card; the lanes walked, (d) against its
     plain version in turns, and the peak device memory;
  9. cohort: s0, s1 and s2, each under three names (9 samples), through
     `call` with the host counter on 2 count workers: each sample's VCF
     data lines, pileup TSV and overview row equal its own single-sample
     card run; again with a missing, a truncated, a malformed and an empty
     file among them (exit 2, the good samples' files unchanged, the
     overview theirs in input order); s0-s2 with `--counter device` (K3 on
     the count workers) equal the host counter's files; cohort wall
     seconds and samples per hour with 1 and 2 count workers in turns,
     beside the single-sample totals and the host's core count;
 10. profile: one sample with `--profile-dir`: the trace names K1's, K2's,
     (b)'s and (c)'s kernels (and counts torch's searchsorted and
     repeat_interleave ops), and the outputs equal the run without it;
 11. device build: the index built on the card (`--device-build on`) against the
     host build + layout (`off`) for the fixture's 4 genomes and the
     32-strain panel: every DeviceIndex tensor equal, medians of 5 of each
     route in turns, K1 and K3 launches and the device peak of the card's
     build; then `call -g strain*.fasta --device-build on` equals phase
     8's files;
 12. mesh: (a) `call --mesh 1x1 -d -r s0 --pileup` in this process on a
     one-rank NCCL group, K1 and K2 launches read around it; (b) `--mesh
     2x2 --counter device` on s0 in 4 rank processes joined by the three
     flags, sharing the card over gloo (K1, K2 and K3 launched on every
     rank; every rank logs the routed layout); (c) the 32-strain panel on
     `--mesh 1x2` (words mode, genome-sharded); (d) `--shard-samples` over
     s0-s2 on 2 ranks; (e) `--mesh 2x1` on s0 with the host counter on 2
     ranks: the routed pass 1 saves its probe and the routed pass 2 walks
     it (every rank logs routed and launches K1 and K2); (f) pass 1 of s0
     on a 2x1 mesh through routed_tally and sharded_tally (B-split), in
     turns, medians of 5, each rank's compute and exchange seconds. Each
     run's files equal its one-device run's (phases 5, 8 and a
     one-process cohort); wall seconds beside the card's name: one card
     shows the paths correct, not their scaling. The rank processes block
     jax and bronko_tpu too;
 13. entry: entry()'s map_batch on the card equals the same call on the
     CPU (K1 and K2 launched); dryrun_multichip(4) on 4 ranks sharing the
     card prints its summary line and its wall;
 14. warm: N (default 1) more samples with each counter, in turns, with
     their stage seconds;
 15. stream: the streamed single-sample path (every phase before it runs
     with BRONKO_NO_STREAM=1, the classic path): s0 with BRONKO_STREAM=1
     and with BRONKO_NO_STREAM=1, equal to each other and to phase 6's
     CPU run (tallies, genome, int32 pileup, files), K1 launched for
     every non-empty partition and K2 for every saved one; the 32-strain
     panel streamed (words), equal to phase 8's card run; s0 with
     PROBE_BYTES_CAP at its first partition's bytes, so the others
     re-probe the sub-index; s0-s2 with BRONKO_STREAM_FIRST=1 against
     their classic cohort; the gate's decision on the card with no
     variable set; warm totals of both paths in turns, medians (q1, q3)
     of max(N, 9) each;
 15b. card count: s0 cut into a pair of mates of ~150,000 reads (a
     sars2-4ref.single sample's size; cached) through `call -1 -2
     --pileup` on the card with no stream variable set, under --counter
     auto (each mate counted on the card) and --counter host: both
     ('hist', 'streamed'), device_counted 2 and 0, the text pack's
     kernels launched 2 (fastq_lines) and 4 (fastq_pack) times by the
     auto run alone, its tallies, genome, pileup and files equal the host
     count's; the auto run again in parts of CARD_PART_BYTES: both mates
     on the card in more than two parts, fastq_lines launched once a part,
     no warning, the same tallies, genome, pileup and files; then the text
     pack (ops/count.py::fastq_pack) against its plain version on the same
     card tensor, exact in words, reads and malformed flag, timed with its
     bound (the text read once and 8 bytes a window written), at a
     mpxv-16ref.single400k mate's size (400,000 records of s0 and s1, ~126
     MB) and at a deep mate's part (s0-s2's text: PART_BYTES and half a
     record, cut by ops/count.py::fastq_records_end after its last whole
     record; the cut held against the host's), the part's numbers under
     `part` in the text pack's row of the kernels line;
 16. saved: the classic path with the saved probe (a one-part
     PendingMap: pass 1 and its copy enqueued with no host sync, then the
     host's pick and pass 2 from the probe), which every classic sample
     on the single histogram word takes: s0-s2 through run_call, all
     ('hist', 'saved'), equal (tallies, genome, pileup, files) to the same
     cohort through the sub-index (PROBE_BYTES_CAP at 1 byte: ('hist',
     'subindex')) and to the CPU run, with K1, (b), K2 and (c) launched
     once a batch; s0 enqueued under
     torch.cuda.set_sync_debug_mode('error') and resolved equal to the
     cohort's s0, with its wall stages; the keys' slot directory (slots,
     rows a slot, bytes, build time); kernels (b) probe_tally and (c)
     walk_scatter against their plain versions at s0's batch (B =
     152,679, J = 16, 2,509,920 keys): (b) on the fixture's words, on
     int64 words of 8 genomes with bit 63 set, on the fixture's keys with
     a real key 2^64-1 (every other key in three slots), on k = 31 ids
     past 2^63 and on one key; (c) on the int32 postings, on the int64
     global ones with the file base read on the card and on rows of 255
     postings mixed with empty ones; each timed with its byte bound
     (torch.searchsorted alone beside (b), (c)'s floor beside (c): the
     same posting, record and pileup traffic on addresses computed
     beforehand, tools/torch_kernel_variants.py);
 17. the script's own wall time, the kernels line, the card's name and
     power limit, and the last stdout line: {"ok": true, "device": {...}}.

The main path (phase 5) takes the saved probe, ('hist', 'saved'), as every
classic sample on the fixture's index (the single histogram word, a
probe within PROBE_BYTES_CAP) does; its stage line gives the wall stages.
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
import logging  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import time  # noqa: E402
from contextlib import contextmanager  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bronko_tpu_torch import cli, entry  # noqa: E402
from bronko_tpu_torch.call import engine  # noqa: E402
from bronko_tpu_torch.consts import KMER_COUNT_CAP  # noqa: E402
from bronko_tpu_torch.index.build import build_index  # noqa: E402
from bronko_tpu_torch.index.device_build import build_device_index_on_device  # noqa: E402
from bronko_tpu_torch.index.layout import build_device_index  # noqa: E402
from bronko_tpu_torch.index.store import load_index  # noqa: E402
from bronko_tpu_torch.io import native  # noqa: E402
from bronko_tpu_torch.ops import count, cuda_buckets, cuda_gather, cuda_lib, cuda_map  # noqa: E402
from bronko_tpu_torch.ops import map as tmap  # noqa: E402
from bronko_tpu_torch.ops.buckets import filtered_bucket_positions  # noqa: E402
from bronko_tpu_torch.ops.codec import from_u64  # noqa: E402
from bronko_tpu_torch.parallel import distributed  # noqa: E402

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
PANEL_FLAT_STRAINS = 300  # past the words guard: buckets of one posting a strain
FLAT_REPS = 3  # (d) and its plain version in turns at the 300-strain panel
MESH_TIMEOUT = 300  # seconds for one run of the mesh phase's rank processes
STREAM_WARM = 9  # warm runs of each path in the stream phase, at least
STREAM_VARS = ("BRONKO_STREAM", "BRONKO_NO_STREAM", "BRONKO_STREAM_FIRST")
MPXV_MATE_READS = 400_000  # a mate of a mpxv-16ref.single400k sample
CARD_PART_BYTES = 8 << 20  # the card count's parts in the card count phase: ~6 a mate
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
    # (b) and (c) fuse XLA work of the JAX mapper and replace no Pallas
    # kernel: `replaces` names the JAX function they take the place of
    "probe_tally": ("bronko_tpu/ops/map.py:666",
                    "bronko_tpu_torch/csrc/map_kernels.cu"),
    "walk_scatter": ("bronko_tpu/ops/map.py:899",
                     "bronko_tpu_torch/csrc/map_kernels.cu"),
    "walk_hits": ("bronko_tpu/ops/map.py:601",
                  "bronko_tpu_torch/csrc/map_kernels.cu"),
    # the text pack takes the place of the host counter's parse, which
    # the JAX package runs in C++ (a streamed lone sample on a card)
    "fastq_pack": ("bronko_tpu/native/kmer_count.cpp:513",
                   "bronko_tpu_torch/csrc/count_kernels.cu"),
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


def _check_and_time(name: str, label: str, kernel, plain, inputs, smi: str, row: dict,
                    phase: str = "kernels", walked_bytes: int = 0, timed=None,
                    library=None) -> dict:
    """Hold kernel() against plain() (exact), time both and give the bound
    of the kernel's call (its inputs and outputs, plus `walked_bytes` of
    postings that a walk reads); `timed` = (kernel, plain) to time where
    the checked calls allocate their outputs, `library` a PyTorch call to
    time beside them. Prints one line and returns the numbers."""
    got = kernel()
    err = max_abs_err(got, plain())
    torch.cuda.synchronize()
    row["max_abs_err"] = max(row["max_abs_err"], err)
    if err != 0.0:
        fail(phase, f"{name} differs from its plain version at {label}")
    k_fn, p_fn = timed or (kernel, plain)
    out = {"ms": median_ms(k_fn), "plain_ms": median_ms(p_fn),
           "bound_ms": bound_ms(inputs, got) + walked_bytes / HBM_BYTES_PER_S * 1e3,
           "library_ms": None if library is None else median_ms(library)}
    lib = "" if library is None else f", library call {out['library_ms']:.4f} ms"
    print(f"[{phase}] {name} {label}: equal; kernel {out['ms']:.4f} ms, plain "
          f"{out['plain_ms']:.4f} ms, bound {out['bound_ms']:.4f} ms (share "
          f"{out['bound_ms'] / out['ms']:.3f}{lib}; mean of {LAUNCHES_PER_RUN} launches, "
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


def stage_total(res) -> float:
    """A sample's stage seconds summed (the spans' parts of `count` left out)."""
    return sum(res.seconds[s] for s in engine.STAGES)


def stage_line(tag: str, res, smi: str) -> str:
    total = stage_total(res)
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


def make_panel(synth0: str, n: int = PANEL_STRAINS) -> list[str]:
    """A panel of n strains (32 unless given): strains of synth0 with
    PANEL_SNPS seeded substitutions each, synth0 itself as strain
    PANEL_SELF; cached."""
    synth = _synthetic()
    with open(synth0) as fh:
        seq = fh.read().split("\n", 1)[1].replace("\n", "").encode()
    rng = np.random.default_rng(SEED + n)
    folder = os.path.join(CACHE, "panel" if n == PANEL_STRAINS else f"panel{n}")
    os.makedirs(folder, exist_ok=True)
    paths = []
    for i in range(n):
        strain = bytearray(seq)
        sites = rng.choice(len(seq), PANEL_SNPS, replace=False)
        shifts = rng.integers(1, 4, PANEL_SNPS)
        if i != PANEL_SELF:
            for p, d in zip(sites, shifts):
                strain[p] = b"ACGT"[(b"ACGT".index(strain[p]) + int(d)) % 4]
        paths.append(os.path.join(folder, f"strain{i:02d}.fasta"))
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


def panel_passes(dev, batches, mcfg, best: int = PANEL_SELF) -> dict:
    """The panel's two paths over the sample's device batches, each run by
    a call that returns ((tallies, pileup), (pass 1 s, pass 2 s), the
    lanes walked), both passes ending in a host sync: 'words' (tally_save
    and pileup_from_saved for strain `best`) and 'flat' (the flat tally
    and the sub-index pass 2). tools/torch_panel_paths.py runs them on
    another checkout's package."""
    def words():
        def pass1():
            tallies, lanes, saved = tmap.tally_save(batches, dev, mcfg)
            return tallies, lanes[:, best].tolist(), saved
        (tallies, walk, saved), pass1_s = _timed(pass1)
        pileup, pass2_s = _timed(lambda: tmap.pileup_from_saved(
            batches, saved, walk, dev.postings_local32, best, mcfg, dev.g_total_len))
        return (tallies, pileup), (pass1_s, pass2_s), sum(walk)

    def flat():
        def pass1():
            tallies, lanes = tmap.tally(batches, dev, mcfg, "flat")
            return tallies, lanes[:, best].tolist(), int(lanes.sum())
        (tallies, walk, n_lanes), pass1_s = _timed(pass1)
        pileup, pass2_s = _timed(lambda: tmap.pileup_from_subindex(
            batches, dev.subindex(best), walk, mcfg, dev.g_total_len))
        return (tallies, pileup), (pass1_s, pass2_s), (n_lanes, sum(walk))

    return {"words": words, "flat": flat}


def time_panel_passes(paths: dict, reps: int) -> dict:
    """`reps` warm runs of each of panel_passes' paths in turns, the order
    reversed every other run: name -> [(pass 1 s, pass 2 s), ...]."""
    times = {name: [] for name in paths}
    for i in range(reps):
        for name in list(paths) if i % 2 == 0 else list(paths)[::-1]:
            times[name].append(paths[name]()[1])
    return times


def phase_panel(synth0: str, fastq: str, planted: list[int], work: str, smi: str):
    """The 32-strain panel through `build` and `call` on the card (the
    saved-probe words path), held against the CPU; then the flat tally and
    the sub-index pass 2 on the same device batches, held against it.
    Returns the card's call."""
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

    if [launches[n] for n in ("probe_tally", "walk_scatter")] != [len(batches)] * 2:
        fail("panel", f"the words path launched {launches}, expected (b) and (c) "
                      f"{len(batches)} each")

    passes = panel_passes(dev, batches, mcfg)
    torch.cuda.reset_peak_memory_stats(gpu)
    (out, cold, (flat_lanes, walk_lanes)), flat_launches = drive(passes["flat"])
    flat_peak = torch.cuda.max_memory_allocated(gpu)
    missing = [n for n in ("bucket_queries", "fold_table") if flat_launches[n] == 0]
    if missing or flat_launches["walk_hits"] != len(batches):
        fail("panel", f"the flat / sub-index path launched {flat_launches}: K1 and K2, and "
                      f"(d) {len(batches)} times expected")
    if not np.array_equal(out[0].cpu().numpy(), res.tallies):
        fail("panel", "the flat tally differs from the words path's tallies")
    if not np.array_equal(out[1].cpu().numpy(), res.pileup):
        fail("panel", "the sub-index pass 2 differs from the words path's pileup")
    med = {name: [statistics.median(t[j] for t in v) for j in (0, 1)]
           for name, v in time_panel_passes(passes, PANEL_REPS).items()}
    print(f"[panel] {kmers.shape[0]} k-mers, {len(batches)} batch(es); flat tally + sub-index "
          f"pass 2 equal the words path (launches {flat_launches}); the flat tally walked "
          f"{flat_lanes} postings, pass 2 {walk_lanes} for strain {PANEL_SELF}; first "
          f"run pass 1 {cold[0]:.4f}s, pass 2 {cold[1]:.4f}s (uploads the genome ids, builds "
          f"the sub-index); warm medians of {PANEL_REPS}, interleaved, pass 1 + pass 2: words "
          f"{med['words'][0]:.6f} + {med['words'][1]:.6f}s, flat + sub-index "
          f"{med['flat'][0]:.6f} + {med['flat'][1]:.6f}s; peak device memory of the flat run "
          f"{flat_peak} bytes; index {index_bytes} bytes on the card ({dev.device_bytes()} with "
          f"the genome ids and the sub-index), host layout {layout_s:.2f}s ({smi})", flush=True)
    _no_sync_enqueue(dev, batches, mcfg, out[0], smi)
    _panel_kernel_rows(dev, batches[0], mcfg, smi)
    return res


def _probe_scatter_plain(kmers, counts, dev, postings, pileup, cfg):
    """ops/map.probe_scatter with every kernel's plain version: K1's and
    K2's, the full key search, (c)'s and (d)'s."""
    q, _, _ = cuda_buckets.bucket_queries_plain(kmers, cfg.k, cfg.positions)
    rowc, hit = cuda_map._probe(q, dev.keys_ordered)
    hit &= (counts > 0)[:, None]
    start = torch.where(hit, dev.offsets[rowc], 0)
    lens = torch.where(hit, dev.offsets[rowc + 1] - dev.offsets[rowc], 0)
    out = pileup.clone()
    cuda_map.walk_scatter_plain(out, cuda_buckets.fold_table_plain(kmers, counts, cfg.k), start,
                                postings, k=cfg.k, lens=lens)
    return out, cuda_map.walk_hits_plain(start, lens, postings, cfg.num_genomes)


def _no_sync_enqueue(dev, batches, mcfg, flat_tallies, smi: str) -> None:
    """A flat tally over the panel's batches and a probe_scatter batch over
    the whole index, enqueued under set_sync_debug_mode('error'): the
    tallies equal the flat run's, and both equal their plain versions on
    the card (the flat tally's hits batch by batch)."""
    fids, postings = dev.posting_fids(), dev.global_postings()
    zero = torch.zeros((4, dev.total_len + 1, 4), dtype=torch.int32, device=CARD)
    kmers, counts = batches[0]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        (tallies, lanes), launches = drive(lambda: tmap.tally(batches, dev, mcfg, "flat"))
        scattered, scatter_launches = drive(lambda: tmap.probe_scatter(
            kmers, counts, dev.keys_ordered, dev.offsets, postings, zero, cfg=mcfg))
        enqueue_s = time.perf_counter() - t0
    finally:
        torch.cuda.set_sync_debug_mode("default")
    J = len(mcfg.positions)
    want_t = torch.zeros_like(tallies)
    for i, (km, ct) in enumerate(batches):
        start, lens = tmap._ranges(km, ct, dev.keys_ordered, dev.offsets, cfg=mcfg)
        hits = cuda_map.walk_hits_plain(start, lens, fids, dev.num_genomes)
        want_t += cuda_map.classify_tallies(hits, ct > 0, J)
        if not torch.equal(lanes[i], hits.sum(dim=0, dtype=torch.int64)):
            fail("panel", f"the flat tally's walk lengths differ from the plain walk's, batch {i}")
    if not torch.equal(tallies, want_t) or not torch.equal(tallies, flat_tallies):
        fail("panel", "the flat tally enqueued under the sync check differs")
    if max_abs_err(scattered, _probe_scatter_plain(kmers, counts, dev, postings, zero,
                                                   mcfg)) != 0.0:
        fail("panel", "probe_scatter differs from its plain version")
    if launches["walk_hits"] != len(batches) or [scatter_launches[n] for n in (
            "bucket_queries", "fold_table", "walk_scatter", "walk_hits")] != [1] * 4:
        fail("panel", f"launches under the sync check: flat {launches}, probe_scatter "
                      f"{scatter_launches}")
    print(f"[panel] a flat tally of {len(batches)} batch(es) and a probe_scatter batch over the "
          f"whole index (G = {dev.num_genomes}, {postings.shape[0]} int64 postings) enqueued "
          f"under set_sync_debug_mode('error'): no sync, {enqueue_s:.6f}s; tallies, walk "
          f"lengths, pileup and hits equal the plain versions on the card; launches {launches}"
          f", {scatter_launches} ({smi})", flush=True)


def _panel_kernel_rows(dev, batch, mcfg, smi: str) -> None:
    """(b) on the W = 4 words, (c) from its saved probe for strain
    PANEL_SELF, (d) on the genome ids and on the int64 global postings,
    and probe_scatter, at one batch of the panel: each against its plain
    version on the card, timed, with its byte bound; torch.searchsorted
    alone beside (b)."""
    kmers, counts = batch
    k, G = mcfg.k, dev.num_genomes
    row = {"max_abs_err": 0.0}
    q, _, _ = cuda_buckets.bucket_queries(kmers, k, mcfg.positions)
    args = (q, counts, dev.keys_ordered, dev.probe_dir(), dev.offsets, dev.hist_words)

    def tally_with(fn):
        tallies = torch.zeros((G, 3), dtype=torch.int32, device=CARD)
        return (*fn(*args, tallies), tallies)
    qs = q ^ tmap.SIGN_BIT
    _check_and_time(
        "probe_tally", f"B={q.shape[0]} J={q.shape[1]} U={dev.keys.shape[0]} G={G} W="
        f"{dev.hist_words.shape[1]} words", lambda: tally_with(cuda_map.probe_tally),
        lambda: tally_with(cuda_map.probe_tally_plain),
        (q, counts, dev.keys_ordered, dev.offsets, dev.hist_words), smi, row, "panel",
        library=lambda: torch.searchsorted(dev.keys_ordered, qs, right=True))

    start, h, lanes, _ = tally_with(cuda_map.probe_tally)
    pc = cuda_buckets.fold_table(kmers, counts, k)
    best = torch.full((1,), PANEL_SELF, dtype=torch.int64, device=CARD)
    walked = int(lanes[PANEL_SELF])
    scratch = torch.zeros((4, dev.g_total_len + 1, 4), dtype=torch.int32, device=CARD)

    def walk(fn, pileup=None):
        pileup = scratch.new_zeros(scratch.shape) if pileup is None else pileup
        fn(pileup, pc, start, dev.postings_local32, k=k, h=h, best=best)
        return (pileup,)
    _check_and_time(
        "walk_scatter", f"from the W = {h.shape[2]} saved words, strain {PANEL_SELF}, "
        f"{walked} lanes", lambda: walk(cuda_map.walk_scatter),
        lambda: walk(cuda_map.walk_scatter_plain), (pc, start, h, best), smi, row, "panel",
        walked * 4, timed=(lambda: walk(cuda_map.walk_scatter, scratch),
               lambda: walk(cuda_map.walk_scatter_plain, scratch)))

    start, lens = tmap._ranges(kmers, counts, dev.keys_ordered, dev.offsets, cfg=mcfg)
    n_lanes = int(lens.sum())
    for label, src in (("genome ids", dev.posting_fids()), ("int64 postings",
                                                             dev.global_postings())):
        _check_and_time(
            "walk_hits", f"G={G}, {n_lanes} lanes, {label}",
            lambda src=src: (cuda_map.walk_hits(start, lens, src, G),),
            lambda src=src: (cuda_map.walk_hits_plain(start, lens, src, G),),
            (start, lens), smi, row, "panel", n_lanes * src.element_size())

    postings = dev.global_postings()
    zero = torch.zeros((4, dev.total_len + 1, 4), dtype=torch.int32, device=CARD)
    _check_and_time(
        "probe_scatter", f"B={kmers.shape[0]} over the whole index, {n_lanes} lanes",
        lambda: tmap.probe_scatter(kmers, counts, dev.keys_ordered, dev.offsets, postings,
                                   zero, cfg=mcfg),
        lambda: _probe_scatter_plain(kmers, counts, dev, postings, zero, mcfg),
        (kmers, counts, dev.keys_ordered, dev.offsets), smi, row, "panel", n_lanes * 8)


def phase_panel_flat(synth0: str, fastq: str, planted: list[int], work: str, smi: str):
    """A panel past the words guard: PANEL_FLAT_STRAINS strains of synth0
    through `call -g --device-build on` on the card (the flat tally on (d),
    pass 2 through strain PANEL_SELF's sub-index), then (d) against its
    plain version on the same sample's batches. Returns (d)'s row of the
    kernels line and its launches on the call's path."""
    paths = make_panel(synth0, PANEL_FLAT_STRAINS)
    n_post = PANEL_FLAT_STRAINS * (GENOME_LEN - 20) * 21  # windows x buckets a window
    print(f"[panel_flat] {PANEL_FLAT_STRAINS} strains: about {n_post} postings, so int32 "
          f"postings and genome ids of {n_post * 4 / 2**30:.2f} GiB each on the card",
          flush=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(CARD)
    out = os.path.join(work, "panel_flat")
    res, launches = drive(lambda: run_call(paths, fastq, out, None, "host",
                                           "--device-build", "on"))
    peak = torch.cuda.max_memory_allocated(CARD)
    print(stage_line("panel_flat", res, smi), flush=True)
    if res.path != ("flat", "subindex"):
        fail("panel_flat", f"expected the flat tally and the sub-index pass 2, took {res.path}")
    if res.best != PANEL_SELF:
        fail("panel_flat", f"selected strain {res.best}, not {PANEL_SELF}")
    absent = [p + 1 for p in planted if p + 1 not in passing_majors(read_vcf(out))]
    if absent:
        fail("panel_flat", f"planted majors missing from the VCF: {absent}")

    torch.cuda.reset_peak_memory_stats(CARD)
    (_, dev), build_s = _timed(lambda: build_device_index_on_device(21, paths, CARD))
    if dev.max_bucket <= 255 or dev.tally_mode() != "flat":
        fail("panel_flat", f"E = {dev.max_bucket}, tally mode {dev.tally_mode()}: not past "
                           f"the words guard")
    cfg = call_args(paths, fastq, work, "host")
    counted = engine._count_job([fastq], cfg, cfg.kmer, CARD)
    batches = engine.to_batches(counted.kmers, counted.counts, cfg.batch_size, CARD)
    if launches["walk_hits"] != len(batches):
        fail("panel_flat", f"launches {launches}: (d) {len(batches)} times expected")
    mcfg = dev.map_config(cfg.n_fixed, cfg.use_full_kmer)
    fids, G, J = dev.posting_fids(), dev.num_genomes, len(mcfg.positions)
    tallies, lanes = tmap.tally(batches, dev, mcfg, "flat")
    want_t = torch.zeros_like(tallies)
    ranges = []
    for i, (kmers, counts) in enumerate(batches):
        start, lens = tmap._ranges(kmers, counts, dev.keys_ordered, dev.offsets, cfg=mcfg)
        got = cuda_map.walk_hits(start, lens, fids, G)
        hits = cuda_map.walk_hits_plain(start, lens, fids, G)
        if not torch.equal(got, hits):
            fail("panel_flat", f"(d)'s hits differ from the plain walk's, batch {i}")
        want_t += cuda_map.classify_tallies(hits, counts > 0, J)
        if not torch.equal(lanes[i], hits.sum(dim=0, dtype=torch.int64)):
            fail("panel_flat", f"walk lengths differ from the plain walk's, batch {i}")
        ranges.append((start, lens))
    if not torch.equal(tallies, want_t) or not np.array_equal(tallies.cpu().numpy(),
                                                               res.tallies):
        fail("panel_flat", "tallies differ from the plain walk's or the call's")
    n_lanes = int(lanes.sum())
    start, lens = ranges[0]
    walked = int(lens.sum())
    hits = cuda_map.walk_hits(start, lens, fids, G)
    times = {"kernel": [], "plain": []}
    for i in range(FLAT_REPS):
        for name in ("kernel", "plain") if i % 2 == 0 else ("plain", "kernel"):
            fn = cuda_map.walk_hits if name == "kernel" else cuda_map.walk_hits_plain
            times[name].append(median_ms(lambda fn=fn: fn(start, lens, fids, G)))
    row = {"ms": statistics.median(times["kernel"]), "plain_ms": statistics.median(times["plain"]),
           "bound_ms": bound_ms((start, lens), (hits,)) + walked * 4 / HBM_BYTES_PER_S * 1e3,
           "max_abs_err": 0.0, "library_ms": None}
    print(f"[panel_flat] E = {dev.max_bucket} > 255, G = {G}, {fids.shape[0]} postings; path "
          f"{res.path}, strain {res.best}, {len(planted)} planted majors PASS; launches "
          f"{launches}; {counted.kmers.shape[0]} k-mers in {len(batches)} batch(es), the flat "
          f"tally walked {n_lanes} lanes; (d)'s hits, tallies and walk lengths equal the plain "
          f"walk's on the card; peak device memory of the call {peak} bytes ({peak / 2**30:.2f} "
          f"GiB), of the card's build {torch.cuda.max_memory_allocated(CARD)} bytes (built in "
          f"{build_s:.3f}s, index {dev.device_bytes()} bytes with the genome ids) ({smi})",
          flush=True)
    print(f"[panel_flat] walk_hits at batch 0, {walked} lanes: kernel "
          f"{', '.join(f'{t:.4f}' for t in times['kernel'])} ms, plain "
          f"{', '.join(f'{t:.4f}' for t in times['plain'])} ms in turns (medians {row['ms']:.4f}"
          f" and {row['plain_ms']:.4f}; each the median of {RUNS} runs of {LAUNCHES_PER_RUN}), "
          f"bound {row['bound_ms']:.4f} ms (share {row['bound_ms'] / row['ms']:.3f}; {smi})",
          flush=True)
    del dev, ranges, batches, counted
    torch.cuda.empty_cache()
    return row, launches


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
        singles[fq] = (read_outputs(out), stage_total(res))
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
    for name in ("bucket_queries_kernel", "fold_table_kernel", "probe_tally_kernel",
                 "walk_scatter_kernel"):
        if not any(name in k for k in kernels):
            fail("profile", f"the trace names no {name} among {len(kernels)} kernels")
    if read_outputs(out) != read_outputs(os.path.join(work, f"single_{stem(fastq)}")):
        fail("profile", "the profiled run's files differ from the run without the profiler")
    ops = {name: sum(e.get("name") == name for e in trace["traceEvents"])
           for name in ("aten::searchsorted", "aten::repeat_interleave")}
    print(f"[profile] {traces[0]}: {len(trace['traceEvents'])} events, {len(kernels)} kernel "
          f"names, K1, K2, (b) and (c) among them; torch ops of the old probe and walk "
          f"{ops}; files equal the run without the profiler; the profiled call took "
          f"{took:.4f}s ({smi})", flush=True)


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


# a rank of the mesh phase: `python -m bronko_tpu_torch` with jax and
# bronko_tpu blocked, as in this script; prints its launch counts last
RANK_WRAPPER = """
import json, runpy, sys
sys.modules["jax"] = None
sys.modules["bronko_tpu"] = None
sys.argv = ["bronko_tpu_torch", *sys.argv[1:]]
try:
    runpy.run_module("bronko_tpu_torch", run_name="__main__")
finally:
    from bronko_tpu_torch.ops import cuda_lib
    print("LAUNCHES " + json.dumps(cuda_lib.LAUNCHES), flush=True)
"""


# a rank of the mesh phase's run (f): pass 1 of one sample on a 2x1 mesh
# through the routed probe and the B-split one, in turns; prints the
# medians of each one's wall, exchange and compute seconds, then its
# launch counts
RANK_PASS1 = """
import argparse, json, statistics, sys, time
sys.modules["jax"] = None
sys.modules["bronko_tpu"] = None
import numpy as np
import torch
from bronko_tpu_torch import cli
from bronko_tpu_torch.call import engine
from bronko_tpu_torch.index.layout import build_device_index
from bronko_tpu_torch.index.store import load_index
from bronko_tpu_torch.ops import cuda_lib
from bronko_tpu_torch.config import setup_logging
from bronko_tpu_torch.parallel import distributed, pipeline

setup_logging(False, False)
ap = argparse.ArgumentParser()
ap.add_argument("db")
ap.add_argument("fastq")
ap.add_argument("--coordinator")
ap.add_argument("--num-processes", type=int)
ap.add_argument("--process-id", type=int)
a = ap.parse_args()
distributed.init_distributed(a.coordinator, a.num_processes, a.process_id)
device = distributed.rank_device()
cfg = cli.call_config(cli.build_parser().parse_args(
    ["call", "-d", a.db, "-r", a.fastq, "-o", "unused", "--mesh", "2x1", "--counter", "host"]))
index = load_index(a.db)
dev = build_device_index(index, torch.device("cpu"))
mapper = engine.ShardedMapper(index, cfg, dev, device)
counted = engine._count_job([a.fastq], cfg, index.k, device)
batches = mapper.place_batches(counted.kmers, counted.counts, cfg.batch_size)
assert mapper._layout == "routed", mapper._layout
mcfg = dev.map_config(cfg.n_fixed, cfg.use_full_kmer)
chunks, bounds = pipeline.route_split(mapper.sharded, 2)
chunk = pipeline.upload_chunk(chunks, bounds, mapper.mesh.g, mapper.mesh.d, device)
save = mapper.mode == "hist" and dev.fid_grouped


def routed():
    return pipeline.routed_tally(batches, chunk, mcfg, mapper.mode, mapper.mesh, save)[0]


def bsplit():
    return pipeline.sharded_tally(batches, mapper.shard, mcfg, mapper.mode, mapper.mesh)


assert np.array_equal(routed(), bsplit())
runs = {"routed": [], "bsplit": []}
for i in range(5):
    for name in ("routed", "bsplit") if i % 2 == 0 else ("bsplit", "routed"):
        torch.cuda.synchronize()
        x0, t0 = distributed.EXCHANGE_SECONDS, time.perf_counter()
        (routed if name == "routed" else bsplit)()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs[name].append((wall, distributed.EXCHANGE_SECONDS - x0))
rep = {name: {"wall": statistics.median(w for w, _ in v),
              "exchange": statistics.median(e for _, e in v),
              "compute": statistics.median(w - e for w, e in v)} for name, v in runs.items()}
rep.update(kmers=int(counted.kmers.shape[0]), batches=len(batches),
           slice=int(sum(km.shape[0] for km, _ in batches)), reps=5)
print("PASS1 " + json.dumps(rep), flush=True)
distributed.shutdown()
print("LAUNCHES " + json.dumps(cuda_lib.LAUNCHES), flush=True)
"""


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(n: int, argv: list[str], work: str, tag: str, script: str = RANK_WRAPPER,
              layouts: str | None = None) -> tuple[list[dict], float, list[str]]:
    """`call argv` (or `script` with argv) in n rank processes on this
    card, joined by the three flags on localhost (n ranks on one card:
    gloo). Returns each rank's launch counts (counted in the rank from 0),
    the wall seconds and each rank's output; fails the phase unless every
    rank exits 0 (and, with `layouts`, logs that the mesh took them), and
    kills every rank past MESH_TIMEOUT."""
    port = _free_port()
    logs = [os.path.join(work, f"mesh_{tag}.{r}.log") for r in range(n)]
    t0 = time.perf_counter()
    procs = []
    head = ["call"] if script is RANK_WRAPPER else []
    for r in range(n):
        with open(logs[r], "w") as fh:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", script, *head, *argv, "--coordinator",
                 f"127.0.0.1:{port}", "--num-processes", str(n), "--process-id", str(r)],
                cwd=REPO, stdout=fh, stderr=subprocess.STDOUT))
    try:
        for p in procs:
            p.wait(timeout=max(1.0, MESH_TIMEOUT - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    launches, texts = [], []
    for r, (p, log) in enumerate(zip(procs, logs)):
        with open(log) as fh:
            text = fh.read()
        if p.returncode != 0:
            fail("mesh", f"{tag}: rank {r} exited {p.returncode}:\n{text[-3000:]}")
        if "backend gloo (ranks share a card)" not in text:
            fail("mesh", f"{tag}: rank {r} did not run gloo over the shared card")
        if layouts is not None and f"mesh layouts used this run: {layouts}\n" not in text:
            fail("mesh", f"{tag}: rank {r} did not log the layouts {layouts}")
        launches.append(json.loads(text.rsplit("LAUNCHES ", 1)[1].splitlines()[0]))
        texts.append(text)
    return launches, wall, texts


def phase_mesh(db: str, panel_db: str, fastqs: list[str], work: str, smi: str) -> dict:
    """--mesh and --shard-samples on this one card: (a) a 1x1 mesh in this
    process on a one-rank NCCL group, (b) a 2x2 mesh of 4 ranks sharing
    the card over gloo with the device counter, (c) the 32-strain panel
    on a 1x2 mesh (words, genome-sharded), (d) --shard-samples on 2
    ranks; each byte-equal to its one-device run. One card shows that
    the paths are correct, not how they scale."""
    fastq = fastqs[0]
    walls = {}
    distributed.init_world_of_one()
    backend = torch.distributed.get_backend()
    if backend != "nccl":
        fail("mesh", f"the world of one on the card runs {backend}, not nccl")
    out = os.path.join(work, "mesh_1x1")
    t0 = time.perf_counter()
    try:
        (res, launches_a) = drive(lambda: run_call(db, fastq, out, None, "host", "--mesh", "1x1"))
    finally:
        distributed.shutdown()
    walls["a"] = time.perf_counter() - t0
    if read_outputs(out) != read_outputs(os.path.join(work, "gpu")):
        fail("mesh", "(a) --mesh 1x1 on NCCL: files differ from the main phase's")
    if any(launches_a[n] == 0 for n in ("bucket_queries", "fold_table")):
        fail("mesh", f"(a) K1 or K2 never launched on the 1x1 mesh: {launches_a}")
    print(f"[mesh] (a) --mesh 1x1 in this process on a one-rank NCCL group: files equal the "
          f"main phase's; path {res.path}; launches {launches_a}; wall {walls['a']:.4f}s "
          f"({smi})", flush=True)

    def check_ranks(tag, launches, kernels):
        missing = [(r, n) for r, counts in enumerate(launches) for n in kernels if counts[n] == 0]
        if missing:
            fail("mesh", f"{tag}: (rank, kernel) never launched: {missing}")

    out = os.path.join(work, "mesh_2x2")
    launches_b, walls["b"], _ = run_ranks(
        4, ["-d", db, "-r", fastq, "-o", out, "--pileup", "--mesh", "2x2",
            "--counter", "device"], work, "2x2", layouts="routed")
    check_ranks("(b)", launches_b, ("bucket_queries", "fold_table", "pack_windows"))
    if read_outputs(out) != read_outputs(os.path.join(work, "gpu")):
        fail("mesh", "(b) --mesh 2x2: files differ from the main phase's")
    print(f"[mesh] (b) --mesh 2x2, 4 ranks sharing the card over gloo, --counter device: every "
          f"rank took the routed layout; files equal the main phase's; launches by rank "
          f"{launches_b}; wall {walls['b']:.4f}s, rank start-up included ({smi})", flush=True)

    out = os.path.join(work, "mesh_panel_1x2")
    launches_c, walls["c"], _ = run_ranks(
        2, ["-d", panel_db, "-r", fastq, "-o", out, "--pileup", "--mesh", "1x2"], work, "panel")
    check_ranks("(c)", launches_c, ("bucket_queries", "fold_table"))
    if read_outputs(out) != read_outputs(os.path.join(work, "panel_gpu")):
        fail("mesh", "(c) the 32-strain panel on --mesh 1x2: files differ from the panel phase's")
    print(f"[mesh] (c) 32-strain panel, --mesh 1x2 (words, 16 strains a rank): files equal the "
          f"panel phase's; launches by rank {launches_c}; wall {walls['c']:.4f}s ({smi})",
          flush=True)

    single = os.path.join(work, "mesh_cohort_single")
    res, walls["d single"] = run_cohort(db, fastqs, single)
    if isinstance(res, int) or len(res) != len(fastqs):
        fail("mesh", f"(d) the one-process cohort returned {res}")
    out = os.path.join(work, "mesh_shard_samples")
    launches_d, walls["d"], _ = run_ranks(
        2, ["-d", db, "-r", *fastqs, "-o", out, "--pileup", "--shard-samples"], work, "shard")
    check_ranks("(d)", launches_d, ("bucket_queries", "fold_table"))
    if read_outputs(out) != read_outputs(single):
        fail("mesh", "(d) --shard-samples: files differ from the one-process cohort's")
    print(f"[mesh] (d) --shard-samples, {len(fastqs)} samples on 2 ranks: every VCF, pileup and "
          f"the overview equal the one-process cohort's; launches by rank {launches_d}; wall "
          f"{walls['d']:.4f}s against {walls['d single']:.4f}s in one process, rank start-up "
          f"included ({smi})", flush=True)

    out = os.path.join(work, "mesh_2x1")
    launches_e, walls["e"], _ = run_ranks(
        2, ["-d", db, "-r", fastq, "-o", out, "--pileup", "--mesh", "2x1", "--counter", "host"],
        work, "2x1", layouts="routed")
    check_ranks("(e)", launches_e, ("bucket_queries", "fold_table"))
    if read_outputs(out) != read_outputs(os.path.join(work, "gpu")):
        fail("mesh", "(e) --mesh 2x1: files differ from the main phase's")
    print(f"[mesh] (e) --mesh 2x1, 2 ranks sharing the card over gloo, host counter: every rank "
          f"took the routed pass 1 with its saved probe and the routed pass 2; files equal the "
          f"main phase's; launches by rank {launches_e}; wall {walls['e']:.4f}s, rank start-up "
          f"included ({smi})", flush=True)

    _, walls["f"], texts = run_ranks(2, [db, fastq], work, "pass1", script=RANK_PASS1)
    for r, text in enumerate(texts):
        rep = json.loads(text.rsplit("PASS1 ", 1)[1].splitlines()[0])
        print(f"[mesh] (f) rank {r} of 2x1: pass 1 of {fastq} ({rep['kmers']} k-mers, "
              f"{rep['batches']} batch(es), a B-split slice of {rep['slice']} k-mers), medians "
              f"of {rep['reps']} in turns, seconds: routed (saved probe) wall "
              f"{rep['routed']['wall']:.6f} = compute {rep['routed']['compute']:.6f} + exchange "
              f"{rep['routed']['exchange']:.6f}; B-split wall {rep['bsplit']['wall']:.6f} = "
              f"compute {rep['bsplit']['compute']:.6f} + exchange "
              f"{rep['bsplit']['exchange']:.6f}; tallies equal ({smi})", flush=True)
    print(f"[mesh] wall seconds {json.dumps(walls)}: "
          f"one card shows the mesh paths correct, not their scaling ({smi})", flush=True)
    return {"1x1": launches_a, "2x2": launches_b, "panel 1x2": launches_c,
            "shard-samples": launches_d, "2x1": launches_e}


def phase_entry(smi: str) -> dict:
    """entry()'s map_batch on the card against the same call on the CPU
    (BRONKO_PLATFORM=cpu: the plain versions), launch counts read around
    the card's; then dryrun_multichip(4): 4 rank processes sharing the
    card over gloo on a 2x2 mesh, which prints JAX's summary line."""
    def on_card():
        fn, args = entry.entry()
        out = fn(*args)
        torch.cuda.synchronize()
        return out, args[0].device

    (got, where), launches = drive(on_card)
    if where.type != "cuda":
        fail("entry", f"entry() put its inputs on {where}, not the card")
    missing = [n for n in ("bucket_queries", "fold_table") if launches[n] == 0]
    if missing:
        fail("entry", f"kernels never launched by entry()'s function: {missing}")
    os.environ["BRONKO_PLATFORM"] = "cpu"
    try:
        fn, args = entry.entry()
        want = fn(*args)
    finally:
        os.environ["BRONKO_PLATFORM"] = "gpu"
    if not all(torch.equal(a.cpu(), b) for a, b in zip(got, want)):
        fail("entry", "entry()'s pileup or tallies differ between the card and the CPU")
    print(f"[entry] entry()'s map_batch on the card: pileup {tuple(got[0].shape)} and tallies "
          f"(sum {int(got[1].sum())}) equal the CPU's; launches {launches}", flush=True)
    t0 = time.perf_counter()
    line = entry.dryrun_multichip(4)
    wall = time.perf_counter() - t0
    if "routed" not in line:
        fail("entry", f"dryrun_multichip(4) took no routed layout: {line}")
    print(f"[entry] dryrun_multichip(4), 4 ranks sharing the card over gloo: wall {wall:.4f}s, "
          f"rank start-up included ({smi})", flush=True)
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
            total, med = quartiles([stage_total(r) for r in results])
            print(f"[warm {counter}] median (q1, q3) of {n}: {', '.join(stages)}; "
                  f"total {total} -> {results[0].reads / med:.0f} reads/s ({smi})", flush=True)


@contextmanager
def stream_env(**env: str):
    """The three stream variables as `env` gives them (the others unset) for
    the duration; their values before come back after."""
    old = {v: os.environ.get(v) for v in STREAM_VARS}
    for v in STREAM_VARS:
        os.environ.pop(v, None)
    os.environ.update(env)
    try:
        yield
    finally:
        for v, x in old.items():
            if x is None:
                os.environ.pop(v, None)
            else:
                os.environ[v] = x


def phase_stream(db: str, panel_db: str, fastqs: list[str], work: str, ref, panel_res,
                 warm: int, smi: str) -> dict:
    """The streamed single-sample path on the card (host counter): s0
    forced streamed and forced classic, both equal to each other and to
    the main phase's CPU run `ref`; the 32-strain panel streamed, equal to
    the panel phase's card run `panel_res`; s0 with the probe cap at its
    first partition's bytes (the other partitions re-probe the sub-index);
    a 3-sample cohort with BRONKO_STREAM_FIRST=1 against its classic run;
    the gate's decision with no variable set; warm totals of both paths in
    turns. Returns the streamed s0 run's launch counts."""
    fastq = fastqs[0]
    cfg = call_args(db, fastq, work, "host")
    parts = [p[0].shape[0] for p in native.native_count_fastq_stream(
        [fastq], cfg.kmer, cfg.min_kmers, KMER_COUNT_CAP, threads=cfg.threads)]
    nonempty = [n for n in parts if n]
    batches = sum(-(-n // cfg.batch_size) for n in nonempty)

    def same_as(res, want, out: str, want_out: str, what: str) -> None:
        if res.best != want.best or not np.array_equal(res.tallies, want.tallies):
            fail("stream", f"{what}: tallies or the selected genome differ")
        if not np.array_equal(res.pileup, want.pileup):
            fail("stream", f"{what}: pileups differ")
        if read_outputs(out) != read_outputs(want_out):
            fail("stream", f"{what}: output files differ")

    def kernels_ran(launches: dict, k1: int, k2: int, what: str) -> None:
        if launches["bucket_queries"] < k1 or launches["fold_table"] < k2:
            fail("stream", f"{what}: launches {launches}, expected K1 >= {k1} and K2 >= {k2}")

    out_s, out_c = os.path.join(work, "stream_s0"), os.path.join(work, "stream_s0_classic")
    with stream_env(BRONKO_STREAM="1"):
        res_s, launches = drive(lambda: run_call(db, fastq, out_s, None, "host"))
    with stream_env(BRONKO_NO_STREAM="1"):
        res_c = run_call(db, fastq, out_c, None, "host")
    if (res_s.path, res_c.path) != (("hist", "streamed"), ("hist", "saved")):
        fail("stream", f"paths {res_s.path} (BRONKO_STREAM=1), {res_c.path} (BRONKO_NO_STREAM=1)")
    kernels_ran(launches, len(nonempty), len(nonempty), "s0 streamed")
    same_as(res_s, res_c, out_s, out_c, "s0 streamed against classic")
    same_as(res_s, ref, out_s, os.path.join(work, "cpu"), "s0 streamed against the CPU run")
    print(f"[stream] s0 streamed in {len(parts)} partitions of {parts} k-mers ({batches} "
          f"batch(es)): launches {launches}; tallies, genome {res_s.best}, pileup and "
          f"{', '.join(read_outputs(out_s))} equal the classic card run and the CPU run; "
          f"{stage_line('stream s0', res_s, smi)}", flush=True)

    out_p = os.path.join(work, "stream_panel")
    with stream_env(BRONKO_STREAM="1"):
        res_p, launches_p = drive(lambda: run_call(panel_db, fastq, out_p, None, "host"))
    if res_p.path != ("words", "streamed"):
        fail("stream", f"the panel took {res_p.path}, not the streamed words path")
    kernels_ran(launches_p, len(nonempty), len(nonempty), "the panel streamed")
    same_as(res_p, panel_res, out_p, os.path.join(work, "panel_gpu"), "the panel streamed")
    print(f"[stream] 32-strain panel streamed (words): launches {launches_p}; equal to the "
          f"panel phase's card run; {stage_line('stream panel', res_p, smi)}", flush=True)

    dev = build_device_index(load_index(db), torch.device("cpu"))
    J = len(dev.map_config(cfg.n_fixed, cfg.use_full_kmer).positions)
    cap = nonempty[0] * J * engine.probe_bytes_per_query(dev)
    out_m = os.path.join(work, "stream_capped")
    full_cap, engine.PROBE_BYTES_CAP = engine.PROBE_BYTES_CAP, cap
    try:
        with stream_env(BRONKO_STREAM="1"):
            res_m, launches_m = drive(lambda: run_call(db, fastq, out_m, None, "host"))
    finally:
        engine.PROBE_BYTES_CAP = full_cap
    if res_m.path != ("hist", "streamed"):
        fail("stream", f"the capped run took {res_m.path}")
    # pass 1 probes every partition; pass 2 probes the sub-index again for
    # each partition past the cap
    kernels_ran(launches_m, 2 * len(nonempty) - 1, 2, "s0 with the probe cap")
    same_as(res_m, res_c, out_m, out_c, "s0 with the probe cap")
    print(f"[stream] s0 with PROBE_BYTES_CAP = {cap} bytes (partition 0 saves its probe, "
          f"{len(nonempty) - 1} re-probe the sub-index): launches {launches_m}; equal to the "
          f"classic run; {stage_line('stream capped', res_m, smi)}", flush=True)

    outs = {"first": os.path.join(work, "stream_cohort"),
            "classic": os.path.join(work, "stream_cohort_classic")}
    with stream_env(BRONKO_STREAM_FIRST="1"):
        (cohort, wall_f), launches_f = drive(lambda: run_cohort(db, fastqs, outs["first"]))
    with stream_env(BRONKO_NO_STREAM="1"):
        classic, wall_c = run_cohort(db, fastqs, outs["classic"])
    if not isinstance(cohort, list) or not isinstance(classic, list):
        fail("stream", f"a cohort run failed: exit {cohort}, {classic}")
    paths = [r.path for r in cohort]
    if paths != [("hist", "streamed")] + [("hist", "saved")] * (len(fastqs) - 1):
        fail("stream", f"the cohort's paths with BRONKO_STREAM_FIRST=1: {paths}")
    if read_outputs(outs["first"]) != read_outputs(outs["classic"]):
        fail("stream", "the cohort with its first sample streamed writes other files")
    print(f"[stream] {len(fastqs)}-sample cohort with BRONKO_STREAM_FIRST=1: paths {paths}, "
          f"launches {launches_f}, files equal the classic cohort's; wall {wall_f:.4f}s "
          f"(classic {wall_c:.4f}s; {smi})", flush=True)

    card_dev = build_device_index(load_index(db), CARD)
    with stream_env():
        decision = engine._can_stream(cfg, card_dev, None)
        res_auto = run_call(db, fastq, os.path.join(work, "stream_auto"), None, "host")
    if not decision or res_auto.path != ("hist", "streamed"):
        fail("stream", f"with no variable set the gate says {decision}, s0 took {res_auto.path}")
    print(f"[stream] gate on the card with no variable set: streamed; a lone sample took "
          f"{res_auto.path} ({smi})", flush=True)

    n = max(warm, STREAM_WARM)
    runs = {"streamed": [], "classic": []}
    for i in range(n):
        for name in ("streamed", "classic") if i % 2 == 0 else ("classic", "streamed"):
            env = {"BRONKO_STREAM": "1"} if name == "streamed" else {"BRONKO_NO_STREAM": "1"}
            with stream_env(**env):
                runs[name].append(run_call(db, fastq, os.path.join(work, f"stream_warm_{name}"),
                                           None, "host"))
    med = {}
    for name, results in runs.items():
        q1, med[name], q3 = statistics.quantiles([stage_total(r) for r in results], n=4)
        stages = ", ".join(f"{s} {statistics.median(r.seconds[s] for r in results):.6f}"
                           for s in engine.STAGES)
        print(f"[stream warm {name}] median (q1, q3) of {n}, in turns: total {med[name]:.6f} "
              f"({q1:.6f}, {q3:.6f}) -> {results[0].reads / med[name]:.0f} reads/s; stage "
              f"medians {stages} ({smi})", flush=True)
    print(f"[stream] warm median streamed / classic = {med['streamed'] / med['classic']:.4f} "
          f"({smi})", flush=True)
    return launches


def make_pair(fastq: str) -> list[str]:
    """Sample s0 cut into two mates of half its reads each (~150,000, a
    sars2-4ref.single mate), gzip level 1 as the benchmark's traffic
    (cached in .smoke_cache/)."""
    mates = [os.path.join(CACHE, f"pair_s0_{m}.fastq.gz") for m in (1, 2)]
    if all(os.path.exists(m) for m in mates):
        return mates
    with gzip.open(fastq, "rb") as fh:
        text = fh.read()
    cut = first_records(text, text.count(b"\n") // 8)
    for path, part in zip(mates, (text[:cut], text[cut:])):
        with open(path + ".tmp", "wb") as fh:
            fh.write(gzip.compress(part, 1))
        os.replace(path + ".tmp", path)
    return mates


def first_records(text: bytes, n: int) -> int:
    """The byte length of the first n 4-line FASTQ records of `text`."""
    nl = np.flatnonzero(np.frombuffer(text, np.uint8) == 10)
    if len(nl) < 4 * n:
        fail("card count", f"{len(nl) // 4} records where {n} are needed")
    return int(nl[4 * n - 1]) + 1


def run_pair(db: str, mates: list[str], out: str, counter: str):
    """`call -d db -1 mate1 -2 mate2 --pileup --counter counter` on the card."""
    cfg = cli.call_config(cli.build_parser().parse_args(
        ["call", "-d", db, "-1", mates[0], "-2", mates[1], "-o", out, "--pileup",
         "--counter", counter]))
    results = cli.run_call_cmd(cfg, device=None)
    if len(results) != 1:
        fail("card count", f"expected one sample result, got {len(results)}")
    return results[0]


def _pack_out(words: torch.Tensor, reads: int, malformed: bool):
    """The text pack's result as tensors to compare: (words, [reads, malformed])."""
    return words, torch.tensor([reads, int(malformed)])


@contextmanager
def card_parts(part_bytes: int):
    """A mate counted on the card in parts of `part_bytes` for the
    duration; yields the list of warnings the port logs meanwhile."""
    from bronko_tpu_torch.call import device_count

    warned = []

    class Keep(logging.Handler):
        def emit(self, record):
            warned.append(record.getMessage())

    handler, logger = Keep(logging.WARNING), logging.getLogger("bronko")
    old = device_count.PART_BYTES
    device_count.PART_BYTES = part_bytes
    logger.addHandler(handler)
    try:
        yield warned
    finally:
        logger.removeHandler(handler)
        device_count.PART_BYTES = old


def phase_card_count(db: str, fastqs: list[str], work: str, smi: str):
    """A lone pair streamed on the card under --counter auto, each mate
    counted there, against --counter host (module docstring, 15b), whole
    and in parts; then the text pack against its plain version at a mpxv
    mate's size and at a deep mate's part. Returns (the text pack's row,
    the part's numbers under `part`; the auto run's launch counts)."""
    mates = make_pair(fastqs[0])
    outs = {c: os.path.join(work, f"card_count_{c}") for c in ("auto", "host")}
    with stream_env():
        res, launches = drive(lambda: run_pair(db, mates, outs["auto"], "auto"))
        res_h, launches_h = drive(lambda: run_pair(db, mates, outs["host"], "host"))
    if {res.path, res_h.path} != {("hist", "streamed")}:
        fail("card count", f"paths {res.path} (auto), {res_h.path} (host)")
    on_card = (res.counts["device_counted"], res_h.counts["device_counted"])
    if on_card != (2, 0):
        fail("card count", f"device_counted {on_card} (auto, host), expected (2, 0)")
    text_pack = {n: (launches[n], launches_h[n]) for n in ("fastq_lines", "fastq_pack")}
    if text_pack != {"fastq_lines": (2, 0), "fastq_pack": (4, 0)}:
        fail("card count", f"text pack launches (auto, host) {text_pack}, expected "
                           "fastq_lines (2, 0) and fastq_pack (4, 0)")
    if res.best != res_h.best or not np.array_equal(res.tallies, res_h.tallies):
        fail("card count", "tallies or the selected genome differ from the host count's")
    if not np.array_equal(res.pileup, res_h.pileup):
        fail("card count", "pileups differ from the host count's")
    if read_outputs(outs["auto"]) != read_outputs(outs["host"]):
        fail("card count", "output files differ from the host count's")
    print(f"[card count] s0 as a pair of mates, both counted on the card: path "
          f"{res.path}, launches {launches}; tallies, genome {res.best}, pileup and "
          f"{', '.join(read_outputs(outs['auto']))} equal --counter host's; "
          f"{stage_line('card count auto', res, smi)}; "
          f"{stage_line('card count host', res_h, smi)}", flush=True)

    # the same pair, each mate counted in parts
    out_parts = os.path.join(work, "card_count_parts")
    with stream_env(), card_parts(CARD_PART_BYTES) as warned:
        res_p, launches_p = drive(lambda: run_pair(db, mates, out_parts, "auto"))
    parts = res_p.counts["count_parts"]
    if res_p.counts["device_counted"] != 2 or parts <= 2 or warned:
        fail("card count", f"in parts: device_counted {res_p.counts['device_counted']}, "
                           f"count_parts {parts}, warnings {warned}")
    if launches_p["fastq_lines"] != parts:
        fail("card count", f"in parts: {launches_p['fastq_lines']} fastq_lines launches "
                           f"for {parts} parts")
    if (res_p.best != res_h.best or not np.array_equal(res_p.tallies, res_h.tallies)
            or not np.array_equal(res_p.pileup, res_h.pileup)
            or read_outputs(out_parts) != read_outputs(outs["host"])):
        fail("card count", "in parts: results differ from the host count's")
    print(f"[card count] the pair in parts of {CARD_PART_BYTES} bytes: both mates on the card in {parts} parts, no warning, merge "
          f"{res_p.seconds['merge']:.4f} s; tallies, genome, pileup and files equal "
          f"--counter host's; {stage_line('card count parts', res_p, smi)}", flush=True)

    texts = []
    for fastq in fastqs:
        with gzip.open(fastq, "rb") as fh:
            texts.append(fh.read())
    joined = b"".join(texts)
    text = joined[:first_records(joined, MPXV_MATE_READS)]
    t = torch.frombuffer(bytearray(text), dtype=torch.uint8).to(CARD)
    row = {"max_abs_err": 0.0, "library_ms": None}
    row.update(_check_and_time(
        "fastq_pack", f"k={REPORT_K} {len(text)} bytes",
        lambda: _pack_out(*count.fastq_pack(t, REPORT_K)),
        lambda: _pack_out(*count.fastq_pack_plain(t, REPORT_K)), (t,), smi, row,
        phase="card count"))
    reads = count.fastq_pack(t, REPORT_K)[1]
    if reads != MPXV_MATE_READS:
        fail("card count", f"the text pack read {reads} records of {MPXV_MATE_READS}")
    del t
    row["part"] = _part_row(joined, smi, row)
    return row, launches


def _part_row(joined: bytes, smi: str, row: dict) -> dict:
    """The text pack against its plain version on one part as a deep mate
    gives it: PART_BYTES of `joined` (whole records from its start) and
    half a record, cut on the card after its last whole record (the cut
    held against the host's). Returns the part's bytes and numbers; the
    text pack's max_abs_err goes into `row`."""
    from bronko_tpu_torch.call import device_count

    size = device_count.PART_BYTES + first_records(joined, 1) // 2
    if len(joined) < size:
        fail("card count", f"{len(joined)} bytes of text where a part needs {size}")
    part = joined[:size]
    tp = torch.frombuffer(bytearray(part), dtype=torch.uint8).to(CARD)
    end = count.fastq_records_end(tp)
    nl = np.flatnonzero(np.frombuffer(part, np.uint8) == 10)
    records = len(nl) // 4
    if end != int(nl[4 * records - 1]) + 1 or end >= size:
        fail("card count", f"the part of {size} bytes was cut at {end}, the host cuts at "
                           f"{int(nl[4 * records - 1]) + 1}")
    t = tp[:end]
    out = _check_and_time(
        "fastq_pack", f"k={REPORT_K} one part, {end} bytes ({device_count.PART_BYTES} and "
                      f"half a record, cut after record {records})",
        lambda: _pack_out(*count.fastq_pack(t, REPORT_K)),
        lambda: _pack_out(*count.fastq_pack_plain(t, REPORT_K)), (t,), smi, row,
        phase="card count")
    reads = count.fastq_pack(t, REPORT_K)[1]
    if reads != records:
        fail("card count", f"the text pack read {reads} records of the part's {records}")
    return {"bytes": end, **out}


def _variants_tool():
    """tools/torch_kernel_variants.py, loaded by path (tools/ is no package):
    the floor of kernel (c), the addresses it takes and the long rows."""
    spec = importlib.util.spec_from_file_location(
        "torch_kernel_variants", os.path.join(REPO, "tools", "torch_kernel_variants.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def _directory_line(dev, smi: str) -> str:
    """The fixture's slot directory: slots, rows a slot (mean, the mean over
    keys of their slot's rows, the largest), bytes, and the build's time
    on the card (median of RUNS fresh builds)."""
    took = []
    for _ in range(RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        directory = cuda_map.probe_directory(dev.keys_ordered)
        torch.cuda.synchronize()
        took.append(time.perf_counter() - t0)
    if not torch.equal(directory.table, dev.probe_dir().table):
        fail("saved", "a fresh directory differs from the DeviceIndex's")
    sizes = torch.diff(directory.table).double()
    U, S = dev.keys.shape[0], sizes.shape[0]
    return (f"directory of the {U} keys: S = {S} slots (shift {directory.shift}), "
            f"{U / S:.2f} rows a slot, {float((sizes * sizes).sum()) / U:.2f} rows in a key's "
            f"slot on average, {float((sizes == 0).double().mean()):.3f} empty, the largest "
            f"{directory.widest} ({directory.steps()} bisection steps); "
            f"{directory.table.numel() * 4} bytes ({directory.table.numel() * 4 / U:.2f} a "
            f"key); built in {statistics.median(took) * 1e3:.3f} ms (median of {RUNS}; {smi})")


def _probe_cases(dev, q, counts):
    """Kernel (b)'s further cases at s0's batch: (label, q, counts,
    keys_ordered, offsets, hist). Skewed: the fixture's keys and a real
    key 2^64-1, which puts every other key in the directory's first three
    slots, queried by 7 k-mers; k = 31 wrap: 200,000 k-mers' bucket ids
    (1,024 near-all-T k-mers' past 2^63), 60% of them as keys; U = 1:
    the fixture's first key alone, queried by 7 k-mers."""
    rng = np.random.default_rng(SEED + 12)
    top = torch.full((1,), (1 << 63) - 1, dtype=torch.int64, device=CARD)  # 2^64-1, ordered
    q_top = q.clone()
    q_top[:7, 0] = -1
    cases = [("skewed, a real key 2^64-1", q_top, counts, torch.cat([dev.keys_ordered, top]),
              torch.cat([dev.offsets, dev.offsets[-1:] + 7]),
              torch.cat([dev.hist, dev.hist[:1]]))]
    kmers31, counts31 = _kernel_inputs(31, rng, CARD)
    kmers31, counts31 = kmers31[:200_000], counts31[:200_000]
    q31, _, _ = cuda_buckets.bucket_queries(kmers31, 31,
                                            tuple(filtered_bucket_positions(31, 2, False)))
    pick = torch.from_numpy(rng.random(q31.numel()) < 0.6).to(CARD)
    keys31 = torch.unique((q31.reshape(-1) ^ tmap.SIGN_BIT)[pick])
    sizes = torch.from_numpy(rng.integers(1, 16, size=keys31.shape[0])).to(CARD)
    offsets31 = torch.cat([sizes.new_zeros(1), torch.cumsum(sizes, 0)]).to(torch.int32)
    hist31 = torch.from_numpy(rng.integers(0, 1 << 31, size=keys31.shape[0], dtype=np.int64)
                              .astype(np.int32) & 0x0F0F0F0F).to(CARD)
    cases.append(("k=31 ids past 2^63", q31, counts31, keys31, offsets31, hist31))
    q_one = q.clone()
    q_one[:7] = dev.keys_ordered[0] ^ tmap.SIGN_BIT
    cases.append(("one key", q_one, counts, dev.keys_ordered[:1], dev.offsets[:2], dev.hist[:1]))
    return cases


def _saved_kernel_rows(dev, batch, best: int, smi: str) -> dict:
    """Kernels (b) and (c) against their plain versions at one sample's
    batch on the fixture's index: (b) on its own histogram, on int64
    words of 8 genomes with bit 63 set, and on the skewed, k = 31 and
    one-key tables (_probe_cases); (c) from the saved probe on the int32
    postings and on the int64 global ones read at genome `best`'s file
    base, and on long rows (the variants tool's long_rows); (c)'s floor
    beside each. Returns
    each one's row of the kernels line (its numbers at the fixture's own
    words and postings)."""
    kmers, counts = batch
    k = dev.k
    positions = tuple(filtered_bucket_positions(k, 2, False))
    q, _, _ = cuda_buckets.bucket_queries(kmers, k, positions)
    print(f"[saved] {_directory_line(dev, smi)}", flush=True)
    rng = np.random.default_rng(SEED + 11)
    hist8 = torch.from_numpy(rng.integers(0, 1 << 63, size=dev.hist.shape[0], dtype=np.int64)
                             | np.int64(-(1 << 63))).to(CARD)
    rows = {name: {"max_abs_err": 0.0, "library_ms": None}
            for name in ("probe_tally", "walk_scatter")}
    G = dev.num_genomes
    saved = None
    cases = [(f"G={G} {dev.hist.dtype} words", q, counts, dev.keys_ordered, dev.offsets,
              dev.hist),
             ("G=8 int64 words, bit 63 set", q, counts, dev.keys_ordered, dev.offsets, hist8),
             *_probe_cases(dev, q, counts)]
    for label, q_c, counts_c, keys, offsets, hist in cases:
        g = 8 if hist is hist8 else G
        directory = dev.probe_dir() if keys is dev.keys_ordered else cuda_map.probe_directory(keys)
        tallies = torch.zeros((g, 3), dtype=torch.int32, device=CARD)
        args = (q_c, counts_c, keys, directory, offsets, hist)
        got = cuda_map.probe_tally(*args, tallies)
        want_tallies = torch.zeros_like(tallies)
        want = cuda_map.probe_tally_plain(*args, want_tallies)
        err = max_abs_err((*got, tallies), (*want, want_tallies))
        torch.cuda.synchronize()
        rows["probe_tally"]["max_abs_err"] = max(rows["probe_tally"]["max_abs_err"], err)
        if err != 0.0:
            fail("saved", f"probe_tally differs from its plain version at {label}")
        scratch = torch.zeros_like(tallies)
        out = {"ms": median_ms(lambda: cuda_map.probe_tally(*args, scratch)),
               "plain_ms": median_ms(lambda: cuda_map.probe_tally_plain(*args, scratch)),
               "bound_ms": bound_ms((q_c, counts_c, keys, offsets, hist), (*got, tallies))}
        print(f"[saved] probe_tally B={q_c.shape[0]} J={q_c.shape[1]} U={keys.shape[0]} "
              f"{label}: equal; kernel {out['ms']:.4f} ms, plain {out['plain_ms']:.4f} ms, "
              f"bound {out['bound_ms']:.4f} ms (share {out['bound_ms'] / out['ms']:.3f}; "
              f"directory of {directory.table.numel() - 1} slots, the largest "
              f"{directory.widest}; {smi})", flush=True)
        if hist is dev.hist and keys is dev.keys_ordered:
            qs = q ^ tmap.SIGN_BIT
            out["library_ms"] = median_ms(
                lambda: torch.searchsorted(dev.keys_ordered, qs, right=True))
            print(f"[saved] torch.searchsorted alone on the same queries: "
                  f"{out['library_ms']:.4f} ms ({smi})", flush=True)
            rows["probe_tally"].update(out)
            saved, lanes = got[:2], got[2]

    start, h = saved
    pc = cuda_buckets.fold_table(kmers, counts, k)
    best_t = torch.full((1,), best, dtype=torch.int64, device=CARD)
    n_lanes = int(lanes[best])
    tool = _variants_tool()
    floor = tool.make_walk_floor(os.path.join(cuda_lib.BUILD_DIR, "floor"))
    long_pc, long_start, long_lens = tool.long_rows(dev, pc)
    for label, postings, base in (
            ("int32 postings", dev.pass2_postings(), None),
            ("int64 global postings, file base on the card", dev.global_postings(),
             dev.file_bases_t()),
            ("long rows: 255 postings or none, by (start, lens)", dev.pass2_postings(), None)):
        long = label.startswith("long")

        def walk(fn, pileup):
            if long:
                fn(pileup, long_pc, long_start, postings, k=k, lens=long_lens)
            else:
                fn(pileup, pc, start, postings, k=k, h=h, best=best_t, file_base=base)
            return pileup

        empty = torch.zeros((4, dev.g_total_len + 1, 4), dtype=torch.int32, device=CARD)
        got = walk(cuda_map.walk_scatter, empty.clone())
        err = max_abs_err((got,), (walk(cuda_map.walk_scatter_plain, empty.clone()),))
        torch.cuda.synchronize()
        walked = int(long_lens.sum()) if long else n_lanes
        rows["walk_scatter"]["max_abs_err"] = max(rows["walk_scatter"]["max_abs_err"], err)
        if err != 0.0 or int(got[2:].sum()) != walked:
            fail("saved", f"walk_scatter differs from its plain version with {label}")
        scratch = empty.clone()
        # each input read once, the walked postings alone, the pileup written once
        inputs = (long_pc, long_start, long_lens) if long else (pc, start, h, best_t)
        nbytes = (sum(t.numel() * t.element_size() for t in (*inputs, got))
                  + walked * postings.element_size())
        out = {"ms": median_ms(lambda: walk(cuda_map.walk_scatter, scratch)),
               "plain_ms": median_ms(lambda: walk(cuda_map.walk_scatter_plain, scratch)),
               "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
        rows_of = f"{long_lens.numel()} rows" if long else f"B={kmers.shape[0]} J={start.shape[1]}"
        lanes_of = f"{walked} lanes" + ("" if long else f" for genome {best}")
        print(f"[saved] walk_scatter {rows_of} {lanes_of}, {label}: "
              f"equal; kernel {out['ms']:.4f} ms, plain {out['plain_ms']:.4f} ms, bound "
              f"{out['bound_ms']:.4f} ms (share {out['bound_ms'] / out['ms']:.3f}; {smi})",
              flush=True)
        at, rec = tool.walk_addresses(*((long_start, long_lens) if long
                                        else tool.saved_ranges(start, h, best)), k)
        file_base = 0 if base is None else int(dev.file_bases[best])
        pc_walked = long_pc if long else pc
        floor_got = floor(empty.clone(), pc_walked, k, at, rec, postings, file_base)
        torch.cuda.synchronize()
        if not torch.equal(floor_got, got):
            fail("saved", f"the walk's floor differs from walk_scatter with {label}")
        floor_ms = median_ms(lambda: floor(scratch, pc_walked, k, at, rec, postings, file_base))
        print(f"[saved] walk_scatter's floor with {label} (the same posting, record and "
              f"pileup traffic on addresses computed beforehand, no walk): {floor_ms:.4f} ms, "
              f"bound {out['bound_ms']:.4f} ms; the kernel at {out['ms'] / floor_ms:.3f}x the "
              f"floor ({smi})", flush=True)
        if base is None and not long:
            rows["walk_scatter"].update(out)
    return rows


@contextmanager
def no_saved_probe():
    """PROBE_BYTES_CAP at 1 byte for the duration: no sample saves its
    probe, so each takes ('hist', 'subindex'): pass 1, the host's pick,
    pass 2 through the genome's sub-index, the path the single histogram
    word takes past the cap."""
    cap, engine.PROBE_BYTES_CAP = engine.PROBE_BYTES_CAP, 1
    try:
        yield
    finally:
        engine.PROBE_BYTES_CAP = cap


def phase_saved(db: str, fastqs: list[str], work: str, smi: str):
    """The classic path with the saved probe (a one-part PendingMap), which
    every classic sample on the single histogram word takes: s0-s2 through
    run_call on the card, all ('hist', 'saved'), against the same cohort
    through the sub-index on the card ('hist', 'subindex') and the run on
    the CPU; s0 enqueued under torch.cuda.set_sync_debug_mode('error') and
    resolved; kernels (b) and (c) against their plain versions at s0's
    batch. Returns ((b) and (c)'s kernel rows, the saved cohort's
    launches)."""
    index = load_index(db)

    def cohort(device, out):
        dev = build_device_index(index, device)
        cfg = call_args(db, fastqs, os.path.join(work, out), "host")
        return engine.run_call(cfg, index, dev), dev

    (saved, dev), launches = drive(lambda: cohort(CARD, "saved_gpu"))
    with no_saved_probe():
        subindex, _ = cohort(CARD, "saved_subindex")
    cpu, _ = cohort(torch.device("cpu"), "saved_cpu")
    for name, res, path in (("card, saved", saved, "saved"),
                            ("card, sub-index", subindex, "subindex"),
                            ("CPU, saved", cpu, "saved")):
        if [r.path for r in res] != [("hist", path)] * len(fastqs):
            fail("saved", f"{name}: paths {[r.path for r in res]}")
    for res in (subindex, cpu):
        for a, b in zip(saved, res):
            if (a.best != b.best or not np.array_equal(a.tallies, b.tallies)
                    or not np.array_equal(a.pileup, b.pileup)):
                fail("saved", f"{a.summary.filename}: tallies, genome or pileup differ")
    files = read_outputs(os.path.join(work, "saved_gpu"))
    if (files != read_outputs(os.path.join(work, "saved_subindex"))
            or files != read_outputs(os.path.join(work, "saved_cpu"))):
        fail("saved", "the saved cohort's files differ from the sub-index or the CPU run's")
    cfg = call_args(db, fastqs[0], work, "host")
    n_batches = sum(-(-(r.summary.n_perfect + r.summary.n_variant + r.summary.n_unmapped)
                      // cfg.batch_size) for r in saved)
    per_batch = [launches[n] for n in ("bucket_queries", "probe_tally", "fold_table",
                                       "walk_scatter")]
    if per_batch != [n_batches] * 4 or launches["pack_windows"] or launches["gather"]:
        fail("saved", f"launches {launches}, expected K1, (b), K2 and (c) {n_batches} each")
    print(f"[saved] {len(fastqs)} samples on a fresh DeviceIndex: paths ('hist', 'saved'); "
          f"tallies, genome {saved[0].best}, pileups and {len(files)} files equal the sub-index "
          f"card run and the CPU run; launches {launches} (K1, (b), K2 and (c) once "
          f"each a batch); {stage_line('saved s0', saved[0], smi)}", flush=True)

    counted = engine._count_job([fastqs[0]], cfg, index.k, CARD, upload=True)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        pending = engine._map_one(counted, index, dev, cfg)
        enqueue_s = time.perf_counter() - t0
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if not isinstance(pending, engine.PendingMap) or pending.path != ("hist", "saved"):
        fail("saved", f"s0 on the single histogram word took {type(pending).__name__}")
    mapped = pending.resolve(index, dev)
    if (mapped.best != saved[0].best or not np.array_equal(mapped.tallies, saved[0].tallies)
            or not np.array_equal(mapped.pileup, saved[0].pileup)):
        fail("saved", "the sample enqueued under the sync check differs from the cohort's")
    wall = ", ".join(f"{s} {mapped.seconds[s]:.6f}" for s in ("pass1", "pass2", "d2h"))
    print(f"[saved] s0 enqueued under set_sync_debug_mode('error'): no sync, enqueue "
          f"{enqueue_s:.6f}s; resolved equal to the cohort's s0; wall stages {wall} ({smi})",
          flush=True)

    rows = _saved_kernel_rows(dev, counted.batches[0], saved[0].best, smi)
    return rows, launches


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
    # every phase but the stream phase takes the classic path, as before
    # the streamed one existed; the stream phase sets the variables itself
    os.environ["BRONKO_NO_STREAM"] = "1"
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
    missing = [n for n in ("bucket_queries", "probe_tally", "fold_table", "walk_scatter")
               if launches[n] == 0]
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
    panel_res = phase_panel(genome_paths[0], fastq, planted, work, smi)
    rows["walk_hits"], flat_launches = phase_panel_flat(genome_paths[0], fastq, planted, work,
                                                        smi)
    cohort_launches = phase_cohort(db + ".bkdb", fastqs, work, smi)
    phase_profile(db + ".bkdb", fastq, work, smi)
    build_launches = phase_device_build(genome_paths, make_panel(genome_paths[0]), fastq, work,
                                        smi)
    mesh_launches = phase_mesh(db + ".bkdb", os.path.join(work, "panel32.bkdb"), fastqs, work,
                               smi)
    entry_launches = phase_entry(smi)
    phase_warm(db + ".bkdb", fastq, work, args.warm, smi)
    stream_launches = phase_stream(db + ".bkdb", os.path.join(work, "panel32.bkdb"), fastqs,
                                   work, ref, panel_res, args.warm, smi)
    rows["fastq_pack"], card_launches = phase_card_count(db + ".bkdb", fastqs, work, smi)
    with stream_env(BRONKO_NO_STREAM="1"):
        saved_rows, saved_launches = phase_saved(db + ".bkdb", fastqs, work, smi)
    rows.update(saved_rows)

    # each kernel's launches on its own path: K1, (b), K2 and (c) on the
    # main path, K3 on the device counter's, K4 on the gather probe's, the
    # text pack on the card-counted pair's
    launches["pack_windows"] = count_launches["pack_windows"]
    launches["gather"] = rows["gather"]["launches"]
    launches["walk_hits"] = flat_launches["walk_hits"]
    launches["fastq_pack"] = card_launches["fastq_pack"]
    print(f"[launches] main path {launches} (K3: the device counter's path; (d): the 300-strain "
          f"panel's call, {flat_launches}); device-counter "
          f"cohort {cohort_launches}; the card's index builds {build_launches}; mesh paths "
          f"{mesh_launches}; entry() {entry_launches}; streamed s0 {stream_launches}; "
          f"card-counted pair {card_launches}; saved cohort {saved_launches}", flush=True)
    kernels = [{
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches[name], "max_abs_err": rows[name]["max_abs_err"],
        "ms": rows[name]["ms"], "plain_ms": rows[name]["plain_ms"],
        "bound_ms": rows[name]["bound_ms"], "bound_by": "bytes",
        "library_ms": rows[name]["library_ms"],
        **({"part": rows[name]["part"]} if "part" in rows[name] else {}),
    } for name, (replaces, source) in KERNELS.items()]
    print(f"[wall] chip_smoke.py took {time.perf_counter() - t_start:.1f}s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
