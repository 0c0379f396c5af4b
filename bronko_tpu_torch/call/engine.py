"""Call orchestrator: count -> map -> select -> call -> write, per sample.

Counterpart of `bronko_tpu/call/engine.py` on one device. Each sample
(single-end [r], or paired [r1, r2] concatenated into one stream, as the
reference's two map_kmers passes into shared pileups, call.rs:301-320)
goes through:

  1. count (cfg.counter): the native C++ counter on the host, or the
     device counter of ops/count.py (window pack K3, sort, merge);
  2. h2d: the k-mers go to the device in batches of cfg.batch_size;
  3. pass 1 tallies perfect/variant/unique k-mers per genome; the tallies
     and the pass-2 walk lengths come back in one copy. With a histogram,
     postings grouped by genome and a probe within PROBE_BYTES_CAP it
     saves its probe (ops/map.tally_save); otherwise it tallies without
     one (ops/map.tally: histogram or flat);
  4. the host picks the best genome (pick_best_genome, f64, first maximum);
  5. pass 2 builds the selected genome's int32 pileup from the saved probe
     (ops/map.pileup_from_saved) or through the genome's sub-index
     (ops/map.pileup_from_subindex); d2h brings it back in one copy;
  6. call: the noise scan, the f64 filter cascade and the writers
     (call/noise.py, call/variants.py, call/outputs.py).

`run_call` pipelines a cohort as the JAX engine's `_run_call_inner` does
(engine.py:1449-1717): count workers count and upload the coming samples
(BRONKO_COUNT_WORKERS, at most workers + 1 submitted ahead), an
inflate-ahead worker inflates their gzip for the host counter under
BRONKO_INFLATE_BUDGET, the main thread runs each sample's device part in
turn (h2d when not done on a worker, pass 1, selection, pass 2, d2h), and
one caller thread runs step 6 with at most 2 samples in flight. Each
sample is isolated: a failure is logged and the run goes on. Summaries,
the overview and the alignment keep the input order. `process_sample` is
the same pieces for one sample, in series.

Batching cannot change a result: tallies are sums, the pileup sums and
maxima. Neither can the pipeline: each sample's device part runs on the
main thread in input order, and its writers on one thread in that order.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor, wait
from dataclasses import dataclass, fields

import numpy as np
import torch

from bronko_tpu_torch.call.noise import baseline_noise
from bronko_tpu_torch.call.outputs import (
    SampleSummary, write_alignments, write_overview, write_pileup, write_vcf,
)
from bronko_tpu_torch.call.variants import CallStats, VCFRecord, call_variants_for_seq
from bronko_tpu_torch.config import CallConfig
from bronko_tpu_torch.consts import KMER_COUNT_CAP
from bronko_tpu_torch.index.layout import DeviceIndex
from bronko_tpu_torch.index.model import BronkoIndex
from bronko_tpu_torch.io import native
from bronko_tpu_torch.io.fastq import read_fastq_chunks
from bronko_tpu_torch.io.naming import clean_sample_id
from bronko_tpu_torch.ops.codec import from_u64, kmer_to_string
from bronko_tpu_torch.ops.count import CountStats, KmerCounter
from bronko_tpu_torch.ops.map import (
    PLANE_CNT_FWD, PLANE_CNT_REV, PLANE_DEPTH_FWD, PLANE_DEPTH_REV,
    pileup_from_saved, pileup_from_subindex, tally, tally_save,
)
from bronko_tpu_torch.utils.memory import log_memory_usage

log = logging.getLogger("bronko")

STAGES = ("count", "h2d", "pass1", "pass2", "d2h", "call")

# cap on the saved pass-1 probe, which stays on the device until pass 2
# (JAX engine.py:51)
PROBE_BYTES_CAP = 512 << 20
# default bytes of inflated text the inflate-ahead worker may hold
# (BRONKO_INFLATE_BUDGET; a gzip file is charged at 8x its size)
INFLATE_BUDGET = 512 << 20


@dataclass
class SampleResult:
    summary: SampleSummary
    records: list[VCFRecord]
    tallies: np.ndarray          # (G, 3) int64 perfect / variant / unique
    best: int                    # selected genome
    pileup: np.ndarray           # (4, Tg+1, 4) int32, genome-local
    reads: int                   # reads counted
    seconds: dict[str, float]    # wall seconds by STAGES
    path: tuple[str, str]        # (pass-1 mode, pass 2: 'saved' or 'subindex')


def native_lib():
    """The native counter library (bronko_tpu_torch/native), built at first
    use (io/native.py)."""
    lib = native.get_lib()
    if lib is None:
        raise RuntimeError("the native library could not be built or loaded")
    return lib


def count_sample(path: str, cfg: CallConfig, k: int, device: torch.device,
                 threads: int | None = None,
                 text=None) -> tuple[np.ndarray, np.ndarray, CountStats]:
    """Count one FASTQ's k-mers (KMC -ci/-cs semantics). Returns (ascending
    uint64 k-mers, int64 counts, stats). cfg.counter: 'host' is the native
    counter on `threads` threads (default cfg.threads); 'device' the device
    counter on `device`; 'auto' the native counter, and the device counter
    after any exception from it (a library that fails to build or load, a
    file it rejects), as the JAX engine chooses (engine.py:79-94). `text`
    is the file's inflated text from the inflate-ahead worker (the native
    counter's only; it closes it)."""
    if cfg.counter in ("auto", "host"):
        try:
            native_lib()
            kmers, counts, st = native.native_count_fastq(
                path, k, cfg.min_kmers, KMER_COUNT_CAP,
                threads=max(1, threads or cfg.threads), text=text)
        except Exception as e:  # noqa: BLE001 — auto: any native failure
            if cfg.counter == "host":
                raise
            log.debug("host counter unavailable (%s); using the device counter", e)
        else:
            log.info("Counted %s with the host counter", path)
            return kmers, counts, CountStats(**st)
    out = _count_sample_device(path, cfg, k, device, *_read_chunks(path, cfg))
    log.info("Counted %s with the device counter on %s", path, device)
    return out


def _read_chunks(path: str, cfg: CallConfig):
    """(chunk iterator, row width): the native FASTQ reader's 512-wide
    rows, or the Python parser's (width None) when the library is missing."""
    try:
        native_lib()
    except RuntimeError:
        return read_fastq_chunks(path, cfg.chunk_reads), None
    return native.native_read_fastq_chunks(path, cfg.chunk_reads, max_len=512), 512


def _count_sample_device(path: str, cfg: CallConfig, k: int, device: torch.device,
                         chunks, native_width: int | None):
    """Feed read chunks to the device counter, each trimmed to its reads and
    to its longest read rounded up to 32 columns. Reads longer than the
    native reader's rows restart the file on the Python parser."""
    counter = KmerCounter(k, cfg.min_kmers, device=device)
    for codes, lengths, n_reads in chunks:
        max_len = int(lengths[:n_reads].max()) if n_reads else 0
        if native_width is not None and max_len > native_width:
            log.warning("reads longer than %d in %s; using Python parser",
                        native_width, path)
            return _count_sample_device(path, cfg, k, device,
                                        read_fastq_chunks(path, cfg.chunk_reads), None)
        width = min(-(-max(max_len, 1) // 32) * 32, codes.shape[1])
        counter.add_chunk(codes[:n_reads, :width], lengths[:n_reads], n_reads)
    kmers, counts = counter.finalize()
    return kmers, counts, counter.stats


@dataclass
class Counted:
    """One sample's count, from a count worker or the main thread."""
    kmers: np.ndarray            # ascending uint64
    counts: np.ndarray           # int64
    cstats: CountStats
    batches: list | None         # device batches (upload=True), else None
    seconds: dict[str, float]    # 'count', and 'h2d' when uploaded


def _count_job(paths: list[str], cfg: CallConfig, k: int, device: torch.device,
               threads: int | None = None, texts: list | None = None,
               upload: bool = False) -> Counted:
    """Count one sample: single-end [r], or paired [r1, r2] concatenated.
    `texts` holds one inflate-ahead future (or None) a path; every buffer
    is closed here, so a failed mate never pins its sibling's (JAX
    engine.py:1392-1405). With upload=True the device batches are built
    here too, on the calling worker thread."""
    t0 = time.perf_counter()
    try:
        parts = [count_sample(
            p, cfg, k, device, threads=threads,
            text=texts[i].result() if texts and texts[i] is not None else None)
            for i, p in enumerate(paths)]
    finally:
        for f in texts or []:
            if f is not None:
                try:
                    f.result().close()
                except Exception:  # noqa: BLE001 — the inflate itself failed
                    pass
    kmers = np.concatenate([p[0] for p in parts])
    counts = np.concatenate([p[1] for p in parts])
    cstats = CountStats(**{f.name: sum(getattr(p[2], f.name) for p in parts)
                           for f in fields(CountStats)})
    t1 = time.perf_counter()
    seconds = {"count": t1 - t0}
    batches = None
    if upload:
        # a copy from pageable host memory returns once it is done
        batches = to_batches(kmers, counts, cfg.batch_size, device)
        seconds["h2d"] = time.perf_counter() - t1
    return Counted(kmers, counts, cstats, batches, seconds)


def to_batches(kmers: np.ndarray, counts: np.ndarray, batch_size: int,
               device: torch.device):
    """Host k-mers and counts -> list of (kmers int64, counts int32) device
    batches of at most batch_size (one copy each way of the whole sample)."""
    km = from_u64(kmers, device)
    ct = torch.from_numpy(np.ascontiguousarray(counts, np.int32)).to(device)
    return list(zip(km.split(batch_size), ct.split(batch_size)))


def pick_best_genome(tallies: np.ndarray, dev: DeviceIndex) -> int | None:
    """argmax of perfect/(2*genome_len), strictly-positive only
    (call.rs:422-450): scores in f64, the first maximum wins."""
    best, best_score = None, 0.0
    for fid in range(dev.num_genomes):
        glen = int(dev.genome_lens[fid])
        if glen == 0:
            continue
        score = float(tallies[fid, 0]) / glen / 2.0
        log.debug("genome %d: perfect=%d variant=%d unique=%d score=%.4f",
                  fid, tallies[fid, 0], tallies[fid, 1], tallies[fid, 2], score)
        if score > best_score:
            best_score = score
            best = fid
    return best


def _select_and_log(tallies: np.ndarray, index: BronkoIndex, dev: DeviceIndex,
                    cstats: CountStats) -> tuple[int, tuple[int, int, int]]:
    """Genome selection + the reference's mapping-stat log lines
    (call.rs:238-248)."""
    best = pick_best_genome(tallies, dev)
    if best is None:
        log.error("Unable to pick a best genome")
        raise RuntimeError("Unable to pick a best genome")
    n_perfect, n_variant, n_unique = (int(x) for x in tallies[best])
    log.info("Selected a representative genome: %s", index.files[best].name)
    n_unmapped = cstats.unique_counted_kmers - n_perfect - n_variant
    log.info(
        "Mapped %d/%d kmers perfectly (%d unique among refs), %d/%d had a variant, %d unmapped",
        n_perfect, cstats.unique_counted_kmers, n_unique,
        n_variant, cstats.unique_counted_kmers, n_unmapped,
    )
    if cstats.unique_counted_kmers and (n_variant + n_perfect) / cstats.unique_counted_kmers < 0.2:
        log.warning(
            "Percent of kmers found is very low for this reference, suggesting lack of a "
            "representative reference, a bad sequencing run, contamination in sample, or some other issue"
        )
    return best, (n_perfect, n_variant, n_unmapped)


def call_sample_variants(index: BronkoIndex, dev: DeviceIndex, cfg: CallConfig,
                         best: int, pileup: np.ndarray):
    """Noise scan + filter cascade over every sequence of genome `best`,
    from its genome-local host pileup."""
    stats = CallStats()
    records: list[VCFRecord] = []
    seq_pileups: dict[str, tuple] = {}
    file_meta = index.files[best]
    slices = dev.slices_for_file(best)
    file_base = min(s.offset for s in slices) if slices else 0
    for sl in slices:
        seq_meta = file_meta.sequences[sl.seq_id]
        block = pileup[:, sl.offset - file_base:sl.offset - file_base + sl.length]
        fwd_depth = block[PLANE_DEPTH_FWD]
        rev_depth = block[PLANE_DEPTH_REV]
        seq_pileups[sl.name] = (fwd_depth, rev_depth)
        noise = baseline_noise(fwd_depth, rev_depth)
        records.extend(call_variants_for_seq(
            sl.name, seq_meta.seq,
            fwd_depth, rev_depth, block[PLANE_CNT_FWD], block[PLANE_CNT_REV],
            noise[:, 0],
            k=cfg.kmer,
            min_af=cfg.min_af,
            filter_end_seq=not cfg.no_end_filter,
            strand_filter=not cfg.no_strand_filter,
            no_strand_balance_filter=cfg.no_strand_balance_filter,
            strand_balance_ratio=cfg.strand_balance_ratio,
            strand_odds_max=cfg.strand_odds_max,
            n_per_strand=cfg.n_per_strand,
            min_depth=cfg.min_depth,
            min_variant_depth=cfg.min_variant_depth,
            variant_multiplier=cfg.variant_multiplier,
            stats=stats,
        ))
    log.info("Sample breadth of coverage: %s, depth of coverage: %s",
             stats.breadth, stats.depth)
    log.info("Called %d major variants, %d minor above maf = %s",
             stats.num_major, stats.num_minor, cfg.min_af)
    return records, stats, seq_pileups


def _finish_one(display_path: str, index: BronkoIndex, dev: DeviceIndex,
                cfg: CallConfig, best: int, pileup: np.ndarray,
                tally_triple: tuple[int, int, int]):
    """Host phase of one sample: call variants and write its outputs."""
    records, stats, seq_pileups = call_sample_variants(index, dev, cfg, best, pileup)
    if cfg.output_pileup:
        write_pileup(cfg.output, display_path, index.files[best], seq_pileups)
    write_vcf(cfg.output, display_path, records, index.files[best])
    summary = SampleSummary(display_path, index.files[best].name, stats,
                            *tally_triple)
    return summary, records


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _log_counted(display: str, cstats: CountStats, cfg: CallConfig, k: int) -> None:
    log.info("%d reads counted from %s", cstats.total_reads, display)
    log.info(
        "%d unique kmers above %d count, %d total unique kmers, "
        "%d total kmers (~%d basepairs)",
        cstats.unique_counted_kmers, cfg.min_kmers, cstats.unique_kmers,
        cstats.total_kmers, cstats.total_kmers * k,
    )


def _dump_counts(display: str, counted: Counted, cfg: CallConfig, k: int) -> None:
    """--keep-kmer-info: every kept k-mer and its count."""
    dump = os.path.join(cfg.output, clean_sample_id(display) + "_counts.txt")
    with open(dump, "w") as fh:
        for km, ct in zip(counted.kmers.tolist(), counted.counts.tolist()):
            fh.write(f"{kmer_to_string(km, k)}\t{ct}\n")


@dataclass
class Mapped:
    """One sample's device part, on the host."""
    best: int
    triple: tuple[int, int, int]  # perfect, variant, unmapped
    tallies: np.ndarray
    pileup: np.ndarray
    path: tuple[str, str]
    seconds: dict[str, float]     # 'pass1', 'pass2', 'd2h', and 'h2d' if done here


def _map_one(counted: Counted, index: BronkoIndex, dev: DeviceIndex,
             cfg: CallConfig) -> Mapped:
    """The device part of one sample: h2d (unless a count worker uploaded
    the batches), pass 1, selection, pass 2, d2h; the device synced at
    every stage boundary."""
    seconds = {}
    mcfg = dev.map_config(cfg.n_fixed, cfg.use_full_kmer)
    # no bucket survives the trim: nothing to map
    n_kmers = counted.kmers.shape[0] if len(mcfg.positions) else 0
    t = [time.perf_counter()]
    batches = counted.batches
    if batches is None:
        batches = to_batches(counted.kmers[:n_kmers], counted.counts[:n_kmers],
                             cfg.batch_size, dev.device)
        _sync(dev.device)
        seconds["h2d"] = time.perf_counter() - t[0]
        t = [time.perf_counter()]

    p1 = run_pass1(batches, dev, mcfg, n_kmers)
    log.info("Tallied %d kmers in %.2fs", n_kmers, time.perf_counter() - t[-1])
    best, triple = _select_and_log(p1.tallies, index, dev, counted.cstats)
    t.append(time.perf_counter())

    pileup_t = run_pass2(batches, dev, mcfg, p1, best)
    _sync(dev.device)
    log.info("Scattered pileup in %.2fs", time.perf_counter() - t[-1])
    t.append(time.perf_counter())
    pileup = pileup_t.cpu().numpy()
    t.append(time.perf_counter())
    seconds.update(pass1=t[1] - t[0], pass2=t[2] - t[1], d2h=t[3] - t[2])
    return Mapped(best, triple, p1.tallies, pileup, p1.path, seconds)


def _call_one(display: str, index: BronkoIndex, dev: DeviceIndex, cfg: CallConfig,
              mapped: Mapped, reads: int, seconds: dict[str, float]) -> SampleResult:
    """Step 6 for one sample (the caller thread's work), timed there;
    `seconds` holds the stages timed elsewhere."""
    t0 = time.perf_counter()
    summary, records = _finish_one(display, index, dev, cfg, mapped.best, mapped.pileup,
                                   mapped.triple)
    seconds = {**seconds, **mapped.seconds, "call": time.perf_counter() - t0}
    return SampleResult(summary, records, mapped.tallies, mapped.best, mapped.pileup,
                        reads, {s: seconds[s] for s in STAGES}, mapped.path)


def process_sample(job: list[str], index: BronkoIndex, dev: DeviceIndex,
                   cfg: CallConfig) -> SampleResult:
    """The whole main path for one sample (single-end [r] or paired
    [r1, r2]), in series: the cohort pipeline's pieces on one thread."""
    counted = _count_job(job, cfg, index.k, dev.device)
    _log_counted(job[0], counted.cstats, cfg, index.k)
    if cfg.keep_kmer_counts:
        _dump_counts(job[0], counted, cfg, index.k)
    mapped = _map_one(counted, index, dev, cfg)
    return _call_one(job[0], index, dev, cfg, mapped, counted.cstats.total_reads,
                     counted.seconds)


def saves_probe(dev: DeviceIndex, n_kmers: int, J: int) -> bool:
    """Whether pass 1 saves its probe for pass 2 (JAX engine.py:790-800):
    a histogram exists, postings are grouped by genome within a bucket,
    and the probe — an int32 start and the histogram words for each of
    the sample's n_kmers x J queries (the port pads no batch) — stays
    under PROBE_BYTES_CAP."""
    if dev.hist is not None:
        per_q = 4 + dev.hist.element_size()
    elif dev.hist_words is not None:
        per_q = 4 + 8 * dev.hist_words.shape[1]
    else:
        return False
    return dev.fid_grouped and n_kmers * J * per_q < PROBE_BYTES_CAP


@dataclass
class Pass1:
    tallies: np.ndarray      # (G, 3) int64 perfect / variant / unique
    lanes: np.ndarray        # (nb, G) int64 pass-2 walk length by batch and genome
    saved: list | None       # the saved probe, or None: pass 2 probes the sub-index
    path: tuple[str, str]    # (tally mode, 'saved' or 'subindex')


def run_pass1(batches, dev: DeviceIndex, mcfg, n_kmers: int) -> Pass1:
    """Pass 1 over the sample's device batches, the route chosen as the JAX
    engine's single-device dispatch does (engine.py:780-870); tallies and
    walk lengths come back in one copy."""
    G = dev.num_genomes
    mode = dev.tally_mode()
    saved = None
    if saves_probe(dev, n_kmers, len(mcfg.positions)):
        tallies_t, lanes_t, saved = tally_save(batches, dev, mcfg)
    else:
        tallies_t, lanes_t = tally(batches, dev, mcfg, mode)
    host = torch.cat([tallies_t.to(torch.int64).reshape(-1),
                      lanes_t.reshape(-1)]).cpu().numpy()
    return Pass1(host[:3 * G].reshape(G, 3), host[3 * G:].reshape(-1, G), saved,
                 (mode, "subindex" if saved is None else "saved"))


def run_pass2(batches, dev: DeviceIndex, mcfg, p1: Pass1, best: int) -> torch.Tensor:
    """Pass 2 for genome `best`: the (4, Tg+1, 4) int32 pileup on the device."""
    walk = p1.lanes[:, best].tolist()
    if p1.saved is None:
        return pileup_from_subindex(batches, dev.subindex(best), walk, mcfg, dev.g_total_len)
    return pileup_from_saved(batches, p1.saved, walk, dev.pass2_postings(), best, mcfg,
                             dev.g_total_len, int(dev.file_bases[best]))


def run_call(cfg: CallConfig, index: BronkoIndex, dev: DeviceIndex) -> list[SampleResult]:
    """Every -r file and every -1/-2 pair through the cohort pipeline, then
    the overview and the alignment. Returns the samples that succeeded, in
    input order; raises SystemExit(1) when every sample failed. With
    cfg.profile_dir the run is traced by torch.profiler (the device's
    kernels too on a CUDA device) into a Chrome trace there, written even
    when the run fails; a profiler that fails to start or stop only warns,
    as the JAX engine's does (engine.py:1427-1446)."""
    prof = None
    if cfg.profile_dir:
        try:
            prof = _start_profiler(cfg.profile_dir, dev.device)
            log.info("Profiling to %s", cfg.profile_dir)
        except Exception as e:  # noqa: BLE001
            log.warning("profiler unavailable: %s", e)
    try:
        return _run_call_inner(cfg, index, dev)
    finally:
        if prof is not None:
            try:
                prof.stop()
                trace = os.path.join(cfg.profile_dir,
                                     f"bronko.{os.getpid()}.{time.time_ns()}.pt.trace.json")
                prof.export_chrome_trace(trace)
                log.info("Wrote the profiler trace %s", trace)
            except Exception as e:  # noqa: BLE001
                log.warning("profiler stop failed: %s", e)


def _start_profiler(profile_dir: str, device: torch.device):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    return prof


def _count_workers(n_jobs: int) -> int:
    """BRONKO_COUNT_WORKERS, by default 2 on hosts of 4 or more cores when
    there is more than one sample, else 1 (JAX engine.py:1540-1547)."""
    default = 2 if (os.cpu_count() or 1) >= 4 and n_jobs > 1 else 1
    try:
        return max(1, int(os.environ.get("BRONKO_COUNT_WORKERS", str(default))))
    except ValueError:
        log.warning("BRONKO_COUNT_WORKERS is not an integer; using 1")
        return 1


class _InflateBudget:
    """Bytes of inflated text the inflate-ahead worker may hold at once
    (BRONKO_INFLATE_BUDGET; 0 turns the prefetch off). A gzip file is
    charged at 8x its size when submitted, and the charge comes back when
    its buffer closes (JAX engine.py:1577-1621)."""

    def __init__(self):
        try:
            self.limit = int(os.environ.get("BRONKO_INFLATE_BUDGET", str(INFLATE_BUDGET)))
        except ValueError:
            self.limit = INFLATE_BUDGET
        self.held = 0
        self._lock = threading.Lock()

    def charge(self, path: str):
        """Reserve one file's bytes; returns the callback that releases
        them, or None (no prefetch) when the file is missing or over budget."""
        try:
            est = os.path.getsize(path)
        except OSError:
            return None
        if path.endswith((".gz", ".bgz", ".bgzf")):
            est *= 8
        with self._lock:
            if self.held + est > self.limit:
                return None
            self.held += est

        def release():
            with self._lock:
                self.held -= est

        return release


def _run_call_inner(cfg: CallConfig, index: BronkoIndex,
                    dev: DeviceIndex) -> list[SampleResult]:
    os.makedirs(cfg.output, exist_ok=True)
    jobs = [[p] for p in cfg.reads] + [
        [r1, r2] for r1, r2 in zip(cfg.first_pairs, cfg.second_pairs)]
    workers = _count_workers(len(jobs))
    threads = max(1, cfg.threads // workers)
    upload = len(dev.map_config(cfg.n_fixed, cfg.use_full_kmer).positions) > 0
    budget = None
    if cfg.counter in ("auto", "host") and native.get_lib() is not None:
        budget = _InflateBudget()
    results: list[SampleResult] = []
    failures: list[str] = []

    with ThreadPoolExecutor(max_workers=workers) as pool, \
            ThreadPoolExecutor(max_workers=1) as call_pool, \
            ThreadPoolExecutor(max_workers=1) as inflate_pool:
        futures: list = []
        call_futs: list = []  # (label, display, future)

        def submit_upto(n: int) -> None:
            while len(futures) < min(n, len(jobs)):
                job = jobs[len(futures)]
                texts = None
                if budget is not None:
                    texts = []
                    for p in job:
                        release = budget.charge(p)
                        texts.append(None if release is None else inflate_pool.submit(
                            native.native_read_inflate, p, release))
                futures.append(pool.submit(_count_job, job, cfg, index.k, dev.device,
                                           threads, texts, upload))

        for ji, job in enumerate(jobs):
            submit_upto(ji + 1 + workers)
            # release the future: it would hold the sample's k-mers and
            # device batches for the rest of the run
            fut, futures[ji] = futures[ji], None
            display = job[0]
            label = display if len(job) == 1 else f"{job[0]}, {job[1]}"
            log.info("Processing %s", label)
            try:
                counted = fut.result()
                _log_counted(display, counted.cstats, cfg, index.k)
                log_memory_usage("Finished counting kmers", dev.device)
                if cfg.keep_kmer_counts:
                    _dump_counts(display, counted, cfg, index.k)
                mapped = _map_one(counted, index, dev, cfg)
                # the caller thread runs this sample while the next one
                # maps; at most 2 samples wait for it
                if len(call_futs) >= 2:
                    wait([call_futs[-2][2]])
                call_futs.append((label, display, call_pool.submit(
                    _call_one, display, index, dev, cfg, mapped,
                    counted.cstats.total_reads, counted.seconds)))
            except Exception:  # noqa: BLE001 — per-sample isolation
                log.exception("Sample %s failed; continuing with remaining samples", label)
                failures.append(display)

        for label, display, cf in call_futs:
            try:
                results.append(cf.result())
                log_memory_usage("Called variants successfully", dev.device)
            except Exception:  # noqa: BLE001 — per-sample isolation
                log.exception("Sample %s failed; continuing with remaining samples", label)
                failures.append(display)

    if failures and not results:
        log.error("All samples failed")
        raise SystemExit(1)
    if failures:
        log.warning("%d of %d samples processed; failed: %s",
                    len(results), len(jobs), ", ".join(failures))
    summaries = [r.summary for r in results]
    log.info("Printing overview")
    write_overview(cfg.output, summaries)
    if not failures:
        log.info("All samples processed successfully")
    if cfg.output_alignment:
        log.info("Building alignment(s)")
        write_alignments(cfg.output, summaries,
                         [(r.summary.filename, r.records) for r in results],
                         index.files, log)
    log.info("bronko complete!")
    return results
