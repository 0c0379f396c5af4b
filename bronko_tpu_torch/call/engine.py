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

Each sample's SampleResult.counts holds what it mapped: its kept k-mer
rows, its device batches and the index's histogram words a row; and how
it was counted: `piped`, its mates the native counter counted while they
inflated (io/native.py), and `device_counted`, its mates counted on the
card (call/device_count.py), each 0, 1 or 2, and `count_parts`, the parts
the card counted those mates in (one a mate within device_count.PART_BYTES
of text).

On one device a PendingMap holds steps 3-5 of a sample: pass 1 enqueued
over its parts (one for a classic sample, one a partition for a
streamed one) and the copy of the packed tallies and walk lengths, with
no host sync; its resolve() waits for that copy alone, picks the genome,
enqueues pass 2 and waits for the pileup's copy. Every copy goes to
page-locked memory behind an event, so resolve() may run on the caller
thread while the main thread enqueues the next sample: it does for a
classic sample with a saved probe, path (mode, 'saved'); a classic
sample without one is resolved at once on the main thread, path (mode,
'subindex'). pass1, pass2 and d2h stay wall seconds (each stage's
enqueue plus the resolve's wait for it).

`run_call` pipelines a cohort as the JAX engine's `_run_call_inner` does
(engine.py:1449-1717): count workers count and upload the coming samples
(BRONKO_COUNT_WORKERS, at most workers + 1 submitted ahead), an
inflate-ahead worker inflates their gzip for the host counter under
BRONKO_INFLATE_BUDGET, the main thread runs or enqueues each sample's
device part in turn (h2d when not done on a worker, pass 1, selection,
pass 2, d2h), and one caller thread resolves the pending ones and runs
step 6, with at most 2 samples in flight. Each sample is isolated: a
failure is logged and the run goes on. Summaries, the overview and the
alignment keep the input order. `process_sample` is
the same pieces for one sample, in series.

The streamed path (JAX engine.py:1059-1374): a lone sample, or a
cohort's first, may count into pass 1 instead. Under --counter auto on a
card each mate is counted there (call/device_count.py: its text read and
inflated on the host into page-locked blocks, mate 2 beside mate 1 on a
helper thread, then copied to the card a part at a time; the text pack,
a sort, the cap and the floor on the card, a deep mate's parts merged
there), and its kept k-mers go into pass 1 straight from the card, in
batches, as one part. Otherwise, and for a mate the card does not take,
the native counter finalizes one key-range partition at a time
(io/native.py: native_count_fastq_stream), and each partition is
uploaded from page-locked memory and its pass 1 enqueued while the host
sorts the next. Each part belongs to the sample's
PendingMap, resolved on the main thread. `_can_stream` streams every sample that
can: not under a mesh, --keep-kmer-info or the device counter, on an
index with a histogram and postings grouped by genome, with the native
library loaded, unless BRONKO_NO_STREAM=1 or BRONKO_STREAM=0;
BRONKO_STREAM_FIRST sets a cohort's first sample. The sample's path is
(mode, 'streamed'); its `count` stage runs until pass 1's copy is
enqueued after the last part, `h2d` is 0 and `pass1` is the wait
for the tallies on the host.

Every stage is timed by a span (utils/spans.py): its wall seconds add
into the sample's SampleResult.seconds, and under torch.profiler it is a
`bronko.<name>` range on the thread that ran it. Beside the six STAGES,
the seconds hold SPAN_KEYS, the parts of `count` (io/native.py: inflate,
parse, finalize, text_wait; for a mate counted on the card,
call/device_count.py: the read and inflate into page-locked blocks in
inflate, the copy to the card and the text pack in parse, each part's
sort in finalize (a mate in one part: its cap and floor too), the sum
of a mate's parts, the cap and the floor in `merge` where it took more;
`dispatch`, the streamed path's uploads and pass-1 enqueues), the main
thread's wait for the sample's count (`count_wait`), so that count ~
inflate - inflate_ahead + text_wait + parse + finalize + merge +
dispatch, and the parts of `call` (`noise`, the noise
scan; `variants`, the filter cascade; `write`, the writers), so that
call ~ noise + variants + write. Ranges with no seconds name what a
thread waits on or works in: `map.rows=<n>.batches=<n>.words=<n>` (the
main thread's device part, named with the sample's counts; on the
streamed path, its resolve), `caller_wait`, `resolve`, and
`sample.<input position>` around each thread's share of a sample.

Batching cannot change a result: tallies are sums, the pileup sums and
maxima. Neither can the pipeline: each sample's device part runs on the
main thread in input order, and its writers on one thread in that order.

Across torch.distributed ranks (parallel/), one a device: under --mesh
DxG a ShardedMapper runs steps 2-5 of every sample over the ranks (the
collectives on the main thread, in input order), every rank holds the
merged result and rank 0 writes; under --shard-samples each rank runs
whole samples (jobs[rank::world]), writes their files, and the results
gather to every rank in input order for rank 0's overview.
"""

from __future__ import annotations

import logging
import os
import pickle
import threading
import time
from concurrent.futures import ThreadPoolExecutor, wait
from dataclasses import dataclass, fields, replace

import numpy as np
import torch

from bronko_tpu_torch.call import device_count
from bronko_tpu_torch.call.noise import baseline_noise
from bronko_tpu_torch.call.outputs import (
    SampleSummary, write_alignments, write_overview, write_pileup, write_vcf,
)
from bronko_tpu_torch.call.variants import CallStats, VCFRecord, call_variants_for_seq
from bronko_tpu_torch.config import CallConfig
from bronko_tpu_torch.consts import KMER_COUNT_CAP
from bronko_tpu_torch.index.layout import DeviceIndex, load_subindex
from bronko_tpu_torch.index.model import BronkoIndex
from bronko_tpu_torch.io import native
from bronko_tpu_torch.io.fastq import read_fastq_chunks
from bronko_tpu_torch.io.naming import clean_sample_id
from bronko_tpu_torch.ops.codec import from_u64, kmer_to_string
from bronko_tpu_torch.ops.count import CountStats, KmerCounter
from bronko_tpu_torch.ops.map import (
    PLANE_CNT_FWD, PLANE_CNT_REV, PLANE_DEPTH_FWD, PLANE_DEPTH_REV, pileup_from_saved,
    pileup_from_subindex, tally, tally_save,
)
from bronko_tpu_torch.parallel import distributed
from bronko_tpu_torch.parallel.distributed import allgather_bytes, is_primary
from bronko_tpu_torch.parallel.mesh import make_mesh
from bronko_tpu_torch.parallel.pipeline import (
    route_split, routed_pileup, routed_tally, sharded_pileup, sharded_tally, split_index,
    upload_chunk, upload_shard,
)
from bronko_tpu_torch.utils.memory import log_memory_usage
from bronko_tpu_torch.utils.spans import sample_span, span

log = logging.getLogger("bronko")

STAGES = ("count", "h2d", "pass1", "pass2", "d2h", "call")
# the spans' seconds beside the stages (the module's docstring); 0 where a
# sample's path has no such span
SPAN_KEYS = ("inflate", "inflate_ahead", "parse", "finalize", "merge", "text_wait",
             "dispatch", "count_wait", "noise", "variants", "write")

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
    pileup: np.ndarray | None    # (4, Tg+1, 4) int32, genome-local; None for a
    #                              sample another rank mapped (--shard-samples)
    reads: int                   # reads counted
    seconds: dict[str, float]    # wall seconds by STAGES, then by SPAN_KEYS
    counts: dict[str, int]       # rows (kept k-mers mapped), batches (device batches),
    #                              words (histogram words a row; 0 without one),
    #                              piped (mates counted while they inflated),
    #                              device_counted (mates counted on the card),
    #                              count_parts (the parts those mates took)
    path: tuple[str, str]        # (pass-1 mode, pass 2: 'saved', 'subindex' or
    #                              'streamed')


def native_lib():
    """The native counter library (bronko_tpu_torch/native), built at first
    use (io/native.py)."""
    lib = native.get_lib()
    if lib is None:
        raise RuntimeError("the native library could not be built or loaded")
    return lib


def count_sample(path: str, cfg: CallConfig, k: int, device: torch.device,
                 threads: int | None = None, text=None,
                 seconds: dict[str, float] | None = None,
                 counters: dict[str, int] | None = None
                 ) -> tuple[np.ndarray, np.ndarray, CountStats]:
    """Count one FASTQ's k-mers (KMC -ci/-cs semantics). Returns (ascending
    uint64 k-mers, int64 counts, stats). cfg.counter: 'host' is the native
    counter on `threads` threads (default cfg.threads); 'device' the device
    counter on `device`; 'auto' the native counter, and the device counter
    after any exception from it (a library that fails to build or load, a
    file it rejects), as the JAX engine chooses (engine.py:79-94). `text`
    is the file's inflated text from the inflate-ahead worker (the native
    counter's only; it closes it). The native counter's spans add their
    seconds into `seconds`, and a file it counted while it inflated adds
    1 to counters["piped"]."""
    if cfg.counter in ("auto", "host"):
        try:
            native_lib()
            kmers, counts, st = native.native_count_fastq(
                path, k, cfg.min_kmers, KMER_COUNT_CAP,
                threads=max(1, threads or cfg.threads), text=text, seconds=seconds,
                counters=counters)
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
    seconds: dict[str, float]    # 'count' and its parts, and 'h2d' when uploaded
    piped: int = 0               # mates the native counter counted while they inflated


def _count_job(paths: list[str], cfg: CallConfig, k: int, device: torch.device,
               threads: int | None = None, texts: list | None = None,
               upload: bool = False, pos: int | None = None) -> Counted:
    """Count one sample: single-end [r], or paired [r1, r2] concatenated.
    `texts` holds one inflate-ahead future (or None) a path; every buffer
    is closed here, so a failed mate never pins its sibling's (JAX
    engine.py:1392-1405). With upload=True the device batches are built
    here too, on the calling worker thread. `pos` is the sample's input
    position, for its range in a trace."""
    seconds: dict[str, float] = {}
    counters = {"piped": 0}
    with sample_span(pos):
        with span("count", seconds):
            try:
                parts = []
                for i, p in enumerate(paths):
                    text = None
                    if texts and texts[i] is not None:
                        with span("count.text_wait", seconds, "text_wait"):
                            text = texts[i].result()
                    parts.append(count_sample(p, cfg, k, device, threads=threads, text=text,
                                              seconds=seconds, counters=counters))
            finally:
                for f in texts or []:
                    if f is not None:
                        try:
                            f.result().close()
                        except Exception:  # noqa: BLE001 — the inflate itself failed
                            pass
            with span("count.finalize", seconds, "finalize"):
                kmers = np.concatenate([p[0] for p in parts])
                counts = np.concatenate([p[1] for p in parts])
            cstats = CountStats(**{f.name: sum(getattr(p[2], f.name) for p in parts)
                                   for f in fields(CountStats)})
        batches = None
        if upload:
            # a copy from pageable host memory returns once it is done
            with span("h2d", seconds):
                batches = to_batches(kmers, counts, cfg.batch_size, device)
    return Counted(kmers, counts, cstats, batches, seconds, counters["piped"])


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
                         best: int, pileup: np.ndarray,
                         seconds: dict[str, float] | None = None):
    """Noise scan + filter cascade over every sequence of genome `best`,
    from its genome-local host pileup. The two spans add into `seconds`
    (keys noise and variants) and leave little of the call outside them:
    `noise` holds the slicing and every sequence's scan, `variants` every
    sequence's cascade and its log lines."""
    with span("call.noise", seconds, "noise"):
        stats = CallStats()
        records: list[VCFRecord] = []
        seq_pileups: dict[str, tuple] = {}
        file_meta = index.files[best]
        slices = dev.slices_for_file(best)
        file_base = min(s.offset for s in slices) if slices else 0
        scanned = []
        for sl in slices:
            block = pileup[:, sl.offset - file_base:sl.offset - file_base + sl.length]
            fwd_depth = block[PLANE_DEPTH_FWD]
            rev_depth = block[PLANE_DEPTH_REV]
            seq_pileups[sl.name] = (fwd_depth, rev_depth)
            scanned.append((sl, block, baseline_noise(fwd_depth, rev_depth)))
    with span("call.variants", seconds, "variants"):
        for sl, block, noise in scanned:
            records.extend(call_variants_for_seq(
                sl.name, file_meta.sequences[sl.seq_id].seq,
                block[PLANE_DEPTH_FWD], block[PLANE_DEPTH_REV],
                block[PLANE_CNT_FWD], block[PLANE_CNT_REV],
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
                tally_triple: tuple[int, int, int], seconds: dict[str, float] | None = None):
    """Host phase of one sample: call variants and write its outputs. In a
    world of several ranks every rank calls; rank 0 alone writes, unless
    each rank owns its samples (--shard-samples; JAX engine.py:1046-1054).
    The spans add into `seconds` (noise, variants, write)."""
    records, stats, seq_pileups = call_sample_variants(index, dev, cfg, best, pileup, seconds)
    with span("call.write", seconds, "write"):
        if is_primary() or cfg.shard_samples:
            if cfg.output_pileup:
                write_pileup(cfg.output, display_path, index.files[best], seq_pileups)
            write_vcf(cfg.output, display_path, records, index.files[best])
        summary = SampleSummary(display_path, index.files[best].name, stats,
                                *tally_triple)
    return summary, records


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _log_counted(display: str, cstats: CountStats, cfg: CallConfig, k: int,
                 piped: int) -> None:
    log.info("%d reads counted from %s, %d mate(s) while they inflated",
             cstats.total_reads, display, piped)
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
    counts: dict[str, int]        # SampleResult.counts


def _event(device: torch.device):
    """On a card, an event recorded on the current stream, whose
    synchronize() waits for the work enqueued before it alone; else None."""
    if device.type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    return event


def _wait(event) -> None:
    """Block the calling thread until `event` (an _event) has passed."""
    if event is not None:
        event.synchronize()


def _copy_to_host(t: torch.Tensor) -> torch.Tensor:
    """Enqueue a copy of a device tensor into page-locked host memory and
    return the host tensor, valid once the stream has passed the copy (an
    event after it); a CPU tensor is returned as it is."""
    if t.device.type != "cuda":
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host


def _pass1(batches, rows: int, dev: DeviceIndex, mcfg, probe_bytes: int):
    """Pass 1 of one part of a sample: `rows` k-mers in `batches`. It saves
    its probe (tally_save) while the sample's probe bytes so far, this
    part's included, stay within PROBE_BYTES_CAP, on an index with a
    histogram and postings grouped by genome (JAX engine.py:790-800,
    :1137-1208; the port pads no batch); otherwise it tallies without one
    (tally, in the index's own mode). Enqueued with no host sync. Returns
    (tallies (G, 3) int32, the part (batches, lanes (nb, G) int64, saved
    | None), the probe bytes so far)."""
    per_q = probe_bytes_per_query(dev)
    if per_q is not None and dev.fid_grouped:
        probe_bytes += rows * len(mcfg.positions) * per_q
        if probe_bytes <= PROBE_BYTES_CAP:
            tallies, lanes, saved = tally_save(batches, dev, mcfg)
            return tallies, (batches, lanes, saved), probe_bytes
    tallies, lanes = tally(batches, dev, mcfg, dev.tally_mode())
    return tallies, (batches, lanes, None), probe_bytes


def _copy_pass1(tallies: torch.Tensor, parts: list):
    """Enqueue the copy of the tallies and every part's walk lengths, packed
    in one int64 vector as JAX's `meta` (engine.py:874-881). Returns
    (the vector on the device, its host copy, the copy's event)."""
    meta = torch.cat([tallies.to(torch.int64).reshape(-1)]
                     + [lanes.reshape(-1) for _, lanes, _ in parts])
    return meta, _copy_to_host(meta), _event(meta.device)


@dataclass
class PendingMap:
    """One sample's device part on one device, enqueued with no host sync
    (JAX engine.py:884-913, :1077-1134): pass 1 over each part, and the
    copy of the packed tallies and walk lengths (_copy_pass1). resolve()
    waits for that copy alone, picks the genome on the host, enqueues
    pass 2 and the pileup's copy, and waits for each behind an event, so
    it may run on a thread other than the one that enqueued."""
    parts: list               # [(batches, lanes (nb, G) int64 on the device, saved | None)]
    meta: torch.Tensor        # (3G + nb*G,) int64 on the device; held until copied
    meta_host: torch.Tensor   # its host copy
    ready: torch.cuda.Event | None  # the copy's event (None off a card)
    mcfg: object
    n_kmers: int
    cstats: CountStats
    t_start: float            # the log's "Tallied" counts from here
    path: tuple[str, str]     # SampleResult.path
    # the sample's seconds so far; resolve() adds its wait into pass1, and
    # pass2 and d2h. The time the sample waits for its resolve() lies in
    # no stage.
    seconds: dict[str, float]
    counts: dict[str, int]    # SampleResult.counts

    def resolve(self, index: BronkoIndex, dev: DeviceIndex) -> Mapped:
        """The tallies and walk lengths, the genome selection
        (pick_best_genome), then pass 2 over every part; the pileup on the
        host."""
        G = dev.num_genomes
        with span("pass1", self.seconds):
            _wait(self.ready)
            meta = self.meta_host.numpy()
            tallies = meta[:3 * G].reshape(G, 3).copy()
            walks = np.split(meta[3 * G:].reshape(-1, G),
                             np.cumsum([len(b) for b, _, _ in self.parts])[:-1])
            log.info("Tallied %d kmers in %.2fs%s", self.n_kmers,
                     time.perf_counter() - self.t_start,
                     " (streamed)" if self.path[1] == "streamed" else "")
            best, triple = _select_and_log(tallies, index, dev, self.cstats)
        with span("pass2", self.seconds) as sp:
            pileup_t = self._pass2(dev, walks, best)
            _wait(_event(dev.device))
            log.info("Scattered pileup in %.2fs", sp.elapsed())
        with span("d2h", self.seconds):
            host = _copy_to_host(pileup_t)
            _wait(_event(dev.device))
            pileup = host.numpy().copy()
        return Mapped(best, triple, tallies, pileup, self.path, self.seconds, self.counts)

    def _pass2(self, dev: DeviceIndex, walks: list, best: int) -> torch.Tensor:
        """Genome `best`'s pileup on the device: the saved parts from their
        probe (pileup_from_saved), the others through the genome's
        sub-index (pileup_from_subindex) with the exact walk lengths of
        their own pass 1; two pileups merge plane by plane, depth max and
        counts add."""
        groups = {True: ([], [], []), False: ([], [], [])}  # saved: batches, probe, walk
        for (batches, _, saved), walk in zip(self.parts, walks):
            b, probe, w = groups[saved is not None]
            b += batches
            probe += saved or []
            w += walk[:, best].tolist()
        pileups = []
        if groups[True][0]:
            b, probe, w = groups[True]
            pileups.append(pileup_from_saved(b, probe, w, dev.pass2_postings(), best,
                                             self.mcfg, dev.g_total_len,
                                             int(dev.file_bases[best])))
        if groups[False][0]:
            b, _, w = groups[False]
            pileups.append(pileup_from_subindex(b, dev.subindex(best), w, self.mcfg,
                                                dev.g_total_len))
        if len(pileups) == 2:
            a, b = pileups
            pileups = [torch.cat([torch.maximum(a[:2], b[:2]), a[2:] + b[2:]])]
        return pileups[0] if pileups else torch.zeros(
            (4, dev.g_total_len + 1, 4), dtype=torch.int32, device=dev.device)


def _map_one(counted: Counted, index: BronkoIndex, dev: DeviceIndex,
             cfg: CallConfig, mapper: ShardedMapper | None = None):
    """The device part of one sample. On one device it enqueues pass 1 and
    its copy as a one-part PendingMap: one that saved its probe is
    returned for the caller thread to resolve, as in JAX's engine
    (engine.py:753-881); one that did not is resolved here. Under a
    mapper (--mesh, whose collectives run on this thread) it returns the
    Mapped sample: pass 1, selection, pass 2 and d2h, the device synced at
    every stage boundary. h2d is done here unless a count worker uploaded
    the batches. All of it runs in the range `map`, named with the
    sample's counts."""
    mcfg = dev.map_config(cfg.n_fixed, cfg.use_full_kmer)
    # no bucket survives the trim: nothing to map
    n_kmers = counted.kmers.shape[0] if len(mcfg.positions) else 0
    mapped_counts = {**map_counts(n_kmers, -(-n_kmers // cfg.batch_size), dev),
                     "piped": counted.piped, "device_counted": 0, "count_parts": 0}
    with span(map_range(mapped_counts)):
        seconds: dict[str, float] = {}
        device = dev.device if mapper is None else mapper.device
        t_start = time.perf_counter()  # the log's "Tallied" counts from here
        batches = counted.batches
        if batches is None:
            with span("h2d", seconds):
                kmers, counts = counted.kmers[:n_kmers], counted.counts[:n_kmers]
                batches = (to_batches(kmers, counts, cfg.batch_size, device) if mapper is None
                           else mapper.place_batches(kmers, counts, cfg.batch_size))
                _sync(device)
        if mapper is None:
            with span("pass1", seconds):
                tallies, part, _ = _pass1(batches, n_kmers, dev, mcfg, 0)
                saved = part[2] is not None
                pending = PendingMap([part], *_copy_pass1(tallies, [part]), mcfg, n_kmers,
                                     counted.cstats, t_start,
                                     (dev.tally_mode(), "saved" if saved else "subindex"),
                                     seconds, mapped_counts)
            return pending if saved else pending.resolve(index, dev)

        with span("pass1", seconds) as sp:
            p1 = mapper.run_tallies(batches, mcfg)
            log.info("Tallied %d kmers in %.2fs", n_kmers, sp.elapsed())
            best, triple = _select_and_log(p1.tallies, index, dev, counted.cstats)
        with span("pass2", seconds) as sp:
            pileup_t = mapper.run_pileup(batches, mcfg, best, dev.g_total_len)
            _sync(device)
            log.info("Scattered pileup in %.2fs", sp.elapsed())
        with span("d2h", seconds):
            pileup = pileup_t.cpu().numpy()
        return Mapped(best, triple, p1.tallies, pileup, p1.path, seconds, mapped_counts)


def _call_one(display: str, index: BronkoIndex, dev: DeviceIndex, cfg: CallConfig,
              mapped, reads: int, seconds: dict[str, float],
              pos: int | None = None) -> SampleResult:
    """Step 6 for one sample (the caller thread's work), timed there, after
    resolving a pending device part (JAX engine.py:1037-1040); `seconds`
    holds the stages timed elsewhere. `pos` is the sample's input
    position, for its range in a trace."""
    own: dict[str, float] = {}
    with sample_span(pos):
        if isinstance(mapped, PendingMap):
            with span("resolve"):
                mapped = mapped.resolve(index, dev)
        with span("call", own):
            summary, records = _finish_one(display, index, dev, cfg, mapped.best,
                                           mapped.pileup, mapped.triple, own)
    seconds = {**seconds, **mapped.seconds, **own}
    return SampleResult(summary, records, mapped.tallies, mapped.best, mapped.pileup, reads,
                        {**{s: seconds[s] for s in STAGES},
                         **{s: seconds.get(s, 0.0) for s in SPAN_KEYS}},
                        mapped.counts, mapped.path)


def process_sample(job: list[str], index: BronkoIndex, dev: DeviceIndex,
                   cfg: CallConfig) -> SampleResult:
    """The whole main path for one sample (single-end [r] or paired
    [r1, r2]), in series: the cohort pipeline's pieces on one thread."""
    with sample_span(0):
        counted = _count_job(job, cfg, index.k, dev.device)
        _log_counted(job[0], counted.cstats, cfg, index.k, counted.piped)
        if cfg.keep_kmer_counts:
            _dump_counts(job[0], counted, cfg, index.k)
        mapped = _map_one(counted, index, dev, cfg)
        return _call_one(job[0], index, dev, cfg, mapped, counted.cstats.total_reads,
                         counted.seconds)


def hist_words(dev: DeviceIndex) -> int:
    """Histogram words a row of the index: 1 for the single word, W for
    the multi-word histogram, 0 without one (the flat tally)."""
    if dev.hist is not None:
        return 1
    return 0 if dev.hist_words is None else int(dev.hist_words.shape[1])


def map_counts(rows: int, batches: int, dev: DeviceIndex) -> dict[str, int]:
    """What a sample maps, for its SampleResult.counts, which are also
    logged."""
    words = hist_words(dev)
    log.info("Mapping %d kept k-mer rows in %d device batch(es) against %d genomes, "
             "%d histogram word(s) a row", rows, batches, dev.num_genomes, words)
    return {"rows": rows, "batches": batches, "words": words}


def map_range(counts: dict[str, int]) -> str:
    """The name of a sample's `map` range, which carries what it maps into
    a trace (a range keeps its name but not its arguments)."""
    return "map.rows={rows}.batches={batches}.words={words}".format(**counts)


def probe_bytes_per_query(dev: DeviceIndex) -> int | None:
    """Bytes of the saved probe a (k-mer, bucket) query holds: an int32
    start and its histogram words; None without a histogram."""
    if dev.hist is not None:
        return 4 + dev.hist.element_size()
    if dev.hist_words is not None:
        return 4 + 8 * dev.hist_words.shape[1]
    return None


@dataclass
class Pass1:
    """A mesh's pass 1 (ShardedMapper.run_tallies), on the host."""
    tallies: np.ndarray      # (G, 3) int64 perfect / variant / unique
    lanes: np.ndarray        # (nb, G) int64 pass-2 walk length by batch and genome
    #                          (over a mesh (1, G): the whole sample's)
    path: tuple[str, str]    # (tally mode, 'subindex', or 'saved' by the routed mesh)


# --- the streamed single-sample path (JAX engine.py:1059-1374) ---------------

def _env_flag(name: str) -> bool:
    """Truthiness of an env toggle: '', '0', 'false', 'no' and 'off' are
    off (a presence check would read BRONKO_X=0 as on)."""
    return os.environ.get(name, "").strip().lower() not in ("", "0", "false", "no", "off")


def _can_stream(cfg: CallConfig, dev: DeviceIndex, mapper) -> bool:
    """Whether a sample takes the streamed path: it does unless something
    keeps it classic, in JAX's order (engine.py:1324-1374): a mesh,
    --keep-kmer-info or the device counter; BRONKO_NO_STREAM or
    BRONKO_STREAM=0; an index without a histogram or with postings not
    grouped by genome; a native library that did not build or load."""
    if mapper is not None or cfg.keep_kmer_counts or cfg.counter == "device":
        return False
    if _env_flag("BRONKO_NO_STREAM"):
        return False
    if os.environ.get("BRONKO_STREAM", "").strip().lower() in ("0", "false", "no", "off"):
        return False
    if (dev.hist is None and dev.hist_words is None) or not dev.fid_grouped:
        return False
    try:
        native_lib()
    except Exception:  # noqa: BLE001 — the library did not build or load
        return False
    return True


def _streams_first(cfg: CallConfig, dev: DeviceIndex, mapper, n_jobs: int) -> bool:
    """Whether the first of `n_jobs` samples streams (JAX
    engine.py:1512-1575): a lone sample when the gate says so; a cohort's
    first when BRONKO_STREAM_FIRST=1 and the gate lets it, not when
    BRONKO_STREAM_FIRST=0, and with the variable unset when the gate says
    so."""
    if n_jobs < 1:
        return False
    if n_jobs > 1 and os.environ.get("BRONKO_STREAM_FIRST", "").strip():
        return _env_flag("BRONKO_STREAM_FIRST") and _can_stream(cfg, dev, mapper)
    return _can_stream(cfg, dev, mapper)


def _stream_pass1(paths: list[str], index: BronkoIndex, dev: DeviceIndex, cfg: CallConfig,
                  threads: int) -> PendingMap:
    """Streamed count -> tally (JAX engine.py:1137-1208): each mate counted
    on the card where device_count.usable says so (its kept k-mers one
    part, already there), else by the native counter one key-range
    partition at a time (each uploaded while the host sorts the next);
    each part is cut into batches of cfg.batch_size and its pass 1
    enqueued (_pass1), a part of the returned PendingMap; pass 1's copy is
    enqueued after the last. Beyond the card's count (a few small copies a
    mate) no host sync happens here: resolve() makes the sample's one.
    Parts cover disjoint key ranges or mates and tallies are sums, so the
    result is the classic path's. The count's parts go into the sample's
    seconds (io/native.py, call/device_count.py), each part's upload and
    enqueue and the copy's into `dispatch`."""
    seconds = {"h2d": 0.0}
    counters = {"piped": 0, "device_counted": 0, "count_parts": 0}
    with span("count", seconds) as count_span:
        device = dev.device
        mcfg = dev.map_config(cfg.n_fixed, cfg.use_full_kmer)
        acc = torch.zeros((dev.num_genomes, 3), dtype=torch.int32, device=device)
        parts = []
        totals = dict.fromkeys((f.name for f in fields(CountStats)), 0)
        n_kmers = probe_bytes = 0
        count = (device_count.count_mates if device_count.usable(cfg, device)
                 else device_count.host_parts)
        for kmers, counts, stats in count(paths, index.k, cfg.min_kmers, KMER_COUNT_CAP,
                                          device, threads=threads, seconds=seconds,
                                          counters=counters):
            if stats is not None:
                for f in totals:
                    totals[f] += stats[f]
            if kmers.shape[0] == 0:
                continue
            with span("stream.dispatch", seconds, "dispatch"):
                n_kmers += kmers.shape[0]
                batches = list(zip(kmers.split(cfg.batch_size), counts.split(cfg.batch_size)))
                tallies, part, probe_bytes = _pass1(batches, kmers.shape[0], dev, mcfg,
                                                    probe_bytes)
                acc += tallies
                parts.append(part)
        with span("stream.dispatch", seconds, "dispatch"):
            copy = _copy_pass1(acc, parts)
    cstats = CountStats(**totals)
    log.info("%d reads counted from %s (streamed), %d mate(s) while they inflated, "
             "%d on the card in %d part(s)", cstats.total_reads, paths[0], counters["piped"],
             counters["device_counted"], counters["count_parts"])
    log.info(
        "%d unique kmers above %d count, %d total unique kmers, "
        "%d total kmers (~%d basepairs); dispatched in %.2fs",
        cstats.unique_counted_kmers, cfg.min_kmers, cstats.unique_kmers,
        cstats.total_kmers, cstats.total_kmers * index.k, seconds["count"])
    log.info("Streamed %d partition(s), %d with a saved probe", len(parts),
             sum(saved is not None for *_, saved in parts))
    counts = {**map_counts(n_kmers, sum(len(batches) for batches, _, _ in parts), dev),
              **counters}
    log_memory_usage("Finished counting kmers", device)
    return PendingMap(parts, *copy, mcfg, n_kmers, cstats, count_span.t0,
                      (dev.tally_mode(), "streamed"), seconds, counts)


class ShardedMapper:
    """Both passes of a sample over a DxG mesh of ranks, one device each
    (JAX engine.py:175-581), in one of three layouts, chosen per sample
    by place_batches as JAX's engine chooses:

      * batchwise / B-split pass 1: the rank's batches probe its genome
        shard with K1; hits sum over the genome group before
        classification, tallies over the data group
        (parallel/pipeline.sharded_tally); pass 2: the selected genome's
        sub-index, cut from the host index through dev.subindex_source,
        sits on every rank; each rank walks its share of its own batches
        (K1 + K2) and the pileups merge over the world
        (pipeline.sharded_pileup);
      * routed pass 1 (B-split batches, D > 1, a histogram, and JAX's
        crossover, routed_wins): rank (d, g) holds chunk d of shard g's
        rows (pipeline.route_split) and each query travels to its chunk
        and back over the data group (pipeline.routed_tally). On a Dx1
        mesh with the histogram word and postings grouped by genome it
        saves its probe, and pass 2 walks each rank's own slice from it
        (pipeline.routed_pileup); otherwise pass 2 is the sub-index one.

    Sums and maxima, so every layout equals the single-device passes
    exactly. `dev` is the full layout on the host: a rank uploads only its
    shard, its routed chunk, and the sub-indexes or shard 0's postings."""

    def __init__(self, index: BronkoIndex, cfg: CallConfig, dev: DeviceIndex,
                 device: torch.device):
        n_data, n_genome = (int(x) for x in cfg.mesh.split("x"))
        self.mesh = make_mesh(n_data, n_genome)
        self.device = device
        self.dev = dev
        self.sharded = split_index(index, n_genome)
        self.mode = self.sharded.tally_mode()
        self.shard = upload_shard(self.sharded.shards[self.mesh.g], self.mode, device)
        self.J = len(dev.map_config(cfg.n_fixed, cfg.use_full_kmer).positions)
        self.layouts_used: set[str] = set()  # 'batchwise' / 'bsplit' / 'routed' of pass 1
        self._layout = "bsplit"  # the layout place_batches chose for the sample
        self._chunk = None       # this rank's routed chunk, at the first routed sample
        self._postings = None    # shard 0's postings, at the first routed pass 2
        self._saved = None       # the routed pass 1's (saved probe, own walk lengths)
        self._subs: dict = {}

    def close(self) -> None:
        self.mesh.close()

    def routed_wins(self, n_kmers: int, batch_size: int) -> bool:
        """JAX's crossover between the routed and the B-split pass 1
        (engine.py:405-431): (D-1)*U*20 > 3*N2, from JAX's own quantities:
        U the largest shard's rows (JAX pads every shard to them), N2 the
        lanes of JAX's batch (engine.py:131-137: a sample of one batch
        gets its lane class, the others batch_size) times J."""
        D, G = self.mesh.n_data, self.mesh.n_genome
        U = max(1, max(s.keys.shape[0] for s in self.sharded.shards))
        width = batch_size
        if n_kmers <= batch_size:
            width = min(batch_size, _lane_class(n_kmers, floor=1 << 14, multiple=D * G))
        return (D - 1) * U * 20 > 3 * width * self.J

    def place_batches(self, kmers: np.ndarray, counts: np.ndarray, batch_size: int):
        """This rank's pass-1 batches of the sample's host k-mers and counts,
        on its device, in the layout JAX's engine takes for the sample
        (engine.py:122-146, :310-337, :388-394). JAX pads a sample of
        several batches to a power of two of them; when that count
        divides by D, row d takes its 1/D of the padded batches (batchwise;
        the port pads nothing, so the last rows may hold fewer batches, or
        none). Otherwise every batch is deinterleaved, row d taking [d::D]
        of each (B-split, or routed where routed_wins)."""
        D, d = self.mesh.n_data, self.mesh.d
        n = kmers.shape[0]
        nb = -(-n // batch_size)
        padded = 1 << (nb - 1).bit_length() if nb > 1 else nb
        batchwise = padded >= D and padded % D == 0
        routed = (not batchwise and nb > 0 and D > 1 and self.mode in ("hist", "words")
                  and self.routed_wins(n, batch_size))
        self._layout = "batchwise" if batchwise else "routed" if routed else "bsplit"
        if batchwise:
            lo, hi = d * (padded // D) * batch_size, (d + 1) * (padded // D) * batch_size
            return to_batches(kmers[lo:hi], counts[lo:hi], batch_size, self.device)
        if nb == 0:
            return []
        starts = range(0, n, batch_size)
        ks = [kmers[i:i + batch_size][d::D] for i in starts]
        cs = [counts[i:i + batch_size][d::D] for i in starts]
        sizes = [k.shape[0] for k in ks]
        km = from_u64(np.concatenate(ks), self.device)
        ct = torch.from_numpy(np.concatenate(cs).astype(np.int32)).to(self.device)
        return list(zip(km.split(sizes), ct.split(sizes)))

    def run_tallies(self, batches, mcfg) -> Pass1:
        """Pass 1 in the layout place_batches chose; the routed one saves
        its probe for pass 2 on a Dx1 mesh with the histogram word and
        postings grouped by genome (JAX engine.py:475-476)."""
        self._saved = None
        self.layouts_used.add(self._layout)
        if self._layout != "routed":
            out = sharded_tally(batches, self.shard, mcfg, self.mode, self.mesh)
            return Pass1(out[:, :3], out[None, :, 3], (self.mode, "subindex"))
        if self._chunk is None:
            chunks, bounds = route_split(self.sharded, self.mesh.n_data)
            self._chunk = upload_chunk(chunks, bounds, self.mesh.g, self.mesh.d, self.device)
        save = self.mesh.n_genome == 1 and self.mode == "hist" and self.dev.fid_grouped
        out, saved, own = routed_tally(batches, self._chunk, mcfg, self.mode, self.mesh, save)
        if save:
            self._saved = (saved, own)
        return Pass1(out[:, :3], out[None, :, 3], (self.mode, "saved" if save else "subindex"))

    def pass2_share(self, batches):
        """This rank's share of its pass-1 batches for pass 2: the D*G
        ranks cover each k-mer once. Rank (d, g) takes whole batches g::G
        of its row's when their count divides by G, else each batch's
        k-mers [g::G] (JAX engine.py:500-511)."""
        G, g = self.mesh.n_genome, self.mesh.g
        if len(batches) >= G and len(batches) % G == 0:
            return batches[g::G]
        return [(km[g::G].contiguous(), ct[g::G].contiguous()) for km, ct in batches]

    def run_pileup(self, batches, mcfg, best: int, total_len: int) -> torch.Tensor:
        """The merged (4, total_len+1, 4) pileup of genome `best`: from the
        routed pass 1's saved probe when it saved one, else through the
        genome's sub-index."""
        if self._saved is not None:
            (saved, own), self._saved = self._saved, None
            if self._postings is None:
                self._postings = torch.from_numpy(self.sharded.shards[0].postings).to(
                    self.device)
            return routed_pileup(batches, saved, own, self._postings, best,
                                 int(self.dev.file_bases[best]), mcfg, total_len)
        if best not in self._subs:
            self._subs[best] = load_subindex(self.dev.subindex_source(best), self.device)
        return sharded_pileup(self.pass2_share(batches), self._subs[best], mcfg, total_len,
                              self.mesh)


def _lane_class(n: int, floor: int = 1 << 16, multiple: int = 1) -> int:
    """Smallest size of the form {1, 1.25, 1.5, 1.75}*2^m covering n and
    divisible by `multiple`: the JAX engine's batch width for a sample of
    one batch (engine.py:584-600), which routed_wins reads."""
    n = max(int(n), floor, multiple)
    p = 1 << (n - 1).bit_length()
    h = p >> 1
    for cand in (h + (h >> 2), h + (h >> 1), h + (h >> 1) + (h >> 2),
                 p, p + (p >> 2), p + (p >> 1), p + (p >> 1) + (p >> 2),
                 p << 1):
        if cand >= n and cand % multiple == 0:
            return cand
    return -(-n // multiple) * multiple


# pass 1's layouts the most recent --mesh run_call used ('batchwise',
# 'bsplit', 'routed'); plain strings, so nothing on a device is held (JAX
# engine.py:1420-1424)
LAST_MESH_LAYOUTS: frozenset = frozenset()


def run_call(cfg: CallConfig, index: BronkoIndex, dev: DeviceIndex,
             device: torch.device | None = None) -> list[SampleResult]:
    """Every -r file and every -1/-2 pair through the cohort pipeline, then
    the overview and the alignment. Returns the samples that succeeded, in
    input order; raises SystemExit(1) when every sample failed. `device`
    (default dev.device) counts and maps; under --mesh `dev` may stay on
    the host. With cfg.profile_dir the run is traced by torch.profiler
    (every thread, and the device's kernels too on a CUDA device) into a
    Chrome trace there, written even when the run fails; a profiler that
    fails to start or stop only warns, as the JAX engine's does
    (engine.py:1427-1446). tools/torch_idle_by_span.py reads the trace."""
    device = dev.device if device is None else device
    prof = None
    if cfg.profile_dir:
        try:
            prof = _start_profiler(cfg.profile_dir, device)
            log.info("Profiling to %s", cfg.profile_dir)
        except Exception as e:  # noqa: BLE001
            log.warning("profiler unavailable: %s", e)
    try:
        return _run_call_inner(cfg, index, dev, device)
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
    """A started torch.profiler recording every thread: the count workers,
    the inflate-ahead worker and the caller thread besides this one. A
    torch whose profiler lacks that option records this thread alone,
    with a warning."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    try:
        config = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    except (AttributeError, TypeError) as e:
        log.warning("the profiler records the main thread only (%s)", e)
        config = None
    prof = torch.profiler.profile(activities=activities, experimental_config=config)
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


def _mesh_mapper(cfg: CallConfig, index: BronkoIndex, dev: DeviceIndex,
                   device: torch.device) -> ShardedMapper | None:
    """The mapper of --mesh DxG (None without it); exits 1 unless the
    batch size divides by D*G (JAX engine.py:1460-1472)."""
    if not cfg.mesh:
        return None
    n_data, n_genome = (int(x) for x in cfg.mesh.split("x"))
    if cfg.batch_size % (n_data * n_genome):
        log.error("batch size must be divisible by the mesh rank count (%d)",
                  n_data * n_genome)
        raise SystemExit(1)
    log.info("Sharding the mapping pipeline over a %s mesh of ranks", cfg.mesh)
    return ShardedMapper(index, cfg, dev, device)


def _gather_results(results: list[SampleResult], result_ids: list[int],
                    failures: list[str], failure_ids: list[int]):
    """--shard-samples: every rank's results and failures, on every rank,
    in global input order (JAX engine.py:1719-1746). Each result travels
    without its pileup, which only its own rank holds; summaries and VCF
    records are small at viral scale."""
    payload = pickle.dumps(([(i, replace(r, pileup=None)) for i, r in zip(result_ids, results)],
                            list(zip(failure_ids, failures))))
    rows: dict[int, SampleResult] = {}
    failed: list[tuple[int, str]] = []
    for part in allgather_bytes(payload):
        got, lost = pickle.loads(part)
        rows.update(got)
        failed += lost
    rows.update(zip(result_ids, results))
    return [rows[i] for i in sorted(rows)], [f for _, f in sorted(failed)]


def _run_call_inner(cfg: CallConfig, index: BronkoIndex, dev: DeviceIndex,
                    device: torch.device) -> list[SampleResult]:
    global LAST_MESH_LAYOUTS
    LAST_MESH_LAYOUTS = frozenset()  # a run that maps nothing keeps no old layouts
    os.makedirs(cfg.output, exist_ok=True)
    jobs = [[p] for p in cfg.reads] + [
        [r1, r2] for r1, r2 in zip(cfg.first_pairs, cfg.second_pairs)]
    n_jobs = len(jobs)
    mapper = _mesh_mapper(cfg, index, dev, device)
    # sample-sharded cohort: whole samples round-robin over the ranks, no
    # per-sample collectives (JAX engine.py:1478-1493)
    rank, n_ranks = distributed.world()
    shard_samples = cfg.shard_samples and n_ranks > 1
    job_ids = list(range(n_jobs))[rank::n_ranks] if shard_samples else list(range(n_jobs))
    jobs = [jobs[i] for i in job_ids]
    if shard_samples:
        log.info("sample-sharded cohort: rank %d of %d owns %d of %d samples",
                 rank, n_ranks, len(jobs), n_jobs)
    try:
        results, result_ids, failures, failure_ids = _run_jobs(
            cfg, index, dev, device, mapper, jobs, job_ids)
    finally:
        if mapper is not None:
            mapper.close()
    if shard_samples:
        results, failures = _gather_results(results, result_ids, failures, failure_ids)

    if failures and not results:
        log.error("All samples failed")
        raise SystemExit(1)
    if failures:
        log.warning("%d of %d samples processed; failed: %s",
                    len(results), n_jobs, ", ".join(failures))
    summaries = [r.summary for r in results]
    log.info("Printing overview")
    if is_primary():
        write_overview(cfg.output, summaries)
    if not failures:
        log.info("All samples processed successfully")
    if cfg.output_alignment:
        log.info("Building alignment(s)")
        if is_primary():
            write_alignments(cfg.output, summaries,
                             [(r.summary.filename, r.records) for r in results],
                             index.files, log)
    if mapper is not None:
        LAST_MESH_LAYOUTS = frozenset(mapper.layouts_used)
        log.info("mesh layouts used this run: %s", "+".join(sorted(mapper.layouts_used)))
    log.info("bronko complete!")
    return results


def _inflate_ahead(path: str, release, pos: int) -> native.InflatedText:
    """The inflate-ahead worker's read and inflate of one file of the
    sample at input `pos`."""
    with sample_span(pos):
        return native.native_read_inflate(path, release)


def _run_jobs(cfg: CallConfig, index: BronkoIndex, dev: DeviceIndex, device: torch.device,
              mapper: ShardedMapper | None, jobs: list[list[str]], job_ids: list[int]):
    """The cohort pipeline over `jobs` (global input positions `job_ids`).
    Returns (results, their positions, failed displays, their positions).
    Collectives (under a mapper) run here on the main thread only, in
    input order: the count workers and the caller thread issue none."""
    workers = _count_workers(len(jobs))
    # the ranks of one host share its cores
    host_threads = max(1, cfg.threads // distributed.local_world_size())
    threads = max(1, host_threads // workers)
    upload = (mapper is None
              and len(dev.map_config(cfg.n_fixed, cfg.use_full_kmer).positions) > 0)
    # a lone sample, or a cohort's first, may stream its count into pass 1
    stream_first = upload and _streams_first(cfg, dev, mapper, len(jobs))
    budget = None
    if cfg.counter in ("auto", "host") and native.get_lib() is not None:
        budget = _InflateBudget()
    results: list[SampleResult] = []
    result_ids: list[int] = []
    failures: list[str] = []
    failure_ids: list[int] = []

    with ThreadPoolExecutor(max_workers=workers) as pool, \
            ThreadPoolExecutor(max_workers=1) as call_pool, \
            ThreadPoolExecutor(max_workers=1) as inflate_pool:
        futures: list = []
        call_futs: list = []  # (label, display, input position, future)

        def submit_upto(n: int) -> None:
            while len(futures) < min(n, len(jobs)):
                job, pos = jobs[len(futures)], job_ids[len(futures)]
                texts = None
                if budget is not None:
                    texts = []
                    for p in job:
                        release = budget.charge(p)
                        texts.append(None if release is None else inflate_pool.submit(
                            _inflate_ahead, p, release, pos))
                futures.append(pool.submit(_count_job, job, cfg, index.k, device,
                                           threads, texts, upload, pos))

        if stream_first:
            futures.append(None)  # the first job counts here, not on a worker
            job = jobs[0]
            label = job[0] if len(job) == 1 else f"{job[0]}, {job[1]}"
            log.info("Processing %s (streamed)", label)
            try:
                with sample_span(job_ids[0]):
                    pending = _stream_pass1(job, index, dev, cfg, host_threads)
                    submit_upto(1 + workers)
                    with span("resolve"), span(map_range(pending.counts)):
                        mapped = pending.resolve(index, dev)
                call_futs.append((label, job[0], job_ids[0], call_pool.submit(
                    _call_one, job[0], index, dev, cfg, mapped,
                    pending.cstats.total_reads, {}, job_ids[0])))
            except Exception:  # noqa: BLE001 — per-sample isolation
                log.exception("Sample %s failed; continuing with remaining samples", label)
                failures.append(job[0])
                failure_ids.append(job_ids[0])

        for ji in range(int(stream_first), len(jobs)):
            job = jobs[ji]
            submit_upto(ji + 1 + workers)
            # release the future: it would hold the sample's k-mers and
            # device batches for the rest of the run
            fut, futures[ji] = futures[ji], None
            display = job[0]
            label = display if len(job) == 1 else f"{job[0]}, {job[1]}"
            log.info("Processing %s", label)
            try:
                with sample_span(job_ids[ji]):
                    waited: dict[str, float] = {}
                    with span("count_wait", waited):
                        counted = fut.result()
                    counted.seconds.update(waited)
                    _log_counted(display, counted.cstats, cfg, index.k, counted.piped)
                    log_memory_usage("Finished counting kmers", device)
                    if cfg.keep_kmer_counts and (is_primary() or cfg.shard_samples):
                        _dump_counts(display, counted, cfg, index.k)
                    mapped = _map_one(counted, index, dev, cfg, mapper)
                    # the caller thread runs this sample while the next one
                    # maps; at most 2 samples wait for it
                    if len(call_futs) >= 2:
                        with span("caller_wait"):
                            wait([call_futs[-2][3]])
                    call_futs.append((label, display, job_ids[ji], call_pool.submit(
                        _call_one, display, index, dev, cfg, mapped,
                        counted.cstats.total_reads, counted.seconds, job_ids[ji])))
            except Exception:  # noqa: BLE001 — per-sample isolation
                log.exception("Sample %s failed; continuing with remaining samples", label)
                failures.append(display)
                failure_ids.append(job_ids[ji])

        for label, display, job_id, cf in call_futs:
            try:
                with span("caller_wait"):
                    res = cf.result()
                results.append(res)
                result_ids.append(job_id)
                log_memory_usage("Called variants successfully", device)
            except Exception:  # noqa: BLE001 — per-sample isolation
                log.exception("Sample %s failed; continuing with remaining samples", label)
                failures.append(display)
                failure_ids.append(job_id)
    return results, result_ids, failures, failure_ids
