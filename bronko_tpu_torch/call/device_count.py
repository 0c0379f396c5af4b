"""A streamed lone sample's counted k-mers, mate by mate, on its device.

`host_parts` is the host's count (io/native.py::native_count_fastq_stream:
one key-range partition at a time), each partition uploaded from
page-locked memory while the host sorts the next.

`count_mates`, where `usable` says so (--counter auto, on a CUDA device),
counts each mate on the card instead. `stage_parts` reads and inflates a
mate a block at a time into page-locked memory (io/native.py::TextReader,
the pipelined front end's reader) and hands its text over in parts of
PART_BYTES: mate 1's first part on the counting thread, the rest of it
and every other mate at once on helper threads, each with at most
PARTS_IN_FLIGHT parts staged and not yet counted. The counting thread
takes each part as it comes, of either mate: it copies the part to the
card (`upload_text`) behind the record its mate's last part cut off,
cuts the part after its last whole record (ops/count.py::
fastq_records_end) unless the mate's text ends with it, and the text pack
(ops/count.py::fastq_pack) emits every window the native counter
counts. Each part's windows are reduced to runs of (k-mer, count) on the
card (`reduce_words`: a sort with run lengths), and after a mate's last
part `merge_runs` sums its parts' runs in int64, caps and floors, once;
a mate within one part is counted whole, as `count_words` counts a text.
The kept k-mers and counts stay on the card, ascending, each mate a k-mer
stream of its own with its own floor, as the native counter keeps them;
mates are yielded in their order.

The card's or the host's count is decided a part at a time, before the
part goes to the card: the card takes a part whose count fits its budget
(`budget`: free device memory, BYTES_PER_TEXT_BYTE a text byte). The
host counts the whole mate, through `host_parts` and with a warning,
where one of its parts does not fit or its file cannot be read or
inflated, so that the host's count raises its own error for it; what the
card had counted of the mate is dropped.

Both yield (k-mers int64, counts int32, stats or None) on the device.
The spans add into the sample's seconds under the host count's keys
(utils/spans.py): `inflate` (a part's read and inflate; `inflate_ahead`
the parts staged on a helper), `text_wait` (the counting thread blocked
on a helper's part), `parse` (a part's copy's enqueue, the cut and the
text pack, whose one small copy back waits for the text on the card and
the count pass), `finalize` (a part's sort and run lengths, with their
sync; for a mate in one part its cap and floor too), `merge` (the merge
of a mate's parts, where it took more than one: the sum, the cap and the
floor) and `dispatch` (a host partition's upload).
Each mate counted on the card adds 1 to counters["device_counted"] and
its parts to counters["count_parts"].
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import asdict, dataclass, field

import numpy as np
import torch

from bronko_tpu_torch.io import native
from bronko_tpu_torch.ops.codec import from_u64
from bronko_tpu_torch.ops.count import (
    CountStats, fastq_pack, fastq_records_end, merge_runs, reduce_words,
)
from bronko_tpu_torch.utils.spans import span

log = logging.getLogger("bronko")

# text bytes read and inflated into page-locked memory at a time
BLOCK_BYTES = 4 << 20

# device bytes a text byte may need at the count's peak: itself, and for
# the window it may start 8 bytes of word, 8 of the sort's copy, 8 of its
# scratch and 16 of unique k-mer and count
BYTES_PER_TEXT_BYTE = 41

# text bytes of a mate counted on the card at once (a part, in whole
# blocks). It bounds what a mate's count holds whatever its depth: on the
# card BYTES_PER_TEXT_BYTE a text byte at the count's peak (11 GB of an
# 80 GB card), and in page-locked memory PARTS_IN_FLIGHT parts a mate
# (1 GiB for a pair). A mate of fewer text bytes is counted whole.
PART_BYTES = 256 << 20
# parts of one mate staged and not yet counted: one filling while the
# card counts the other
PARTS_IN_FLIGHT = 2


def usable(cfg, device: torch.device) -> bool:
    """Whether a streamed sample's mates may be counted on `device`: under
    --counter auto, on a card."""
    return cfg.counter == "auto" and device.type == "cuda"


def budget(device: torch.device) -> int:
    """Device bytes a part's count may take: the card's free memory and
    what PyTorch holds cached but unused."""
    free, _ = torch.cuda.mem_get_info(device)
    return free + torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)


def upload_part(kmers: np.ndarray, counts: np.ndarray, device: torch.device):
    """Host k-mers (u64) and counts -> (int64, int32) tensors on `device`:
    on a card through page-locked memory, both copies enqueued on the
    current stream and the host going on at once (a copy from pageable
    memory waits for the card)."""
    if device.type != "cuda":
        return from_u64(kmers, device), torch.from_numpy(np.ascontiguousarray(counts, np.int32))
    km = torch.empty(kmers.shape[0], dtype=torch.int64, pin_memory=True)
    ct = torch.empty(kmers.shape[0], dtype=torch.int32, pin_memory=True)
    km.numpy()[:] = kmers.view(np.int64)
    ct.numpy()[:] = counts
    return km.to(device, non_blocking=True), ct.to(device, non_blocking=True)


def host_parts(paths: list[str], k: int, min_count: int, count_cap: int,
               device: torch.device, threads: int = 4,
               seconds: dict[str, float] | None = None,
               counters: dict[str, int] | None = None):
    """native_count_fastq_stream's partitions of `paths`, each uploaded in
    the span `stream.dispatch` as it comes."""
    for kmers, counts, stats in native.native_count_fastq_stream(
            paths, k, min_count, count_cap, threads=threads, seconds=seconds,
            counters=counters):
        with span("stream.dispatch", seconds, "dispatch"):
            kmers, counts = upload_part(kmers, counts, device)
        yield kmers, counts, stats


def stage_parts(path: str):
    """Read and inflate `path` BLOCK_BYTES at a time into page-locked
    memory (where a CUDA runtime is; io/native.py::TextReader) and yield
    its text a part at a time, each part's staging in the span
    `count.inflate`: (the filled uint8 host blocks in order, whether the
    text ends with them, the part's wall seconds). A part is whole blocks
    of at least PART_BYTES; the last part holds what is left, perhaps
    nothing. A file the reader cannot open or inflate to its end yields
    (None, True, seconds) and ends."""
    reader = None
    try:
        while True:
            t0 = time.perf_counter()
            blocks, size, ends = [], 0, False
            with span("count.inflate"):
                try:
                    reader = reader or native.TextReader(path)
                    while size < PART_BYTES:
                        block = torch.empty(BLOCK_BYTES, dtype=torch.uint8,
                                            pin_memory=torch.cuda.is_available())
                        got = reader.read_into(block.data_ptr(), BLOCK_BYTES)
                        if got <= 0:
                            blocks, ends = (blocks if got == 0 else None), True
                            break
                        blocks.append(block[:got])
                        size += got
                except (OSError, ValueError):
                    blocks, ends = None, True
            yield blocks, ends, time.perf_counter() - t0
            if ends:
                return
    finally:
        if reader is not None:
            reader.close()


def upload_text(blocks: list[torch.Tensor], device: torch.device) -> torch.Tensor:
    """The staged text as one uint8 tensor on `device`, each block's copy
    enqueued on the current stream."""
    text = torch.empty(sum(b.numel() for b in blocks), dtype=torch.uint8, device=device)
    at = 0
    for b in blocks:
        text[at:at + b.numel()].copy_(b, non_blocking=True)
        at += b.numel()
    return text


@dataclass
class _Mate:
    """One mate's count on the card as its parts come: the runs of its
    parts, the reads and windows counted, the record its last part cut off
    (on the device), and once it is over its result or why the host
    counts it."""
    path: str
    runs: list = field(default_factory=list)
    reads: int = 0
    windows: int = 0
    parts: int = 0
    tail: torch.Tensor | None = None
    result: tuple | None = None
    why: str | None = None
    stop: threading.Event = field(default_factory=threading.Event)
    slots: threading.Semaphore = field(
        default_factory=lambda: threading.Semaphore(PARTS_IN_FLIGHT))

    @property
    def over(self) -> bool:
        return self.result is not None or self.why is not None


def _off_card(mate: _Mate, blocks: list[torch.Tensor] | None,
              device: torch.device) -> str | None:
    """Why the host counts a mate with this staged part next, or None
    where the card counts the part."""
    if blocks is None:
        return "it cannot be read or inflated"
    size = sum(b.numel() for b in blocks) + (0 if mate.tail is None else mate.tail.numel())
    need = size * BYTES_PER_TEXT_BYTE
    room = budget(device)
    if need > room:
        return f"the count of {size} bytes of its text needs {need} device bytes, {room} are free"
    return None


def _count_part(mate: _Mate, blocks: list[torch.Tensor], ends: bool, k: int, min_count: int,
                count_cap: int, device: torch.device, seconds: dict[str, float] | None):
    """Count one part of the mate's text on the card: after the record its
    last part cut off, up to its own last whole record unless the text
    ends with it. After the last part, the mate's (k-mers, int32 counts,
    stats); before it, None."""
    with span("count.parse", seconds, "parse"):
        text = upload_text(blocks if mate.tail is None else [mate.tail, *blocks], device)
        del blocks
        end = text.numel() if ends else fastq_records_end(text)
        mate.tail = None if ends else text[end:].clone()
        words, reads, malformed = fastq_pack(text[:end], k)
        del text
    if malformed:
        raise ValueError(f"malformed FASTQ: {mate.path}")
    mate.parts += 1
    mate.reads += reads
    mate.windows += words.numel()
    with span("count.finalize", seconds, "finalize"):
        mate.runs.append(reduce_words(words))
        del words
        if ends and mate.parts == 1:
            return _merged(mate, min_count, count_cap)  # counted whole, as count_words
    if not ends:
        return None
    with span("count.merge", seconds, "merge"):
        return _merged(mate, min_count, count_cap)


def _merged(mate: _Mate, min_count: int, count_cap: int):
    """The mate's (k-mers, int32 counts, stats) from the runs of its parts."""
    kmers, counts, distinct = merge_runs(mate.runs, min_count, count_cap)
    mate.runs = []
    return (kmers, counts.to(torch.int32),
            CountStats(mate.reads, mate.windows, distinct, kmers.numel()))


def _pump(i: int, mate: _Mate, parts, ready: queue.Queue) -> None:
    """Stage mate i's parts on this helper thread into `ready`, each once
    a slot is free, until its text ends or its count stops; an error goes
    into `ready` too."""
    try:
        while True:
            mate.slots.acquire()
            if mate.stop.is_set():
                return
            part = next(parts)
            ready.put((i, part))
            if part[1]:
                return
    except Exception as e:  # noqa: BLE001 — handed to the counting thread
        ready.put((i, e))
    finally:
        parts.close()


def count_mates(paths: list[str], k: int, min_count: int, count_cap: int,
                device: torch.device, threads: int = 4,
                seconds: dict[str, float] | None = None,
                counters: dict[str, int] | None = None):
    """Count each mate of `paths` and yield (k-mers, counts, stats) on
    `device` in mate order: for a mate counted on the card its kept k-mers
    (ascending int64) and counts (int32) and its stats; for one the host
    counts, host_parts' partitions on `threads` threads. Mate 1's first
    part is staged on this thread, every later part on a helper thread
    while the card counts what came before. Staging still in flight when
    a count fails or the consumer abandons the generator is stopped and
    waited for. Raises ValueError for a malformed text, as the host count
    does."""
    mates = [_Mate(p) for p in paths]
    ready: queue.Queue = queue.Queue()

    def take(i: int, part, ahead: bool) -> None:
        mate = mates[i]
        if isinstance(part, BaseException):
            raise part
        blocks, ends, s = part
        native.add_inflate(seconds, s, ahead)
        try:
            if mate.over:
                return  # a part staged before the mate left the card
            mate.why = _off_card(mate, blocks, device)
            if mate.why is not None:
                mate.stop.set()
                mate.runs, mate.tail = [], None
                return
            mate.result = _count_part(mate, blocks, ends, k, min_count, count_cap, device,
                                      seconds)
        finally:
            mate.slots.release()

    with ThreadPoolExecutor(max_workers=len(paths)) as pool:
        pumps = [pool.submit(_pump, i, mates[i], stage_parts(p), ready)
                 for i, p in enumerate(paths) if i > 0]
        first = stage_parts(paths[0])
        try:
            mates[0].slots.acquire()
            take(0, next(first), False)
            if not mates[0].over:
                pumps.append(pool.submit(_pump, 0, mates[0], first, ready))
                first = None
            for mate in mates:
                while not mate.over:
                    with span("count.text_wait", seconds, "text_wait"):
                        j, part = ready.get()
                    take(j, part, True)
                if mate.why is not None:
                    log.warning("%s is counted on the host, not on the card: %s",
                                mate.path, mate.why)
                    busy = sum(not m.over for m in mates)
                    yield from host_parts([mate.path], k, min_count, count_cap, device,
                                          threads=max(1, threads - busy), seconds=seconds,
                                          counters=counters)
                    continue
                if counters is not None:
                    counters["device_counted"] = counters.get("device_counted", 0) + 1
                    counters["count_parts"] = counters.get("count_parts", 0) + mate.parts
                kmers, counts, stats = mate.result
                yield kmers, counts, asdict(stats)
        finally:
            if first is not None:
                first.close()
            for mate in mates:
                mate.stop.set()
                mate.slots.release()
            for pump in pumps:
                pump.result()
