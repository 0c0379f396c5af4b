"""A streamed lone sample's counted k-mers, mate by mate, on its device.

`host_parts` is the host's count (io/native.py::native_count_fastq_stream:
one key-range partition at a time), each partition uploaded from
page-locked memory while the host sorts the next.

`count_mates`, where `usable` says so (--counter auto, on a CUDA device),
counts each mate on the card instead: `stage_text` reads and inflates it
a block at a time into page-locked memory (io/native.py::TextReader, the
pipelined front end's reader), mate 1 on the counting thread and mate 2
at once on a helper thread; the counting thread copies the blocks to the
card (`upload_text`), the text pack
(ops/count.py::fastq_pack) emits every window the native counter counts,
and `count_words` sorts them, takes run lengths, caps and floors. The
kept k-mers and counts stay on the card, ascending, each mate a k-mer
stream of its own with its own floor, as the native counter keeps them.

Whether the card counts a mate is decided once, from its staged text,
before any of it goes to the card: the card takes a file within the
whole-buffer cap whose text is within its budget (`budget`: free device
memory, BYTES_PER_TEXT_BYTE a text byte). The host counts, through
`host_parts` and with a warning, a file past the cap (not staged), a
text past the budget and a file that cannot be read or inflated, so that
the host's count raises its own error for it.

Both yield (k-mers int64, counts int32, stats or None) on the device.
The spans add into the sample's seconds under the host count's keys
(utils/spans.py): `inflate` (a mate's read and inflate;
`inflate_ahead` mate 2's, on the helper), `text_wait` (the counting
thread blocked on mate 2's text), `parse` (the copy's enqueue and the
text pack, whose one small copy back waits for the text on the card and
the count pass), `finalize` (the sort, run lengths, cap and floor, with
their syncs) and `dispatch` (a host partition's upload). Each mate
counted on the card adds 1 to counters["device_counted"].
"""

from __future__ import annotations

import logging
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import asdict

import numpy as np
import torch

from bronko_tpu_torch.io import native
from bronko_tpu_torch.ops.codec import from_u64
from bronko_tpu_torch.ops.count import count_words, fastq_pack
from bronko_tpu_torch.utils.spans import span

log = logging.getLogger("bronko")

# text bytes read and inflated into page-locked memory at a time
BLOCK_BYTES = 4 << 20

# device bytes a text byte may need at the count's peak: itself, and for
# the window it may start 8 bytes of word, 8 of the sort's copy, 8 of its
# scratch and 16 of unique k-mer and count
BYTES_PER_TEXT_BYTE = 41


def usable(cfg, device: torch.device) -> bool:
    """Whether a streamed sample's mates may be counted on `device`: under
    --counter auto, on a card."""
    return cfg.counter == "auto" and device.type == "cuda"


def budget(device: torch.device) -> int:
    """Device bytes a mate's count may take: the card's free memory and
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


def stage_text(path: str):
    """Read and inflate `path` BLOCK_BYTES at a time into page-locked
    memory (where a CUDA runtime is; io/native.py::TextReader), in the
    span `count.inflate`. Returns (the filled uint8 host blocks in order,
    or None for a file past the whole-buffer cap or one the reader cannot
    open or inflate to its end; the wall seconds)."""
    t0 = time.perf_counter()
    blocks = []
    with span("count.inflate"):
        try:
            if native.whole_buf_size(path) < 0:
                blocks = None
            else:
                with native.TextReader(path) as reader:
                    while True:
                        block = torch.empty(BLOCK_BYTES, dtype=torch.uint8,
                                            pin_memory=torch.cuda.is_available())
                        got = reader.read_into(block.data_ptr(), BLOCK_BYTES)
                        if got <= 0:
                            blocks = blocks if got == 0 else None
                            break
                        blocks.append(block[:got])
        except (OSError, ValueError):
            blocks = None
    return blocks, time.perf_counter() - t0


def upload_text(blocks: list[torch.Tensor], device: torch.device) -> torch.Tensor:
    """The staged text as one uint8 tensor on `device`, each block's copy
    enqueued on the current stream."""
    text = torch.empty(sum(b.numel() for b in blocks), dtype=torch.uint8, device=device)
    at = 0
    for b in blocks:
        text[at:at + b.numel()].copy_(b, non_blocking=True)
        at += b.numel()
    return text


def _off_card(blocks: list[torch.Tensor] | None, device: torch.device) -> str | None:
    """Why the host counts a staged mate, or None where the card does."""
    if blocks is None:
        return "it is past the whole-buffer cap or cannot be read"
    need = sum(b.numel() for b in blocks) * BYTES_PER_TEXT_BYTE
    room = budget(device)
    if need > room:
        return f"its count needs {need} device bytes, {room} are free"
    return None


def count_mates(paths: list[str], k: int, min_count: int, count_cap: int,
                device: torch.device, threads: int = 4,
                seconds: dict[str, float] | None = None,
                counters: dict[str, int] | None = None):
    """Count each mate of `paths` in turn and yield (k-mers, counts, stats)
    on `device`: for a mate counted on the card its kept k-mers (ascending
    int64) and counts (int32) and its stats; for one the host counts,
    host_parts' partitions on `threads` threads. Mate i+1 is staged on a
    helper thread while mate i counts; a staging still in flight when a
    count fails or the consumer abandons the generator is waited for.
    Raises ValueError for a malformed text, as the host count does."""
    with ThreadPoolExecutor(max_workers=1) as pool:
        ahead = pool.submit(stage_text, paths[1]) if len(paths) > 1 else None
        try:
            for i, path in enumerate(paths):
                if i == 0:
                    blocks, s = stage_text(path)
                else:
                    with span("count.text_wait", seconds, "text_wait"):
                        blocks, s = ahead.result()
                    ahead = (pool.submit(stage_text, paths[i + 1])
                             if i + 1 < len(paths) else None)
                native.add_inflate(seconds, s, i > 0)
                why = _off_card(blocks, device)
                if why is not None:
                    log.warning("%s is counted on the host, not on the card: %s", path, why)
                    del blocks
                    yield from host_parts([path], k, min_count, count_cap, device,
                                          threads=max(1, threads - (ahead is not None)),
                                          seconds=seconds, counters=counters)
                    continue
                with span("count.parse", seconds, "parse"):
                    text = upload_text(blocks, device)
                    del blocks
                    words, reads, malformed = fastq_pack(text, k)
                    del text
                if malformed:
                    raise ValueError(f"malformed FASTQ: {path}")
                with span("count.finalize", seconds, "finalize"):
                    kmers, counts, stats = count_words(words, reads, min_count, count_cap)
                    del words
                if counters is not None:
                    counters["device_counted"] = counters.get("device_counted", 0) + 1
                yield kmers, counts, asdict(stats)
        finally:
            if ahead is not None:
                try:
                    ahead.result()
                except Exception:  # noqa: BLE001 — the staging itself failed
                    pass
