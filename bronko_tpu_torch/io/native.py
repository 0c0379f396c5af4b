"""ctypes bindings for the native (C++) host components: the FASTQ reader,
the k-mer counter and the noise scan.

Counterpart of `bronko_tpu/io/native.py`, loading the port's own copy of
the sources (`bronko_tpu_torch/native/`). The library is built at first
use with make (g++ and zlib) into `native/build/`, which git ignores, and
rebuilt whenever a source is newer. Callers fall back to the pure-Python
implementations when it is unavailable.

The counter has three front ends (native/kmer_count.cpp):

- text: `native_read_inflate` reads and inflates one FASTQ into a
  C++-owned buffer (`InflatedText`) that `native_count_fastq(..., text=)`
  then parses and counts on every thread. The engine's inflate-ahead
  worker overlaps one sample's single-threaded inflate with another's
  parse and count this way.
- pipelined: a file given by its path alone that is gzip (but BGZF
  where libdeflate loads) or past the whole-buffer cap is counted from
  its path: the counter's reader thread inflates it while the other
  threads parse and count what it has inflated (`pipes`).
- whole buffer: any other file given by its path alone (uncompressed,
  or BGZF that libdeflate inflates in parallel) is read and inflated
  here first, then counted as text.

Every count splits into the same spans (utils/spans.py), whose seconds
add into the caller's `seconds` dict: `inflate` (read and inflate, on
whatever thread ran it; `inflate_ahead` the share another thread ran:
the inflate-ahead worker's, the mate prefetch's, and the pipelined
reader's, which runs beside the parse), `parse` (the multi-threaded
parse and hash count, and on the pipelined front end everything from the
file's open to its last record counted), `finalize` (merge, sort, floor
and cap, extract) and, on the streamed path, `text_wait` (blocked on the
next mate's prefetch). Each file counted while it inflated adds 1 to
`counters["piped"]`.

`native_count_fastq_stream` yields a sample's counted k-mers one key-range
partition at a time, for the engine's streamed single-sample path where
the host counts. Where the card counts a streamed sample's mate
(call/device_count.py), the host only reads and inflates it, a block at
a time into page-locked memory, through `TextReader` (the pipelined
front end's reader, handing out the text unparsed), whatever its size:
the whole-buffer cap bounds only the host's whole-buffer front end. The
spans keep their keys there: `inflate` is the read and inflate, `parse`
the copy to the card and the text pack, `finalize` the card's sort, cap
and floor, and `merge` the merge of a mate's parts.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
import time

import numpy as np

from bronko_tpu_torch.utils.spans import add_seconds, span

log = logging.getLogger("bronko")

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native")
_SO_PATH = os.path.join(_NATIVE_DIR, "build", "libbronko_io.so")
_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> bool:
    try:
        subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                       capture_output=True, timeout=300)
        return True
    except subprocess.CalledProcessError as e:
        log.debug("native build failed: %s", e.stderr.decode(errors="replace"))
    except Exception as e:  # noqa: BLE001 — no make, a timeout
        log.debug("native build failed: %s", e)
    return False


def get_lib():
    """Load (building if needed) the native library, or None."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        # make is a no-op when the library is newer than every source; if
        # it fails but a library exists, still try that one
        if not _build() and not os.path.exists(_SO_PATH):
            return None
        try:
            lib = ctypes.CDLL(_SO_PATH)
        except OSError as e:
            log.debug("native load failed: %s", e)
            return None
        lib.bronko_fastq_open.restype = ctypes.c_void_p
        lib.bronko_fastq_open.argtypes = [ctypes.c_char_p]
        lib.bronko_fastq_close.argtypes = [ctypes.c_void_p]
        lib.bronko_fastq_read_chunk.restype = ctypes.c_int64
        lib.bronko_fastq_read_chunk.argtypes = [
            ctypes.c_void_p,
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            ctypes.c_int64, ctypes.c_int64,
        ]
        lib.bronko_noise_scan.restype = None
        lib.bronko_noise_scan.argtypes = [
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            ctypes.c_int64,
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            ctypes.c_int64,
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        ]
        lib.bronko_counter_create.restype = ctypes.c_void_p
        lib.bronko_counter_create.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.bronko_counter_destroy.argtypes = [ctypes.c_void_p]
        lib.bronko_counter_count_fastq.restype = ctypes.c_int
        lib.bronko_counter_count_fastq.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        for fn in ("total_reads", "total_kmers", "unique"):
            f = getattr(lib, f"bronko_counter_{fn}")
            f.restype = ctypes.c_int64
            f.argtypes = [ctypes.c_void_p]
        lib.bronko_counter_finalize.restype = ctypes.c_int64
        lib.bronko_counter_finalize.argtypes = [
            ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint32]
        lib.bronko_counter_finalize_part.restype = ctypes.c_int64
        lib.bronko_counter_finalize_part.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_uint32, ctypes.c_uint32]
        lib.bronko_counter_extract.restype = None
        lib.bronko_counter_extract.argtypes = [
            ctypes.c_void_p,
            np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS"),
        ]
        lib.bronko_read_inflate.restype = ctypes.c_void_p
        lib.bronko_read_inflate.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64)]
        lib.bronko_buffer_data.restype = ctypes.c_void_p
        lib.bronko_buffer_data.argtypes = [ctypes.c_void_p]
        lib.bronko_buffer_free.restype = None
        lib.bronko_buffer_free.argtypes = [ctypes.c_void_p]
        lib.bronko_counter_count_text.restype = ctypes.c_int
        lib.bronko_counter_count_text.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
        lib.bronko_counter_pipes.restype = ctypes.c_int
        lib.bronko_counter_pipes.argtypes = [ctypes.c_char_p]
        lib.bronko_counter_inflate_seconds.restype = ctypes.c_double
        lib.bronko_counter_inflate_seconds.argtypes = [ctypes.c_void_p]
        lib.bronko_gz_open.restype = ctypes.c_void_p
        lib.bronko_gz_open.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int)]
        lib.bronko_gz_read.restype = ctypes.c_int64
        lib.bronko_gz_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
        lib.bronko_gz_close.restype = None
        lib.bronko_gz_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


class InflatedText:
    """Handle to a C++-owned inflated FASTQ text (bronko_read_inflate).
    `handle` is None when the file was over the whole-buffer cap or could
    not be read: the counter then reads the path itself. `on_close` fires
    once, at the first close() (the engine returns the buffer's bytes to
    its inflate-ahead budget there); close() is idempotent. `seconds` is
    the wall the read and inflate took on the thread that ran it."""

    def __init__(self, handle, size: int, on_close=None, seconds: float = 0.0):
        self.handle = handle
        self.size = size
        self.seconds = seconds
        self._on_close = on_close

    def close(self):
        if self.handle is not None:
            get_lib().bronko_buffer_free(self.handle)
            self.handle = None
        if self._on_close is not None:
            cb, self._on_close = self._on_close, None
            cb()

    def __del__(self):  # backstop; the engine closes explicitly
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass


def native_read_inflate(path: str, on_close=None) -> InflatedText:
    """Read and inflate one FASTQ on the calling thread (the C call
    releases the GIL), in the span `count.inflate`."""
    lib = get_lib()
    assert lib is not None
    size = ctypes.c_int64()
    t0 = time.perf_counter()
    with span("count.inflate"):
        try:
            h = lib.bronko_read_inflate(path.encode(), ctypes.byref(size))
        except Exception:  # noqa: BLE001 — the counter reads the path instead
            h = None
    return InflatedText(h, int(size.value), on_close=on_close,
                        seconds=time.perf_counter() - t0)


def add_inflate(seconds: dict | None, s: float, ahead: bool) -> None:
    """Charge s seconds of read and inflate to the counting sample's
    seconds; `ahead`: another thread ran them."""
    if seconds is not None:
        add_seconds(seconds, "inflate", s)
        if ahead:
            add_seconds(seconds, "inflate_ahead", s)


def pipes(path: str) -> bool:
    """Whether the counter counts the file given by its path while it
    inflates (the pipelined front end); False too when it cannot open it,
    so that the read reports that."""
    return get_lib().bronko_counter_pipes(path.encode()) == 1


def _text_unless_piped(path: str) -> InflatedText | None:
    """None for a file the counter reads from its path while it inflates,
    else its text, read and inflated here."""
    return None if pipes(path) else native_read_inflate(path)


def _stats(lib, h, unique_counted: int) -> dict:
    return dict(
        total_reads=int(lib.bronko_counter_total_reads(h)),
        total_kmers=int(lib.bronko_counter_total_kmers(h)),
        unique_kmers=int(lib.bronko_counter_unique(h)),
        unique_counted_kmers=unique_counted,
    )


def _extract(lib, h, n: int) -> tuple[np.ndarray, np.ndarray]:
    """The n k-mers and counts the last finalize kept, as (u64, int64)."""
    kmers = np.empty(n, np.uint64)
    counts = np.empty(n, np.uint32)
    if n:
        lib.bronko_counter_extract(h, kmers, counts)
    return kmers, counts.astype(np.int64)


def _count_into(lib, h, path: str, text: InflatedText | None) -> bool:
    """Count one file into counter handle h: from the inflated text when
    there is one (closed here), else from the path. Maps the C return
    codes to exceptions. Returns whether it counted from the path: the
    pipelined front end then inflated it on the counter's reader thread
    (a text's file past the cap has no buffer, and pipes)."""
    from_path = text is None or text.handle is None
    if not from_path:
        try:
            rc = lib.bronko_counter_count_text(
                h, lib.bronko_buffer_data(text.handle), text.size)
        finally:
            text.close()
    else:
        rc = lib.bronko_counter_count_fastq(h, path.encode())
    if rc == -1:
        raise OSError(f"cannot open {path}")
    if rc != 0:
        raise ValueError(f"malformed FASTQ: {path}")
    return from_path


def _add_piped(lib, h, seconds: dict | None, counters: dict | None) -> None:
    """Charge a file counted from its path: its read and inflate ran on
    the counter's reader thread, beside the parse."""
    add_inflate(seconds, float(lib.bronko_counter_inflate_seconds(h)), True)
    if counters is not None:
        counters["piped"] = counters.get("piped", 0) + 1


def _create(lib, k: int, threads: int):
    h = lib.bronko_counter_create(k, max(1, threads))
    if not h:
        raise ValueError(f"k={k} outside the counter's supported range")
    return h


def native_count_fastq(path: str, k: int, min_count: int, count_cap: int,
                       threads: int = 4, text: InflatedText | None = None,
                       seconds: dict[str, float] | None = None,
                       counters: dict[str, int] | None = None):
    """Count a FASTQ file's k-mers entirely in C++ (multithreaded pipeline).

    Returns (kmers u64 sorted, counts int64, stats dict), with KMC -b
    -ci<min> -cs<cap> semantics like ops/count.KmerCounter. `threads` is
    the total thread budget; the C++ side picks the split. `text` (from
    native_read_inflate on another thread) stands for the read and
    inflate; without it the file is counted while it inflates or, where
    the counter would not pipe it, read and inflated here first. `text`
    is closed here. The spans' seconds add into `seconds` and the count
    of piped files into `counters` (the module's docstring)."""
    lib = get_lib()
    assert lib is not None
    ahead = text is not None
    if text is None:
        text = _text_unless_piped(path)
    if text is not None:
        add_inflate(seconds, text.seconds, ahead)
    h = None
    try:
        with span("count.parse", seconds, "parse"):
            h = _create(lib, k, threads)
            piped = _count_into(lib, h, path, text)
        if piped:
            _add_piped(lib, h, seconds, counters)
        with span("count.finalize", seconds, "finalize"):
            n = int(lib.bronko_counter_finalize(h, min_count, count_cap))
            kmers, counts = _extract(lib, h, n)
            stats = _stats(lib, h, n)
            lib.bronko_counter_destroy(h)
            h = None
        return kmers, counts, stats
    finally:
        if text is not None:
            text.close()
        if h:
            lib.bronko_counter_destroy(h)


NATIVE_COUNT_PARTS = 4  # key-range partitions of the streamed finalize
# (a power of two in [1, 8]; JAX io/native.py:209)


def native_count_fastq_stream(paths: list[str], k: int, min_count: int,
                              count_cap: int, threads: int = 4,
                              seconds: dict[str, float] | None = None,
                              counters: dict[str, int] | None = None):
    """Count each file, then yield the sorted unique (kmers u64, counts
    int64, stats or None) of each of its NATIVE_COUNT_PARTS key-range
    partitions: a path's first finalize merges all of them across threads,
    and the caller sends each to the device as it comes. Partitions in order are
    native_count_fastq's output. Each path has its own counter (paired
    mates are separate k-mer streams); stats come with a path's last
    partition. Path 0 is counted from its path where the counter pipes
    it, else read and inflated here first; mate i+1 is read and inflated
    on a helper thread while mate i counts, so at most two inflated
    buffers are live; a prefetch still in flight when a count fails or
    the consumer abandons the generator is closed (JAX
    io/native.py:215-284). The spans' seconds add into `seconds` and the
    count of piped files into `counters` (the module's docstring); each
    span closes before its yield, so the consumer's work between
    partitions lies in none of them."""
    from concurrent.futures import ThreadPoolExecutor

    lib = get_lib()
    assert lib is not None
    with ThreadPoolExecutor(max_workers=1) as pool:
        # path i+1 is submitted just before path i counts
        next_tf = pool.submit(native_read_inflate, paths[1]) if len(paths) > 1 else None
        try:
            for i, path in enumerate(paths):
                if i == 0:
                    text = _text_unless_piped(path)
                else:
                    with span("count.text_wait", seconds, "text_wait"):
                        text = next_tf.result()
                    next_tf = (pool.submit(native_read_inflate, paths[i + 1])
                               if i + 1 < len(paths) else None)
                if text is not None:
                    add_inflate(seconds, text.seconds, i > 0)
                h = None
                try:
                    with span("count.parse", seconds, "parse"):
                        h = _create(lib, k, threads)
                        piped = _count_into(lib, h, path, text)
                    if piped:
                        _add_piped(lib, h, seconds, counters)
                    unique_counted = 0
                    for part in range(NATIVE_COUNT_PARTS):
                        with span("count.finalize", seconds, "finalize"):
                            n = int(lib.bronko_counter_finalize_part(
                                h, part, NATIVE_COUNT_PARTS, min_count, count_cap))
                            kmers, counts = _extract(lib, h, n)
                            unique_counted += n
                            stats = (_stats(lib, h, unique_counted)
                                     if part == NATIVE_COUNT_PARTS - 1 else None)
                        yield kmers, counts, stats
                    with span("count.finalize", seconds, "finalize"):
                        lib.bronko_counter_destroy(h)
                        h = None
                finally:
                    if text is not None:
                        text.close()
                    if h:
                        lib.bronko_counter_destroy(h)
        finally:
            if next_tf is not None:
                try:
                    next_tf.result().close()
                except Exception:  # noqa: BLE001 — the prefetch itself failed
                    pass


class TextReader:
    """One file's text a block at a time (native/kmer_count.cpp GzStream):
    gzip inflated with zlib, as the pipelined front end reads it, with
    read_inflate's acceptance; any other file as it is. A context
    manager; raises OSError when the file cannot be opened and ValueError
    when zlib does not start."""

    def __init__(self, path: str):
        lib = get_lib()
        err = ctypes.c_int()
        self._h = lib.bronko_gz_open(path.encode(), ctypes.byref(err))
        if not self._h:
            if err.value == -1:
                raise OSError(f"cannot open {path}")
            raise ValueError(f"cannot inflate {path}")

    def read_into(self, address: int, cap: int) -> int:
        """Up to cap (> 0) bytes of text at `address` (the C call releases
        the GIL): how many, 0 at the end, -2 on a corrupt or truncated gzip
        member or a read error."""
        return int(get_lib().bronko_gz_read(self._h, address, cap))

    def close(self) -> None:
        if self._h:
            get_lib().bronko_gz_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def native_read_fastq_chunks(path: str, chunk_reads: int, max_len: int = 512):
    """Yield (codes, lengths, n_reads) like io.fastq.read_fastq_chunks but
    decoded by the C++ reader. Rows beyond n_reads stay padding (code 4)."""
    lib = get_lib()
    assert lib is not None
    h = lib.bronko_fastq_open(path.encode())
    if not h:
        raise OSError(f"cannot open {path}")
    try:
        while True:
            codes = np.empty((chunk_reads, max_len), np.uint8)
            lengths = np.zeros(chunk_reads, np.int32)
            n = lib.bronko_fastq_read_chunk(h, codes, lengths, chunk_reads, max_len)
            if n < 0:
                raise ValueError(f"malformed FASTQ: {path}")
            if n == 0:
                break
            yield codes, lengths, int(n)
            if n < chunk_reads:
                break
    finally:
        lib.bronko_fastq_close(h)


def native_noise_scan(freqs: np.ndarray, taus: np.ndarray) -> np.ndarray:
    lib = get_lib()
    assert lib is not None
    L = freqs.shape[0]
    out = np.zeros((L, 3), np.float64)
    lib.bronko_noise_scan(np.ascontiguousarray(freqs, np.float64), L,
                          np.ascontiguousarray(taus, np.float64), taus.shape[0], out)
    return out
