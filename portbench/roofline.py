"""The bytes the map kernels need, and their share of the card's roofline.

Every map kernel is bound by memory, so its least time is the bytes it
must move over the device memory's bandwidth: each input byte read once,
each output byte written once, and of the index only what these queries
touch. The counts come from the plain reference's own pass over the
sample (reference.mapper: k-mers, queries that hit, distinct index rows
they touch, posting lanes walked, pileup cells set), never from the
program. Where a kernel may read less than it is given (the saved probe's
histogram bytes below the selected genome), the least is counted, so
the share is a lower bound of the truth and never above it.

Per sample of N k-mers, J queries each, G genomes, k:
  K1 bucket_queries: N k-mers in; N*J bucket ids, N canonical k-mers, N
     strand flags out: N * (8 + 8J + 8 + 1).
  K2 fold_table: N k-mers and counts in; N*k 4-byte records out.
  (b) probe_tally: N*J ids and N counts in; of the index, each touched
     row's key (8), CSR start (4) and histogram bytes (G); N*J starts (4)
     and N*J histogram rows (G) out.
  (d) walk_hits: N*J lengths in, the start of each hit query (4), a
     genome id (4) per posting lane; N*G hit counts (4) out.
  (c) walk_scatter, saved probe: one histogram byte per query (the
     selected genome's), the start (4) and the fold record (4) of each
     query it walks, a posting (4) per lane, each pileup cell set (4).
     Through the sub-index: a length (4) per query instead of the byte,
     and K1 a second time over the N k-mers.
Paths: ("hist" | "words", "saved" | "fused" | "streamed") run K1, (b),
K2, (c) on the saved probe; ("flat", "subindex") runs K1, (d), then K1,
K2, (c) through the sub-index.
"""

from __future__ import annotations

import re

# H100 SXM device memory bandwidth, NVIDIA's data sheet (at 700 W)
PEAK_BYTES_PER_S = 3.35e12


class OverRoofline(ValueError):
    """A share above 100%: the bytes are counted too high or the time
    leaves out part of the work."""


_NAME = re.compile(r"\b(bucket_queries|fold_table|probe_tally|probe_tally_words|walk_scatter|"
                   r"walk_hits)_kernel\b")


def kernel_of(trace_name: str) -> str | None:
    """The map kernel a trace's kernel name belongs to, or None."""
    m = _NAME.search(trace_name)
    if not m:
        return None
    name = m.group(1)
    return "probe_tally" if name == "probe_tally_words" else name


def sample_bytes(work: dict, path: tuple[str, str], k: int, J: int, G: int) -> dict[str, int]:
    """Bytes needed by each map kernel for one sample on `path`."""
    N = int(work["kmers"])
    NJ = N * J
    k1 = N * (8 + 8 * J + 8 + 1)
    k2 = N * (8 + 4 + 4 * k)
    walked = int(work["best_queries"]) * (4 + 4) + int(work["best_lanes"]) * 4 \
        + int(work["pileup_cells"]) * 4
    mode, _ = path
    if mode in ("hist", "words"):
        return {
            "bucket_queries": k1,
            "probe_tally": NJ * 8 + N * 4 + int(work["rows_touched"]) * (8 + 4 + G)
            + NJ * 4 + NJ * G,
            "fold_table": k2,
            "walk_scatter": NJ * 1 + walked,
        }
    if mode == "flat":
        return {
            "bucket_queries": 2 * k1,
            "walk_hits": NJ * 4 + int(work["hit_queries"]) * 4 + int(work["flat_lanes"]) * 4
            + N * G * 4,
            "fold_table": k2,
            "walk_scatter": NJ * 4 + walked,
        }
    raise ValueError(f"no byte count for path {path}")


def share(samples: list[tuple[dict, tuple[str, str]]], kernel_seconds: dict[str, float],
          k: int, J: int, G: int) -> tuple[float | None, dict]:
    """Percent of the roofline over the traced samples: the least time of
    the bytes they need over the time the map kernels took, counting only
    kernels that ran. Returns (share or None, per-kernel detail)."""
    need: dict[str, int] = {}
    for work, path in samples:
        for name, b in sample_bytes(work, path, k, J, G).items():
            need[name] = need.get(name, 0) + b
    ran = {n: s for n, s in kernel_seconds.items() if s > 0 and n in need}
    if not ran:
        return None, {}
    least = sum(need[n] for n in ran) / PEAK_BYTES_PER_S
    detail = {n: {"bytes": need[n], "seconds": s, "pct": 100.0 * need[n] / PEAK_BYTES_PER_S / s}
              for n, s in ran.items()}
    return 100.0 * least / sum(ran.values()), detail


def kernel_seconds(trace_kernels: dict) -> dict[str, float]:
    """A trace reduction's kernels (name -> [launches, seconds]) summed by
    map kernel."""
    out: dict[str, float] = {}
    for name, (_, seconds) in trace_kernels.items():
        k = kernel_of(name)
        if k is not None:
            out[k] = out.get(k, 0.0) + seconds
    return out
