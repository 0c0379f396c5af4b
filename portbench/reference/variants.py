"""The per-position filter cascade of bronko's caller.

A frozen copy of the port's host caller (bronko_tpu_torch/call/variants.py;
upstream call_variants, call.rs:969-1150), in float64 as bronko states,
with one addition: `ftype`, the float type the cascade computes in, so
the benchmark's control can run it one precision lower (float32).

Per (position, alt base): the strand odds ratio with +1 pseudocounts
(skipped, and reported as -1.0, under the strand-balance bypass), at
least n_per_strand distinct k-mers on one strand, an allele frequency of
at least min_af and of the noise floor times the multiplier (tightened
below ~1% AF), and for a minor (AF < 0.5) total depth >= min_depth and
alt depth >= min_variant_depth.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

BITS = np.zeros(256, np.uint8)
for _c, _v in zip(b"ACGT", range(4)):
    BITS[_c] = _v
    BITS[_c + 32] = _v


@dataclass
class Record:
    seq: str
    pos: int        # 1-based
    ref_base: int   # 2-bit code
    alt_base: int
    fwd_ref: int
    rev_ref: int
    fwd_alt: int
    rev_alt: int
    depth: int
    af: float
    sor: float


@dataclass
class Stats:
    num_major: int = 0
    num_minor: int = 0
    positions_covered: int = 0
    total_positions: int = 0
    total_coverage: int = 0

    @property
    def breadth(self) -> float:
        if not self.total_positions:
            return float("nan")
        return self.positions_covered / self.total_positions

    @property
    def depth(self) -> float:
        if not self.positions_covered:
            return float("nan")
        return self.total_coverage / self.positions_covered


def call_variants(seq_name: str, ref_bytes: bytes, fwd_depth: np.ndarray, rev_depth: np.ndarray,
                  fwd_cnt: np.ndarray, rev_cnt: np.ndarray, noise_max: np.ndarray, *, k: int,
                  p: dict, stats: Stats, ftype=np.float64) -> list[Record]:
    """Records of one sequence from its (L, 4) pileups and (L,) noise maxima;
    `p` holds the call parameters (the keys of portbench.reference.DEFAULTS)."""
    ft = np.dtype(ftype)
    L = fwd_depth.shape[0]
    ref_bits = BITS[np.frombuffer(ref_bytes, np.uint8)].astype(np.int64)

    fwd = fwd_depth.astype(np.int64)
    rev = rev_depth.astype(np.int64)
    row_total = fwd + rev
    total_depth = row_total.sum(axis=1)

    start, end = (k, L - k) if not p["no_end_filter"] else (0, L)
    in_range = np.zeros(L, bool)
    if end > start:
        in_range[start:end] = True

    stats.total_positions += L
    covered = in_range & (total_depth > 0)
    stats.positions_covered += int(covered.sum())
    stats.total_coverage += int(total_depth[covered].sum())

    pos_idx = np.arange(L)
    alt = np.arange(4)[None, :]
    is_ref = alt == ref_bits[:, None]
    candidate = covered[:, None] & ~is_ref & (row_total > 0)

    odds_max = p["strand_odds_max"]
    sor = np.full((L, 4), odds_max + 1.0, dtype=ft)
    keep = candidate.copy()
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        if not p["no_strand_filter"]:
            a = fwd[pos_idx, ref_bits].astype(ft)[:, None] + 1.0
            b = rev[pos_idx, ref_bits].astype(ft)[:, None] + 1.0
            c = fwd.astype(ft) + 1.0
            d = rev.astype(ft) + 1.0
            ref_total = a + b + c + d
            min_strand = np.minimum(a + c, b + d)
            msp = min_strand / ref_total
            do_sor = (not p["no_strand_balance_filter"]) | (msp >= p["strand_balance_ratio"])
            r = (a * d) / (b * c)
            rr = np.minimum(a, b) / np.maximum(a, b)
            ar = np.minimum(c, d) / np.maximum(c, d)
            sor_val = np.log(r + 1.0 / r) + np.log(rr) - np.log(ar)
            sor = np.where(do_sor, sor_val, -1.0).astype(ft)
            kmer_ok = (fwd_cnt >= p["n_per_strand"]) | (rev_cnt >= p["n_per_strand"])
            keep &= np.where(do_sor, (sor_val <= odds_max) & kmer_ok, True)

        alt_count = row_total
        af = np.where(total_depth[:, None] > 0,
                      alt_count.astype(ft) / np.maximum(total_depth[:, None], 1).astype(ft),
                      0.0).astype(ft)
        mult = p["noise_multiplier"]
        factor = mult + 0.5 * np.power(ft.type(0.03), 100.0 * af)
        noise_thresh = np.maximum(factor, mult) * noise_max.astype(ft)[:, None]
        keep &= (af >= p["min_af"]) & (af >= noise_thresh)

        is_major = af >= 0.5
        minor_ok = (total_depth[:, None] >= p["min_depth"]) & (alt_count >= p["min_variant_depth"])
        keep &= is_major | minor_ok

    records: list[Record] = []
    li, ai = np.nonzero(keep)
    stats.num_major += int(is_major[li, ai].sum())
    stats.num_minor += int((~is_major[li, ai]).sum())
    for i, a_ in zip(li.tolist(), ai.tolist()):
        rb = int(ref_bits[i])
        records.append(Record(
            seq=seq_name, pos=i + 1, ref_base=rb, alt_base=a_,
            fwd_ref=int(fwd[i, rb]), rev_ref=int(rev[i, rb]),
            fwd_alt=int(fwd[i, a_]), rev_alt=int(rev[i, a_]),
            depth=int(total_depth[i]), af=float(af[i, a_]), sor=float(sor[i, a_]),
        ))
    return records
