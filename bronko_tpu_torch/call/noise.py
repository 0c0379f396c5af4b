"""Baseline-noise estimation: streaming modified-Thompson-tau outlier filter.

Faithful reimplementation of get_baseline_noise (call.rs:799-967): a centered
100-position window of the 3 minor-allele frequencies per position feeds
rolling n/s/s2 plus a top-10 max table; the largest values are iteratively
rejected as outliers while |max - mu| > tau * sigma, with tau derived from
the Student's-t inverse CDF.

Replicated quirks required for output parity:
  * the outlier rejection subtracts the VALUE from s2, not its square
    (call.rs:936), so curr_var can go negative -> sqrt gives NaN -> the NaN
    comparison terminates the loop exactly like Rust f64;
  * a new MAF marks its slot as "in the max table" even when it was too
    small to be inserted (call.rs:890), so stale removals can delete a
    different equal-valued entry or nothing;
  * tau = +inf while curr_n <= 2, and inf * 0.0 = NaN stops rejection.

The per-position frequency prep is vectorized; the window scan itself is an
inherently sequential O(L) recurrence over tiny state, so it runs on host in
f64 (TPU f32 would break parity; see docs/design.md).
"""

from __future__ import annotations

import functools
import math

import numpy as np

from bronko_tpu_torch.call._tau_golden import N_MAX as _TAU_N_MAX, TAU as _TAU_GOLDEN
from bronko_tpu_torch.consts import (
    NOISE_ALPHA as ALPHA,
    NOISE_MAX_TABLE_LEN as MAX_TABLE_LEN,
    NOISE_WINDOW_SIZE as WINDOW_SIZE,
)


@functools.lru_cache(maxsize=4096)
def _tau(curr_n: int) -> float:
    """Modified Thompson tau for the current sample size (call.rs:922-929).

    Served from the precomputed correctly-rounded table (_tau_golden.py:
    mpmath 50-digit Student's-t inverse CDF, rounded once to f64, then the
    reference's f64 tau formula). The window holds at most WINDOW_SIZE*3
    samples so curr_n < N_MAX always; the scipy fallback exists only for
    out-of-domain queries from tests. scipy's Cephes ppf is up to ~3.8e3 ulp
    off the correctly-rounded value (measured, tests/test_tau.py), which is
    why the table — not a library call — is the product path."""
    if curr_n <= 2:
        return math.inf
    if curr_n < _TAU_N_MAX:
        return _TAU_GOLDEN[curr_n]
    from scipy.stats import t as _student_t

    df = float(curr_n - 2)
    t_crit = float(_student_t.ppf(1.0 - ALPHA / curr_n, df))
    return (t_crit * (curr_n - 1.0)) / (
        math.sqrt(curr_n) * math.sqrt(curr_n - 2.0 + t_crit * t_crit)
    )


def _sqrt(x: float) -> float:
    return math.sqrt(x) if x >= 0.0 else float("nan")


def _minor_freqs(fwd_counts: np.ndarray, rev_counts: np.ndarray) -> np.ndarray:
    """(L, 3) minor-allele frequencies: per position the 4 strand-combined
    counts sorted descending, ranks 1..3 as fractions of depth."""
    totals = (fwd_counts + rev_counts).astype(np.int64)
    srt = np.sort(totals, axis=1)[:, ::-1].astype(np.float64)
    depth = srt.sum(axis=1)
    with np.errstate(invalid="ignore", divide="ignore"):
        freqs = np.where(depth[:, None] > 0,
                         srt / np.where(depth[:, None] > 0, depth[:, None], 1), 0.0)
    return np.ascontiguousarray(freqs[:, 1:4])


def _tau_table(n_max: int = 1024) -> np.ndarray:
    return np.asarray([_tau(n) for n in range(n_max)], np.float64)


def baseline_noise(fwd_counts: np.ndarray, rev_counts: np.ndarray) -> np.ndarray:
    """Per-position noise floor.

    Args:
      fwd_counts, rev_counts: (L, 4) integer depth-estimate pileups.

    Returns:
      (L, 3) float64 [max, mean, std] per position.

    Dispatches to the native C++ scan when available (identical operation
    order; tested equal in tests/test_native.py), else the Python loop.
    """
    freqs3 = _minor_freqs(fwd_counts, rev_counts)
    try:
        from bronko_tpu_torch.io.native import get_lib, native_noise_scan

        if get_lib() is not None:
            # window holds at most WINDOW_SIZE*3 samples
            return native_noise_scan(freqs3, _tau_table(WINDOW_SIZE * 3 + 2))
    except Exception:  # noqa: BLE001 — any native issue falls back to Python
        pass
    return _baseline_noise_py(freqs3)


def _baseline_noise_py(freqs3: np.ndarray) -> np.ndarray:
    L = freqs3.shape[0]
    out = np.zeros((L, 3), np.float64)
    window_counts = [0.0] * (WINDOW_SIZE * 3)
    in_max = [0] * (WINDOW_SIZE * 3)
    maxes = [0.0] * MAX_TABLE_LEN
    n = 0
    s = 0.0
    s2 = 0.0
    half = WINDOW_SIZE // 2

    for i in range(L + half):
        base_pos = (i % WINDOW_SIZE) * 3
        row = freqs3[i] if i < L else None

        for j in range(1, 4):
            idx = base_pos + (j - 1)
            old = window_counts[idx]
            if old > 0.0:
                n -= 1
                s -= old
                s2 -= old * old
                if in_max[idx] == 1:
                    pos = next(
                        (p for p, x in enumerate(maxes) if abs(x - old) < 1e-12), None
                    )
                    if pos is not None:
                        for kk in range(pos, MAX_TABLE_LEN - 1):
                            maxes[kk] = maxes[kk + 1]
                        maxes[MAX_TABLE_LEN - 1] = 0.0
                    in_max[idx] = 0

            maf = float(row[j - 1]) if row is not None else 0.0
            if maf > 0.0:
                n += 1
                s += maf
                s2 += maf * maf
                for kk in range(MAX_TABLE_LEN - 1, -1, -1):
                    if maf > maxes[kk]:
                        if kk + 1 < MAX_TABLE_LEN:
                            maxes[kk + 1] = maxes[kk]
                        maxes[kk] = maf
                    else:
                        break
                in_max[idx] = 1
            else:
                in_max[idx] = 0
            window_counts[idx] = maf

        if n != 0:
            mu = s / n
            var = (s2 / n) - mu * mu
        else:
            mu = 0.0
            var = 0.0

        curr_max_idx = 0
        curr_n = n
        curr_s = s
        curr_s2 = s2
        curr_mu = mu
        curr_var = var

        while curr_max_idx < MAX_TABLE_LEN and maxes[curr_max_idx] != 0.0:
            candidate = maxes[curr_max_idx]
            std = _sqrt(curr_var)
            tau = _tau(curr_n)
            if abs(candidate - curr_mu) > tau * std:
                curr_s -= candidate
                curr_s2 -= candidate  # value, not square: call.rs:936
                curr_n -= 1
                if curr_n > 0:
                    curr_mu = curr_s / curr_n
                    curr_var = (curr_s2 / curr_n) - curr_mu * curr_mu
                else:
                    curr_mu = 0.0
                    curr_var = 0.0
                curr_max_idx += 1
            else:
                break

        if i >= half:
            w = i - half
            if w < L:
                # Deliberate divergence: when every max-table entry was
                # rejected as an outlier (curr_max_idx == MAX_TABLE_LEN), the
                # reference indexes maxes[10] out of bounds and PANICS
                # (call.rs:954). We clamp to the last (just-rejected) entry —
                # graceful degradation instead of a crash; recorded in
                # docs/parity_checklist.md. The C++ twin clamps identically.
                out[w, 0] = maxes[min(curr_max_idx, MAX_TABLE_LEN - 1)]
                out[w, 1] = curr_mu
                out[w, 2] = _sqrt(curr_var)

    return out
