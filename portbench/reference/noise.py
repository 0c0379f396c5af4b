"""Baseline-noise estimation: the streaming modified-Thompson-tau filter.

The scan is a frozen copy of the port's host noise scan
(bronko_tpu_torch/call/noise.py, its Python loop; upstream
get_baseline_noise, call.rs:799-967), with its quirks kept for output
parity: the outlier rejection subtracts the value, not its square, from
s2; a new frequency marks its slot as in the max table even when too
small to enter it; tau is +inf while n <= 2. Tau is worked out here from
its formula (call.rs:922-929), not taken from the program's table: the
Student's t critical value at 1 - alpha/n with n - 2 degrees of freedom,
found to 40 digits on the exact tail and rounded once to float64, then
the tau expression in float64 in upstream's order of operations.
"""

from __future__ import annotations

import functools
import math

import mpmath as mp
import numpy as np

WINDOW_SIZE = 100
MAX_TABLE_LEN = WINDOW_SIZE // 10
ALPHA = "0.001"  # call.rs:803
_TAU_N_MAX = WINDOW_SIZE * 3 + 2  # the window holds at most 300 frequencies


def _t_crit(n: int) -> float:
    """Student's t quantile at 1 - ALPHA/n, n - 2 degrees of freedom:
    Newton steps on the exact upper tail, I_{nu/(nu+x^2)}(nu/2, 1/2) / 2,
    from scipy's float64 estimate, at 40 digits; rounded once."""
    from scipy.stats import t as student

    with mp.workdps(40):
        nu, q = mp.mpf(n - 2), mp.mpf(ALPHA) / n
        pdf0 = mp.gamma((nu + 1) / 2) / (mp.sqrt(nu * mp.pi) * mp.gamma(nu / 2))
        x = mp.mpf(float(student.isf(float(q), n - 2)))
        for _ in range(50):
            tail = mp.betainc(nu / 2, mp.mpf(1) / 2, 0, nu / (nu + x * x), regularized=True) / 2
            step = (tail - q) / (pdf0 * (1 + x * x / nu) ** (-(nu + 1) / 2))
            x += step
            if abs(step) < mp.mpf(10) ** -35 * x:
                return float(x)
    raise ArithmeticError(f"t quantile for n = {n} did not converge")


@functools.lru_cache(maxsize=None)
def _tau(curr_n: int) -> float:
    """Modified Thompson tau for the current sample size (call.rs:922-929)."""
    if curr_n <= 2:
        return math.inf
    if curr_n >= _TAU_N_MAX:
        raise ValueError(f"no tau for n = {curr_n}: the window holds at most "
                         f"{WINDOW_SIZE * 3} frequencies")
    t = _t_crit(curr_n)
    return (t * (curr_n - 1.0)) / (math.sqrt(curr_n) * math.sqrt(curr_n - 2.0 + t * t))


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


def baseline_noise(fwd_counts: np.ndarray, rev_counts: np.ndarray) -> np.ndarray:
    """(L, 3) float64 [max, mean, std] noise floor per position, from the
    (L, 4) depth-estimate pileups of both strands."""
    return _baseline_noise_py(_minor_freqs(fwd_counts, rev_counts))


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
