// Streaming modified-Thompson-tau baseline-noise scan.
//
// Native implementation of the sequential window recurrence of
// get_baseline_noise (reference call.rs:799-967), operation-for-operation
// identical to bronko_tpu_torch/call/noise.py (including the replicated quirks:
// s2 -= value on outlier rejection, stale max-table membership flags,
// NaN-terminated rejection loops). The per-position frequency prep and the
// Student's-t tau table are computed by the caller; this scan is O(L) with
// tiny state and dominates host time only when L is large or samples many.
//
// freqs:  L x 3 row-major minor-allele frequencies (descending counts 1..3)
// taus:   tau[n] for current sample size n (index by n; n >= tau_len -> last)
// out:    L x 3 row-major [max, mean, std]

#include <cmath>
#include <cstdint>
#include <cstring>

namespace {
constexpr int kWindow = 100;
constexpr int kMaxTable = kWindow / 10;
}

extern "C" void bronko_noise_scan(const double* freqs, int64_t L,
                                  const double* taus, int64_t tau_len,
                                  double* out) {
  double window_counts[kWindow * 3];
  int in_max[kWindow * 3];
  double maxes[kMaxTable];
  memset(window_counts, 0, sizeof(window_counts));
  memset(in_max, 0, sizeof(in_max));
  memset(maxes, 0, sizeof(maxes));

  int64_t n = 0;
  double s = 0.0, s2 = 0.0;
  const int half = kWindow / 2;

  for (int64_t i = 0; i < L + half; ++i) {
    int base_pos = (int)(i % kWindow) * 3;
    for (int j = 1; j < 4; ++j) {
      int idx = base_pos + (j - 1);
      double old = window_counts[idx];
      if (old > 0.0) {
        --n;
        s -= old;
        s2 -= old * old;
        if (in_max[idx] == 1) {
          int pos = -1;
          for (int p = 0; p < kMaxTable; ++p) {
            if (std::fabs(maxes[p] - old) < 1e-12) { pos = p; break; }
          }
          if (pos >= 0) {
            for (int kk = pos; kk < kMaxTable - 1; ++kk) maxes[kk] = maxes[kk + 1];
            maxes[kMaxTable - 1] = 0.0;
          }
          in_max[idx] = 0;
        }
      }
      double maf = (i < L) ? freqs[i * 3 + (j - 1)] : 0.0;
      if (maf > 0.0) {
        ++n;
        s += maf;
        s2 += maf * maf;
        for (int kk = kMaxTable - 1; kk >= 0; --kk) {
          if (maf > maxes[kk]) {
            if (kk + 1 < kMaxTable) maxes[kk + 1] = maxes[kk];
            maxes[kk] = maf;
          } else {
            break;
          }
        }
        in_max[idx] = 1;
      } else {
        in_max[idx] = 0;
      }
      window_counts[idx] = maf;
    }

    double mu = 0.0, var = 0.0;
    if (n != 0) {
      mu = s / (double)n;
      var = (s2 / (double)n) - mu * mu;
    }

    int curr_max_idx = 0;
    int64_t curr_n = n;
    double curr_s = s, curr_s2 = s2, curr_mu = mu, curr_var = var;

    while (curr_max_idx < kMaxTable && maxes[curr_max_idx] != 0.0) {
      double candidate = maxes[curr_max_idx];
      double std_ = std::sqrt(curr_var);  // NaN when curr_var < 0, as f64
      double tau = (curr_n < tau_len) ? taus[curr_n]
                                      : taus[tau_len > 0 ? tau_len - 1 : 0];
      if (std::fabs(candidate - curr_mu) > tau * std_) {
        curr_s -= candidate;
        curr_s2 -= candidate;  // value, not square: reference call.rs:936
        --curr_n;
        if (curr_n > 0) {
          curr_mu = curr_s / (double)curr_n;
          curr_var = (curr_s2 / (double)curr_n) - curr_mu * curr_mu;
        } else {
          curr_mu = 0.0;
          curr_var = 0.0;
        }
        ++curr_max_idx;
      } else {
        break;
      }
    }

    if (i >= half) {
      int64_t w = i - half;
      if (w < L) {
        int mi = curr_max_idx < kMaxTable ? curr_max_idx : kMaxTable - 1;
        out[w * 3 + 0] = maxes[mi];
        out[w * 3 + 1] = curr_mu;
        out[w * 3 + 2] = std::sqrt(curr_var);
      }
    }
  }
}
