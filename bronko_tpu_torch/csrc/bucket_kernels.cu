// Hopper kernels for the mapper's k-mer front end (pass 1 queries, pass 2
// fold table), with a plain C launch interface, wrapped by
// bronko_tpu_torch/ops/cuda_buckets.py and built and loaded with the
// port's other kernels by ops/cuda_lib.py.
//
// K1 bucket_queries replaces bronko_tpu/ops/pallas_buckets.py
//   bucket_queries_pallas / _bucket_kernel (+ _canonical_u32).
// K2 fold_table replaces bronko_tpu/ops/pallas_buckets.py
//   fold_table_pallas / _fold_kernel.
//
// The TPU kernels emulated u64 arithmetic on (hi, lo) u32 planes because
// Mosaic has no 64-bit integers; Hopper has them natively, so every word
// here is a uint64_t and u64 wrap-around (the bucket hash at k=31) is
// plain unsigned overflow. Both kernels are bound by device memory, not
// arithmetic: K1 reads 8 bytes and writes 8*(J+1)+1 per k-mer, K2 reads
// 12 bytes per k-mer and writes 4*k. A thread computes one output row
// (K1) or one output word (K2) entirely in registers, so nothing
// intermediate touches memory. K1's (B, J) row-major store is strided
// across a warp; staging it through shared memory for coalesced stores is
// left for a later change.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// Reverse complement of the low 2k bits: complement, reverse the 32 2-bit
// groups of the word, shift the k meaningful groups down. Equal to the
// reference's k-step loop (lcb.rs:76-85) for every input.
__device__ __forceinline__ uint64_t revcomp(uint64_t x, int k) {
  x = ~x;
  x = ((x >> 2) & 0x3333333333333333ull) | ((x & 0x3333333333333333ull) << 2);
  x = ((x >> 4) & 0x0F0F0F0F0F0F0F0Full) | ((x & 0x0F0F0F0F0F0F0F0Full) << 4);
  x = ((x >> 8) & 0x00FF00FF00FF00FFull) | ((x & 0x00FF00FF00FF00FFull) << 8);
  x = ((x >> 16) & 0x0000FFFF0000FFFFull) | ((x & 0x0000FFFF0000FFFFull) << 16);
  x = (x >> 32) | (x << 32);
  return x >> (64 - 2 * k);
}

// mu_i and its pieces for wildcard position i of canonical k-mer c
// (bronko_tpu/ops/buckets.py closed forms).
struct Pos {
  uint64_t base, cur, val, mu;
};

__device__ __forceinline__ Pos position(uint64_t c, int k, int i) {
  const int shift = 2 * (k - 1 - i);
  Pos p;
  p.base = (c >> shift) & 3ull;
  p.cur = p.base << shift;
  const uint64_t one_at = 1ull << shift;
  p.val = c & (one_at - 1);
  p.mu = p.base ? one_at + (p.cur >> 2) * (uint64_t)(k - 1 - i) : p.val;
  return p;
}

__global__ void bucket_queries_kernel(const uint64_t* __restrict__ kmers,
                                      int64_t n, int k, uint32_t keep, int J,
                                      uint64_t* __restrict__ q,
                                      uint64_t* __restrict__ canon_out,
                                      uint8_t* __restrict__ is_rc_out) {
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n) return;
  const uint64_t fwd = kmers[b];
  const uint64_t rc = revcomp(fwd, k);
  const bool flag = fwd >= rc;
  const uint64_t c = flag ? rc : fwd;

  uint64_t sum_mu = 0;
  for (int i = 0; i < k; ++i) sum_mu += position(c, k, i).mu;

  // bucket_i = sum_mu - mu_i + val_i - num_a_i*cur_i + 1 + num_a_i, with
  // num_a_i the count of 'A' bases strictly before i
  uint64_t num_a = 0;
  uint64_t* row = q + b * J;
  int j = 0;
  for (int i = 0; i < k; ++i) {
    const Pos p = position(c, k, i);
    if ((keep >> i) & 1u) {
      row[j++] = sum_mu - p.mu + p.val - num_a * p.cur + 1 + num_a;
    }
    num_a += (p.base == 0);
  }
  canon_out[b] = c;
  is_rc_out[b] = flag;
}

// One thread per (k-mer b, position i): out[b*k+i] packs the canonical
// base at i (bits 0-1), the complement of the canonical base at k-1-i
// (bits 2-3), is_rc (bit 4) and the count (bits 5 and up). Built in
// uint32_t: `count << 5` on a signed int is undefined on overflow, while
// the JAX original wraps.
__global__ void fold_table_kernel(const uint64_t* __restrict__ kmers,
                                  const int32_t* __restrict__ counts,
                                  int64_t n, int k,
                                  int32_t* __restrict__ out) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n * k) return;
  const int64_t b = t / k;
  const int i = (int)(t - b * k);
  const uint64_t fwd = kmers[b];
  const uint64_t rc = revcomp(fwd, k);
  const bool flag = fwd >= rc;
  const uint64_t c = flag ? rc : fwd;
  const uint32_t base = (uint32_t)((c >> (2 * (k - 1 - i))) & 3ull);
  const uint32_t mirror = (uint32_t)((c >> (2 * i)) & 3ull);
  const uint32_t rec = base | ((3u - mirror) << 2) | ((uint32_t)flag << 4) |
                       ((uint32_t)counts[b] << 5);
  out[t] = (int32_t)rec;
}

int64_t blocks_for(int64_t n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

// Each entry point selects `device` (this library links its own CUDA
// runtime, whose current device is not PyTorch's), launches on `stream`,
// never synchronises, and returns the CUDA error code (0 on success) so
// the caller can raise on a refused launch.
extern "C" int bronko_bucket_queries(int device, const int64_t* kmers,
                                     int64_t n, int k, uint32_t keep, int J,
                                     int64_t* q, int64_t* canon,
                                     uint8_t* is_rc, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    bucket_queries_kernel<<<(unsigned)blocks_for(n), kThreads, 0, stream>>>(
        reinterpret_cast<const uint64_t*>(kmers), n, k, keep, J,
        reinterpret_cast<uint64_t*>(q), reinterpret_cast<uint64_t*>(canon),
        is_rc);
  }
  return (int)cudaGetLastError();
}

extern "C" int bronko_fold_table(int device, const int64_t* kmers,
                                 const int32_t* counts, int64_t n, int k,
                                 int32_t* out, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    fold_table_kernel<<<(unsigned)blocks_for(n * k), kThreads, 0, stream>>>(
        reinterpret_cast<const uint64_t*>(kmers), counts, n, k, out);
  }
  return (int)cudaGetLastError();
}
