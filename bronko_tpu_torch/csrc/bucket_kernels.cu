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
// plain unsigned overflow.
//
// K1 is bound by bytes at best: 8 read and 8*J + 9 written a k-mer (145
// at k = 21, J = 16: 43 us for 1,000,003 k-mers at 3.35 TB/s). Its
// arithmetic comes close to that: each of the k positions takes a 64-bit
// shift, mask and multiply. So the kernel is compiled once for every k
// (1-31) and picks its instance by a switch: the position loops unroll,
// every shift is a constant and the weight k-1-i a constant factor. Each
// position's pieces (base, cur, val, mu) are computed once, in one pass
// that sums mu and, for a kept position, stores t_i = val_i - mu_i -
// num_a_i*cur_i + num_a_i; bucket_i is sum_mu + 1 + t_i, the sum added as
// the row is copied out. The (B, J) row-major output would be a strided
// store if each thread wrote its own row (a warp's 32 rows lie 8*J bytes
// apart), so a block of kRows k-mers stages its (kRows, J) tile in shared
// memory, rows padded to an odd stride (J | 1 words) so that the row
// writes of a half-warp hit distinct banks, and then writes the tile's
// kRows*J contiguous words with 16-byte stores by consecutive threads.
// The tile is sized by J at launch (18 KB at J = 16), so more blocks fit
// an SM. canon and is_rc are one coalesced store each.
//
// K2 is bound by bytes too: 12 read and 4*k written a k-mer (96 B at
// k = 21: 28.7 us for 1,000,003 k-mers at 3.35 TB/s). A thread for each
// record would need a division by k and the k-mer's reverse complement
// again for each of its k records, and be bound by issued instructions.
// So one thread takes one k-mer: the kernel is compiled for every k (the
// same switch as K1), so every shift is a constant; the canonical form,
// is_rc and the record's head (is_rc << 4 | count << 5) are computed
// once, then its k records. A block of kFoldRows k-mers stages its (kFoldRows, k)
// int32 tile in shared memory, rows at an odd stride (k | 1) so that a
// half-warp's row writes hit distinct banks, and writes the block's
// kFoldRows*k contiguous records (a multiple of 16 bytes, so every
// block's output starts aligned) with 16-byte stores by consecutive
// threads; at odd k the tile is the output's layout and is read back as
// 16-byte vectors. The ragged last block writes its tail one by one.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kFoldRows = 128;  // K2's block: k-mers (threads) a block
constexpr int kRows = 128;     // K1's block: k-mers (threads) a block

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

// One thread per k-mer; `keep` has bit i set for each kept wildcard
// position i (J of them, written in position order). Dynamic shared
// memory: kRows words of sum(mu) + 1, then the (kRows, J | 1) tile.
template <int K>
__global__ void __launch_bounds__(kRows)
    bucket_queries_kernel(const uint64_t* __restrict__ kmers, int64_t n,
                          uint32_t keep, int J, uint64_t* __restrict__ q,
                          uint64_t* __restrict__ canon_out,
                          uint8_t* __restrict__ is_rc_out) {
  extern __shared__ uint64_t smem[];
  uint64_t* sums = smem;
  uint64_t* tile = smem + kRows;
  const int stride = J | 1;
  const int64_t row0 = (int64_t)blockIdx.x * kRows;
  const int rows = n - row0 < kRows ? (int)(n - row0) : kRows;
  const int r = threadIdx.x;
  if (r < rows) {
    const uint64_t fwd = kmers[row0 + r];
    const uint64_t rc = revcomp(fwd, K);
    const bool flag = fwd >= rc;
    const uint64_t c = flag ? rc : fwd;

    // bucket_i = sum_mu - mu_i + val_i - num_a_i*cur_i + 1 + num_a_i, with
    // num_a_i the count of 'A' bases strictly before i
    // (bronko_tpu/ops/buckets.py closed forms): the row keeps the terms
    // of position i, sums[r] the sum_mu + 1 that the copy-out adds
    uint64_t* row = tile + r * stride;
    uint64_t sum_mu = 0;
    uint32_t num_a = 0;
    int j = 0;
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const int shift = 2 * (K - 1 - i);
      const uint32_t base = (uint32_t)(c >> shift) & 3u;
      const uint64_t one_at = 1ull << shift;
      const uint64_t val = c & (one_at - 1);
      // with cur = base << shift: (cur >> 2) * (K-1-i) as
      // (base * (K-1-i)) << (shift - 2) (0 at the last position, where
      // K-1-i is 0), and num_a * cur as (num_a * base) << shift; the same
      // bits mod 2^64, from one 32-bit multiply each
      const uint64_t wcur = (uint64_t)(base * (K - 1 - i)) << (shift > 0 ? shift - 2 : 0);
      const uint64_t mu = base ? one_at + wcur : val;
      sum_mu += mu;
      if ((keep >> i) & 1u) {
        row[j++] = val - mu - ((uint64_t)(num_a * base) << shift) + num_a;
      }
      num_a += base == 0;
    }
    sums[r] = sum_mu + 1;
    canon_out[row0 + r] = c;
    is_rc_out[row0 + r] = flag;
  }
  __syncthreads();
  if (J == 0) return;

  // the tile's rows*J words are contiguous in q: word w is row w / J,
  // column w % J, at tile[row * stride + column]. A thread copies the pair
  // (w, w+1) with w = 2*threadIdx.x + 2*kRows*m, tracking its row and
  // column by steps instead of a division each time.
  const uint32_t W = (uint32_t)rows * J;
  ulonglong2* __restrict__ out = reinterpret_cast<ulonglong2*>(q + row0 * J);
  const uint32_t step = 2 * kRows;
  const uint32_t step_rows = step / J, step_cols = step % J;
  uint32_t w = 2 * threadIdx.x;
  uint32_t wr = w / J, wc = w % J;
  for (; w + 1 < W; w += step) {
    const uint32_t a = wr * stride + wc;
    const bool same_row = wc + 1 < (uint32_t)J;
    const uint32_t b = same_row ? a + 1 : (wr + 1) * stride;
    out[w / 2] = make_ulonglong2(tile[a] + sums[wr], tile[b] + sums[same_row ? wr : wr + 1]);
    wc += step_cols;
    wr += step_rows;
    if (wc >= (uint32_t)J) {
      wc -= J;
      ++wr;
    }
  }
  if ((W & 1) && threadIdx.x == 0) {  // an odd word count: the last word
    q[row0 * J + W - 1] = tile[(rows - 1) * stride + J - 1] + sums[rows - 1];
  }
}

// One thread per k-mer b: out[b*K+i] packs the canonical base at i (bits
// 0-1), the complement of the canonical base at K-1-i (bits 2-3), is_rc
// (bit 4) and the count (bits 5 and up). Built in uint32_t: `count << 5`
// on a signed int is undefined on overflow, while the JAX original wraps.
template <int K>
__global__ void __launch_bounds__(kFoldRows)
    fold_table_kernel(const uint64_t* __restrict__ kmers,
                      const int32_t* __restrict__ counts, int64_t n,
                      uint32_t* __restrict__ out) {
  constexpr int kStride = K | 1;
  __shared__ __align__(16) uint32_t tile[kFoldRows * kStride];
  const int64_t row0 = (int64_t)blockIdx.x * kFoldRows;
  const int rows = n - row0 < kFoldRows ? (int)(n - row0) : kFoldRows;
  const int r = threadIdx.x;
  if (r < rows) {
    const uint64_t fwd = kmers[row0 + r];
    const uint64_t rc = revcomp(fwd, K);
    const bool flag = fwd >= rc;
    const uint64_t c = flag ? rc : fwd;
    const uint32_t head = ((uint32_t)flag << 4) | ((uint32_t)counts[row0 + r] << 5);
    uint32_t* row = tile + r * kStride;
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const uint32_t base = (uint32_t)(c >> (2 * (K - 1 - i))) & 3u;
      const uint32_t mirror = (uint32_t)(c >> (2 * i)) & 3u;
      row[i] = base | ((3u - mirror) << 2) | head;
    }
  }
  __syncthreads();

  // the block's rows*K records are contiguous in out; record w is row
  // w / K, column w % K, at tile[row * kStride + column]
  const uint32_t total = (uint32_t)rows * K;
  uint32_t* dst = out + row0 * K;
  uint32_t w = 4 * threadIdx.x;
  for (; w + 3 < total; w += 4 * kFoldRows) {
    uint4 v;
    if (K % 2) {  // kStride == K: the tile is laid out as the output
      v = *reinterpret_cast<const uint4*>(tile + w);
    } else {
      v = make_uint4(tile[(w / K) * kStride + w % K], tile[((w + 1) / K) * kStride + (w + 1) % K],
                     tile[((w + 2) / K) * kStride + (w + 2) % K],
                     tile[((w + 3) / K) * kStride + (w + 3) % K]);
    }
    *reinterpret_cast<uint4*>(dst + w) = v;
  }
  for (; w < total; ++w) {  // the ragged last block: up to 3 records past the last vector
    dst[w] = tile[(w / K) * kStride + w % K];
  }
}

}  // namespace

// The kernels' instances for every k the port takes (1-31), as the cases
// of a switch on k.
#define BRONKO_EACH_K(CASE)                                                   \
  CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8) CASE(9)     \
  CASE(10) CASE(11) CASE(12) CASE(13) CASE(14) CASE(15) CASE(16) CASE(17)     \
  CASE(18) CASE(19) CASE(20) CASE(21) CASE(22) CASE(23) CASE(24) CASE(25)     \
  CASE(26) CASE(27) CASE(28) CASE(29) CASE(30) CASE(31)

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
  if (k < 1 || k > 31 || J < 0 || J > k) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const unsigned blocks = (unsigned)((n + kRows - 1) / kRows);
    // at most (1 + 31) * 128 * 8 = 32 KB: no opt-in above 48 KB needed
    const size_t smem = sizeof(uint64_t) * kRows * (1 + (J | 1));
    const uint64_t* in = reinterpret_cast<const uint64_t*>(kmers);
    uint64_t* qo = reinterpret_cast<uint64_t*>(q);
    uint64_t* co = reinterpret_cast<uint64_t*>(canon);
    switch (k) {
#define BRONKO_K1_CASE(K)                                                   \
  case K:                                                                   \
    bucket_queries_kernel<K>                                                \
        <<<blocks, kRows, smem, stream>>>(in, n, keep, J, qo, co, is_rc);   \
    break;
      BRONKO_EACH_K(BRONKO_K1_CASE)
#undef BRONKO_K1_CASE
    }
  }
  return (int)cudaGetLastError();
}

extern "C" int bronko_fold_table(int device, const int64_t* kmers,
                                 const int32_t* counts, int64_t n, int k,
                                 int32_t* out, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (k < 1 || k > 31) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const unsigned blocks = (unsigned)((n + kFoldRows - 1) / kFoldRows);
    const uint64_t* in = reinterpret_cast<const uint64_t*>(kmers);
    uint32_t* o = reinterpret_cast<uint32_t*>(out);
    switch (k) {
#define BRONKO_K2_CASE(K)                                                    \
  case K:                                                                    \
    fold_table_kernel<K><<<blocks, kFoldRows, 0, stream>>>(in, counts, n, o); \
    break;
      BRONKO_EACH_K(BRONKO_K2_CASE)
#undef BRONKO_K2_CASE
    }
  }
  return (int)cudaGetLastError();
}
