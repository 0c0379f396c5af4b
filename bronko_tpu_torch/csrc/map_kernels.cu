// Hopper kernels for the mapper's two passes after K1 and K2, with a plain
// C launch interface, wrapped by bronko_tpu_torch/ops/cuda_map.py and
// built and loaded with the port's other kernels by ops/cuda_lib.py.
//
// Neither replaces a Pallas kernel: on the TPU this work was XLA.
//
// (b) probe_tally fuses pass 1 after K1 for the single-word histogram
//   (bronko_tpu/ops/map.py _tally_save_body: the merge probe, the
//   histogram pickup, _hist_hits and classify_tallies). One thread takes
//   one (k-mer, bucket) query: a binary search over the sorted keys (bit
//   63 flipped, so the signed order is the unsigned one) for the LAST row
//   equal to the query, the row's CSR start on a hit and its histogram
//   word where the k-mer's count is positive. A block holds whole k-mers
//   (kTallyThreads / J of them, their J queries on consecutive threads, so
//   every load of q and store of start and h is coalesced); each thread
//   adds its word's G <= 8 bytes to its k-mer's hits in shared memory,
//   then one thread a k-mer classifies them (perfect: hits == J; variant:
//   0 < hits != J; unique: the only perfect genome). The block sums its
//   tallies and per-genome lanes in shared memory and adds them to the
//   (G, 3) int32 tallies and the (G,) int64 lanes with one global atomic
//   each. Integer sums: any order gives the same.
//   Bound: the search's ~log2 U dependent loads a query (the upper levels
//   shared and cached). A first design gave each k-mer one thread that ran
//   its J searches in series: at the main batch (152,679 k-mers, one wave
//   of threads) the kernel took the time of one thread's 16 x 22
//   dependent loads, 0.31 ms; a thread a query keeps J times more loads in
//   flight. The byte bound counts the queries, the keys, CSR starts and
//   words once, and the outputs.
//
// (c) walk_scatter is pass 2 without a lane count known on the host
//   (bronko_tpu/ops/map.py _pileup_from_saved_body / _scatter_lanes; the
//   port's _walk + _walk_scatter). One thread takes one (k-mer, bucket)
//   row and loops over its own posting range, so no lane budget, no
//   repeat_interleave and no host value sizes anything. A row's range is
//   given (start, lens), or derived from the saved probe (start, h) and a
//   device pointer to the selected genome `best`: its length is byte
//   `best` of h and its offset in the bucket the sum of the bytes below
//   (postings grouped by genome; JAX _saved_lens_prefix). Each posting is
//   decoded as _walk_scatter does (int32 lpos<<6 | canon<<5 | idx, or
//   int64 pos<<22 | meta with pos moved by -file_base), reads K2's record
//   of its k-mer and position, and does atomicMax of the count into a
//   depth plane and atomicAdd of 1 into a count plane of the (4, T+1, 4)
//   int32 pileup. Integer max and add give the same result in any order.
//   Bound: the scattered atomics and the posting reads; the byte bound
//   counts the rows, the fold records, the walked postings and the
//   pileup once.

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int kTallyThreads = 256;
constexpr int kWalkThreads = 256;
constexpr int kMaxG = 8;  // genomes of the single-word histogram
constexpr uint64_t kSign = 1ull << 63;

// The word's bits as an unsigned 64-bit value (an int32 word is not
// sign-extended, so its top byte stays a byte).
template <typename Word>
__device__ __forceinline__ uint64_t word_bits(Word w) {
  return static_cast<uint64_t>(static_cast<typename std::make_unsigned<Word>::type>(w));
}

// The last row of keys[0, n) (ascending as int64) whose key is <= qs, or
// -1: torch.searchsorted(keys, qs, right=True) - 1.
__device__ __forceinline__ int64_t last_le(const int64_t* __restrict__ keys, int64_t n,
                                           int64_t qs) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = lo + ((hi - lo) >> 1);
    if (keys[mid] <= qs) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo - 1;
}

// Thread t of a block takes query t % J of the block's k-mer t / J (with
// J = 0, k-mer t and no query); a block takes per_block = kTallyThreads /
// max(J, 1) k-mers.
template <typename Word>
__global__ void __launch_bounds__(kTallyThreads)
    probe_tally_kernel(const int64_t* __restrict__ q, const int32_t* __restrict__ counts,
                       int64_t B, int J, const int64_t* __restrict__ keys, int64_t U,
                       const int32_t* __restrict__ offsets, const Word* __restrict__ hist,
                       int G, int32_t* __restrict__ start_out, Word* __restrict__ h_out,
                       int32_t* __restrict__ tallies, unsigned long long* __restrict__ lanes) {
  __shared__ uint32_t s_hits[kTallyThreads * kMaxG];
  __shared__ int32_t s_tallies[kMaxG * 3];
  __shared__ unsigned long long s_lanes[kMaxG];
  const int per_query = J > 0 ? J : 1;
  const int per_block = kTallyThreads / per_query;
  for (int i = threadIdx.x; i < per_block * kMaxG; i += kTallyThreads) s_hits[i] = 0;
  if (threadIdx.x < kMaxG * 3) s_tallies[threadIdx.x] = 0;
  if (threadIdx.x < kMaxG) s_lanes[threadIdx.x] = 0;
  __syncthreads();

  const int64_t first = (int64_t)blockIdx.x * per_block;
  const int local = threadIdx.x / per_query;
  const int64_t b = first + local;
  if (J > 0 && local < per_block && b < B) {
    const int64_t at = b * J + threadIdx.x % per_query;
    const int64_t qs = (int64_t)((uint64_t)q[at] ^ kSign);
    const int64_t row = last_le(keys, U, qs);
    int32_t start = 0;
    Word h = 0;
    if (row >= 0 && keys[row] == qs) {
      start = offsets[row];
      if (counts[b] > 0) h = hist[row];
    }
    start_out[at] = start;
    h_out[at] = h;
    const uint64_t bits = word_bits(h);
    for (int g = 0; g < G; ++g) {
      const uint32_t byte = (uint32_t)(bits >> (8 * g)) & 0xFFu;
      if (byte) atomicAdd(&s_hits[local * kMaxG + g], byte);
    }
  }
  __syncthreads();

  const int64_t kb = first + threadIdx.x;
  if (threadIdx.x < per_block && kb < B && counts[kb] > 0) {
    const uint32_t* hits = s_hits + threadIdx.x * kMaxG;
    int n_perfect = 0;
    for (int g = 0; g < G; ++g) n_perfect += hits[g] == (uint32_t)J;
    for (int g = 0; g < G; ++g) {
      if (hits[g] == (uint32_t)J) {
        atomicAdd(&s_tallies[g * 3], 1);
        if (n_perfect == 1) atomicAdd(&s_tallies[g * 3 + 2], 1);
      } else if (hits[g] > 0) {
        atomicAdd(&s_tallies[g * 3 + 1], 1);
      }
      if (hits[g] > 0) atomicAdd(&s_lanes[g], (unsigned long long)hits[g]);
    }
  }
  __syncthreads();
  if (threadIdx.x < G * 3 && s_tallies[threadIdx.x] != 0) {
    atomicAdd(&tallies[threadIdx.x], s_tallies[threadIdx.x]);
  }
  if (threadIdx.x < G && s_lanes[threadIdx.x] != 0) {
    atomicAdd(&lanes[threadIdx.x], s_lanes[threadIdx.x]);
  }
}

// Row r = (k-mer r / J, bucket r % J). lens != nullptr: the row's range is
// [start[r], start[r] + lens[r]); else it comes from h[r] and *best. The
// genome's base is file_bases[base_by_best ? *best : 0] (0 without
// file_bases; only int64 postings read it). A range past the n_postings
// postings ends there, and a posting whose position index reaches k or
// whose cell falls outside the pileup is skipped: a valid index has none,
// and nothing is read or written out of bounds.
template <typename Post, typename Word>
__global__ void __launch_bounds__(kWalkThreads)
    walk_scatter_kernel(const int32_t* __restrict__ pc, int k, int J,
                        const int32_t* __restrict__ start, const int32_t* __restrict__ lens,
                        const Word* __restrict__ h, const int64_t* __restrict__ best,
                        const Post* __restrict__ postings,
                        int64_t n_postings, const int64_t* __restrict__ file_bases,
                        int base_by_best, int64_t n_rows, int32_t* __restrict__ pileup,
                        int64_t row_len) {
  const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rows) return;
  int64_t first = start[r];
  int32_t n;
  if (lens != nullptr) {
    n = lens[r];
  } else {
    const int shift = 8 * (int)*best;
    const uint64_t bits = word_bits(h[r]);
    n = (int32_t)((bits >> shift) & 0xFFu);
    const uint64_t below = shift ? bits & ((1ull << shift) - 1) : 0;
    int32_t prefix = 0;
#pragma unroll
    for (int byte = 0; byte < 8; ++byte) prefix += (int32_t)((below >> (8 * byte)) & 0xFFu);
    first += prefix;
  }
  if (first < 0 || n <= 0) return;
  if (first + n > n_postings) n = (int32_t)(first < n_postings ? n_postings - first : 0);
  int64_t file_base = 0;
  if constexpr (sizeof(Post) == 8) {
    if (file_bases != nullptr) file_base = file_bases[base_by_best ? *best : 0];
  }
  const int32_t* __restrict__ rec = pc + (r / J) * k;
  for (int32_t i = 0; i < n; ++i) {
    const Post p = postings[first + i];
    int64_t pos;
    uint32_t meta;
    if constexpr (sizeof(Post) == 4) {
      pos = (int64_t)(p >> 6);
      meta = (uint32_t)p & 63u;
    } else {
      pos = (int64_t)(p >> 22) - file_base;
      meta = (uint32_t)((uint64_t)p & 0x3FFFFFu);
    }
    const uint32_t idx = meta & 31u;
    if (idx >= (uint32_t)k) continue;
    const bool is_canon = (meta >> 5) & 1u;
    const int32_t v = rec[idx];  // mirror bits hold the k-1-idx complement
    const int64_t base = is_canon ? (v >> 2) & 3 : v & 3;
    const bool fwd = is_canon == (bool)((v >> 4) & 1);
    const int64_t cell = pos * 4 + base;
    if (cell < 0 || cell >= row_len) continue;
    atomicMax(&pileup[(fwd ? 0 : 1) * row_len + cell], v >> 5);
    atomicAdd(&pileup[(fwd ? 2 : 3) * row_len + cell], 1);
  }
}

template <typename Post>
void launch_walk(unsigned blocks, cudaStream_t stream, const int32_t* pc, int k, int J,
                 const int32_t* start, const int32_t* lens, const void* h, int word_bytes,
                 const int64_t* best, const void* postings, int64_t n_postings,
                 const int64_t* file_bases, int base_by_best, int64_t n_rows,
                 int32_t* pileup, int64_t row_len) {
  const Post* post = static_cast<const Post*>(postings);
  if (word_bytes == 8) {
    walk_scatter_kernel<Post, int64_t><<<blocks, kWalkThreads, 0, stream>>>(
        pc, k, J, start, lens, static_cast<const int64_t*>(h), best, post, n_postings,
        file_bases, base_by_best, n_rows, pileup, row_len);
  } else {
    walk_scatter_kernel<Post, int32_t><<<blocks, kWalkThreads, 0, stream>>>(
        pc, k, J, start, lens, static_cast<const int32_t*>(h), best, post, n_postings,
        file_bases, base_by_best, n_rows, pileup, row_len);
  }
}

}  // namespace

// Each entry point selects `device` (this library links its own CUDA
// runtime, whose current device is not PyTorch's), launches on `stream`,
// never synchronises, and returns the CUDA error code (0 on success) so
// the caller can raise on a refused launch.

// q (B, J) int64 bucket ids from K1; keys (U,) int64 with bit 63 flipped;
// offsets (U+1,) int32; hist (U,) words of word_bytes (4 or 8). Writes
// start (B, J) int32 and h (B, J) words; adds into tallies (G, 3) int32
// and lanes (G,) int64.
extern "C" int bronko_probe_tally(int device, const int64_t* q, const int32_t* counts,
                                  int64_t B, int J, const int64_t* keys, int64_t U,
                                  const int32_t* offsets, const void* hist, int word_bytes,
                                  int G, int32_t* start, void* h, int32_t* tallies,
                                  int64_t* lanes, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (G < 1 || G > kMaxG || J < 0 || J > kTallyThreads ||
      (word_bytes != 4 && word_bytes != 8)) {
    return (int)cudaErrorInvalidValue;
  }
  if (B > 0) {
    const int64_t per_block = kTallyThreads / (J > 0 ? J : 1);
    const unsigned blocks = (unsigned)((B + per_block - 1) / per_block);
    unsigned long long* lanes_u = reinterpret_cast<unsigned long long*>(lanes);
    if (word_bytes == 8) {
      probe_tally_kernel<int64_t><<<blocks, kTallyThreads, 0, stream>>>(
          q, counts, B, J, keys, U, offsets, static_cast<const int64_t*>(hist), G, start,
          static_cast<int64_t*>(h), tallies, lanes_u);
    } else {
      probe_tally_kernel<int32_t><<<blocks, kTallyThreads, 0, stream>>>(
          q, counts, B, J, keys, U, offsets, static_cast<const int32_t*>(hist), G, start,
          static_cast<int32_t*>(h), tallies, lanes_u);
    }
  }
  return (int)cudaGetLastError();
}

// pc (B*k,) int32 K2 records; start (B, J) int32; either lens (B, J) int32,
// or h (B, J) words of word_bytes with best a device pointer to one int64;
// n_postings postings of post_bytes (4: int32 genome-local, 8: int64);
// n_rows = B*J;
// pileup (4 * row_len,) int32, accumulated into.
extern "C" int bronko_walk_scatter(int device, const int32_t* pc, int k, int J,
                                   const int32_t* start, const int32_t* lens, const void* h,
                                   int word_bytes, const int64_t* best, const void* postings,
                                   int post_bytes, int64_t n_postings,
                                   const int64_t* file_bases, int base_by_best, int64_t n_rows,
                                   int32_t* pileup, int64_t row_len, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (k < 1 || k > 32 || J < 1 || (post_bytes != 4 && post_bytes != 8) ||
      (lens == nullptr && (h == nullptr || best == nullptr ||
                           (word_bytes != 4 && word_bytes != 8))) ||
      (base_by_best && best == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_rows > 0) {
    const unsigned blocks = (unsigned)((n_rows + kWalkThreads - 1) / kWalkThreads);
    if (post_bytes == 8) {
      launch_walk<int64_t>(blocks, stream, pc, k, J, start, lens, h, word_bytes, best,
                           postings, n_postings, file_bases, base_by_best, n_rows, pileup,
                           row_len);
    } else {
      launch_walk<int32_t>(blocks, stream, pc, k, J, start, lens, h, word_bytes, best,
                           postings, n_postings, file_bases, base_by_best, n_rows, pileup,
                           row_len);
    }
  }
  return (int)cudaGetLastError();
}
