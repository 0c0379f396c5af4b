// Hopper kernels for the mapper's two passes after K1 and K2, with a plain
// C launch interface, wrapped by bronko_tpu_torch/ops/cuda_map.py and
// built and loaded with the port's other kernels by ops/cuda_lib.py.
//
// None replaces a Pallas kernel: on the TPU this work was XLA.
//
// (b) probe_tally fuses pass 1 after K1 for the single-word histogram
//   (bronko_tpu/ops/map.py _tally_save_body: the merge probe, the
//   histogram pickup, _hist_hits and classify_tallies). One thread takes
//   one (k-mer, bucket) query. It finds the LAST row of the sorted keys
//   (bit 63 flipped, so the signed order is the unsigned one) equal to
//   the query through the keys' slot directory (ops/cuda_map.py
//   probe_directory): a query farther than `span` from the smallest key
//   `lo` misses without a load; else its slot s = (query - lo) >> shift
//   gives the rows [dir[s], dir[s+1]) its key can be in (about 11 at the
//   bench fixture, 57 at most), and a last-<= search bounded to them
//   finds the row. The row's CSR start is kept on a hit, and its
//   histogram word where the k-mer's count is positive. A block holds
//   whole k-mers (kTallyThreads / J of them, their J queries on
//   consecutive threads, so every load of q and store of start and h is
//   coalesced). A word's eight bytes split into two uint64s of four
//   16-bit fields (bytes 0, 2, 4, 6 and 1, 3, 5, 7): summed over a
//   k-mer's J <= 32 queries a field holds at most 32 x 255 = 8,160, and
//   over a block's 256 threads 65,280, so no field carries into the
//   next. A k-mer's sums are taken by shuffles where J divides 32, else
//   by two 64-bit shared-memory adds a thread. Then a thread a k-mer
//   reads its hits from the fields and classifies them (perfect: hits ==
//   J; variant: 0 < hits != J; unique: the only perfect genome); each
//   warp counts its classes by ballot into the block's tallies, the
//   block's packed sums are its per-genome lanes, and the block adds both
//   to the (G, 3) int32 tallies and the (G,) int64 lanes with one global
//   atomic each. Integer sums: any order gives the same.
//   Bound: random loads, not bytes. A search over all U keys costs ~22
//   dependent loads a query, of which the ~10 below the cached top of the
//   tree land on random L2 sectors (the first design: 0.24 of the byte
//   bound); through the directory a query reads one pair of slot
//   entries, a sector or two of keys, its CSR start and its word. The
//   byte bound counts the queries, the keys, CSR starts and words once,
//   and the outputs; the directory (~2 bytes a key) is the design's own
//   read and is not in it.
//
// (c) walk_scatter is pass 2 without a lane count known on the host
//   (bronko_tpu/ops/map.py _pileup_from_saved_body / _scatter_lanes; the
//   port's _walk + _walk_scatter). A row is one (k-mer, bucket) query;
//   its posting range is given (start, lens), or derived from the saved
//   probe (start, h) and a device pointer to the selected genome `best`:
//   its length is byte `best` of h and its offset in the bucket the sum
//   of the bytes below (postings grouped by genome; JAX
//   _saved_lens_prefix). So no lane budget, no repeat_interleave and no
//   host value sizes the walk. A warp takes 32 consecutive rows and reads
//   their ranges coalesced; it leaves at once when they hold no posting.
//   Each lane walks its own row's first posting (most rows hold none or
//   one), and the warp shares the rest: a scan of the rows' remaining
//   counts by shuffles, then its lanes take those postings in turn, walk
//   lane t finding its row by a 5-step search over the scanned offsets
//   held in the lanes' registers. So no lane idles behind a long row,
//   and consecutive lanes read consecutive postings of one row. Each
//   posting is decoded as _walk_scatter does (int32 lpos<<6 | canon<<5 |
//   idx, or int64 pos<<22 | meta with pos moved by -file_base), reads
//   K2's record of its k-mer and position, and does a max of the count
//   into a depth plane and an add of 1 into a count plane of the (4,
//   T+1, 4) int32 pileup, reductions whose result is not read (RED).
//   Integer max and add give the same result in any order.
//   Bound: the random traffic, two reads and two reductions a posting
//   (the posting, the record and two pileup cells), not bytes: a kernel
//   with that traffic alone on addresses computed beforehand (the floor
//   in tools/torch_kernel_variants.py) takes 1.6x the byte bound at the
//   bench fixture, and on rows of 255 postings the reductions hold it at
//   14x. The row's own first posting keeps a walk of short rows as cheap
//   as a thread a row (a warp sharing every posting took 1.12x as long);
//   sharing the rest takes rows of 255 postings to the floor (a thread a
//   row took 1.33x as long). The byte bound counts the rows, the fold
//   records, the walked postings and the pileup once.
//
// (b) on the multi-word histogram (bronko_tpu/ops/map.py
//   tally_save_words_jit: _probe_hist, _hist_hits_words, classify_tallies)
//   is probe_tally_words_kernel: the same threads, search and CSR start,
//   then the row's W int64 words taken one word at a time. For word w a
//   query reads its word, writes it to h, and the k-mer's J words are
//   summed as (b)'s packed 16-bit fields (the same no-carry bound, per
//   word); the classifying thread of each k-mer counts genomes 8w..8w+7
//   by ballot into the block's word tallies, added to the (G, 3) tallies
//   and (G,) lanes with one global atomic each before the next word.
//   Unique needs the k-mer's perfect genomes across all W words, so each
//   classifying thread carries their count and the last one through the
//   loop, and adds 1 to that genome's unique tally at the end (k-mers of a
//   warp that share the genome add once, by __match_any_sync). Genomes
//   past G in the last word are read and summed into nothing. Bound: as
//   (b)'s, random loads; the W words of a row are one 8W-byte run.
//
// (c) on the multi-word saved probe reads a row's length from byte `best`
//   % 8 of word `best` / 8 and its offset as the bytes of every word below
//   plus those below the byte in its own word (JAX
//   pileup_from_saved_words_jit's prefix); a word's bytes sum in three
//   mask-and-add steps. The offset stays int32 (it may pass 255).
//
// (d) walk_hits is the flat tally's exact walk (bronko_tpu/ops/map.py
//   tally_flat, the port's _flat_hits): every posting of every (k-mer,
//   bucket) row [start, start + lens) adds one to hits[k-mer, genome], the
//   genome from the int32 genome ids of the postings or decoded from the
//   int64 global postings ((p & 0x3FFFFF) >> 6). A block owns whole
//   k-mers, per_block of them (at most 256 / J, so a thread holds one
//   row), and counts their hits in per_block x G counters: in shared
//   memory while one k-mer's G counters fit (fewer k-mers a block as G
//   grows, dynamic shared memory past 48 KB), else in the k-mers' own
//   rows of hits with global atomics. Either way the block zeroes its
//   counters first and no other block touches them, so hits needs no
//   fill. The block scans its rows' lengths (int64) and its 256 threads
//   take the postings of all of its rows in turn: lane t finds its row by
//   a bisection over the scanned ends in shared memory. So a row of any
//   length (2^25 and more) is shared by the whole block and no thread
//   walks one alone. Consecutive lanes of a warp mostly read consecutive
//   postings of one row, and in a grouped bucket those are one genome's:
//   the lanes of a run of equal counters add the run's length once (its
//   first lane, found by a ballot of run heads). The shared counters are
//   then written to the block's k-mers' rows of hits with coalesced plain
//   stores. A range past the postings' end stops there; a genome outside
//   [0, G) counts nowhere (JAX drops it). Bound: bytes, the walked
//   postings' genome ids (4 or 8 bytes each), the rows once and hits once.

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int kTallyThreads = 256;
constexpr int kWalkThreads = 256;
constexpr int kMaxG = 8;  // genomes of the single-word histogram
constexpr uint64_t kSign = 1ull << 63;
constexpr uint64_t kEvenBytes = 0x00FF00FF00FF00FFull;  // bytes 0, 2, 4, 6
constexpr unsigned kFullMask = 0xFFFFFFFFu;
// (c): each lane walks its own row's first posting before the warp shares
// the rest; rows of kLongRow postings or more walk alone, so a warp's
// shared walk stays below 2^30 lanes
constexpr bool kOwnFirst = true;
constexpr int32_t kLongRow = 1 << 25;
// (d): threads a block, and the dynamic shared memory a block's counters
// may take: a share of the 227 KB a block can have, beside the static
// arrays, and the smaller target that keeps several blocks on an SM
constexpr int kHitsThreads = 256;
constexpr int64_t kHitsSharedMax = 220 * 1024;
constexpr int64_t kHitsSharedTarget = 24 * 1024;

// The word's bits as an unsigned 64-bit value (an int32 word is not
// sign-extended, so its top byte stays a byte).
template <typename Word>
__device__ __forceinline__ uint64_t word_bits(Word w) {
  return static_cast<uint64_t>(static_cast<typename std::make_unsigned<Word>::type>(w));
}

// Genome g's field of the packed sums: bytes 0, 2, 4, 6 summed in `even`,
// 1, 3, 5, 7 in `odd`, 16 bits each.
__device__ __forceinline__ uint32_t field(uint64_t even, uint64_t odd, int g) {
  return (uint32_t)(((g & 1) ? odd : even) >> (16 * (g >> 1))) & 0xFFFFu;
}

// The sum of a word's eight bytes: pairs into 16-bit fields, those into
// 32-bit ones, then the two halves.
__device__ __forceinline__ int32_t byte_sum(uint64_t x) {
  x = (x & kEvenBytes) + ((x >> 8) & kEvenBytes);
  x = (x & 0x0000FFFF0000FFFFull) + ((x >> 16) & 0x0000FFFF0000FFFFull);
  return (int32_t)((x & 0xFFFFFFFFull) + (x >> 32));
}

// The LAST row of the sorted keys equal to the query qs (bit 63 flipped),
// through the slot directory, or -1: a query farther than span from lo
// misses without a load; else a last-<= bisection over its slot's rows.
__device__ __forceinline__ int32_t find_row(int64_t qs, const int64_t* __restrict__ keys,
                                            const int32_t* __restrict__ dir, int64_t lo,
                                            uint64_t span, int shift) {
  const uint64_t d = (uint64_t)qs - (uint64_t)lo;
  if (d > span) return -1;
  const uint64_t s = d >> shift;
  const int32_t row0 = dir[s];
  int32_t l = row0, r = dir[s + 1];
  while (l < r) {  // one past the slot's last row whose key is <= qs
    const int32_t mid = (int32_t)(((uint32_t)l + (uint32_t)r) >> 1);
    if (keys[mid] <= qs) {
      l = mid + 1;
    } else {
      r = mid;
    }
  }
  return l > row0 && keys[l - 1] == qs ? l - 1 : -1;
}

// Thread t of a block takes query t % J of the block's k-mer t / J (with
// J = 0, k-mer t and no query); a block takes per_block = kTallyThreads /
// max(J, 1) k-mers.
template <typename Word>
__global__ void __launch_bounds__(kTallyThreads)
    probe_tally_kernel(const int64_t* __restrict__ q, const int32_t* __restrict__ counts,
                       int64_t B, int J, const int64_t* __restrict__ keys,
                       const int32_t* __restrict__ dir, int64_t lo, uint64_t span, int shift,
                       const int32_t* __restrict__ offsets, const Word* __restrict__ hist,
                       int G, int32_t* __restrict__ start_out, Word* __restrict__ h_out,
                       int32_t* __restrict__ tallies, unsigned long long* __restrict__ lanes) {
  __shared__ unsigned long long s_even[kTallyThreads], s_odd[kTallyThreads];
  __shared__ int32_t s_tallies[kMaxG * 3];
  __shared__ unsigned long long s_lanes[2];
  const int per_query = J > 0 ? J : 1;
  const int per_block = kTallyThreads / per_query;
  const int lane = threadIdx.x & 31;
  s_even[threadIdx.x] = 0;
  s_odd[threadIdx.x] = 0;
  if (threadIdx.x < kMaxG * 3) s_tallies[threadIdx.x] = 0;
  if (threadIdx.x < 2) s_lanes[threadIdx.x] = 0;
  __syncthreads();

  const int64_t first = (int64_t)blockIdx.x * per_block;
  const int local = threadIdx.x / per_query;
  const int64_t b = first + local;
  uint64_t even = 0, odd = 0;
  if (J > 0 && local < per_block && b < B) {
    const int64_t at = b * J + threadIdx.x % per_query;
    const int64_t qs = (int64_t)((uint64_t)q[at] ^ kSign);
    const int32_t row = find_row(qs, keys, dir, lo, span, shift);
    int32_t start = 0;
    Word h = 0;
    if (row >= 0) {
      start = offsets[row];
      if (counts[b] > 0) h = hist[row];
    }
    start_out[at] = start;
    h_out[at] = h;
    const uint64_t bits = word_bits(h);
    even = bits & kEvenBytes;
    odd = (bits >> 8) & kEvenBytes;
  }
  if (J > 0 && 32 % J == 0) {  // a k-mer's J threads: J-aligned in one warp
    for (int off = J >> 1; off > 0; off >>= 1) {
      even += __shfl_xor_sync(kFullMask, even, off);
      odd += __shfl_xor_sync(kFullMask, odd, off);
    }
    if (threadIdx.x % J == 0) {
      s_even[local] = even;
      s_odd[local] = odd;
    }
  } else if (even | odd) {
    atomicAdd(&s_even[local], (unsigned long long)even);
    atomicAdd(&s_odd[local], (unsigned long long)odd);
  }
  __syncthreads();

  // thread c classifies the block's k-mer c, in whole warps for the ballots
  const int c = threadIdx.x;
  if (c < ((per_block + 31) & ~31)) {
    const int64_t kb = first + c;
    const bool valid = c < per_block && kb < B && counts[kb] > 0;
    const uint64_t ev = s_even[c], od = s_odd[c];
    uint64_t warp_even = ev, warp_odd = od;
    for (int off = 16; off > 0; off >>= 1) {
      warp_even += __shfl_xor_sync(kFullMask, warp_even, off);
      warp_odd += __shfl_xor_sync(kFullMask, warp_odd, off);
    }
    if (lane == 0 && (warp_even | warp_odd)) {
      atomicAdd(&s_lanes[0], (unsigned long long)warp_even);
      atomicAdd(&s_lanes[1], (unsigned long long)warp_odd);
    }
    int n_perfect = 0;
    for (int g = 0; g < G; ++g) n_perfect += valid && field(ev, od, g) == (uint32_t)J;
    for (int g = 0; g < G; ++g) {
      const uint32_t hits = field(ev, od, g);
      const bool perfect = valid && hits == (uint32_t)J;
      const unsigned p = __ballot_sync(kFullMask, perfect);
      const unsigned v = __ballot_sync(kFullMask, valid && hits > 0 && hits != (uint32_t)J);
      const unsigned u = __ballot_sync(kFullMask, perfect && n_perfect == 1);
      if (lane == 0) {
        if (p) atomicAdd(&s_tallies[g * 3], __popc(p));
        if (v) atomicAdd(&s_tallies[g * 3 + 1], __popc(v));
        if (u) atomicAdd(&s_tallies[g * 3 + 2], __popc(u));
      }
    }
  }
  __syncthreads();
  if (threadIdx.x < G * 3 && s_tallies[threadIdx.x] != 0) {
    atomicAdd(&tallies[threadIdx.x], s_tallies[threadIdx.x]);
  }
  if (threadIdx.x < G) {
    const uint32_t sum = field(s_lanes[0], s_lanes[1], threadIdx.x);
    if (sum) atomicAdd(&lanes[threadIdx.x], (unsigned long long)sum);
  }
}

// (b) on the multi-word histogram: hist (U, W) int64, h (B, J, W). Thread
// t takes query t % J of the block's k-mer t / J, as probe_tally_kernel;
// thread c classifies the block's k-mer c, word by word.
__global__ void __launch_bounds__(kTallyThreads)
    probe_tally_words_kernel(const int64_t* __restrict__ q, const int32_t* __restrict__ counts,
                             int64_t B, int J, const int64_t* __restrict__ keys,
                             const int32_t* __restrict__ dir, int64_t lo, uint64_t span,
                             int shift, const int32_t* __restrict__ offsets,
                             const int64_t* __restrict__ hist, int W, int G,
                             int32_t* __restrict__ start_out, int64_t* __restrict__ h_out,
                             int32_t* __restrict__ tallies,
                             unsigned long long* __restrict__ lanes) {
  __shared__ unsigned long long s_even[kTallyThreads], s_odd[kTallyThreads];
  __shared__ int32_t s_tallies[8 * 2];  // the word's genomes: perfect, variant
  __shared__ unsigned long long s_lanes[2];
  const int per_query = J > 0 ? J : 1;
  const int per_block = kTallyThreads / per_query;
  const int lane = threadIdx.x & 31;
  const int64_t first = (int64_t)blockIdx.x * per_block;
  const int local = threadIdx.x / per_query;
  const int64_t b = first + local;
  const bool query = J > 0 && local < per_block && b < B;
  int64_t at = 0;
  int32_t row = -1;
  bool valid = false;
  if (query) {
    at = b * J + threadIdx.x % per_query;
    row = find_row((int64_t)((uint64_t)q[at] ^ kSign), keys, dir, lo, span, shift);
    start_out[at] = row >= 0 ? offsets[row] : 0;
    valid = row >= 0 && counts[b] > 0;
  }
  // the classifying threads are whole warps, for the ballots
  const int c = threadIdx.x;
  const bool classifier = c < ((per_block + 31) & ~31);
  const int64_t kb = first + c;
  const bool kvalid = classifier && c < per_block && kb < B && counts[kb] > 0;
  int n_perfect = 0, perfect_g = -1;  // the k-mer's perfect genomes over all words
  for (int w = 0; w < W; ++w) {
    s_even[threadIdx.x] = 0;
    s_odd[threadIdx.x] = 0;
    if (threadIdx.x < 16) s_tallies[threadIdx.x] = 0;
    if (threadIdx.x < 2) s_lanes[threadIdx.x] = 0;
    __syncthreads();
    uint64_t even = 0, odd = 0;
    if (query) {
      const int64_t hw = valid ? hist[(int64_t)row * W + w] : 0;
      h_out[at * W + w] = hw;
      even = (uint64_t)hw & kEvenBytes;
      odd = ((uint64_t)hw >> 8) & kEvenBytes;
    }
    if (J > 0 && 32 % J == 0) {  // a k-mer's J threads: J-aligned in one warp
      for (int off = J >> 1; off > 0; off >>= 1) {
        even += __shfl_xor_sync(kFullMask, even, off);
        odd += __shfl_xor_sync(kFullMask, odd, off);
      }
      if (query && threadIdx.x % J == 0) {
        s_even[local] = even;
        s_odd[local] = odd;
      }
    } else if (even | odd) {
      atomicAdd(&s_even[local], (unsigned long long)even);
      atomicAdd(&s_odd[local], (unsigned long long)odd);
    }
    __syncthreads();
    const int g0 = 8 * w;
    const int ng = G - g0 < 8 ? G - g0 : 8;  // this word's genomes below G
    if (classifier) {
      const uint64_t ev = s_even[c], od = s_odd[c];
      uint64_t warp_even = ev, warp_odd = od;
      for (int off = 16; off > 0; off >>= 1) {
        warp_even += __shfl_xor_sync(kFullMask, warp_even, off);
        warp_odd += __shfl_xor_sync(kFullMask, warp_odd, off);
      }
      if (lane == 0 && (warp_even | warp_odd)) {
        atomicAdd(&s_lanes[0], (unsigned long long)warp_even);
        atomicAdd(&s_lanes[1], (unsigned long long)warp_odd);
      }
      for (int j = 0; j < ng; ++j) {
        const uint32_t hits = field(ev, od, j);
        const bool perfect = kvalid && hits == (uint32_t)J;
        if (perfect) {
          ++n_perfect;
          perfect_g = g0 + j;
        }
        const unsigned p = __ballot_sync(kFullMask, perfect);
        const unsigned v = __ballot_sync(kFullMask, kvalid && hits > 0 && hits != (uint32_t)J);
        if (lane == 0) {
          if (p) atomicAdd(&s_tallies[j * 2], __popc(p));
          if (v) atomicAdd(&s_tallies[j * 2 + 1], __popc(v));
        }
      }
    }
    __syncthreads();
    if ((int)threadIdx.x < ng * 2 && s_tallies[threadIdx.x] != 0) {
      atomicAdd(&tallies[(g0 + threadIdx.x / 2) * 3 + threadIdx.x % 2], s_tallies[threadIdx.x]);
    }
    if ((int)threadIdx.x < ng) {
      const uint32_t sum = field(s_lanes[0], s_lanes[1], threadIdx.x);
      if (sum) atomicAdd(&lanes[g0 + threadIdx.x], (unsigned long long)sum);
    }
    __syncthreads();  // the word's shared sums are read before the next word clears them
  }
  if (classifier) {
    const int unique_g = kvalid && n_perfect == 1 ? perfect_g : -1;
    const unsigned peers = __match_any_sync(kFullMask, unique_g);
    if (unique_g >= 0 && lane == __ffs(peers) - 1) {
      atomicAdd(&tallies[unique_g * 3 + 2], __popc(peers));
    }
  }
}

// Posting `at` of K2 records `rec` (its k-mer's first): decoded, then the
// max of the count into a depth plane and an add of 1 into a count plane.
// A position index that reaches k, or a cell outside the pileup, is
// skipped (a valid index has none).
template <typename Post>
__device__ __forceinline__ void scatter_posting(const Post* __restrict__ postings, int32_t at,
                                                const int32_t* __restrict__ pc, int32_t rec,
                                                int k, int64_t file_base,
                                                int32_t* __restrict__ pileup, int64_t row_len) {
  const Post p = postings[at];
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
  if (idx >= (uint32_t)k) return;
  const bool is_canon = (meta >> 5) & 1u;
  const int32_t v = pc[rec + idx];  // mirror bits hold the k-1-idx complement
  const int64_t base = is_canon ? (v >> 2) & 3 : v & 3;
  const bool fwd = is_canon == (bool)((v >> 4) & 1);
  const int64_t cell = pos * 4 + base;
  if (cell < 0 || cell >= row_len) return;
  atomicMax(&pileup[(fwd ? 0 : 1) * row_len + cell], v >> 5);
  atomicAdd(&pileup[(fwd ? 2 : 3) * row_len + cell], 1);
}

// Row r = (k-mer r / J, bucket r % J), r < 2^31. lens != nullptr: the
// row's range is [start[r], start[r] + lens[r]); else it comes from the
// row's `words` words h[r * words, (r + 1) * words) and *best. The
// genome's base is file_bases[base_by_best ? *best : 0] (0 without
// file_bases; only int64 postings read it). A range past the
// n_postings < 2^31 postings ends there, and nothing is read or written
// out of bounds. With kOwnFirst each lane first walks its own row's first
// posting, and the warp shares the rest; a row of kLongRow postings or
// more (a CSR range; no histogram byte is one) walks alone. kMulti: the
// rows hold words > 1 words; the single word keeps its own shorter
// decode, which the general word loop slows.
template <typename Post, typename Word, bool kMulti>
__global__ void __launch_bounds__(kWalkThreads)
    walk_scatter_kernel(const int32_t* __restrict__ pc, int k, int J,
                        const int32_t* __restrict__ start, const int32_t* __restrict__ lens,
                        const Word* __restrict__ h, int64_t words,
                        const int64_t* __restrict__ best,
                        const Post* __restrict__ postings,
                        int64_t n_postings, const int64_t* __restrict__ file_bases,
                        int base_by_best, int64_t n_rows, int32_t* __restrict__ pileup,
                        int64_t row_len) {
  const int lane = threadIdx.x & 31;
  const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int64_t first = 0;
  int32_t n = 0;
  if (r < n_rows) {
    first = start[r];
    if (lens != nullptr) {
      n = lens[r];
    } else if constexpr (!kMulti) {
      const int shift = 8 * (int)*best;
      const uint64_t bits = word_bits(h[r]);
      n = (int32_t)((bits >> shift) & 0xFFu);
      first += byte_sum(shift ? bits & ((1ull << shift) - 1) : 0);
    } else {
      // byte best % 8 of word best / 8; the offset sums every byte below it
      const int64_t g = *best;
      const int64_t wb = g >> 3;
      if (wb < words) {
        const Word* hr = h + r * words;
        int32_t prefix = 0;
        for (int64_t w = 0; w < wb; ++w) prefix += byte_sum(word_bits(hr[w]));
        const int shift = 8 * (int)(g & 7);
        const uint64_t bits = word_bits(hr[wb]);
        n = (int32_t)((bits >> shift) & 0xFFu);
        first += prefix + byte_sum(shift ? bits & ((1ull << shift) - 1) : 0);
      }
    }
    if (first < 0 || n <= 0) {
      n = 0;
    } else if (first + n > n_postings) {
      n = first < n_postings ? (int32_t)(n_postings - first) : 0;
    }
  }
  if (__all_sync(kFullMask, n == 0)) return;
  const int32_t rec = (int32_t)((uint32_t)r / (uint32_t)J * (uint32_t)k);  // its k-mer's records
  int64_t file_base = 0;
  if constexpr (sizeof(Post) == 8) {
    if (file_bases != nullptr) file_base = file_bases[base_by_best ? *best : 0];
  }
  const int32_t own = kOwnFirst && n > 0 ? 1 : 0;
  if (own) scatter_posting(postings, (int32_t)first, pc, rec, k, file_base, pileup, row_len);
  const int32_t rest = n - own;
  if (__all_sync(kFullMask, rest == 0)) return;
  if (__any_sync(kFullMask, rest >= kLongRow)) {
    for (int32_t i = own; i < n; ++i) {
      scatter_posting(postings, (int32_t)first + i, pc, rec, k, file_base, pileup, row_len);
    }
    return;
  }
  // the warp's walk of the rest: an inclusive scan of its 32 rows' counts
  int32_t end = rest;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int32_t v = __shfl_up_sync(kFullMask, end, off);
    if (lane >= off) end += v;
  }
  const int32_t total = __shfl_sync(kFullMask, end, 31);
  const int32_t begin = end - rest;                    // this row's first walk lane
  const int32_t at0 = (int32_t)first + own - begin;    // walk lane t reads posting at0 + t
  for (int32_t t0 = 0; t0 < total; t0 += 32) {
    const int32_t t = t0 + lane;
    int j = 0;  // the last row whose first walk lane is <= t
#pragma unroll
    for (int step = 16; step > 0; step >>= 1) {
      if (__shfl_sync(kFullMask, begin, j + step) <= t) j += step;
    }
    const int32_t at = __shfl_sync(kFullMask, at0, j) + t;
    const int32_t rec_j = __shfl_sync(kFullMask, rec, j);
    if (t < total) scatter_posting(postings, at, pc, rec_j, k, file_base, pileup, row_len);
  }
}

template <typename Post>
void launch_walk(unsigned blocks, cudaStream_t stream, const int32_t* pc, int k, int J,
                 const int32_t* start, const int32_t* lens, const void* h, int word_bytes,
                 int64_t words, const int64_t* best, const void* postings,
                 int64_t n_postings, const int64_t* file_bases, int base_by_best,
                 int64_t n_rows, int32_t* pileup, int64_t row_len) {
  const Post* post = static_cast<const Post*>(postings);
  if (lens == nullptr && words > 1) {
    walk_scatter_kernel<Post, int64_t, true><<<blocks, kWalkThreads, 0, stream>>>(
        pc, k, J, start, lens, static_cast<const int64_t*>(h), words, best, post, n_postings,
        file_bases, base_by_best, n_rows, pileup, row_len);
  } else if (word_bytes == 8) {
    walk_scatter_kernel<Post, int64_t, false><<<blocks, kWalkThreads, 0, stream>>>(
        pc, k, J, start, lens, static_cast<const int64_t*>(h), words, best, post, n_postings,
        file_bases, base_by_best, n_rows, pileup, row_len);
  } else {
    walk_scatter_kernel<Post, int32_t, false><<<blocks, kWalkThreads, 0, stream>>>(
        pc, k, J, start, lens, static_cast<const int32_t*>(h), words, best, post, n_postings,
        file_bases, base_by_best, n_rows, pileup, row_len);
  }
}

// Genome of posting `at`: an int32 genome id, or decoded from an int64
// global posting (gpos<<22 | fid<<6 | canon<<5 | idx).
template <typename Src>
__device__ __forceinline__ int32_t genome_of(const Src* __restrict__ src, int64_t at) {
  if constexpr (sizeof(Src) == 4) {
    return src[at];
  } else {
    return (int32_t)(((uint64_t)src[at] & 0x3FFFFFull) >> 6);
  }
}

// (d): the block's k-mers are b0 .. b0 + per_block - 1 (those below B),
// their rows the block's first per_block * J <= kHitsThreads rows from
// b0 * J; kShared: their counters in dynamic shared memory, else in their
// own rows of hits.
template <typename Src, bool kShared>
__global__ void __launch_bounds__(kHitsThreads)
    walk_hits_kernel(const int32_t* __restrict__ start, const int32_t* __restrict__ lens,
                     int64_t B, int J, const Src* __restrict__ src, int64_t n_postings, int G,
                     int per_block, int32_t* __restrict__ hits) {
  extern __shared__ int32_t s_hits[];
  __shared__ int64_t s_end[kHitsThreads];  // the rows' inclusive ends in the block's walk
  __shared__ int64_t s_at[kHitsThreads];   // posting of walk lane t in row i: s_at[i] + t
  __shared__ int64_t s_warp[kHitsThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t b0 = (int64_t)blockIdx.x * per_block;
  const int64_t nk = B - b0 < per_block ? B - b0 : per_block;
  const int64_t n_counters = nk * G;
  int32_t* counters = kShared ? s_hits : hits + b0 * G;
  for (int64_t i = threadIdx.x; i < n_counters; i += kHitsThreads) counters[i] = 0;

  const int rows = (int)nk * J;
  int64_t first = 0, n = 0;
  if ((int)threadIdx.x < rows) {
    const int64_t r = b0 * J + threadIdx.x;
    first = start[r];
    n = lens[r];
    if (first < 0 || n <= 0) {
      n = 0;
    } else if (first + n > n_postings) {
      n = first < n_postings ? n_postings - first : 0;
    }
  }
  int64_t end = n;  // the block's inclusive scan of the rows' lengths
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int64_t v = __shfl_up_sync(kFullMask, end, off);
    if (lane >= off) end += v;
  }
  if (lane == 31) s_warp[warp] = end;
  __syncthreads();  // also orders the counters' zeroes before the adds
  int64_t total = 0;
#pragma unroll
  for (int w = 0; w < kHitsThreads / 32; ++w) {
    if (w < warp) end += s_warp[w];
    total += s_warp[w];
  }
  s_end[threadIdx.x] = end;
  s_at[threadIdx.x] = first - (end - n);
  __syncthreads();

  for (int64_t t0 = 0; t0 < total; t0 += kHitsThreads) {
    const int64_t t = t0 + threadIdx.x;
    const bool live = t < total;
    int64_t key = -1;  // the counter: local k-mer * G + genome
    if (live) {
      int lo = 0, hi = rows - 1;  // the first row whose end is past t
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (s_end[mid] > t) {
          hi = mid;
        } else {
          lo = mid + 1;
        }
      }
      const int32_t g = genome_of(src, s_at[lo] + t);
      if (g >= 0 && g < G) key = (int64_t)(lo / J) * G + g;
    }
    // a run of lanes with one counter adds its length once, at its head
    const int64_t prev = __shfl_up_sync(kFullMask, key, 1);
    const bool head = live && (lane == 0 || prev != key);
    const unsigned heads = __ballot_sync(kFullMask, head);
    const unsigned alive = __ballot_sync(kFullMask, live);
    if (head && key >= 0) {
      const unsigned above = heads & ~(kFullMask >> (31 - lane));
      const int run_end = above ? __ffs(above) - 1 : __popc(alive);
      atomicAdd(&counters[key], run_end - lane);
    }
  }
  if (kShared) {
    __syncthreads();
    for (int64_t i = threadIdx.x; i < n_counters; i += kHitsThreads) {
      hits[b0 * G + i] = s_hits[i];
    }
  }
}

template <typename Src>
int launch_hits(const int32_t* start, const int32_t* lens, int64_t B, int J, const void* src,
                int64_t n_postings, int G, int32_t* hits, cudaStream_t stream) {
  const Src* s = static_cast<const Src*>(src);
  const int64_t counter_bytes = (int64_t)G * 4;
  const int64_t by_rows = kHitsThreads / J;
  if (counter_bytes > kHitsSharedMax) {  // one k-mer's counters do not fit: global atomics
    const unsigned blocks = (unsigned)((B + by_rows - 1) / by_rows);
    walk_hits_kernel<Src, false><<<blocks, kHitsThreads, 0, stream>>>(
        start, lens, B, J, s, n_postings, G, (int)by_rows, hits);
    return (int)cudaGetLastError();
  }
  int64_t per_block = kHitsSharedTarget / counter_bytes;
  if (per_block > by_rows) per_block = by_rows;
  if (per_block < 1) per_block = 1;
  const int64_t smem = per_block * counter_bytes;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        walk_hits_kernel<Src, true>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned blocks = (unsigned)((B + per_block - 1) / per_block);
  walk_hits_kernel<Src, true><<<blocks, kHitsThreads, (size_t)smem, stream>>>(
      start, lens, B, J, s, n_postings, G, (int)per_block, hits);
  return (int)cudaGetLastError();
}

}  // namespace

// Each entry point selects `device` (this library links its own CUDA
// runtime, whose current device is not PyTorch's), launches on `stream`,
// never synchronises, and returns the CUDA error code (0 on success) so
// the caller can raise on a refused launch.

// q (B, J) int64 bucket ids from K1; keys (U,) int64 with bit 63 flipped;
// dir (S+1,) int32 the keys' slot directory, with the smallest key lo
// (bit 63 flipped), the largest key's distance span from it (as uint64
// bits) and the slots' shift, S > span >> shift; offsets (U+1,) int32;
// hist (U,) words of word_bytes (4 or 8). Writes start (B, J) int32 and h
// (B, J) words; adds into tallies (G, 3) int32 and lanes (G,) int64.
extern "C" int bronko_probe_tally(int device, const int64_t* q, const int32_t* counts,
                                  int64_t B, int J, const int64_t* keys, int64_t U,
                                  const int32_t* dir, int64_t lo, int64_t span, int shift,
                                  const int32_t* offsets, const void* hist, int word_bytes,
                                  int G, int32_t* start, void* h, int32_t* tallies,
                                  int64_t* lanes, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (G < 1 || G > kMaxG || J < 0 || J > 32 || U < 0 || U >= (1ll << 31) || shift < 0 ||
      shift > 63 || (word_bytes != 4 && word_bytes != 8)) {
    return (int)cudaErrorInvalidValue;
  }
  if (B > 0) {
    const int64_t per_block = kTallyThreads / (J > 0 ? J : 1);
    const unsigned blocks = (unsigned)((B + per_block - 1) / per_block);
    unsigned long long* lanes_u = reinterpret_cast<unsigned long long*>(lanes);
    if (word_bytes == 8) {
      probe_tally_kernel<int64_t><<<blocks, kTallyThreads, 0, stream>>>(
          q, counts, B, J, keys, dir, lo, (uint64_t)span, shift, offsets,
          static_cast<const int64_t*>(hist), G, start, static_cast<int64_t*>(h), tallies,
          lanes_u);
    } else {
      probe_tally_kernel<int32_t><<<blocks, kTallyThreads, 0, stream>>>(
          q, counts, B, J, keys, dir, lo, (uint64_t)span, shift, offsets,
          static_cast<const int32_t*>(hist), G, start, static_cast<int32_t*>(h), tallies,
          lanes_u);
    }
  }
  return (int)cudaGetLastError();
}

// The same for the multi-word histogram: hist (U, W) int64 words, genome g
// in byte g % 8 of word g / 8, 1 <= G <= 8W; writes h (B, J, W) int64.
// Refuses B*J >= 2^31.
extern "C" int bronko_probe_tally_words(int device, const int64_t* q, const int32_t* counts,
                                        int64_t B, int J, const int64_t* keys, int64_t U,
                                        const int32_t* dir, int64_t lo, int64_t span,
                                        int shift, const int32_t* offsets,
                                        const int64_t* hist, int64_t W, int G,
                                        int32_t* start, int64_t* h, int32_t* tallies,
                                        int64_t* lanes, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (G < 1 || W < 1 || W >= (1ll << 28) || G > 8 * W || J < 0 || J > 32 || B < 0 ||
      B * (J > 0 ? J : 1) >= (1ll << 31) || U < 1 || U >= (1ll << 31) || shift < 0 ||
      shift > 63) {
    return (int)cudaErrorInvalidValue;
  }
  if (B > 0) {
    const int64_t per_block = kTallyThreads / (J > 0 ? J : 1);
    const unsigned blocks = (unsigned)((B + per_block - 1) / per_block);
    probe_tally_words_kernel<<<blocks, kTallyThreads, 0, stream>>>(
        q, counts, B, J, keys, dir, lo, (uint64_t)span, shift, offsets, hist, (int)W, G,
        start, h, tallies, reinterpret_cast<unsigned long long*>(lanes));
  }
  return (int)cudaGetLastError();
}

// pc (B*k,) int32 K2 records; start (B, J) int32; either lens (B, J) int32,
// or h (B, J, words) words of word_bytes (words > 1: int64) with best a
// device pointer to one int64; n_postings < 2^31 postings of post_bytes
// (4: int32 genome-local, 8: int64); n_rows = B*J < 2^31, B*k < 2^31;
// pileup (4 * row_len,) int32, accumulated into.
extern "C" int bronko_walk_scatter_words(int device, const int32_t* pc, int k, int J,
                                         const int32_t* start, const int32_t* lens,
                                         const void* h, int word_bytes, int64_t words,
                                         const int64_t* best, const void* postings,
                                         int post_bytes, int64_t n_postings,
                                         const int64_t* file_bases, int base_by_best,
                                         int64_t n_rows, int32_t* pileup, int64_t row_len,
                                         cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (k < 1 || k > 32 || J < 1 || (post_bytes != 4 && post_bytes != 8) ||
      (lens == nullptr && (h == nullptr || best == nullptr ||
                           (word_bytes != 4 && word_bytes != 8) || words < 1 ||
                           (words > 1 && word_bytes != 8))) ||
      (base_by_best && best == nullptr) || n_rows >= (1ll << 31) ||
      n_postings >= (1ll << 31) || (n_rows / J + 1) * k >= (1ll << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_rows > 0) {
    const unsigned blocks = (unsigned)((n_rows + kWalkThreads - 1) / kWalkThreads);
    if (post_bytes == 8) {
      launch_walk<int64_t>(blocks, stream, pc, k, J, start, lens, h, word_bytes, words, best,
                           postings, n_postings, file_bases, base_by_best, n_rows, pileup,
                           row_len);
    } else {
      launch_walk<int32_t>(blocks, stream, pc, k, J, start, lens, h, word_bytes, words, best,
                           postings, n_postings, file_bases, base_by_best, n_rows, pileup,
                           row_len);
    }
  }
  return (int)cudaGetLastError();
}

// start, lens (B, J) int32 rows, 1 <= J <= 256, B*J < 2^31; src (n_postings,)
// int32 genome ids (src_bytes 4) or int64 global postings (8); writes
// hits (B, G) int32, every entry (no fill needed).
extern "C" int bronko_walk_hits(int device, const int32_t* start, const int32_t* lens,
                                int64_t B, int J, const void* src, int src_bytes,
                                int64_t n_postings, int G, int32_t* hits,
                                cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (J < 1 || J > kHitsThreads || B < 0 || B * J >= (1ll << 31) || G < 1 ||
      n_postings < 0 || (src_bytes != 4 && src_bytes != 8)) {
    return (int)cudaErrorInvalidValue;
  }
  if (B == 0) return (int)cudaGetLastError();
  if (src_bytes == 8) return launch_hits<int64_t>(start, lens, B, J, src, n_postings, G, hits,
                                                  stream);
  return launch_hits<int32_t>(start, lens, B, J, src, n_postings, G, hits, stream);
}
