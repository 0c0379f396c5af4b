// Hopper kernel for the device k-mer counter's first stage, with a plain C
// launch interface, wrapped by bronko_tpu_torch/ops/count.py and built
// and loaded with the port's other kernels by ops/cuda_lib.py.
//
// K3 pack_windows replaces bronko_tpu/ops/pallas_pack.py
//   pack_windows_pallas / _pack_kernel: every k-window of every read,
//   packed 2 bits a base with the first base highest, and its validity
//   (all k codes < 4 and col + k <= the read's length). Invalid windows
//   still get the packed `code & 3` bits, as the XLA pack gives them.
//
// The TPU kernel built each word from two int32 planes (the first k-16
// bases and the last 16) because Mosaic has no 64-bit integers; Hopper
// has them, so a word is one uint64_t and the split is gone.
//
// What bounds it is device memory: a window reads one new code and writes
// 9 bytes (its word and its validity byte). A window built from its k
// codes one by one would cost O(k) instructions (and a thread for each
// window of a flat index a 64-bit division) and be bound by issued
// instructions instead. So the work a window is made O(1):
//
// - A block takes a tile of whole rows (kTileRows of them, or fewer, a
//   multiple of 16, when rows are long), whose codes are contiguous; a row
//   too long for the tile (more than kMaxTileCodes codes) is cut into
//   column tiles of kColumnTile windows, each with its k-1 codes of halo,
//   one tile a block. Either way a tile is one contiguous run of codes and
//   one contiguous run of outputs.
// - The codes are staged in shared memory once: the 16-byte aligned body
//   by one TMA bulk copy that completes on an mbarrier (or, without
//   kBulkCopy, by cp.async 16 bytes a thread), the unaligned head and
//   tail by byte loads. A row slice of a chunk starts at any byte.
//   Rows of 32 and the bulk copy were the fastest of the variants that
//   tools/torch_kernel_variants.py times (rows of 16-128, cp.async, 4-byte
//   validity stores), by 1-16% (PERF.md).
// - A warp turns 32 staged codes into one word of a 2-bit plane (code & 3,
//   the tile's first code in the highest bits) and one word of a 1-bit
//   invalid plane (code >= 4, by __ballot_sync), both indexed by the
//   tile's flat code index f.
// - The window at f is then bits [2f, 2f + 2k) of the 2-bit plane, read
//   from two adjacent words with one 64-bit funnel shift, and invalid if
//   any of bits [f, f + k) of the invalid plane is set (one 32-bit funnel
//   shift and a mask); a window is valid only if col + k <= its length.
// - Consecutive threads take consecutive outputs of the tile: words go out
//   as 16-byte pairs, validity bytes kValidBytes (4 or 16) to a thread,
//   each store coalesced; the ragged head and tail of a tile's outputs are
//   written one by one in the kernel. A thread tracks its (row, column)
//   by steps, with no division in the loops.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileRows = 32;        // rows of a tile when they fit
constexpr int kMaxTileCodes = 32768; // codes a tile stages (< 48 KB of shared memory in all)
constexpr int kColumnTile = kMaxTileCodes - 32;  // windows of a column tile (+ <= 30 halo codes)
constexpr int kValidBytes = 16;      // validity bytes a thread stores at once: 4 or 16
constexpr bool kBulkCopy = true;     // stage by one TMA bulk copy, else by cp.async

static_assert(kTileRows % 16 == 0, "a tile's outputs must start 16-byte aligned");
static_assert(kValidBytes == 4 || kValidBytes == 16, "validity stores are 4 or 16 bytes");

// Shared memory of a tile of n codes and `rows` rows: the staged codes
// (with up to 15 bytes of alignment phase in front), the 2-bit plane, the
// invalid plane (each one word past the last code's), the rows' lengths.
__host__ __device__ constexpr uint32_t code_bytes(uint32_t n) { return (n + 30) & ~15u; }
__host__ __device__ constexpr uint32_t plane_words(uint32_t n) { return (n + 31) / 32 + 1; }
__host__ __device__ constexpr uint32_t smem_bytes(uint32_t n, uint32_t rows) {
  return code_bytes(n) + plane_words(n) * 12 + rows * 4;
}

// a tile needs no opt-in above 48 KB of shared memory
static_assert(smem_bytes(kMaxTileCodes, kTileRows) + 8 <= 48 * 1024, "tile over 48 KB");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// The word of the window whose first code is the tile's code f: bits
// [2f, 2f + 2k) of the 2-bit plane, first code highest.
__device__ __forceinline__ uint64_t window_word(const uint64_t* plane, uint32_t f, int k) {
  const uint32_t j = f >> 5, s2 = 2 * (f & 31);
  const uint64_t hi = plane[j], lo = plane[j + 1];
  // (lo >> 1) >> (63 - s2) is lo >> (64 - s2), and 0 at s2 = 0
  return ((hi << s2) | ((lo >> 1) >> (63 - s2))) >> (64 - 2 * k);
}

// Whether one of the window's k codes is >= 4: bits [f, f + k) of the
// invalid plane (k <= 31, so one funnel shift of two words holds them).
__device__ __forceinline__ bool window_bad(const uint32_t* bad, uint32_t f, uint32_t mask) {
  const uint32_t j = f >> 5;
  return (__funnelshift_r(bad[j], bad[j + 1], f & 31) & mask) != 0;
}

// kValidBytes validity bytes, packed 4 to a word, in one aligned store.
__device__ __forceinline__ void store_valid(uint8_t* dst, const uint32_t (&w)[1]) {
  *reinterpret_cast<uint32_t*>(dst) = w[0];
}
__device__ __forceinline__ void store_valid(uint8_t* dst, const uint32_t (&w)[4]) {
  *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
}

// Grid: with rt_full > 0 block b takes rows [b * rt_full, + rt_full) whole;
// with rt_full == 0 it takes row b / col_tiles, column tile b % col_tiles.
__global__ void __launch_bounds__(kThreads)
    pack_windows_kernel(const uint8_t* __restrict__ codes,
                        const int32_t* __restrict__ lengths, int64_t R,
                        int64_t L, int64_t W, int k, int rt_full,
                        int64_t col_tiles, uint64_t* __restrict__ words,
                        uint8_t* __restrict__ valid) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) uint64_t bar;

  // the tile: rt rows of wt windows from row r0, column c0; its codes are
  // the n contiguous ones from codes + r0 * L + c0, row i's at i * ls
  int64_t r0, c0;
  uint32_t rt, wt, ls;
  if (rt_full) {
    r0 = (int64_t)blockIdx.x * rt_full;
    c0 = 0;
    rt = (uint32_t)(R - r0 < rt_full ? R - r0 : rt_full);
    wt = (uint32_t)W;
    ls = (uint32_t)L;
  } else {
    r0 = blockIdx.x / col_tiles;
    c0 = (blockIdx.x - r0 * col_tiles) * (int64_t)kColumnTile;
    rt = 1;
    wt = (uint32_t)(W - c0 < kColumnTile ? W - c0 : kColumnTile);
    ls = 0;
  }
  const uint32_t n = rt_full ? rt * ls : wt + k - 1;
  const uint32_t n_out = rt * wt;
  const int64_t o0 = r0 * W + c0;  // the tile's first output

  uint8_t* sc = smem;  // code q of the tile at sc[p + q]
  uint64_t* plane = reinterpret_cast<uint64_t*>(smem + code_bytes(n));
  uint32_t* bad = reinterpret_cast<uint32_t*>(plane + plane_words(n));
  int32_t* lens = reinterpret_cast<int32_t*>(bad + plane_words(n));

  // stage: bytes [x_lo, x_hi) of the 16-byte aligned run from gbase come
  // as 16-byte copies, the head [p, x_lo) and tail [x_hi, p + n) one by one
  const uint8_t* g = codes + r0 * L + c0;
  const uint32_t p = (uint32_t)((uintptr_t)g & 15);
  const uint8_t* gbase = g - p;
  const uint32_t x_end = p + n;
  uint32_t x_lo = (p + 15) & ~15u, x_hi = x_end & ~15u;
  if (x_hi < x_lo) x_lo = x_hi = x_end;  // no aligned 16 bytes: all one by one
  if (kBulkCopy) {
    if (threadIdx.x == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(&bar)));
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    if (threadIdx.x == 0 && x_hi > x_lo) {
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                   ::"r"(smem_addr(&bar)), "r"(x_hi - x_lo) : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];"
          ::"r"(smem_addr(sc + x_lo)), "l"(gbase + x_lo), "r"(x_hi - x_lo),
          "r"(smem_addr(&bar)) : "memory");
    }
  } else {
    for (uint32_t x = x_lo + 16 * threadIdx.x; x < x_hi; x += 16 * kThreads) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
                   ::"r"(smem_addr(sc + x)), "l"(gbase + x) : "memory");
    }
    asm volatile("cp.async.commit_group;\ncp.async.wait_all;" ::: "memory");
  }
  const uint32_t n_head = x_lo - p;
  for (uint32_t i = threadIdx.x; i < n_head + (x_end - x_hi); i += kThreads) {
    const uint32_t x = i < n_head ? p + i : x_hi + (i - n_head);
    sc[x] = gbase[x];
  }
  for (uint32_t i = threadIdx.x; i < rt; i += kThreads) lens[i] = lengths[r0 + i];
  if (kBulkCopy && x_hi > x_lo) {
    uint32_t done = 0;
    while (!done) {
      asm volatile(
          "{\n.reg .pred ready;\n"
          "mbarrier.try_wait.parity.shared::cta.b64 ready, [%1], 0;\n"
          "selp.u32 %0, 1, 0, ready;\n}"
          : "=r"(done) : "r"(smem_addr(&bar)) : "memory");
    }
  }
  __syncthreads();

  // the planes: a warp packs 32 codes a step; codes past n count as 0
  const uint32_t lane = threadIdx.x & 31;
  for (uint32_t u = threadIdx.x >> 5; u < plane_words(n); u += kThreads / 32) {
    const uint32_t q = 32 * u + lane;
    const uint32_t c = q < n ? sc[p + q] : 0u;
    const uint32_t part = (c & 3u) << (30 - 2 * (lane & 15));
    const uint32_t hi = __reduce_or_sync(~0u, lane < 16 ? part : 0u);
    const uint32_t lo = __reduce_or_sync(~0u, lane < 16 ? 0u : part);
    const uint32_t b = __ballot_sync(~0u, c >= 4u);
    if (lane == 0) {
      plane[u] = (uint64_t)hi << 32 | lo;
      bad[u] = b;
    }
  }
  __syncthreads();

  // words: the pair (t, t+1) from the first even output on; t is row r,
  // column c of the tile, tracked by steps
  const uint32_t h2 = (uint32_t)(o0 & 1);
  {
    const uint32_t step = 2 * kThreads, step_r = step / wt, step_c = step % wt;
    uint32_t t = h2 + 2 * threadIdx.x;
    uint32_t r = t / wt, c = t - r * wt;
    for (; t + 1 < n_out; t += step) {
      const uint32_t f = r * ls + c;
      const uint32_t f2 = c + 1 < wt ? f + 1 : (r + 1) * ls;
      *reinterpret_cast<ulonglong2*>(words + o0 + t) =
          make_ulonglong2(window_word(plane, f, k), window_word(plane, f2, k));
      c += step_c;
      r += step_r;
      if (c >= wt) {
        c -= wt;
        ++r;
      }
    }
  }

  // validity: kValidBytes consecutive windows a thread from the first
  // output aligned to kValidBytes on
  const uint32_t mask = (1u << k) - 1;
  const uint32_t hv = min(n_out, (uint32_t)(-o0 & (kValidBytes - 1)));
  const uint32_t groups = (n_out - hv) / kValidBytes;
  {
    const uint32_t step = kValidBytes * kThreads, step_r = step / wt, step_c = step % wt;
    uint32_t t = hv + kValidBytes * threadIdx.x;
    uint32_t r = t / wt, c = t - r * wt;
    for (uint32_t gi = threadIdx.x; gi < groups; gi += kThreads) {
      uint32_t packed[kValidBytes / 4] = {};
      uint32_t rr = r, cc = c;
#pragma unroll
      for (int e = 0; e < kValidBytes; ++e) {
        const bool ok = !window_bad(bad, rr * ls + cc, mask) &&
                        c0 + cc + k <= (int64_t)lens[rr];
        packed[e / 4] |= (uint32_t)ok << (8 * (e & 3));
        if (++cc == wt) {
          cc = 0;
          ++rr;
        }
      }
      store_valid(valid + o0 + hv + (uint64_t)kValidBytes * gi, packed);
      c += step_c;
      r += step_r;
      if (c >= wt) {
        c -= wt;
        ++r;
      }
    }
  }

  // the ragged ends, one output at a time: the words' head (t = 0 when o0
  // is odd) and tail (the last output when an odd count is left), the
  // validity bytes before the first aligned group and after the last
  const uint32_t w_tail = (n_out - h2) & 1;
  const uint32_t v_tail = n_out - hv - groups * kValidBytes;
  for (uint32_t i = threadIdx.x; i < h2 + w_tail + hv + v_tail; i += kThreads) {
    uint32_t t;
    if (i < h2 + w_tail) {
      t = i < h2 ? 0 : n_out - 1;
    } else {
      const uint32_t v = i - h2 - w_tail;
      t = v < hv ? v : n_out - v_tail + (v - hv);
    }
    const uint32_t r = t / wt, c = t - r * wt, f = r * ls + c;
    if (i < h2 + w_tail) {
      words[o0 + t] = window_word(plane, f, k);
    } else {
      valid[o0 + t] = !window_bad(bad, f, mask) && c0 + c + k <= (int64_t)lens[r];
    }
  }
}

}  // namespace

// Selects `device` (this library links its own CUDA runtime, whose
// current device is not PyTorch's), launches on `stream`, never
// synchronises, and returns the CUDA error code (0 on success) so the
// caller can raise on a refused launch. codes is (R, L) row-major at any
// byte offset, words (16-byte aligned) and valid (R, L - k + 1).
extern "C" int bronko_pack_windows(int device, const uint8_t* codes,
                                   const int32_t* lengths, int64_t R,
                                   int64_t L, int k, int64_t* words,
                                   uint8_t* valid, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (k < 1 || k > 31 || L < k || R < 0) return (int)cudaErrorInvalidValue;
  const int64_t W = L - k + 1;
  if (R > 0) {
    // whole rows when 16 or more fit a tile, else column tiles of one row
    const int rt = kTileRows * L <= kMaxTileCodes ? kTileRows
                                                  : (int)((kMaxTileCodes / L) & ~15);
    int64_t blocks, col_tiles = 0;
    uint32_t max_codes;
    if (rt > 0) {
      blocks = (R + rt - 1) / rt;
      max_codes = (uint32_t)(rt * L);
    } else {
      col_tiles = (W + kColumnTile - 1) / kColumnTile;
      blocks = R * col_tiles;
      max_codes = (uint32_t)((W < kColumnTile ? W : kColumnTile) + k - 1);
    }
    if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
    const uint32_t smem = smem_bytes(max_codes, rt > 0 ? rt : 1);
    pack_windows_kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
        codes, lengths, R, L, W, k, rt, col_tiles,
        reinterpret_cast<uint64_t*>(words), valid);
  }
  return (int)cudaGetLastError();
}
