// Hopper kernel for the gather probe, with a plain C launch interface,
// wrapped by bronko_tpu_torch/ops/cuda_gather.py and built and loaded
// with the port's other kernels by ops/cuda_lib.py.
//
// K4 gather replaces tests/profile_gather.py pallas_gather / kernel:
//   out[i] = tbl[idx[i]] for an int32 table and int32 indices.
//
// The TPU kernel held the whole (2^20,) table in VMEM and gathered from
// it. A Hopper block has at most 227 KB of shared memory, so the 4 MB
// table cannot be staged there; it stays in device memory and, after the
// first touches, in the 50 MB L2, which plays VMEM's part.
//
// What bounds it on this card: bytes. Each index is read once and each
// result written once (8 bytes an element, coalesced), the table read
// once: 21 MB at U = 2^20, N = 2^21, 6.3 us at 3.35 TB/s. Each random
// 4-byte lookup still moves a whole 32-byte L2 sector, so the lookups
// cost 8x their bytes in L2 traffic (67 MB at N = 2^21), and what a
// thread can hide of the L2's latency is what it has in flight.
//
// Design: a thread takes kVec runs of 4 consecutive indices, each with
// one 16-byte load, then issues all 4 * kVec table loads before it uses
// any, so that many lookups are in flight per thread, and writes each run
// of 4 results with one 16-byte store. The vector body starts at the
// first 16-byte boundary of idx; the wrapper gives out the same
// alignment, and the elements before that boundary and after the last
// whole run are gathered one by one by block 0. An index outside [0, U)
// is the caller's error: the kernel never reads outside the table and
// writes 0 there. Measured on the card it sits at torch's own gathers
// (~20 us at N = 2^21): both are held by the L2's rate of random sector
// reads, not by the lookups a thread has in flight (1, 2, 4 or 8 runs a
// thread time alike).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 2;  // 16-byte runs a thread: 8 lookups in flight

__device__ __forceinline__ int32_t lookup(const int32_t* __restrict__ tbl,
                                          uint32_t U, int32_t i) {
  // a negative i is >= 2^31 as unsigned, and U <= 2^31
  return (uint32_t)i < U ? __ldg(tbl + i) : 0;
}

__global__ void __launch_bounds__(kThreads)
    gather_kernel(const int32_t* __restrict__ tbl, uint32_t U,
                  const int32_t* __restrict__ idx, int64_t n, int head,
                  int32_t* __restrict__ out) {
  const int64_t nvec = (n - head) / 4;  // whole 16-byte runs
  if (blockIdx.x == 0 && threadIdx.x < 4) {
    // the scalar head (before idx's first 16-byte boundary) and tail
    const int t = threadIdx.x;
    if (t < head) out[t] = lookup(tbl, U, idx[t]);
    const int64_t e = head + nvec * 4 + t;
    if (e < n) out[e] = lookup(tbl, U, idx[e]);
  }
  const int4* __restrict__ iv = reinterpret_cast<const int4*>(idx + head);
  int4* __restrict__ ov = reinterpret_cast<int4*>(out + head);
  const int64_t v0 = (int64_t)blockIdx.x * (kThreads * kVec) + threadIdx.x;
  int4 in[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const int64_t v = v0 + j * kThreads;
    in[j] = v < nvec ? iv[v] : make_int4(0, 0, 0, 0);
  }
  int4 res[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    res[j].x = lookup(tbl, U, in[j].x);
    res[j].y = lookup(tbl, U, in[j].y);
    res[j].z = lookup(tbl, U, in[j].z);
    res[j].w = lookup(tbl, U, in[j].w);
  }
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const int64_t v = v0 + j * kThreads;
    if (v < nvec) ov[v] = res[j];
  }
}

}  // namespace

// Selects `device`, launches on `stream`, never synchronises, and returns
// the CUDA error code (0 on success). `out` must sit at the same offset
// from a 16-byte boundary as `idx` (cudaErrorInvalidValue otherwise).
extern "C" int bronko_gather(int device, const int32_t* tbl, int64_t U,
                             const int32_t* idx, int64_t n, int32_t* out,
                             cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const uintptr_t phase = reinterpret_cast<uintptr_t>(idx) & 15;
  if (phase != (reinterpret_cast<uintptr_t>(out) & 15) || (phase & 3)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n > 0) {
    const int64_t head64 = ((16 - (int64_t)phase) & 15) / 4;
    const int head = (int)(head64 < n ? head64 : n);
    const int64_t nvec = (n - head) / 4;
    const int64_t per_block = (int64_t)kThreads * kVec;
    const int64_t blocks = nvec > 0 ? (nvec + per_block - 1) / per_block : 1;
    // int32 indices never reach past 2^31 entries
    const uint32_t u = U > (int64_t)0x80000000LL ? 0x80000000u : (uint32_t)U;
    gather_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(tbl, u, idx, n,
                                                             head, out);
  }
  return (int)cudaGetLastError();
}
