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
// first touches, in the 50 MB L2, which plays VMEM's part. What bounds
// the gather is memory traffic: 4 bytes of index read and 4 written per
// element, coalesced, plus one random 4-byte table read, which costs a
// whole 32-byte L2 sector. One thread per index, read-only loads through
// the non-coherent cache. An index outside [0, U) is the caller's error:
// the kernel never reads outside the table and writes 0 there.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void gather_kernel(const int32_t* __restrict__ tbl, int64_t U,
                              const int32_t* __restrict__ idx, int64_t n,
                              int32_t* __restrict__ out) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  const int32_t i = __ldg(idx + t);
  out[t] = (i >= 0 && i < U) ? __ldg(tbl + i) : 0;
}

}  // namespace

// Selects `device`, launches on `stream`, never synchronises, and returns
// the CUDA error code (0 on success).
extern "C" int bronko_gather(int device, const int32_t* tbl, int64_t U,
                             const int32_t* idx, int64_t n, int32_t* out,
                             cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    gather_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                    stream>>>(tbl, U, idx, n, out);
  }
  return (int)cudaGetLastError();
}
