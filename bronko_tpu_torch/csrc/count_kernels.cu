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
// What bounds it is device memory: per window it writes 9 bytes (the
// word and the validity byte) and reads its k codes, which the window's
// neighbours share. One thread per (read, window): neighbouring threads
// take neighbouring windows of a row, so the two stores are coalesced and
// the k overlapping code loads of a warp hit the same few L1 lines; the
// codes are read from device memory about once. The flat window index is
// 64-bit: a chunk of 262,144 reads of 10,000 bp has 2.6e9 windows.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void pack_windows_kernel(const uint8_t* __restrict__ codes,
                                    const int32_t* __restrict__ lengths,
                                    int64_t n_windows, int64_t L, int64_t W,
                                    int k, uint64_t* __restrict__ words,
                                    uint8_t* __restrict__ valid) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_windows) return;
  const int64_t r = t / W;
  const int64_t col = t - r * W;
  const uint8_t* window = codes + r * L + col;
  uint64_t word = 0;
  bool bad = false;
  for (int i = 0; i < k; ++i) {
    const uint32_t c = __ldg(window + i);
    word = (word << 2) | (c & 3u);
    bad |= c >= 4u;
  }
  words[t] = word;
  valid[t] = !bad && col + k <= (int64_t)__ldg(lengths + r);
}

}  // namespace

// Selects `device` (this library links its own CUDA runtime, whose
// current device is not PyTorch's), launches on `stream`, never
// synchronises, and returns the CUDA error code (0 on success) so the
// caller can raise on a refused launch. codes is (R, L) row-major,
// words and valid (R, L - k + 1).
extern "C" int bronko_pack_windows(int device, const uint8_t* codes,
                                   const int32_t* lengths, int64_t R,
                                   int64_t L, int k, int64_t* words,
                                   uint8_t* valid, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int64_t W = L - k + 1;
  const int64_t n = R * W;
  if (n > 0) {
    pack_windows_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads,
                          0, stream>>>(codes, lengths, n, L, W, k,
                                       reinterpret_cast<uint64_t*>(words),
                                       valid);
  }
  return (int)cudaGetLastError();
}
