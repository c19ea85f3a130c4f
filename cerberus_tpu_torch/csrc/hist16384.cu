// Exact 16384-bin histogram of int32 ids (ids clipped into [0, 16383]).
//
// Replaces the TPU kernel cerberus_tpu/ops/pallas_hist.py:_hist_kernel,
// which counts with bf16 one-hot matmuls on the MXU into an f32 (128, 128)
// accumulator. Here counts are integer atomics and the result is int32
// (exact to 2^31, where the TPU's f32 was exact to 2^24).
//
// Bound on an H100: bytes. The least traffic is the id plane read once
// (4 B/px) plus 64 KB of counts written once.
//
// Design: each block keeps a private 16384-bin histogram in 64 KB of dynamic
// shared memory (over the 48 KB static limit, hence the
// cudaFuncSetAttribute below), walks a grid-stride share of the input, and
// flushes its non-zero bins into the output with global atomics. Label
// planes are mostly background, so one bin takes most pixels: lanes of a
// warp holding the same id are merged with __match_any_sync and only the
// lowest such lane adds their count, which removes the shared-memory
// atomic contention on bin 0.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBins = 16384;
constexpr int kThreads = 512;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
hist_kernel(const int* __restrict__ ids, long long n, int* __restrict__ out) {
  extern __shared__ int bins[];
  for (int i = threadIdx.x; i < kBins; i += blockDim.x) bins[i] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  // `base` is uniform across the block, so every lane reaches the match
  for (long long base = static_cast<long long>(blockIdx.x) * blockDim.x;
       base < n; base += stride) {
    const long long i = base + threadIdx.x;
    int v = -1;
    if (i < n) v = min(max(ids[i], 0), kBins - 1);
    const unsigned peers = __match_any_sync(kFull, v);
    if (v >= 0 && lane == __ffs(peers) - 1) atomicAdd(&bins[v], __popc(peers));
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kBins; i += blockDim.x) {
    const int c = bins[i];
    if (c) atomicAdd(&out[i], c);
  }
}

}  // namespace

// ids: n int32; out: 16384 int32 (zeroed here). Launches on `stream`, does
// not synchronise. Returns the CUDA error (0 = success).
extern "C" int hist16384_launch(const void* ids, long long n, void* out,
                                int max_blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaMemsetAsync(out, 0, kBins * sizeof(int), s);
  if (n > 0) {
    const int smem = kBins * static_cast<int>(sizeof(int));
    cudaFuncSetAttribute(hist_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    long long blocks = (n + kThreads * 8 - 1) / (kThreads * 8);
    if (blocks > max_blocks) blocks = max_blocks;
    if (blocks < 1) blocks = 1;
    hist_kernel<<<static_cast<int>(blocks), kThreads, smem, s>>>(
        static_cast<const int*>(ids), n, static_cast<int*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
