// Exact 16384-bin histogram of int32 ids (ids clipped into [0, 16383]).
//
// Replaces the TPU kernel cerberus_tpu/ops/pallas_hist.py:_hist_kernel,
// which counts with bf16 one-hot matmuls on the MXU into an f32 (128, 128)
// accumulator. Here counts are integer atomics and the result is int32
// (exact to 2^31, where the TPU's f32 was exact to 2^24).
//
// Bound on an H100: bytes. The least traffic is the id plane read once
// (4 B/px) plus 64 KB of counts written once — about a microsecond at tile
// sizes, less than a kernel launch, so what a call costs is its fixed work.
//
// Design:
//  * the caller may promise that ids lie in [0, n_live) (a compacted label
//    plane knows its component count). A block keeps a private histogram of
//    only those bins in dynamic shared memory, so it zeroes and flushes
//    n_live words instead of 16384; a clipped id at or above n_live is still
//    counted exactly, straight into the output with a global atomic;
//  * a block takes 4096 ids, up to two blocks per SM. Fewer, fatter blocks
//    when many bins are live (so that fewer blocks flush them) measured
//    slower on the card at every n_live: the ids want the parallelism;
//  * ids are read as int4 (16 bytes a thread) from the first 16-byte
//    boundary; the at most 3 + 3 ids before it and after the last whole
//    int4 are counted one by one;
//  * label planes are long runs of equal ids. A thread whose four ids are
//    equal joins the lanes of its warp that hold the same id
//    (__match_any_sync) and the lowest of them adds the whole count: one
//    shared atomic per id per warp instead of 128 on bin 0. A thread with
//    mixed ids adds its runs itself;
//  * the opt-in to more than 48 KB of dynamic shared memory and the SM
//    count are asked once per device (hist16384_setup), not per call.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBins = 16384;
constexpr int kThreads = 512;
constexpr int kIdsPerBlock = 4096;  // 8 ids a thread
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int clip(int v) {
  return min(max(v, 0), kBins - 1);
}

__device__ __forceinline__ void add(int* bins, int n_live, int* out, int v,
                                    int count) {
  if (v < n_live)
    atomicAdd(&bins[v], count);
  else
    atomicAdd(&out[v], count);
}

// ids[head + 4 * i], i < n4, are the 16-byte aligned body; block 0 also
// counts the `head` ids before it and the ids after it.
__global__ void __launch_bounds__(kThreads)
    hist_kernel(const int* __restrict__ ids, long long n, int head,
                long long n4, int n_live, int* __restrict__ out) {
  extern __shared__ int bins[];
  for (int i = threadIdx.x; i < n_live; i += kThreads) bins[i] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int4* body = reinterpret_cast<const int4*>(ids + head);
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  // `base` is uniform across the block, so every lane reaches the match
  for (long long base = static_cast<long long>(blockIdx.x) * kThreads;
       base < n4; base += stride) {
    const long long i = base + threadIdx.x;
    int4 q = make_int4(0, 0, 0, 0);
    bool uniform = false;
    if (i < n4) {
      q = __ldg(body + i);
      q.x = clip(q.x);
      q.y = clip(q.y);
      q.z = clip(q.z);
      q.w = clip(q.w);
      uniform = q.x == q.y && q.y == q.z && q.z == q.w;
    }
    // lanes without four equal ids get a key of their own (ids are < 2^14)
    const unsigned peers =
        __match_any_sync(kFull, uniform ? q.x : (kBins + lane));
    if (uniform) {
      if (lane == __ffs(peers) - 1)
        add(bins, n_live, out, q.x, 4 * __popc(peers));
    } else if (i < n4) {
      int cur = q.x, count = 1;
      const int rest[3] = {q.y, q.z, q.w};
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        if (rest[j] == cur) {
          ++count;
        } else {
          add(bins, n_live, out, cur, count);
          cur = rest[j];
          count = 1;
        }
      }
      add(bins, n_live, out, cur, count);
    }
  }
  if (blockIdx.x == 0) {
    const long long tail = head + 4 * n4;  // first id after the body
    if (threadIdx.x < head)
      add(bins, n_live, out, clip(ids[threadIdx.x]), 1);
    else if (threadIdx.x >= 32 && tail + (threadIdx.x - 32) < n)
      add(bins, n_live, out, clip(ids[tail + (threadIdx.x - 32)]), 1);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_live; i += kThreads) {
    const int c = bins[i];
    if (c) atomicAdd(&out[i], c);
  }
}

}  // namespace

// Once per device, before the first launch there: opts hist_kernel in to
// 64 KB of dynamic shared memory and reports the device's SM count.
extern "C" int hist16384_setup(int* sm_count) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sm_count, cudaDevAttrMultiProcessorCount,
                                 dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(hist_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kBins * static_cast<int>(sizeof(int)));
  return static_cast<int>(err);
}

// ids: n int32; out: 16384 int32 (zeroed here, by one memset). n_live in
// [1, 16384]: the caller's promise that clipped ids lie below it (ids that
// do not are still counted, more slowly). Launches on `stream`, does not
// synchronise. Returns the CUDA error (0 = success).
extern "C" int hist16384_launch(const void* ids, long long n, void* out,
                                int n_live, int sm_count, void* stream) {
  if (n_live < 1 || n_live > kBins)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaMemsetAsync(out, 0, kBins * sizeof(int), s);
  if (n > 0) {
    const uintptr_t addr = reinterpret_cast<uintptr_t>(ids);
    long long head = ((16 - addr % 16) % 16) / 4;
    if (head > n) head = n;
    const long long n4 = (n - head) / 4;
    long long blocks = (n + kIdsPerBlock - 1) / kIdsPerBlock;
    if (blocks > 2LL * sm_count) blocks = 2LL * sm_count;
    if (blocks < 1) blocks = 1;
    hist_kernel<<<static_cast<int>(blocks), kThreads,
                  n_live * static_cast<int>(sizeof(int)), s>>>(
        static_cast<const int*>(ids), n, static_cast<int>(head), n4, n_live,
        static_cast<int*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
