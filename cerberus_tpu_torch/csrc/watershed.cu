// Marker watershed by level-ordered flooding, and the one-level label
// propagation it is built from.
//
// Contract (shared with cerberus_tpu.ops.lax_postproc.watershed and the
// Pallas kernel): elevations inside the mask are bucketed into n_levels
// levels, level = clip(int((img - lo) / span * (n_levels - 1))), with lo/hi
// the min/max over the mask and span = max(hi - lo, 1e-6), in IEEE f32 in
// that order (so no fast-math). At each level L, unlabelled pixels with
// mask && level <= L take the minimum label of their 4 neighbours,
// SYNCHRONOUSLY (each sweep reads the previous sweep's plane), until a sweep
// changes nothing. Labels are never overwritten. Markers outside the mask
// are dropped; the output is 0 outside the mask.
//
// Replaces the TPU kernel cerberus_tpu/ops/pallas_watershed.py:_ws_kernel,
// which holds the planes in VMEM and runs the whole levels x sweeps loop
// nest in one call (<= 1M px). Here the planes live in device memory, so
// there is no size cap.
//
// Bound on an H100: bytes, at 9 B/px read once (image, markers, mask) and
// 4 B/px written once; in practice the launches dominate, since every sweep
// is a launch over the whole plane. Each sweep double-buffers (Jacobi: an
// in-place flood would break plateau ties differently), writes its own
// "changed" flag, and the host reads the flag of the last of every
// k_sweeps sweeps: sweeps after the fixed point change nothing, so this is
// exact and cuts host synchronisations k-fold.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint8_t kNever = 255;  // level of pixels never allowed to flood
constexpr int kThreads = 256;

__device__ __forceinline__ unsigned ordered(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float unordered(unsigned o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

__global__ void ws_minmax(const float* __restrict__ img,
                          const uint8_t* __restrict__ mask, long long n,
                          unsigned* lohi) {
  unsigned lo = 0xffffffffu, hi = 0u;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    if (mask[i]) {
      const unsigned o = ordered(img[i]);
      lo = min(lo, o);
      hi = max(hi, o);
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    lo = min(lo, __shfl_down_sync(0xffffffffu, lo, off));
    hi = max(hi, __shfl_down_sync(0xffffffffu, hi, off));
  }
  if ((threadIdx.x & 31) == 0) {
    atomicMin(&lohi[0], lo);
    atomicMax(&lohi[1], hi);
  }
}

__global__ void ws_init(const float* __restrict__ img,
                        const int* __restrict__ markers,
                        const uint8_t* __restrict__ mask,
                        const unsigned* __restrict__ lohi, int n_levels,
                        long long n, int big, uint8_t* __restrict__ level,
                        int* __restrict__ work) {
  const float lo = unordered(lohi[0]);
  const float hi = unordered(lohi[1]);
  const float span = fmaxf(hi - lo, 1e-6f);
  const float top = static_cast<float>(n_levels - 1);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    if (mask[i]) {
      // (img - lo) / span * top, each step rounded to f32, then truncated
      const float v = __fmul_rn(__fdiv_rn(__fsub_rn(img[i], lo), span), top);
      int l = __float2int_rz(v);
      l = min(max(l, 0), n_levels - 1);
      level[i] = static_cast<uint8_t>(l);
      work[i] = markers[i] != 0 ? markers[i] : big;
    } else {
      level[i] = kNever;
      work[i] = big;
    }
  }
}

__global__ void prop_init(const int* __restrict__ lab,
                          const uint8_t* __restrict__ allowed, long long n,
                          int big, uint8_t* __restrict__ level,
                          int* __restrict__ work) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    level[i] = allowed[i] ? 0 : kNever;
    work[i] = lab[i] != 0 ? lab[i] : big;
  }
}

// blockDim = (32, 8)
__global__ void flood_sweep(const int* __restrict__ src, int* __restrict__ dst,
                            const uint8_t* __restrict__ level, int lvl,
                            int h, int w, int big, int* changed) {
  const int x = blockIdx.x * 32 + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  const int p = y * w + x;
  const int v = src[p];
  int nv = v;
  if (v == big && level[p] <= lvl) {
    int m = big;
    if (y > 0) m = min(m, src[p - w]);
    if (y + 1 < h) m = min(m, src[p + w]);
    if (x > 0) m = min(m, src[p - 1]);
    if (x + 1 < w) m = min(m, src[p + 1]);
    nv = m;
  }
  dst[p] = nv;
  if (nv != v) *changed = 1;
}

__global__ void ws_finish(const int* __restrict__ work,
                          const uint8_t* __restrict__ mask, long long n,
                          int big, int* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const int v = work[i];
    out[i] = (v == big || (mask != nullptr && !mask[i])) ? 0 : v;
  }
}

int grid_for(long long n) {
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 65535) blocks = 65535;
  return static_cast<int>(blocks < 1 ? 1 : blocks);
}

// Floods levels [0, last] of `level` into work_a (scratch work_b), k_sweeps
// sweeps per read of the changed flag; k_sweeps is even so the plane ends
// in work_a. Synchronises `stream` once per flag read.
int flood(int* work_a, int* work_b, const uint8_t* level, int last, int h,
          int w, int big, int k_sweeps, int* flags, cudaStream_t s) {
  const dim3 block(32, 8);
  const dim3 grid((w + 31) / 32, (h + 7) / 8);
  for (int lvl = 0; lvl <= last; ++lvl) {
    int changed = 1;
    while (changed) {
      cudaMemsetAsync(flags, 0, k_sweeps * sizeof(int), s);
      for (int k = 0; k < k_sweeps; ++k) {
        const int* src = (k & 1) ? work_b : work_a;
        int* dst = (k & 1) ? work_a : work_b;
        flood_sweep<<<grid, block, 0, s>>>(src, dst, level, lvl, h, w, big,
                                           flags + k);
      }
      cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
      cudaMemcpyAsync(&changed, flags + k_sweeps - 1, sizeof(int),
                      cudaMemcpyDeviceToHost, s);
      err = cudaStreamSynchronize(s);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  return 0;
}

}  // namespace

// image f32, markers int32, mask bool-as-bytes, out int32, all (h, w).
// Scratch: work_a/work_b int32 (h, w), level uint8 (h, w), flags int32
// (k_sweeps), lohi uint32 (2). k_sweeps must be even. Returns the CUDA error
// (0 = success). Synchronises `stream`.
extern "C" int watershed_launch(const void* image, const void* markers,
                                const void* mask, void* out, void* work_a,
                                void* work_b, void* level, void* flags,
                                void* lohi, int h, int w, int n_levels,
                                int k_sweeps, void* stream) {
  if (h <= 0 || w <= 0) return 0;
  if (k_sweeps < 2 || (k_sweeps & 1) || n_levels < 1 || n_levels > 255)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n = static_cast<long long>(h) * w;
  const int big = h * w + 2;
  unsigned* lh = static_cast<unsigned*>(lohi);
  cudaMemsetAsync(lh, 0xff, sizeof(unsigned), s);
  cudaMemsetAsync(lh + 1, 0, sizeof(unsigned), s);
  const float* img = static_cast<const float*>(image);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  uint8_t* lv = static_cast<uint8_t*>(level);
  int* wa = static_cast<int*>(work_a);
  ws_minmax<<<grid_for(n), kThreads, 0, s>>>(img, m, n, lh);
  ws_init<<<grid_for(n), kThreads, 0, s>>>(
      img, static_cast<const int*>(markers), m, lh, n_levels, n, big, lv, wa);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rc = flood(wa, static_cast<int*>(work_b), lv, n_levels - 1, h, w,
                       big, k_sweeps, static_cast<int*>(flags), s);
  if (rc != 0) return rc;
  ws_finish<<<grid_for(n), kThreads, 0, s>>>(wa, m, n, big,
                                             static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

// One level of the same flood: labels in `lab` (0 = unlabelled) spread by
// neighbour minimum into unlabelled `allowed` pixels to the fixed point;
// out = the flooded plane with 0 where nothing arrived. Same scratch and
// synchronisation as watershed_launch.
extern "C" int propagate_launch(const void* lab, const void* allowed,
                                void* out, void* work_a, void* work_b,
                                void* level, void* flags, int h, int w,
                                int k_sweeps, void* stream) {
  if (h <= 0 || w <= 0) return 0;
  if (k_sweeps < 2 || (k_sweeps & 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n = static_cast<long long>(h) * w;
  const int big = h * w + 2;
  uint8_t* lv = static_cast<uint8_t*>(level);
  int* wa = static_cast<int*>(work_a);
  prop_init<<<grid_for(n), kThreads, 0, s>>>(
      static_cast<const int*>(lab), static_cast<const uint8_t*>(allowed), n,
      big, lv, wa);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rc = flood(wa, static_cast<int*>(work_b), lv, 0, h, w, big,
                       k_sweeps, static_cast<int*>(flags), s);
  if (rc != 0) return rc;
  ws_finish<<<grid_for(n), kThreads, 0, s>>>(wa, nullptr, n, big,
                                             static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
