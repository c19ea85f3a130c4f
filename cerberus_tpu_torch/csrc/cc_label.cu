// 4-connected component labelling of a binary mask, by union-find with
// min-index roots (Playne & Hawick, "A New Algorithm for Parallel
// Connected-Component Labelling on GPUs", IEEE TPDS 2018).
//
// Contract (shared with cerberus_tpu.ops.lax_postproc.connected_components
// and the Pallas kernels): out[p] = (min flat index of p's component) + 1 on
// foreground, 0 on background, in the UNPADDED (H, W) grid.
//
// Replaces the TPU kernels cerberus_tpu/ops/pallas_cc.py:_cc_kernel (a
// VMEM-resident fixed point of segmented run-min scans, capped at 400k px)
// and cerberus_tpu/ops/pallas_cc_blocked.py:_strip_kernel (the same fixed
// point in row strips with a carry row, for larger canvases). Union-find
// works from device memory at any size, so one kernel covers both.
//
// Bound on an H100: bytes. The least traffic is the mask read once (1 B/px)
// and the labels written once (4 B/px); the parent forest adds a 4 B/px
// scratch plane that stays mostly in the 50 MB L2 at tile sizes.
//
// Design:
//  * init: each warp owns 32 consecutive pixels of one row; a ballot finds
//    the horizontal run starts and every pixel links straight to its run's
//    start (forest depth <= 1 before any union);
//  * merge: lane 0 unites with its left neighbour across the segment edge,
//    and every pixel unites with the pixel above unless that link is implied
//    by its left neighbour's (left and up-left both foreground);
//  * union links the larger root under the smaller with atomicMin, so a
//    root is always its set's minimum index; finds halve paths with
//    atomicMin too, so a racing union is never undone (parents only fall);
//  * flatten: out = find(p) + 1.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int find_root(int* parent, int x) {
  volatile int* vp = parent;
  int p = vp[x];
  while (p != x) {
    const int gp = vp[p];
    if (gp < p) atomicMin(&parent[x], gp);
    x = p;
    p = gp;
  }
  return x;
}

__device__ void unite(int* parent, int a, int b) {
  while (true) {
    a = find_root(parent, a);
    b = find_root(parent, b);
    if (a == b) return;
    if (a > b) {
      const int t = a;
      a = b;
      b = t;
    }
    const int old = atomicMin(&parent[b], a);
    if (old == b) return;  // b was still a root: now linked under a
    b = old;               // b was linked meanwhile: retry from its parent
  }
}

// blockDim = (32, 8): each warp is one 32-pixel segment of one row.
__global__ void cc_init(const uint8_t* __restrict__ mask, int* parent,
                        int h, int w) {
  const int x = blockIdx.x * 32 + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const bool in = x < w && y < h;
  const int p = y * w + x;
  const bool fg = in && mask[p];
  const unsigned fg_bits = __ballot_sync(kFull, fg);
  const unsigned starts = fg_bits & ~(fg_bits << 1);
  const int lane = threadIdx.x;
  if (!in) return;
  if (!fg) {
    parent[p] = p;
    return;
  }
  const unsigned upto = starts & (kFull >> (31 - lane));
  const int s = 31 - __clz(upto);
  parent[p] = p - (lane - s);
}

__global__ void cc_merge(const uint8_t* __restrict__ mask, int* parent,
                         int h, int w) {
  const int x = blockIdx.x * 32 + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  const int p = y * w + x;
  if (!mask[p]) return;
  const bool left = x > 0 && mask[p - 1];
  if (threadIdx.x == 0 && left) unite(parent, p, p - 1);
  if (y > 0 && mask[p - w]) {
    const bool implied = left && mask[p - w - 1];
    if (!implied) unite(parent, p, p - w);
  }
}

__global__ void cc_flatten(const uint8_t* __restrict__ mask, int* parent,
                           int* __restrict__ out, int h, int w) {
  const int x = blockIdx.x * 32 + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  const int p = y * w + x;
  out[p] = mask[p] ? find_root(parent, p) + 1 : 0;
}

}  // namespace

// mask: (h, w) bool as bytes; parent: (h, w) int32 scratch; out: (h, w)
// int32. Launches on `stream`, does not synchronise. Returns the CUDA error
// of the launches (0 = success).
extern "C" int cc_label_launch(const void* mask, void* parent, void* out,
                               int h, int w, void* stream) {
  if (h <= 0 || w <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 block(32, 8);
  const dim3 grid((w + 31) / 32, (h + 7) / 8);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  int* par = static_cast<int*>(parent);
  cc_init<<<grid, block, 0, s>>>(m, par, h, w);
  cc_merge<<<grid, block, 0, s>>>(m, par, h, w);
  cc_flatten<<<grid, block, 0, s>>>(m, par, static_cast<int*>(out), h, w);
  return static_cast<int>(cudaGetLastError());
}
