// 4-connected component labelling of a binary mask: tiles labelled in shared
// memory, merged across tile borders by union-find with min-index roots
// (after Playne & Hawick, "A New Algorithm for Parallel Connected-Component
// Labelling on GPUs", IEEE TPDS 2018), in one launch.
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
// Bound on an H100: bytes, the mask read once (1 B/px) and the labels
// written once (4 B/px). At tile-image sizes that is under 2 us, less than
// one kernel launch, so the design spends as few launches and as little
// global traffic as it can:
//  * label: a CTA of 1024 threads owns a tile of 32 rows x 128 columns
//    (wide rows: fewer row starts off a 16-byte boundary on a 1002-wide
//    ring-padded plane than 64 x 64, which measured slower there). It
//    reads the tile's mask rows as aligned 16-byte chunks (whatever the
//    row's alignment) and packs them to one bit per pixel in shared memory.
//    Then a thread owns 4 consecutive pixels of a row and works on the
//    row's bits in registers: every start of a horizontal run is a node of
//    a shared-memory forest, runs unite with the row above once per overlap
//    segment, and each pixel's tile root goes out as a GLOBAL flat index + 1
//    (16-byte stores where the row allows). From here `out` is the parent
//    forest (parent + 1, 0 on background): there is no separate parent
//    plane. The phase is bound by the SM's issue rate, not by
//    latency or bytes, which is why it is written per run and per 4 pixels;
//  * borders: pixels of a tile's top row and left column unite with the
//    foreground pixel across the edge, unless the link is implied by the
//    pixel before them (that pixel and its partner both foreground). These
//    are the only global atomics: O(perimeter), not O(area);
//  * flatten: out = find(out - 1) + 1. Most tile roots are still roots (two
//    independent loads a pixel); a tile root that was linked away is walked
//    once per tile, by the thread that owns its pixel, and its pixels read
//    the result from shared memory.
// A union links the larger root under the smaller with atomicMin, so a root
// is always its set's minimum index, which is the tile-row-major minimum
// inside a tile too; finds halve paths with atomicMin, so a racing union is
// never undone (parents only fall). The labels are exact whatever the order.
// The three phases are one cooperative launch with grid.sync() between
// them (CTAs loop over tiles; the grid comes from the occupancy query,
// cached per device): grid.sync() costs the device less than two more
// launches cost the host. A plane of one tile needs only the first phase.
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

using u64 = unsigned long long;

constexpr int kThreads = 1024;  // 4 pixels of a tile per thread
constexpr int kMinBlocks = 2;    // CTAs an SM must hold (32 registers)

constexpr int kTH = 32;          // tile rows
constexpr int kWords = 2;        // 64-bit words of mask bits per tile row
constexpr int kTW = 64 * kWords; // tile columns
constexpr int kPix = kTH * kTW;

struct Plane {
  int h, w, tiles_x, n_tiles;
};

// ---- the forest in `out` (label = parent's flat index + 1) ---------------

__device__ __forceinline__ int find_root(int* lab, int x) {
  volatile int* v = lab;
  int p = v[x] - 1;
  while (p != x) {
    const int gp = v[p] - 1;
    if (gp < p) atomicMin(&lab[x], gp + 1);
    x = p;
    p = gp;
  }
  return x;
}

__device__ void unite(int* lab, int a, int b) {
  while (true) {
    a = find_root(lab, a);
    b = find_root(lab, b);
    if (a == b) return;
    if (a > b) {
      const int t = a;
      a = b;
      b = t;
    }
    const int old = atomicMin(&lab[b], a + 1) - 1;
    if (old == b) return;  // b was still a root: now linked under a
    b = old;               // b was linked meanwhile: retry from its parent
  }
}

// ---- the tile's forest in shared memory (parent = tile-local index) ------

__device__ __forceinline__ int find_local(int* s, int x) {
  volatile int* v = s;
  int p = v[x];
  while (p != x) {
    const int gp = v[p];
    if (gp < p) atomicMin(&s[x], gp);
    x = p;
    p = gp;
  }
  return x;
}

__device__ void unite_local(int* s, int a, int b) {
  while (true) {
    a = find_local(s, a);
    b = find_local(s, b);
    if (a == b) return;
    if (a > b) {
      const int t = a;
      a = b;
      b = t;
    }
    const int old = atomicMin(&s[b], a);
    if (old == b) return;
    b = old;
  }
}

// 4 mask bytes (any non-zero value is foreground) to 4 bits
__device__ __forceinline__ unsigned nibble(unsigned bytes) {
  return (((__vcmpne4(bytes, 0u) & 0x01010101u) * 0x01020408u) >> 24) & 0xfu;
}

// Column where the run of foreground holding column x starts, from the
// row's bits: one past the highest background bit below x.
__device__ __forceinline__ int run_start(const u64* row, int x) {
  int k = x >> 6;
  u64 zeros = ~row[k] & (~0ull >> (63 - (x & 63)));
  while (zeros == 0 && k > 0) zeros = ~row[--k];
  return zeros ? 64 * k + 64 - __clzll(zeros) : 0;
}

// Phase 0: label tile t in shared memory, write global roots + 1 to `out`.
__device__ void label_tile(const uint8_t* __restrict__ mask,
                           int* __restrict__ out, const Plane& pl, int t,
                           u64* s_bits, int* s_lab) {
  const int tid = threadIdx.x;
  const int y0 = (t / pl.tiles_x) * kTH, x0 = (t % pl.tiles_x) * kTW;
  const int th = min(kTH, pl.h - y0), tw = min(kTW, pl.w - x0);
  __syncthreads();  // the previous tile's shared memory is no longer read
  for (int i = tid; i < kTH * kWords; i += kThreads) s_bits[i] = 0;
  __syncthreads();
  // Each tile row as the aligned 16-byte chunks that cover it. A chunk is
  // only read when it holds a byte of the row, so it lies in the mask's own
  // 16-byte granules; bytes of other columns are shifted or masked away.
  constexpr int kChunks = kTW / 16 + 1;
  const uintptr_t base = reinterpret_cast<uintptr_t>(mask);
  bool mine = false;
  for (int i = tid; i < th * kChunks; i += kThreads) {
    const int y = i / kChunks, k = i % kChunks;
    const uintptr_t row = base + static_cast<long long>(y0 + y) * pl.w + x0;
    const uintptr_t addr = (row & ~static_cast<uintptr_t>(15)) + 16 * k;
    int col = static_cast<int>(static_cast<long long>(addr) -
                               static_cast<long long>(row));  // of byte 0
    if (col >= tw) continue;
    const uint4 q = *reinterpret_cast<const uint4*>(addr);
    unsigned bits = nibble(q.x) | (nibble(q.y) << 4) | (nibble(q.z) << 8) |
                    (nibble(q.w) << 12);
    if (col < 0) {
      bits >>= -col;
      col = 0;
    }
    if (col + 16 > tw) bits &= (1u << (tw - col)) - 1u;
    if (bits == 0) continue;
    mine = true;
    // two 32-bit halves of the row's words (native shared atomics)
    unsigned* half = reinterpret_cast<unsigned*>(s_bits + y * kWords);
    const u64 placed = static_cast<u64>(bits) << (col & 31);
    atomicOr(&half[col >> 5], static_cast<unsigned>(placed));
    if ((placed >> 32) != 0 && (col >> 5) + 1 < 2 * kWords)
      atomicOr(&half[(col >> 5) + 1], static_cast<unsigned>(placed >> 32));
  }
  const bool any = __syncthreads_or(mine);
  // From here a thread owns 4 consecutive pixels of one row: it works on
  // the row's bits in registers and touches the forest only at run starts.
  static_assert(kPix == 4 * kThreads, "4 pixels per thread");
  const int y = tid / (kTW / 4), xq = 4 * (tid % (kTW / 4));
  const bool vec = y < th && xq + 3 < tw &&
                   ((static_cast<long long>(y0 + y) * pl.w + x0 + xq) & 3) == 0;
  int* dst = out + static_cast<long long>(y0 + y) * pl.w + x0 + xq;
  int label[4] = {0, 0, 0, 0};
  if (any) {
    const u64* row = s_bits + y * kWords;
    const u64* up = row - kWords;  // read only below the first row
    const int k = xq >> 6, off = xq & 63;
    const u64 word = row[k];
    const unsigned fg = static_cast<unsigned>(word >> off) & 0xfu;
    // bit of column xq - 1 (of the previous word at a word's first column)
    const unsigned prev = off ? static_cast<unsigned>(word >> (off - 1)) & 1u
                              : (k ? static_cast<unsigned>(row[k - 1] >> 63)
                                   : 0u);
    // every run start is its own root
    const unsigned starts = fg & ~((fg << 1) | prev);
    for (unsigned m = starts; m; m &= m - 1) {
      const int idx = y * kTW + xq + __ffs(m) - 1;
      s_lab[idx] = idx;
    }
    __syncthreads();
    // one union with the row above per overlap segment (the segment's
    // first column), between the two runs' starts
    if (y > 0) {
      const u64 wup = up[k];
      const unsigned both = fg & (static_cast<unsigned>(wup >> off) & 0xfu);
      const unsigned prev_up =
          off ? static_cast<unsigned>(wup >> (off - 1)) & 1u
              : (k ? static_cast<unsigned>(up[k - 1] >> 63) : 0u);
      const unsigned first = both & ~((both << 1) | (prev & prev_up));
      for (unsigned m = first; m; m &= m - 1) {
        const int x = xq + __ffs(m) - 1;
        unite_local(s_lab, y * kTW + run_start(row, x),
                    (y - 1) * kTW + run_start(up, x));
      }
    }
    __syncthreads();
    // the forest is final: plain loads, one walk per run
    int root = -1;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (!((fg >> i) & 1u)) {
        root = -1;
        continue;
      }
      if (root < 0) {
        int r = y * kTW + run_start(row, xq + i);
        while (s_lab[r] != r) r = s_lab[r];
        root = (y0 + r / kTW) * pl.w + x0 + r % kTW + 1;
      }
      label[i] = root;
    }
  }
  if (vec) {
    *reinterpret_cast<int4*>(dst) =
        make_int4(label[0], label[1], label[2], label[3]);
  } else if (y < th) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (xq + i < tw) dst[i] = label[i];
  }
}

// Phase 1: unite tile t's top row and left column with the pixels across
// the edge.
__device__ void unite_borders(int* out, const Plane& pl, int t) {
  static_assert(kTW + kTH <= kThreads, "one thread per border pixel");
  const int tid = threadIdx.x;
  const int y0 = (t / pl.tiles_x) * kTH, x0 = (t % pl.tiles_x) * kTW;
  // the pixel, its partner across the edge, and the step back to the pixel
  // before it along the edge (0: there is none)
  int p = -1, q = 0, back = 0;
  if (tid < kTW) {
    const int x = x0 + tid;
    if (y0 > 0 && x < pl.w) {
      p = y0 * pl.w + x;
      q = p - pl.w;
      back = x > 0 ? 1 : 0;
    }
  } else if (tid < kTW + kTH) {
    const int j = tid - kTW;
    if (x0 > 0 && y0 + j < pl.h) {
      p = (y0 + j) * pl.w + x0;
      q = p - 1;
      back = j > 0 ? pl.w : 0;
    }
  }
  if (p < 0) return;
  // whether a pixel is foreground never changes, so the four loads overlap
  const int fp = __ldcg(&out[p]), fq = __ldcg(&out[q]);
  const int bp = __ldcg(&out[p - back]), bq = __ldcg(&out[q - back]);
  if (fp && fq && !(back && bp && bq)) unite(out, p, q);
}

// Phase 2: every pixel of tile t takes its root.
__device__ void flatten_tile(int* out, const Plane& pl, int t, int* s_root) {
  // pixel j of a thread is tile pixel threadIdx.x + j * kThreads: a warp
  // reads 32 consecutive pixels at a time (4 consecutive pixels a thread,
  // as in label_tile, measured slower here)
  constexpr int kPer = kPix / kThreads;
  static_assert(kPix % kThreads == 0, "tile must split evenly");
  const int y0 = (t / pl.tiles_x) * kTH, x0 = (t % pl.tiles_x) * kTW;
  // two rounds of independent loads: the labels, then their parents. A
  // pixel whose label names a root is done; the others' tile roots were
  // linked away by the border phase
  int pix[kPer], label[kPer], parent[kPer], slot[kPer];
  bool any = false;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int idx = threadIdx.x + j * kThreads;
    const int y = y0 + idx / kTW, x = x0 + idx % kTW;
    pix[j] = (y < pl.h && x < pl.w) ? y * pl.w + x : -1;
    label[j] = pix[j] >= 0 ? __ldcg(&out[pix[j]]) : 0;
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    parent[j] = label[j] ? __ldcg(&out[label[j] - 1]) : 0;
    any |= parent[j] != label[j];
  }
  // (also: the previous tile's s_root is no longer read)
  if (!__syncthreads_or(any)) return;
  // Thousands of pixels share the few roots that were linked away, and a
  // walk halves its path with atomics on those same words, so each such
  // root is walked once: its pixels post its label in the root's slot of
  // the tile, the thread that owns that slot walks, all read the result.
  // (A stale slot that happens to match costs a needless walk, no more.)
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    slot[j] = -1;
    if (parent[j] == label[j]) continue;
    const int ry = (label[j] - 1) / pl.w - y0, rx = (label[j] - 1) % pl.w - x0;
    if (ry >= 0 && ry < kTH && rx >= 0 && rx < kTW) {
      slot[j] = ry * kTW + rx;
      s_root[slot[j]] = label[j];
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int idx = threadIdx.x + j * kThreads;
    if (label[j] && s_root[idx] == pix[j] + 1)
      s_root[idx] = find_root(out, label[j] - 1) + 1;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if (parent[j] == label[j]) continue;
    // a tile root linked to a root of another tile walks by itself
    out[pix[j]] = slot[j] >= 0 ? s_root[slot[j]]
                               : find_root(out, parent[j] - 1) + 1;
  }
}

// The first `phases` phases over all tiles, grid.sync() between them: a
// cooperative launch.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    cc_phases(const uint8_t* __restrict__ mask, int* out, Plane pl,
              int phases) {
  __shared__ u64 s_bits[kTH * kWords];
  __shared__ int s_lab[kPix];
  for (int phase = 0; phase < phases; ++phase) {
    if (phase > 0) cg::this_grid().sync();
    for (int t = blockIdx.x; t < pl.n_tiles; t += gridDim.x) {
      if (phase == 0)
        label_tile(mask, out, pl, t, s_bits, s_lab);
      else if (phase == 1)
        unite_borders(out, pl, t);
      else
        flatten_tile(out, pl, t, s_lab);
    }
  }
}

__global__ void empty_kernel() {}

}  // namespace

// mask: (h, w) bool as bytes; out: (h, w) int32; h * w < 2^31 - 1. Launches
// on `stream`, does not synchronise. Returns the CUDA error (0 = success).
extern "C" int cc_label_launch(const void* mask_, void* out_, int h, int w,
                               void* stream) {
  if (h <= 0 || w <= 0) return 0;
  const uint8_t* mask = static_cast<const uint8_t*>(mask_);
  int* out = static_cast<int*>(out_);
  const int tiles_x = (w + kTW - 1) / kTW, tiles_y = (h + kTH - 1) / kTH;
  Plane pl{h, w, tiles_x, tiles_x * tiles_y};
  static int capacity[64] = {};  // co-resident CTAs of cc_phases, per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (capacity[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, cc_phases,
                                                          kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1)
      return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
    capacity[dev] = per_sm * sms;
  }
  int phases = pl.n_tiles == 1 ? 1 : 3;  // a single tile's roots are final
  void* params[] = {&mask, &out, &pl, &phases};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(cc_phases),
      dim3(pl.n_tiles < capacity[dev] ? pl.n_tiles : capacity[dev]),
      dim3(kThreads), params, 0, static_cast<cudaStream_t>(stream)));
}

// An empty kernel through the same route: the least a one-launch entry of
// these libraries can cost.
extern "C" int launch_floor_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
