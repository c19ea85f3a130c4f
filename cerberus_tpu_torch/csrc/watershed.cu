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
// changes nothing. Labels (positive ids) are never overwritten. Markers
// outside the mask are dropped; the output is 0 outside the mask.
//
// Replaces the TPU kernel cerberus_tpu/ops/pallas_watershed.py:32
// (_ws_kernel), which holds the planes in VMEM and runs the whole levels x
// sweeps loop nest in one call (<= 1M px). Here the planes live in device
// memory (no size cap) and the whole level loop is ONE cooperative launch:
// no host synchronisation, no per-sweep launch.
//
// Why the flood need not be synchronous. Within one level an unlabelled
// allowed pixel p is labelled at sweep d = its geodesic distance (through
// unlabelled allowed pixels) to the labelled set, and takes the minimum
// label among the labelled pixels at that distance (induction on d). So a
// level is a shortest-path problem under the lexicographic key (distance,
// label), and monotone min-relaxation key(p) = min(key(p), key(q) + 1<<32)
// reaches its unique fixed point in ANY order: in place, tile by tile, with
// racing reads of a neighbour's half-written tile (keys only fall, and every
// key ever held is an upper bound of the fixed point). Keys are 64 bits,
// distance in the high word (a 1000^2 spiral corridor has distances near
// 500k), label in the low word.
//
// What cannot be folded: the levels. At the start of each level every
// labelled pixel is a seed at distance 0 again (lax_postproc restarts
// _propagate_labels from the label plane), so distances are reset per
// level; one key (level, distance, label) relaxed across all levels at once
// gives other plateau ties. A level that no pixel enters is skipped exactly:
// its allowed set equals the previous level's, already at its fixed point.
//
// Schedule. Init (tile-wise) writes the level bytes and keys ((0 << 32) |
// label for labelled pixels, UINT64_MAX for the rest), a per-level count of
// entering pixels, and per tile a mask of the levels present. flood_levels
// then runs every level on the device: each pass, each CTA takes its
// 64 x 64 tiles that are active, loads the keys with a 1 px halo into shared
// memory, relaxes them in place to the tile's fixed point (rounds alternate
// column and row strips and their direction), writes back the keys that
// changed, and activates the neighbouring tile across every border whose
// keys changed. A tile is active in a level's first pass if pixels enter it
// at that level or it holds keys with a distance (those it resets to 0);
// later only when a neighbour activated it. A level ends after a pass that
// activated nothing; passes are separated by grid.sync().
//
// Bound on an H100: bytes. The watershed reads 9 B/px (image, markers,
// mask) and writes 4 B/px, 13 B/px; propagate reads 5 B/px and writes 4,
// 9 B/px. The 8 B/px keys and 1 B/px levels are the working set, which at
// 1000^2 (9 MB) stays in the 50 MB L2 across passes; what the design pays
// beyond the bound is passes (one grid.sync and one tile reload each) and
// rounds inside a tile.
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

using u64 = unsigned long long;

constexpr uint8_t kNever = 255;  // level of pixels never allowed to flood
constexpr int kThreads = 256;    // elementwise kernels
constexpr int kTH = 64;          // flood tile rows
constexpr int kTW = 64;          // flood tile columns
constexpr int kTileThreads = 512;
constexpr int kMinBlocks = 2;    // flood CTAs an SM must hold (64 regs)
constexpr int kSW = kTW + 2;     // shared row stride (1 px halo each side)
constexpr int kStrip = 8;        // pixels a thread relaxes in sequence
constexpr u64 kNone = ~0ull;
constexpr u64 kStep = 1ull << 32;

// One scratch buffer per call. It starts with int32 words, zeroed by the
// entry:
// [0, 4) stats: levels visited, passes, tile passes, unused
// [4, 8) pass counters (three rotate), unused
// [8, 10) lohi: ~min and max of the ordered f32 (0 = empty), [10, 12) unused
// [12, 268) per-level count of entering pixels
// then stale, act0, act1: n_tiles each; then, 8-byte aligned, the tiles'
// level masks (n_tiles u64), the keys (h * w u64) and the levels (h * w
// bytes).
constexpr int kStats = 0;
constexpr int kCounters = 4;
constexpr int kLohi = 8;
constexpr int kHist = 12;
constexpr int kHistBins = 256;
constexpr int kPerTile = kHist + kHistBins;

static_assert(kTH * kTW % kTileThreads == 0, "tile must split evenly");
static_assert(kTileThreads == kTW * (kTH / kStrip), "column strips");
static_assert(kTileThreads == kTH * (kTW / kStrip), "row strips");

struct Plane {
  int h, w, tiles_x, n_tiles;
};

__device__ __forceinline__ unsigned ordered(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float unordered(unsigned o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

// blockDim = kThreads; one pair of atomics per block
__global__ void ws_minmax(const float* __restrict__ img,
                          const uint8_t* __restrict__ mask, long long n,
                          unsigned* lohi) {
  __shared__ unsigned s_lo[kThreads / 32], s_hi[kThreads / 32];
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
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  if ((threadIdx.x & 31) == 0) {
    s_lo[threadIdx.x / 32] = lo;
    s_hi[threadIdx.x / 32] = hi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 1; i < kThreads / 32; ++i) {
      lo = min(lo, s_lo[i]);
      hi = max(hi, s_hi[i]);
    }
    atomicMax(&lohi[0], ~lo);
    atomicMax(&lohi[1], hi);
  }
}

// One CTA per flood tile. Watershed (kProp false): level bucketed inside the
// mask, key from markers inside the mask. Propagate (kProp true): level 0
// where `allowed` (passed as mask), key from `lab` (passed as markers)
// everywhere. Also counts the entering pixels per level and the tile's mask
// of levels present (bit min(level, 63)).
template <bool kProp>
__global__ void __launch_bounds__(kTileThreads)
    tile_init(const float* __restrict__ img, const int* __restrict__ markers,
              const uint8_t* __restrict__ mask,
              const unsigned* __restrict__ lohi, int n_levels, Plane pl,
              uint8_t* __restrict__ level, u64* __restrict__ keys,
              u64* __restrict__ tile_levels, int* __restrict__ hist) {
  __shared__ int s_hist[kHistBins];
  __shared__ unsigned long long s_mask;
  for (int i = threadIdx.x; i < kHistBins; i += blockDim.x) s_hist[i] = 0;
  if (threadIdx.x == 0) s_mask = 0;
  __syncthreads();
  float lo = 0.f, span = 1.f;
  if (!kProp) {
    lo = unordered(~lohi[0]);
    span = fmaxf(unordered(lohi[1]) - lo, 1e-6f);
  }
  const float top = static_cast<float>(n_levels - 1);
  const int t = blockIdx.x;
  const int y0 = (t / pl.tiles_x) * kTH, x0 = (t % pl.tiles_x) * kTW;
  for (int idx = threadIdx.x; idx < kTH * kTW; idx += kTileThreads) {
    const int y = y0 + idx / kTW, x = x0 + idx % kTW;
    int l = -1;
    if (y < pl.h && x < pl.w) {
      const long long i = static_cast<long long>(y) * pl.w + x;
      u64 key = kNone;
      if (kProp) {
        if (mask[i]) l = 0;
        if (markers[i] != 0) key = static_cast<unsigned>(markers[i]);
      } else if (mask[i]) {
        // (img - lo) / span * top, each step rounded to f32, then truncated
        const float v =
            __fmul_rn(__fdiv_rn(__fsub_rn(img[i], lo), span), top);
        l = min(max(__float2int_rz(v), 0), n_levels - 1);
        if (markers[i] != 0) key = static_cast<unsigned>(markers[i]);
      }
      level[i] = l < 0 ? kNever : static_cast<uint8_t>(l);
      keys[i] = key;
    }
    // all lanes take part: tile and thread counts are multiples of 32
    const unsigned peers = __match_any_sync(0xffffffffu, l);
    if (l >= 0 && (threadIdx.x & 31) == __ffs(peers) - 1) {
      atomicAdd(&s_hist[l], __popc(peers));
      atomicOr(&s_mask, 1ull << min(l, 63));
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) tile_levels[t] = s_mask;
  for (int i = threadIdx.x; i < kHistBins; i += blockDim.x)
    if (s_hist[i] != 0) atomicAdd(&hist[i], s_hist[i]);
}

// Relaxes smem pixel (y, x) of the tile (interior coordinates) against its
// 4 neighbours; true if its key fell. Pixels above the level, and seeds
// (distance 0), cannot fall.
__device__ __forceinline__ bool relax(u64* sk, const uint8_t* sl, int y,
                                      int x, int lvl) {
  if (sl[y * kTW + x] > lvl) return false;
  const int c = (y + 1) * kSW + (x + 1);
  const u64 k = sk[c];
  if ((k >> 32) == 0) return false;
  u64 m = min(min(sk[c - kSW], sk[c + kSW]), min(sk[c - 1], sk[c + 1]));
  if (m == kNone) return false;
  m += kStep;
  if (m >= k) return false;
  sk[c] = m;
  return true;
}

struct FloodArgs {
  u64* keys;
  const uint8_t* level;
  const u64* tile_levels;
  int* scratch;
  Plane pl;
  int n_levels;
};

// Every level of the flood in one cooperative launch; see the file note.
__global__ void __launch_bounds__(kTileThreads, kMinBlocks)
    flood_levels(FloodArgs a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ u64 sk[(kTH + 2) * kSW];
  __shared__ uint8_t sl[kTH * kTW];
  __shared__ int s_active, s_bits;
  const Plane pl = a.pl;
  int* stats = a.scratch + kStats;
  int* counters = a.scratch + kCounters;
  const int* hist = a.scratch + kHist;
  int* stale = a.scratch + kPerTile;
  int* act = stale + pl.n_tiles;  // act[(pass & 1) * n_tiles + t]
  const int tid = threadIdx.x;
  const bool leader = blockIdx.x == 0 && tid == 0;
  u64 orig[kTH * kTW / kTileThreads];
  int pass = 0;
  for (int lvl = 0; lvl < a.n_levels; ++lvl) {
    if (hist[lvl] == 0) continue;  // written by tile_init, uniform
    if (leader) stats[0] += 1;
    for (bool first = true;; first = false) {
      int* next_count = counters + (pass + 1) % 3;
      int* act_cur = act + (pass & 1) * pl.n_tiles;
      int* act_next = act + ((pass + 1) & 1) * pl.n_tiles;
      if (leader) {
        // last read at the start of the previous pass, by every CTA
        counters[(pass + 2) % 3] = 0;
        stats[1] += 1;
      }
      for (int t = blockIdx.x; t < pl.n_tiles; t += gridDim.x) {
        __syncthreads();  // the previous tile's smem is no longer read
        if (tid == 0) {
          int on = __ldcg(&act_cur[t]);
          if (first)
            on |= __ldcg(&stale[t]) |
                  static_cast<int>((a.tile_levels[t] >> min(lvl, 63)) & 1);
          if (on) {
            __stcg(&act_cur[t], 0);
            atomicAdd(&stats[2], 1);
          }
          s_active = on;
          s_bits = 0;
        }
        __syncthreads();
        if (!s_active) continue;
        const int y0 = (t / pl.tiles_x) * kTH, x0 = (t % pl.tiles_x) * kTW;
        // interior: keys (reset to distance 0 in a level's first pass) and
        // levels; pixels past the image edge never flood
#pragma unroll
        for (int j = 0; j < kTH * kTW / kTileThreads; ++j) {
          const int idx = tid + j * kTileThreads;
          const int y = idx / kTW, x = idx % kTW;
          u64 k = kNone;
          uint8_t l = kNever;
          if (y0 + y < pl.h && x0 + x < pl.w) {
            const long long g =
                static_cast<long long>(y0 + y) * pl.w + x0 + x;
            k = __ldcg(&a.keys[g]);
            l = __ldg(&a.level[g]);
          }
          orig[j] = k;
          if (first && k != kNone) k &= 0xffffffffull;
          sk[(y + 1) * kSW + x + 1] = k;
          sl[idx] = l;
        }
        // halo: top and bottom rows, then left and right columns
        for (int i = tid; i < 2 * (kTW + kTH); i += kTileThreads) {
          int y, x;
          if (i < 2 * kTW) {
            y = i < kTW ? -1 : kTH;
            x = i % kTW;
          } else {
            y = (i - 2 * kTW) % kTH;
            x = i - 2 * kTW < kTH ? -1 : kTW;
          }
          const int gy = y0 + y, gx = x0 + x;
          sk[(y + 1) * kSW + x + 1] =
              (gy >= 0 && gy < pl.h && gx >= 0 && gx < pl.w)
                  ? __ldcg(&a.keys[static_cast<long long>(gy) * pl.w + gx])
                  : kNone;
        }
        __syncthreads();
        // rounds to the tile's fixed point: strips of kStrip pixels relaxed
        // in sequence, column strips then row strips, forwards then back
        for (int round = 0;; ++round) {
          bool changed = false;
          const bool rows = round & 1, back = round & 2;
          const int a0 = rows ? tid / (kTW / kStrip) : tid % kTW;
          const int b0 = (rows ? tid % (kTW / kStrip) : tid / kTW) * kStrip;
#pragma unroll
          for (int s = 0; s < kStrip; ++s) {
            const int b = b0 + (back ? kStrip - 1 - s : s);
            changed |= rows ? relax(sk, sl, a0, b, lvl)
                            : relax(sk, sl, b, a0, lvl);
          }
          if (!__syncthreads_or(changed)) break;
        }
        // write back what changed; note distances and changed borders
        int bits = 0;
#pragma unroll
        for (int j = 0; j < kTH * kTW / kTileThreads; ++j) {
          const int idx = tid + j * kTileThreads;
          const int y = idx / kTW, x = idx % kTW;
          const u64 k = sk[(y + 1) * kSW + x + 1];
          if (k != kNone && (k >> 32) != 0) bits |= 1;
          if (k != orig[j]) {
            __stcg(&a.keys[static_cast<long long>(y0 + y) * pl.w + x0 + x],
                   k);
            bits |= (y == 0 ? 2 : 0) | (y == kTH - 1 ? 4 : 0) |
                    (x == 0 ? 8 : 0) | (x == kTW - 1 ? 16 : 0);
          }
        }
        bits = __reduce_or_sync(0xffffffffu, static_cast<unsigned>(bits));
        if ((tid & 31) == 0 && bits) atomicOr(&s_bits, bits);
        __syncthreads();
        if (tid == 0) {
          const int b = s_bits;
          __stcg(&stale[t], b & 1);
          const int ty = t / pl.tiles_x, tx = t % pl.tiles_x;
          const int tiles_y = pl.n_tiles / pl.tiles_x;
          int nb[4] = {ty > 0 ? t - pl.tiles_x : -1,
                       ty + 1 < tiles_y ? t + pl.tiles_x : -1,
                       tx > 0 ? t - 1 : -1, tx + 1 < pl.tiles_x ? t + 1 : -1};
          for (int d = 0; d < 4; ++d) {
            if ((b & (2 << d)) && nb[d] >= 0) {
              __stcg(&act_next[nb[d]], 1);
              atomicExch(next_count, 1);
            }
          }
        }
      }
      __threadfence();
      grid.sync();
      ++pass;
      if (__ldcg(next_count) == 0) break;
    }
  }
}

__global__ void ws_finish(const u64* __restrict__ keys,
                          const uint8_t* __restrict__ mask, long long n,
                          int* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const u64 k = keys[i];
    out[i] = (k == kNone || (mask != nullptr && !mask[i]))
                 ? 0
                 : static_cast<int>(static_cast<unsigned>(k));
  }
}

int grid_for(long long n, long long cap = 65535) {
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > cap) blocks = cap;
  return static_cast<int>(blocks < 1 ? 1 : blocks);
}

Plane plane(int h, int w) {
  const int tiles_x = (w + kTW - 1) / kTW, tiles_y = (h + kTH - 1) / kTH;
  return {h, w, tiles_x, tiles_x * tiles_y};
}

struct Scratch {
  int* ints;
  u64* tile_levels;
  u64* keys;
  uint8_t* level;
};

long long int_words(const Plane& pl) { return kPerTile + 3LL * pl.n_tiles; }

// Carves the call's scratch buffer and zeroes its int32 words.
Scratch carve(void* buffer, const Plane& pl, cudaStream_t s) {
  char* b = static_cast<char*>(buffer);
  const long long ints = (int_words(pl) * 4 + 7) / 8 * 8;
  const long long n = static_cast<long long>(pl.h) * pl.w;
  Scratch sc{reinterpret_cast<int*>(b), reinterpret_cast<u64*>(b + ints),
             reinterpret_cast<u64*>(b + ints + 8LL * pl.n_tiles),
             reinterpret_cast<uint8_t*>(b + ints + 8LL * (pl.n_tiles + n))};
  cudaMemsetAsync(sc.ints, 0, int_words(pl) * 4, s);
  return sc;
}

// The cooperative launch: as many CTAs as fit on the card at once (queried
// at the launch's own block and shared-memory size), at most one per tile.
int launch_flood(const FloodArgs& args, cudaStream_t s) {
  static int capacity[64] = {};  // co-resident flood CTAs, per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (capacity[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, flood_levels, kTileThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1)
      return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
    capacity[dev] = per_sm * sms;
  }
  const int grid = min(args.pl.n_tiles, capacity[dev]);
  FloodArgs copy = args;
  void* params[] = {&copy};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(flood_levels), dim3(grid), dim3(kTileThreads),
      params, 0, s));
}

}  // namespace

// Bytes of the scratch buffer that the entries below need for an (h, w)
// plane; its first three int32 words are the call's stats: levels visited,
// passes, tile passes.
extern "C" long long flood_scratch_bytes(int h, int w) {
  const Plane pl = plane(h, w);
  return (int_words(pl) * 4 + 7) / 8 * 8 + 8LL * pl.n_tiles +
         9LL * pl.h * pl.w;
}

// image f32, markers int32, mask bool-as-bytes, out int32, all (h, w);
// scratch of flood_scratch_bytes(h, w). Enqueues on `stream` without
// synchronising; returns the CUDA error (0 = success).
extern "C" int watershed_launch(const void* image, const void* markers,
                                const void* mask, void* out, void* scratch,
                                int h, int w, int n_levels, void* stream) {
  if (h <= 0 || w <= 0) return 0;
  if (n_levels < 1 || n_levels > 255)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Plane pl = plane(h, w);
  const long long n = static_cast<long long>(h) * w;
  const Scratch sc = carve(scratch, pl, s);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  unsigned* lohi = reinterpret_cast<unsigned*>(sc.ints + kLohi);
  ws_minmax<<<grid_for(n, 1024), kThreads, 0, s>>>(
      static_cast<const float*>(image), m, n, lohi);
  tile_init<false><<<pl.n_tiles, kTileThreads, 0, s>>>(
      static_cast<const float*>(image), static_cast<const int*>(markers), m,
      lohi, n_levels, pl, sc.level, sc.keys, sc.tile_levels,
      sc.ints + kHist);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rc = launch_flood(
      {sc.keys, sc.level, sc.tile_levels, sc.ints, pl, n_levels}, s);
  if (rc != 0) return rc;
  ws_finish<<<grid_for(n), kThreads, 0, s>>>(sc.keys, m, n,
                                             static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

// One level of the same flood: labels in `lab` (0 = unlabelled) spread by
// neighbour minimum into unlabelled `allowed` pixels to the fixed point;
// out = the flooded plane with 0 where nothing arrived. Same scratch, stats
// and stream behaviour as watershed_launch.
extern "C" int propagate_launch(const void* lab, const void* allowed,
                                void* out, void* scratch, int h, int w,
                                void* stream) {
  if (h <= 0 || w <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Plane pl = plane(h, w);
  const long long n = static_cast<long long>(h) * w;
  const Scratch sc = carve(scratch, pl, s);
  tile_init<true><<<pl.n_tiles, kTileThreads, 0, s>>>(
      nullptr, static_cast<const int*>(lab),
      static_cast<const uint8_t*>(allowed), nullptr, 1, pl, sc.level,
      sc.keys, sc.tile_levels, sc.ints + kHist);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rc =
      launch_flood({sc.keys, sc.level, sc.tile_levels, sc.ints, pl, 1}, s);
  if (rc != 0) return rc;
  ws_finish<<<grid_for(n), kThreads, 0, s>>>(sc.keys, nullptr, n,
                                             static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
