// Per-instance statistics of int32 label planes, as exact integers: the
// box, the pixel count, the coordinate sums and the (instance, type) counts
// of every id, for several planes of one shape in one launch.
//
// Replaces no TPU kernel. The JAX package builds the tile engine's instance
// records on the host, with whole-map passes over 2x-upscaled copies of the
// label and type maps (cerberus_tpu/infer/tile.py, ops/postproc.py
// get_inst_info_dict: np.unique, find_objects, a joint bincount). Every
// record but the contour is an integer reduction per instance over the 1x
// map, which this kernel computes on the card where the maps already are;
// the host then works on each instance's crop alone.
//
// Bound on an H100: bytes. The least traffic is each label plane read once
// (4 B/px) and the type plane of a typed plane read once (4 B/px); the
// tables (tens of bytes an id) are small beside them.
//
// Design:
//  * one thread a pixel, a warp on 32 consecutive pixels of the stacked
//    planes, a grid of up to 8 blocks an SM striding over them (coalesced
//    128-byte reads). A warp of background skips at once;
//  * label planes are long runs of equal ids, so a warp groups its lanes
//    by (plane, id) (__match_any_sync) and each group reduces its count, x
//    and y sums and minima and maxima in registers (__reduce_*_sync):
//    one set of atomics a (warp, id), not one a pixel. Its lanes then group
//    again by type, one atomic a (warp, id, type);
//  * box updates read the table first and take an atomic only where the
//    box grows (the values only ever move one way, so a stale read only
//    costs an atomic);
//  * nuclei planes hold thousands of ids, so the tables live in global
//    memory (no per-block shared table could hold every plane's);
//  * every count is an integer atomic: the result is exact and the same on
//    every run, whatever order the atomics land in.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxPlanes = 8;
constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned char kEmptyByte = 0x7f;  // rmin, cmin of an absent id

struct Planes {
  int type_plane[kMaxPlanes];  // index into the type planes, or -1
  int n_ids[kMaxPlanes];       // ids above this are not counted
  int n_types[kMaxPlanes];     // types outside [0, n_types) are not counted
  long long row_base[kMaxPlanes];
  long long joint_base[kMaxPlanes];
};

// ints: rmin[rows], cmin[rows], rmax[rows], cmax[rows], then the joint
// counts; sums: n[rows], sum x[rows], sum y[rows].
__global__ void __launch_bounds__(kThreads)
    inst_table(const int* __restrict__ labels, const int* __restrict__ types,
               int width, long long plane_px, long long n_px, Planes planes,
               long long rows, int* __restrict__ ints,
               unsigned long long* __restrict__ sums) {
  const int lane = threadIdx.x & 31;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  // `base` is uniform across the block, so every lane reaches each vote
  for (long long base = static_cast<long long>(blockIdx.x) * kThreads;
       base < n_px; base += stride) {
    const long long i = base + threadIdx.x;
    int id = 0, p = 0;
    long long pix = 0;
    if (i < n_px) {
      p = static_cast<int>(i / plane_px);
      pix = i - p * plane_px;
      id = __ldg(labels + i);
      if (id < 1 || id > planes.n_ids[p]) id = 0;
    }
    if (!__any_sync(kFull, id != 0)) continue;
    const unsigned long long key =
        (static_cast<unsigned long long>(p) << 32) | static_cast<unsigned>(id);
    const unsigned peers = __match_any_sync(kFull, key);
    if (id == 0) continue;
    // from here on only the lanes of one (plane, id) group take part
    const int y = static_cast<int>(pix / width);
    const int x = static_cast<int>(pix - static_cast<long long>(y) * width);
    const unsigned sx = __reduce_add_sync(peers, static_cast<unsigned>(x));
    const unsigned sy = __reduce_add_sync(peers, static_cast<unsigned>(y));
    const int y0 = __reduce_min_sync(peers, y);
    const int y1 = __reduce_max_sync(peers, y) + 1;
    const int x0 = __reduce_min_sync(peers, x);
    const int x1 = __reduce_max_sync(peers, x) + 1;
    const long long row = planes.row_base[p] + id;
    if (lane == __ffs(peers) - 1) {
      atomicAdd(&sums[row], static_cast<unsigned long long>(__popc(peers)));
      atomicAdd(&sums[rows + row], static_cast<unsigned long long>(sx));
      atomicAdd(&sums[2 * rows + row], static_cast<unsigned long long>(sy));
      if (y0 < ints[row]) atomicMin(&ints[row], y0);
      if (x0 < ints[rows + row]) atomicMin(&ints[rows + row], x0);
      if (y1 > ints[2 * rows + row]) atomicMax(&ints[2 * rows + row], y1);
      if (x1 > ints[3 * rows + row]) atomicMax(&ints[3 * rows + row], x1);
    }
    const int tp = planes.type_plane[p];
    if (tp >= 0) {
      const int t = __ldg(types + tp * plane_px + pix);
      const unsigned same = __match_any_sync(peers, t);
      const int n_types = planes.n_types[p];
      if (lane == __ffs(same) - 1 && t >= 0 && t < n_types)
        atomicAdd(&ints[4 * rows + planes.joint_base[p] +
                        static_cast<long long>(id) * n_types + t],
                  static_cast<int>(__popc(same)));
    }
  }
}

}  // namespace

// labels: n_planes stacked (height, width) int32 planes; types: stacked
// int32 type planes (may be null when no plane is typed). desc: per plane
// five int64 on the host: type plane index (-1: none), n_ids, n_types,
// row_base, joint_base. ints: 4 * rows + joint_len int32; sums: 3 * rows
// int64; both zeroed (rmin and cmin to 0x7f7f7f7f) here. Launches on
// `stream`, does not synchronise. Returns the CUDA error (0 = success).
extern "C" int inst_stats_launch(const void* labels, const void* types,
                                 int n_planes, int height, int width,
                                 const long long* desc, long long rows,
                                 long long joint_len, void* ints, void* sums,
                                 int sm_count, void* stream) {
  // 32 x-coordinates (or y) summed in 32 bits must not wrap
  if (n_planes < 1 || n_planes > kMaxPlanes || height < 0 || width < 0 ||
      height >= (1 << 26) || width >= (1 << 26) || rows < n_planes)
    return static_cast<int>(cudaErrorInvalidValue);
  Planes planes = {};
  for (int p = 0; p < n_planes; ++p) {
    planes.type_plane[p] = static_cast<int>(desc[5 * p]);
    planes.n_ids[p] = static_cast<int>(desc[5 * p + 1]);
    planes.n_types[p] = static_cast<int>(desc[5 * p + 2]);
    planes.row_base[p] = desc[5 * p + 3];
    planes.joint_base[p] = desc[5 * p + 4];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaMemsetAsync(ints, kEmptyByte, 2 * rows * sizeof(int), s);
  cudaMemsetAsync(static_cast<int*>(ints) + 2 * rows, 0,
                  (2 * rows + joint_len) * sizeof(int), s);
  cudaMemsetAsync(sums, 0, 3 * rows * sizeof(unsigned long long), s);
  const long long plane_px = static_cast<long long>(height) * width;
  const long long n_px = plane_px * n_planes;
  if (n_px > 0) {
    long long blocks = (n_px + kThreads - 1) / kThreads;
    if (blocks > static_cast<long long>(kBlocksPerSm) * sm_count)
      blocks = static_cast<long long>(kBlocksPerSm) * sm_count;
    if (blocks < 1) blocks = 1;
    inst_table<<<static_cast<int>(blocks), kThreads, 0, s>>>(
        static_cast<const int*>(labels), static_cast<const int*>(types),
        width, plane_px, n_px, planes, rows, static_cast<int*>(ints),
        static_cast<unsigned long long*>(sums));
  }
  return static_cast<int>(cudaGetLastError());
}
