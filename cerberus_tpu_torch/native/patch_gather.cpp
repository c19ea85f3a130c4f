// Parallel patch gather: crop N fixed-size windows from a large (mmap'd)
// uint8 image into a contiguous batch buffer.
//
// This is the hot host-side loop of both inference pipelines (the role the
// reference fills with 12 torch DataLoader worker *processes*,
// infer/wsi.py:943-949): slicing patch windows out of slide-scale arrays
// and packing the network batch. Done in C++ with a thread pool it runs at
// memory bandwidth with zero GIL contention and no worker-process plumbing.
//
// Windows may extend outside the source image; out-of-bounds rows/cols are
// zero-filled (pyramidal-reader padding semantics, wsi/reader.py).
//
// Build: cc -O3 -shared -fPIC -o libpatchgather.so patch_gather.cpp -lpthread
// ABI (ctypes):
//   void gather_patches(const uint8_t* src, int64_t src_h, int64_t src_w,
//                       int64_t channels, const int64_t* coords /* n*2: y,x */,
//                       int64_t n, int64_t win_h, int64_t win_w,
//                       uint8_t* out /* n*win_h*win_w*channels */,
//                       int64_t n_threads);

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

static void gather_range(const uint8_t* src, int64_t src_h, int64_t src_w,
                         int64_t c, const int64_t* coords, int64_t win_h,
                         int64_t win_w, uint8_t* out,
                         std::atomic<int64_t>* next, int64_t n) {
  const int64_t src_stride = src_w * c;
  const int64_t out_row = win_w * c;
  const int64_t out_patch = win_h * out_row;
  for (;;) {
    const int64_t i = next->fetch_add(1, std::memory_order_relaxed);
    if (i >= n) break;
    const int64_t y0 = coords[2 * i];
    const int64_t x0 = coords[2 * i + 1];
    uint8_t* dst = out + i * out_patch;

    const int64_t ys = std::max<int64_t>(y0, 0);
    const int64_t ye = std::min<int64_t>(y0 + win_h, src_h);
    const int64_t xs = std::max<int64_t>(x0, 0);
    const int64_t xe = std::min<int64_t>(x0 + win_w, src_w);

    if (ys >= ye || xs >= xe) {
      std::memset(dst, 0, out_patch);
      continue;
    }
    const bool needs_zero = (ys != y0) | (ye != y0 + win_h) |
                            (xs != x0) | (xe != x0 + win_w);
    if (needs_zero) std::memset(dst, 0, out_patch);

    const int64_t row_bytes = (xe - xs) * c;
    const uint8_t* src_row = src + ys * src_stride + xs * c;
    uint8_t* dst_row = dst + (ys - y0) * out_row + (xs - x0) * c;
    for (int64_t y = ys; y < ye; ++y) {
      std::memcpy(dst_row, src_row, row_bytes);
      src_row += src_stride;
      dst_row += out_row;
    }
  }
}

void gather_patches(const uint8_t* src, int64_t src_h, int64_t src_w,
                    int64_t channels, const int64_t* coords, int64_t n,
                    int64_t win_h, int64_t win_w, uint8_t* out,
                    int64_t n_threads) {
  if (n <= 0) return;
  if (n_threads <= 1 || n == 1) {
    std::atomic<int64_t> next(0);
    gather_range(src, src_h, src_w, channels, coords, win_h, win_w, out,
                 &next, n);
    return;
  }
  n_threads = std::min<int64_t>(n_threads, n);
  std::atomic<int64_t> next(0);
  std::vector<std::thread> workers;
  workers.reserve(n_threads);
  for (int64_t t = 0; t < n_threads; ++t) {
    workers.emplace_back(gather_range, src, src_h, src_w, channels, coords,
                         win_h, win_w, out, &next, n);
  }
  for (auto& w : workers) w.join();
}

}  // extern "C"
