// Host-side frame packing for the video pipeline hot loop.
//
// The reference's host path leans on OpenCV/ATen native kernels
// (SURVEY.md §2.2); this library is the rrin-tpu equivalent for the
// per-frame work that sits between the decoder and the device: BGR<->RGB
// channel swaps and batch packing. g++ -O3 auto-vectorizes the swap loop;
// large frames are split across a few threads (1080p is ~6 MB per frame
// and the decode thread must keep up with the TPU).
//
// Exposed via ctypes (rrin_tpu/native/__init__.py); a numpy fallback keeps
// the pipeline functional when the toolchain is unavailable.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

void swap_rb_range(const uint8_t* src, uint8_t* dst, int64_t begin,
                   int64_t end) {
  for (int64_t i = begin; i < end; ++i) {
    const uint8_t b = src[3 * i + 0];
    const uint8_t g = src[3 * i + 1];
    const uint8_t r = src[3 * i + 2];
    dst[3 * i + 0] = r;
    dst[3 * i + 1] = g;
    dst[3 * i + 2] = b;
  }
}

constexpr int64_t kParallelThreshold = 1 << 20;  // pixels

}  // namespace

extern "C" {

// Swap the R/B channels of an interleaved 3-channel uint8 image.
// src and dst may alias (in-place swap works element-wise here).
void rrin_swap_rb_u8(const uint8_t* src, uint8_t* dst, int64_t npx,
                     int32_t max_threads) {
  if (npx < kParallelThreshold || max_threads <= 1) {
    swap_rb_range(src, dst, 0, npx);
    return;
  }
  const int n = max_threads > 8 ? 8 : max_threads;
  std::vector<std::thread> workers;
  workers.reserve(n);
  const int64_t chunk = (npx + n - 1) / n;
  for (int t = 0; t < n; ++t) {
    const int64_t b = t * chunk;
    const int64_t e = b + chunk < npx ? b + chunk : npx;
    if (b >= e) break;
    workers.emplace_back(swap_rb_range, src, dst, b, e);
  }
  for (auto& w : workers) w.join();
}

// Pack a (prev, cur) uint8 HWC frame pair into one slot of a
// (B, 2, H, W, 3) batch buffer, swapping BGR->RGB on the way.
void rrin_pack_pair_bgr(const uint8_t* prev_bgr, const uint8_t* cur_bgr,
                        uint8_t* batch, int64_t slot, int64_t frame_bytes,
                        int32_t max_threads) {
  const int64_t npx = frame_bytes / 3;
  uint8_t* dst = batch + slot * 2 * frame_bytes;
  rrin_swap_rb_u8(prev_bgr, dst, npx, max_threads);
  rrin_swap_rb_u8(cur_bgr, dst + frame_bytes, npx, max_threads);
}

}  // extern "C"
