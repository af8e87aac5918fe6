// Backward bilinear warp kernels (zeros outside, both align_corners variants).
//
// One templated kernel, three instantiations by source format:
//   SRC_F32  : float32 NHWC source, 3 channels                  ("warp_f32")
//   SRC_BF16 : source rounded to bfloat16, 4 x bf16 per pixel     ("warp_bf16")
//   SRC_U8   : round(clip(img)*255) as one word c0|c1<<8|c2<<16   ("warp_u8")
// plus the two small passes that produce the bf16 and byte-packed sources.
//
// One thread per output pixel: it reads its flow vector, computes the sample
// position, gathers the four taps straight from global memory (no window, so
// no bound on the flow) and writes three float32 channels, NHWC or planar.
// Sample position, weights and accumulation use the explicitly rounded
// intrinsics (__fmul_rn, __fadd_rn, __fsub_rn) so the compiler cannot contract
// them into FMAs: the float32 and bf16 variants then round exactly where the
// plain PyTorch version (ops/warp.py: warp_bilinear) rounds. The byte-packed
// variant folds the 1/255 dequantization into the horizontal weights, which
// equals the plain version only to float32 rounding.
//
// Plain C entry points; each returns cudaGetLastError() after its launch,
// runs on the given stream, allocates nothing and does not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum { SRC_F32 = 0, SRC_BF16 = 1, SRC_U8 = 2 };

struct Tap3 {
  float c0, c1, c2;
};

template <int SRC>
__device__ __forceinline__ Tap3 load_tap(const void* src, size_t pix) {
  Tap3 t;
  if (SRC == SRC_F32) {
    const float* p = reinterpret_cast<const float*>(src) + pix * 3;
    t.c0 = __ldg(p);
    t.c1 = __ldg(p + 1);
    t.c2 = __ldg(p + 2);
  } else if (SRC == SRC_BF16) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(src) + pix);
    // bf16 -> f32 is a 16-bit shift: c0 low half of x, c1 high half, c2 low of y.
    t.c0 = __uint_as_float(v.x << 16);
    t.c1 = __uint_as_float(v.x & 0xFFFF0000u);
    t.c2 = __uint_as_float(v.y << 16);
  } else {
    const uint32_t v = __ldg(reinterpret_cast<const uint32_t*>(src) + pix);
    t.c0 = static_cast<float>(v & 255u);
    t.c1 = static_cast<float>((v >> 8) & 255u);
    t.c2 = static_cast<float>((v >> 16) & 255u);
  }
  return t;
}

template <int SRC>
__global__ void __launch_bounds__(256)
warp_kernel(const void* __restrict__ src, const float* __restrict__ flow,
            float* __restrict__ out, int B, int H, int W, int flow_stride,
            float scale_x, float scale_y, int align_corners, int planar_out) {
  const size_t n = static_cast<size_t>(B) * H * W;
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int x = static_cast<int>(idx % W);
  const size_t row = idx / W;
  const int y = static_cast<int>(row % H);
  const size_t b = row / H;

  // flow_stride floats per pixel (2 for a dense field, 4 for a channel slice
  // of two concatenated fields); the wrapper guarantees 8-byte alignment.
  const float2 f = __ldg(reinterpret_cast<const float2*>(flow + idx * flow_stride));
  float sx = __fadd_rn(static_cast<float>(x), f.x);
  float sy = __fadd_rn(static_cast<float>(y), f.y);
  if (!align_corners) {
    sx = __fsub_rn(__fmul_rn(sx, scale_x), 0.5f);
    sy = __fsub_rn(__fmul_rn(sy, scale_y), 0.5f);
  }
  const float x0f = floorf(sx);
  const float y0f = floorf(sy);
  const float wx = __fsub_rn(sx, x0f);
  const float wy = __fsub_rn(sy, y0f);
  // Clamp before the integer cast: positions this far out have no valid tap.
  const int x0 = static_cast<int>(fminf(fmaxf(x0f, -2.0f), static_cast<float>(W)));
  const int y0 = static_cast<int>(fminf(fmaxf(y0f, -2.0f), static_cast<float>(H)));
  const int x1 = x0 + 1;
  const int y1 = y0 + 1;
  const float vx0 = (x0 >= 0 && x0 < W) ? 1.0f : 0.0f;
  const float vx1 = (x1 >= 0 && x1 < W) ? 1.0f : 0.0f;
  const float vy0 = (y0 >= 0 && y0 < H) ? 1.0f : 0.0f;
  const float vy1 = (y1 >= 0 && y1 < H) ? 1.0f : 0.0f;
  const int xc0 = min(max(x0, 0), W - 1);
  const int xc1 = min(max(x1, 0), W - 1);
  const int yc0 = min(max(y0, 0), H - 1);
  const int yc1 = min(max(y1, 0), H - 1);

  const size_t base = b * H * W;
  const Tap3 t00 = load_tap<SRC>(src, base + static_cast<size_t>(yc0) * W + xc0);
  const Tap3 t01 = load_tap<SRC>(src, base + static_cast<size_t>(yc0) * W + xc1);
  const Tap3 t10 = load_tap<SRC>(src, base + static_cast<size_t>(yc1) * W + xc0);
  const Tap3 t11 = load_tap<SRC>(src, base + static_cast<size_t>(yc1) * W + xc1);

  const float ax = __fsub_rn(1.0f, wx);
  const float ay = __fsub_rn(1.0f, wy);
  float o0, o1, o2;
  if (SRC == SRC_U8) {
    // 1/255 folded into the horizontal weights; rows share them.
    const float inv255 = 1.0f / 255.0f;
    const float cw0 = ax * inv255 * vx0;
    const float cw1 = wx * inv255 * vx1;
    const float r0 = ay * vy0;
    const float r1 = wy * vy1;
    o0 = r0 * (cw0 * t00.c0 + cw1 * t01.c0) + r1 * (cw0 * t10.c0 + cw1 * t11.c0);
    o1 = r0 * (cw0 * t00.c1 + cw1 * t01.c1) + r1 * (cw0 * t10.c1 + cw1 * t11.c1);
    o2 = r0 * (cw0 * t00.c2 + cw1 * t01.c2) + r1 * (cw0 * t10.c2 + cw1 * t11.c2);
  } else {
    // Same products and the same order of additions as warp_bilinear.
    const float w00 = __fmul_rn(__fmul_rn(ay, ax), vy0 * vx0);
    const float w01 = __fmul_rn(__fmul_rn(ay, wx), vy0 * vx1);
    const float w10 = __fmul_rn(__fmul_rn(wy, ax), vy1 * vx0);
    const float w11 = __fmul_rn(__fmul_rn(wy, wx), vy1 * vx1);
#define RRIN_ACC(c)                                                         \
  __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(t00.c, w00), __fmul_rn(t01.c, w01)), \
                      __fmul_rn(t10.c, w10)),                               \
            __fmul_rn(t11.c, w11))
    o0 = RRIN_ACC(c0);
    o1 = RRIN_ACC(c1);
    o2 = RRIN_ACC(c2);
#undef RRIN_ACC
  }

  if (planar_out) {
    const size_t plane = static_cast<size_t>(H) * W;
    const size_t o = b * 3 * plane + static_cast<size_t>(y) * W + x;
    out[o] = o0;
    out[o + plane] = o1;
    out[o + 2 * plane] = o2;
  } else {
    float* p = out + idx * 3;
    p[0] = o0;
    p[1] = o1;
    p[2] = o2;
  }
}

// (B,H,W,3) float32 -> one word per pixel: round(clip(c,0,1)*255) bytes.
__global__ void __launch_bounds__(256)
pack_u8_kernel(const float* __restrict__ img, uint32_t* __restrict__ out, size_t n) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const float* p = img + idx * 3;
  uint32_t v = 0;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float q = rintf(__fmul_rn(fminf(fmaxf(p[c], 0.0f), 1.0f), 255.0f));
    v |= static_cast<uint32_t>(q) << (8 * c);
  }
  out[idx] = v;
}

// (B,H,W,3) float32 -> (c0,c1,c2,0) bfloat16 per pixel (round to nearest even).
__global__ void __launch_bounds__(256)
pack_bf16_kernel(const float* __restrict__ img, uint2* __restrict__ out, size_t n) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const float* p = img + idx * 3;
  const uint32_t c0 = __bfloat16_as_ushort(__float2bfloat16_rn(p[0]));
  const uint32_t c1 = __bfloat16_as_ushort(__float2bfloat16_rn(p[1]));
  const uint32_t c2 = __bfloat16_as_ushort(__float2bfloat16_rn(p[2]));
  out[idx] = make_uint2(c0 | (c1 << 16), c2);
}

inline unsigned blocks_for(size_t n) {
  return static_cast<unsigned>((n + 255) / 256);
}

}  // namespace

extern "C" {

// src_kind: 0 float32 NHWC, 1 packed bf16 (uint2 per pixel), 2 packed bytes.
int rrin_warp_launch(const void* src, const void* flow, void* out, int B, int H,
                     int W, int flow_stride, float scale_x, float scale_y,
                     int align_corners, int planar_out, int src_kind, void* stream) {
  const size_t n = static_cast<size_t>(B) * H * W;
  if (n == 0) return 0;
  if (n > (static_cast<size_t>(1) << 31) * 255 || flow_stride < 2 || (flow_stride & 1))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fl = static_cast<const float*>(flow);
  float* o = static_cast<float*>(out);
  const unsigned g = blocks_for(n);
  switch (src_kind) {
    case SRC_F32:
      warp_kernel<SRC_F32><<<g, 256, 0, s>>>(src, fl, o, B, H, W, flow_stride, scale_x,
                                             scale_y, align_corners, planar_out);
      break;
    case SRC_BF16:
      warp_kernel<SRC_BF16><<<g, 256, 0, s>>>(src, fl, o, B, H, W, flow_stride, scale_x,
                                              scale_y, align_corners, planar_out);
      break;
    case SRC_U8:
      warp_kernel<SRC_U8><<<g, 256, 0, s>>>(src, fl, o, B, H, W, flow_stride, scale_x,
                                            scale_y, align_corners, planar_out);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

int rrin_pack_u8_launch(const void* img, void* out, long long n_pixels, void* stream) {
  if (n_pixels <= 0) return 0;
  const size_t n = static_cast<size_t>(n_pixels);
  pack_u8_kernel<<<blocks_for(n), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<uint32_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

int rrin_pack_bf16_launch(const void* img, void* out, long long n_pixels, void* stream) {
  if (n_pixels <= 0) return 0;
  const size_t n = static_cast<size_t>(n_pixels);
  pack_bf16_kernel<<<blocks_for(n), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<uint2*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
