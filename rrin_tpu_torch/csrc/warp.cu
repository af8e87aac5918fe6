// Backward bilinear warp kernels (zeros outside, both align_corners variants).
//
// Replace the three Pallas warp kernels of rrin_tpu/ops/warp_pallas.py and
// their pair entry point warp_pair_pallas (:659). One templated kernel,
// instantiated by how the source is rounded:
//   SRC_F32      : the float32 NHWC source, 3 channels            ("warp_f32")
//   SRC_BF16     : each tap rounded to bfloat16 as it is read      ("warp_bf16")
//   SRC_U8       : each tap taken to round(clip(v,0,1)*255) as it
//                  is read                                         ("warp_u8")
// and by the number of frames one launch warps (1, or 2: both warps of the
// cascade).
//
// What bounds them on an H100: bytes. Per pixel and frame a warp reads 3
// source channels and a 2-channel flow and writes 3 channels, some 40 float
// operations for them, far below the card's operations-per-byte line, and
// the four taps of a pixel are a data-dependent gather. The design moves
// the fewest bytes it can:
//   * one launch warps both frames of a pair; where the two flows are the
//     halves of one NHWC-contiguous 4-channel tensor (the cascade's Ft0|Ft1),
//     a thread reads its pixel's four floats with one 16-byte load, so that
//     tensor is read once, not twice at half use of its cache lines;
//   * blocks are 32x8 pixel tiles: a warp's flow loads and stores are one
//     coalesced row, and a block's taps (smooth flow) fall in few lines;
//   * the source is read as it is (float32) and rounded per tap (bf16, or
//     the byte grid) in registers, so no packing pass writes and rereads a
//     copy of it;
//   * the four taps are gathered straight from global memory (no window, so
//     no bound on the flow), and each output is stored once, NHWC or planar.
// Sample position, weights and accumulation use the explicitly rounded
// intrinsics (__fmul_rn, __fadd_rn, __fsub_rn) so the compiler cannot contract
// them into FMAs: the float32 and bf16 variants then round exactly where the
// plain PyTorch version (ops/warp.py: warp_bilinear) rounds. The byte
// variants fold the 1/255 dequantization into the horizontal weights, which
// equals the plain version only to float32 rounding.
//
// Plain C entry points; each returns cudaGetLastError() after its launch,
// runs on the given stream, allocates nothing and does not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

enum { SRC_F32 = 0, SRC_BF16 = 1, SRC_U8 = 2 };

constexpr int BX = 32, BY = 8;  // pixels per block: one warp per row

struct Tap3 {
  float c0, c1, c2;
};

// round(clip(v, 0, 1) * 255), the byte the u8 variant samples.
__device__ __forceinline__ float byte_of(float v) {
  return rintf(__fmul_rn(fminf(fmaxf(v, 0.0f), 1.0f), 255.0f));
}

__device__ __forceinline__ float bf16_of(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <int SRC>
__device__ __forceinline__ Tap3 load_tap(const float* src, size_t pix) {
  Tap3 t;
  const float* p = src + pix * 3;
  t.c0 = __ldg(p);
  t.c1 = __ldg(p + 1);
  t.c2 = __ldg(p + 2);
  if (SRC == SRC_BF16) {
    t.c0 = bf16_of(t.c0);
    t.c1 = bf16_of(t.c1);
    t.c2 = bf16_of(t.c2);
  } else if (SRC == SRC_U8) {
    t.c0 = byte_of(t.c0);
    t.c1 = byte_of(t.c1);
    t.c2 = byte_of(t.c2);
  }
  return t;
}

struct WarpArgs {
  const float* src[2];   // per frame: float32 (B,H,W,3)
  const float* flow[2];  // per frame: (B,H,W,2) with fstride floats per pixel
  float* out[2];         // per frame: (B,H,W,3), or (B,3,H,W) when planar_out
  int fstride[2];
  int flow4;             // flow[1] == flow[0] + 2, stride 4: one 16-byte load
  int H, W;
  float scale_x, scale_y;
  int align_corners, planar_out;
};

// One output pixel (b, y, x) of one frame.
template <int SRC>
__device__ __forceinline__ void warp_pixel(const WarpArgs& a, const float* src, float2 f,
                                           float* out, size_t b, int y, int x) {
  const int H = a.H, W = a.W;
  float sx = __fadd_rn(static_cast<float>(x), f.x);
  float sy = __fadd_rn(static_cast<float>(y), f.y);
  if (!a.align_corners) {
    sx = __fsub_rn(__fmul_rn(sx, a.scale_x), 0.5f);
    sy = __fsub_rn(__fmul_rn(sy, a.scale_y), 0.5f);
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

  if (a.planar_out) {
    const size_t plane = static_cast<size_t>(H) * W;
    const size_t o = b * 3 * plane + static_cast<size_t>(y) * W + x;
    out[o] = o0;
    out[o + plane] = o1;
    out[o + 2 * plane] = o2;
  } else {
    float* p = out + (base + static_cast<size_t>(y) * W + x) * 3;
    p[0] = o0;
    p[1] = o1;
    p[2] = o2;
  }
}

// NF frames (1, or both of a pair) per thread, one output pixel of each:
// the flow vectors first (one 16-byte load where they are the halves of one
// 4-channel tensor), then each frame's gather.
template <int SRC, int NF>
__global__ void __launch_bounds__(BX * BY) warp_kernel(const WarpArgs a) {
  const int x = blockIdx.x * BX + threadIdx.x;
  const int y = blockIdx.y * BY + threadIdx.y;
  if (x >= a.W || y >= a.H) return;
  const size_t b = blockIdx.z;
  const size_t pix = (b * a.H + y) * a.W + x;
  float2 f[NF];
  if (NF == 2 && a.flow4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(a.flow[0]) + pix);
    f[0] = make_float2(v.x, v.y);
    f[NF - 1] = make_float2(v.z, v.w);
  } else {
#pragma unroll
    for (int i = 0; i < NF; ++i)
      f[i] = __ldg(reinterpret_cast<const float2*>(a.flow[i] + pix * a.fstride[i]));
  }
#pragma unroll
  for (int i = 0; i < NF; ++i) warp_pixel<SRC>(a, a.src[i], f[i], a.out[i], b, y, x);
}

template <int SRC>
void launch_src(const WarpArgs& a, int nf, dim3 grid, cudaStream_t s) {
  if (nf == 2)
    warp_kernel<SRC, 2><<<grid, dim3(BX, BY), 0, s>>>(a);
  else
    warp_kernel<SRC, 1><<<grid, dim3(BX, BY), 0, s>>>(a);
}

}  // namespace

extern "C" {

// nf frames (1 or 2) of one shape: src_i float32 (B,H,W,3), flow_i with
// fstride_i floats per pixel (flow4: flow1 is flow0 + 2 floats and both have
// stride 4), out_i.
int rrin_warp_launch(const void* src0, const void* src1, const void* flow0, const void* flow1,
                     void* out0, void* out1, int nf, int B, int H, int W, int fstride0,
                     int fstride1, int flow4, float scale_x, float scale_y, int align_corners,
                     int planar_out, int src_kind, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return 0;
  if ((nf != 1 && nf != 2) || B > 65535 || (H + BY - 1) / BY > 65535 || fstride0 < 2 ||
      (fstride0 & 1) || fstride1 < 2 || (fstride1 & 1) || (flow4 && (nf != 2 || fstride0 != 4)))
    return cudaErrorInvalidValue;
  WarpArgs a = {};
  a.src[0] = static_cast<const float*>(src0);
  a.src[1] = static_cast<const float*>(src1);
  a.flow[0] = static_cast<const float*>(flow0);
  a.flow[1] = static_cast<const float*>(flow1);
  a.out[0] = static_cast<float*>(out0);
  a.out[1] = static_cast<float*>(out1);
  a.fstride[0] = fstride0;
  a.fstride[1] = fstride1;
  a.flow4 = flow4;
  a.H = H;
  a.W = W;
  a.scale_x = scale_x;
  a.scale_y = scale_y;
  a.align_corners = align_corners;
  a.planar_out = planar_out;
  const dim3 grid((W + BX - 1) / BX, (H + BY - 1) / BY, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (src_kind) {
    case SRC_F32: launch_src<SRC_F32>(a, nf, grid, s); break;
    case SRC_BF16: launch_src<SRC_BF16>(a, nf, grid, s); break;
    case SRC_U8: launch_src<SRC_U8>(a, nf, grid, s); break;
    default: return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
