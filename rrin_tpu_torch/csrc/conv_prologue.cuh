// The element arithmetic of the fused-resample halo builders of the Hopper
// core (conv_sm90.cuh): eight channels of one stored pixel at a time,
// widened to float32 (or read as float32), pooled or interpolated with
// every product and sum rounded separately (as the plain PyTorch versions
// compute them, no fused multiply-add), then rounded once to bfloat16,
// taken to the int8 grid (conv_sm90.cuh's codes8), or stored as float32 as
// they are.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

struct F8 {
  float v[8];
};

__device__ __forceinline__ F8 unpack8(const uint4 u) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  F8 f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f.v[2 * i] = __uint_as_float(w[i] << 16);
    f.v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
  return f;
}

__device__ __forceinline__ F8 unpack8_s8(const uint2 u) {
  const uint32_t w[2] = {u.x, u.y};
  F8 f;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    f.v[i] = static_cast<float>(static_cast<int8_t>((w[i >> 2] >> (8 * (i & 3))) & 0xffu));
  return f;
}

__device__ __forceinline__ uint4 pack8(const F8& f) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(f.v[2 * i], f.v[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&p);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// 0.25 * far + 0.75 * near with each product and the sum rounded separately,
// as the plain version computes it (no fused multiply-add).
__device__ __forceinline__ F8 lerp8(const F8& far, const F8& near) {
  F8 r;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    r.v[i] = __fadd_rn(__fmul_rn(0.25f, far.v[i]), __fmul_rn(0.75f, near.v[i]));
  return r;
}

// The 2x2 mean of four pixels' eight channels in avg_pool_2x's order:
// ((p00 + p01) + p10) + p11, then times 1/4, each step rounded.
__device__ __forceinline__ F8 avg4_8(const F8& p00, const F8& p01, const F8& p10,
                                     const F8& p11) {
  F8 r;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    r.v[i] = __fmul_rn(
        __fadd_rn(__fadd_rn(__fadd_rn(p00.v[i], p01.v[i]), p10.v[i]), p11.v[i]), 0.25f);
  return r;
}

// avg4_8's arithmetic on four channels (float32 K7's halo items).
__device__ __forceinline__ float4 avg4_4(const float4& p00, const float4& p01,
                                         const float4& p10, const float4& p11) {
  auto m = [](float a, float b, float c, float d) {
    return __fmul_rn(__fadd_rn(__fadd_rn(__fadd_rn(a, b), c), d), 0.25f);
  };
  return make_float4(m(p00.x, p01.x, p10.x, p11.x), m(p00.y, p01.y, p10.y, p11.y),
                     m(p00.z, p01.z, p10.z, p11.z), m(p00.w, p01.w, p10.w, p11.w));
}

// The far tap of output position p of a 2x half-pixel bilinear upsample of n
// samples, clamped at both ends; the near tap is p / 2.
__device__ __forceinline__ int far_tap(int p, int n) {
  const int h = p >> 1;
  return (p & 1) ? min(h + 1, n - 1) : max(h - 1, 0);
}

__device__ __forceinline__ size_t pix_off(int cs, int Ws, int y, int x, int c) {
  return (static_cast<size_t>(y) * Ws + x) * cs + c;
}

// The bytes of eight channels of one stored pixel: 16 of bf16, or 8 of int8
// codes (in .x and .y) when the operand is int8.
template <bool Q>
__device__ __forceinline__ uint4 load8(const void* xb, int i8, int cs, int Ws, int y, int x,
                                       int c) {
  const size_t off = pix_off(cs, Ws, y, x, c);
  if (Q && i8) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(static_cast<const int8_t*>(xb) + off));
    return make_uint4(u.x, u.y, 0u, 0u);
  }
  return __ldg(reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(xb) + off));
}

// What load8 read, as float32 (times `pre` in int8 mode).
template <bool Q>
__device__ __forceinline__ F8 widen8(const uint4 u, int i8, float pre) {
  F8 f = (Q && i8) ? unpack8_s8(make_uint2(u.x, u.y)) : unpack8(u);
  if (Q) {
#pragma unroll
    for (int i = 0; i < 8; ++i) f.v[i] = __fmul_rn(f.v[i], pre);
  }
  return f;
}

// Eight float32 channels of one stored pixel (two 16-byte loads).
__device__ __forceinline__ F8 load8_f32(const float* xb, int cs, int Ws, int y, int x, int c) {
  const float4* p = reinterpret_cast<const float4*>(xb + pix_off(cs, Ws, y, x, c));
  const float4 lo = __ldg(p), hi = __ldg(p + 1);
  return F8{{lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w}};
}

// Eight float32 values stored as they are (two 16-byte stores).
__device__ __forceinline__ void store8_f32(unsigned char* dst, const F8& f) {
  float4* p = reinterpret_cast<float4*>(dst);
  p[0] = make_float4(f.v[0], f.v[1], f.v[2], f.v[3]);
  p[1] = make_float4(f.v[4], f.v[5], f.v[6], f.v[7]);
}
