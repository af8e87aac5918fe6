// Direct (implicit-GEMM) convolution on NHWC bfloat16 for low-channel sites:
// stride 1, SAME padding, odd k, cout <= 64, + float32 bias + optional
// LeakyReLU, float32 accumulation, one rounding to bfloat16 at the store.
//
// GEMM view: M = output pixels, N = cout, K = k*k*cin. The tensor cores are
// driven with mma.sync.m16n8k16 (bf16 in, f32 accumulate):
//   * a block computes an 8-row x 32-column tile of output pixels for all
//     cout; warp w owns row w as two m-tiles of 16 consecutive pixels and
//     NT n-tiles of 8 output channels (cout zero-padded to NT*8);
//   * the input halo tile (8+k-1) x (32+k-1) x cchunk is staged in shared
//     memory, SAME padding being zero-filled loads, cin zero-padded to the
//     chunk. cin is walked in chunks of at most 64 channels so the tile and
//     the weights fit at every site; each pixel's channels are padded by 8
//     elements, which spreads the eight pixel rows of an A fragment over
//     distinct banks;
//   * the weights arrive pre-arranged in B-fragment order
//     [chunk][dy][dx][k16][n-tile][lane] (one uint2 per lane) and are
//     streamed into shared memory one dy row at a time, so the largest row
//     (5 x 64 x 64) is 41 KB beside its halo tile;
//   * for each (dy, dx, 16 channels) a warp loads two A fragments straight
//     from the halo tile (a pixel shift in x is an address offset, which is
//     what makes the convolution implicit) and runs 2*NT mma instructions.
// Ragged edges are masked at the store; nothing assumes W % 32 or H % 8.
//
// Plain C entry point; returns cudaGetLastError() after the launch, runs on
// the given stream, allocates nothing and does not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int TH = 8;            // output rows per block = warps per block
constexpr int TW = 32;           // output columns per block = 2 m-tiles
constexpr int THREADS = TH * 32;
constexpr int CPAD = 8;          // bf16 elements of padding per halo pixel

template <int NT>
__global__ void __launch_bounds__(THREADS)
conv_phase_kernel(const __nv_bfloat16* __restrict__ x, const uint2* __restrict__ wfrag,
                  const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
                  int H, int W, int cin, int cout, int k, int cchunk, int n_chunks,
                  int has_slope, float slope) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int hpad = (k - 1) / 2;
  const int hw = TW + k - 1;                 // halo tile columns
  const int hh = TH + k - 1;                 // halo tile rows
  const int cstride = cchunk + CPAD;         // elements per halo pixel
  const int kc_count = cchunk / 16;
  const int wrow_elems = k * kc_count * NT * 32;  // uint2 per (chunk, dy)
  __nv_bfloat16* halo = reinterpret_cast<__nv_bfloat16*>(smem);
  uint2* wrow = reinterpret_cast<uint2*>(
      smem + static_cast<size_t>(hh) * hw * cstride * sizeof(__nv_bfloat16));

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;    // fragment row group
  const int tig = lane & 3;   // thread in group
  const int x0 = blockIdx.x * TW;
  const int y0 = blockIdx.y * TH;
  const size_t b = blockIdx.z;
  const __nv_bfloat16* xb = x + b * H * W * cin;

  float acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0f;

  for (int ch = 0; ch < n_chunks; ++ch) {
    const int c_base = ch * cchunk;
    __syncthreads();  // the previous chunk's fragments are all read
    if ((cin & 7) == 0) {
      // 16-byte loads: 8 channels at a time.
      const int v_per_pix = cchunk >> 3;
      const int total = hh * hw * v_per_pix;
      for (int i = tid; i < total; i += THREADS) {
        const int v = i % v_per_pix;
        const int pix = i / v_per_pix;
        const int gy = y0 + pix / hw - hpad;
        const int gx = x0 + pix % hw - hpad;
        const int c = c_base + v * 8;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (gy >= 0 && gy < H && gx >= 0 && gx < W && c < cin)
          val = __ldg(reinterpret_cast<const uint4*>(
              xb + (static_cast<size_t>(gy) * W + gx) * cin + c));
        *reinterpret_cast<uint4*>(halo + pix * cstride + v * 8) = val;
      }
    } else {
      // cin in {6, 9, 10, ...}: element loads, zero-padded to the chunk.
      const int total = hh * hw * cchunk;
      for (int i = tid; i < total; i += THREADS) {
        const int c = i % cchunk;
        const int pix = i / cchunk;
        const int gy = y0 + pix / hw - hpad;
        const int gx = x0 + pix % hw - hpad;
        __nv_bfloat16 val = __float2bfloat16_rn(0.0f);
        if (gy >= 0 && gy < H && gx >= 0 && gx < W && c_base + c < cin)
          val = xb[(static_cast<size_t>(gy) * W + gx) * cin + c_base + c];
        halo[pix * cstride + c] = val;
      }
    }

    for (int dy = 0; dy < k; ++dy) {
      __syncthreads();  // halo tile written; previous weight row consumed
      const uint2* wsrc = wfrag + static_cast<size_t>(ch * k + dy) * wrow_elems;
      for (int i = tid; i < wrow_elems; i += THREADS) wrow[i] = __ldg(wsrc + i);
      __syncthreads();

      const __nv_bfloat16* arow = halo + (warp + dy) * hw * cstride;
      for (int dx = 0; dx < k; ++dx) {
        for (int kc = 0; kc < kc_count; ++kc) {
          uint32_t a[2][4];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            const __nv_bfloat16* p =
                arow + (mt * 16 + g + dx) * cstride + kc * 16 + 2 * tig;
            a[mt][0] = *reinterpret_cast<const uint32_t*>(p);
            a[mt][1] = *reinterpret_cast<const uint32_t*>(p + 8 * cstride);
            a[mt][2] = *reinterpret_cast<const uint32_t*>(p + 8);
            a[mt][3] = *reinterpret_cast<const uint32_t*>(p + 8 * cstride + 8);
          }
          const uint2* bp = wrow + (dx * kc_count + kc) * NT * 32 + lane;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const uint2 bfrag = bp[nt * 32];
            mma_m16n8k16_bf16(acc[0][nt], a[0], bfrag);
            mma_m16n8k16_bf16(acc[1][nt], a[1], bfrag);
          }
        }
      }
    }
  }

  // Epilogue: bias, LeakyReLU, one rounding to bf16, masked stores.
  const int oy = y0 + warp;
  if (oy >= H) return;
  const bool pair_store = (cout & 1) == 0;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int ox = x0 + mt * 16 + g + half * 8;
      if (ox >= W) continue;
      __nv_bfloat16* op = out + ((b * H + oy) * W + ox) * cout;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int co = nt * 8 + 2 * tig;
        if (co >= cout) continue;
        float v0 = acc[mt][nt][half * 2] + __ldg(bias + co);
        float v1 = acc[mt][nt][half * 2 + 1];
        const bool has1 = co + 1 < cout;
        if (has1) v1 += __ldg(bias + co + 1);
        if (has_slope) {
          v0 = v0 >= 0.0f ? v0 : slope * v0;
          v1 = v1 >= 0.0f ? v1 : slope * v1;
        }
        if (pair_store) {
          *reinterpret_cast<__nv_bfloat162*>(op + co) = __floats2bfloat162_rn(v0, v1);
        } else {
          op[co] = __float2bfloat16_rn(v0);
          if (has1) op[co + 1] = __float2bfloat16_rn(v1);
        }
      }
    }
  }
}

template <int NT>
int launch_nt(const void* x, const void* wfrag, const void* bias, void* out, int B,
              int H, int W, int cin, int cout, int k, int cchunk, int n_chunks,
              int has_slope, float slope, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(conv_phase_kernel<NT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  conv_phase_kernel<NT><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint2*>(wfrag),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out), H, W, cin,
      cout, k, cchunk, n_chunks, has_slope, slope);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared memory one block needs, in bytes (also used by the Python planner).
long long rrin_conv_phase_smem(int k, int cchunk, int n_tiles) {
  const long long halo = static_cast<long long>(TH + k - 1) * (TW + k - 1) *
                         (cchunk + CPAD) * 2;
  const long long wrow = static_cast<long long>(k) * (cchunk / 16) * n_tiles * 32 * 8;
  return halo + wrow;
}

// x: (B,H,W,cin) bf16 NHWC; wfrag: weights in fragment order (see the file
// head) for n_chunks chunks of cchunk channels and n_tiles tiles of 8 output
// channels; bias: cout float32; out: (B,H,W,cout) bf16.
int rrin_conv_phase_launch(const void* x, const void* wfrag, const void* bias,
                           void* out, int B, int H, int W, int cin, int cout, int k,
                           int cchunk, int n_chunks, int n_tiles, int has_slope,
                           float slope, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return 0;
  if (k < 1 || (k & 1) == 0 || cchunk < 16 || (cchunk & 15) || n_chunks < 1 ||
      n_chunks * cchunk < cin || cout < 1 || cout > n_tiles * 8 || B > 65535 ||
      (H + TH - 1) / TH > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(rrin_conv_phase_smem(k, cchunk, n_tiles));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RRIN_LAUNCH(NT)                                                            \
  return launch_nt<NT>(x, wfrag, bias, out, B, H, W, cin, cout, k, cchunk, n_chunks, \
                       has_slope, slope, smem, s)
  switch (n_tiles) {
    case 1: RRIN_LAUNCH(1);
    case 2: RRIN_LAUNCH(2);
    case 4: RRIN_LAUNCH(4);
    case 8: RRIN_LAUNCH(8);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RRIN_LAUNCH
}

}  // extern "C"
