// The convolutions of the packed serving path on NHWC tensors: one
// implicit-GEMM core with five load prologues, one C entry point each, in
// bfloat16 or int8.
//
//   conv_packed       stride-1 SAME conv over the channel concat of 1..4
//                     operands given separately (the concat never exists in
//                     device memory: the K-loop walks the operands);
//   conv_pool_packed  conv(avg_pool_2x(x)): the block reads the 2x footprint
//                     of its halo tile from the full-resolution tensor and
//                     pools while loading;
//   conv_up_m_packed  conv(upsample_2x_bilinear(x)): the block builds the
//                     upsampled halo tile (rows and columns) from the
//                     half-resolution tensor while loading;
//   conv_up_packed    the same function (mode UPD), interpolating along W
//                     first and then H, and in int8 dequantising an int8
//                     input before it interpolates, as the reference's plain
//                     version of that kernel does (conv_up_m_packed
//                     interpolates H first, and the int8 codes themselves);
//   conv_up_f_packed  the same function for k = 3 with the W-upsample folded
//                     into per-output-parity weights on the host: the block
//                     builds only the H-interpolated rows, at half width,
//                     and the GEMM emits two output columns per pixel.
//
// bfloat16 (Q = false): bf16 operands, mma.sync.m16n8k16 with float32
// accumulation; the epilogue adds a float32 bias and an optional LeakyReLU
// and rounds once to bfloat16. Values built in a prologue are computed in
// float32 and rounded once to bfloat16 (round to nearest even) as they enter
// shared memory.
//
// int8 (Q = true): every operand is bf16 or already int8 on its grid. The
// prologue builds the float32 value as above (dequantising an int8 input in
// mode UPD, pre-scaling a bf16 input by 127/ax in mode UPF) and stores
// clip(rint(v * 127/ax), +-127) as int8 (round half to even, the reference's
// jnp.round); an int8 input is copied as it is in mode DIRECT and its
// constructed values re-rounded to the grid elsewhere. The weights are int8
// per output channel, pre-scaled per operand on the host, so one int32 sum
// serves all operands; mma.sync.m16n8k32 (s8 x s8 -> s32); the epilogue
// computes sum * scale[co] + bias[co], LeakyReLU, and stores bf16, or int8
// via rint and a clip when the next layer carries int8 (the 127/ax_out step
// is folded into scale and bias on the host). ax reaches the kernel as a
// device pointer per operand: nothing is read back to the host.
//
// GEMM view: M = pixels, N = channels per pixel of the output, K = taps x
// input channels (KK = 16 bf16 or 32 int8 per mma):
//   * a block computes 8 rows x 32 columns of pixels for one block of NT*8
//     <= 64 output channels (blockIdx.z walks batch x channel blocks); warp
//     w owns row w as two m-tiles of 16 consecutive pixels;
//   * input channels are walked operand by operand in chunks of at most 64
//     (bf16) or 128 (int8); for each chunk the halo tile
//     (8+ky-1) x (32+kx-1) x chunk is staged in shared memory (zero outside
//     the image: SAME padding at the resolution the conv runs at), each
//     pixel padded by 16 bytes so the eight pixel rows of an A fragment fall
//     on distinct banks. An A fragment's four registers lie at the same byte
//     offsets in both element types;
//   * the weights arrive in B-fragment order
//     [channel block][chunk][dy][tap][k-step][n-tile][lane] (one uint2 a
//     lane) and are streamed into shared memory one dy row at a time.
// Redundant halo loads across channel blocks and neighbouring tiles are
// served by the L2 cache. Ragged edges are masked at the store; nothing
// assumes W % 32 or H % 8.
//
// The folded variant: along W, conv3(upsample(s)) at output column 2j + r is
// a 3-tap stencil on half-resolution columns j-1, j, j+1 with weights that
// depend on the parity r, so the GEMM runs on (row, j) pixels with N =
// (r, cout) and the output tensor (B, 2Hs, Ws, 2*cout) is the NHWC result
// (B, 2Hs, 2Ws, cout) byte for byte. The stencil assumes s[-1] = s[Ws] = 0
// where the upsample clamps; the exact difference is a product of the edge
// pixel's values with two more weight taps (3: left, 4: right), which the
// warps holding column 0 or Ws-1 add with a row-masked A fragment.
//
// Plain C entry points; each returns cudaGetLastError() after the launch,
// runs on the given stream, allocates nothing and does not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_bf16.cuh"

namespace {

constexpr int TH = 8;            // pixel rows per block = warps per block
constexpr int TW = 32;           // pixel columns per block = 2 m-tiles
constexpr int THREADS = TH * 32;
constexpr int PAD_BYTES = 16;    // padding per halo pixel
constexpr int MAX_OPS = 4;       // operands of one conv_packed call

enum Mode { DIRECT = 0, POOL = 1, UP = 2, UPF = 3, UPD = 4 };

struct ConvArgs {
  const void* x[MAX_OPS];
  int c[MAX_OPS];      // channels of each operand that enter the conv
  int cs[MAX_OPS];     // its pixel stride in elements (>= c)
  int in_i8[MAX_OPS];  // int8 mode: the operand is int8 on its grid already
  const float* ax[MAX_OPS];  // int8 mode: its calibrated |x| maximum
  int n_ops;
  const uint2* wfrag;
  const float* bias;
  const float* scale;  // int8 mode: per output channel
  void* out;
  int out_i8;
  int H, W;          // rows and columns of the GEMM's pixels
  int Hs, Ws;        // rows and columns of the stored operands
  int cout;          // channels per GEMM pixel of the output
  int ky, kx;        // taps that slide in y and in x
  int ntaps;         // weight taps per dy row (kx, + 2 edge taps when folded)
  int cchunk, total_chunks, n_cb;
  int has_slope;
  float slope;
};

// s8 x s8 -> s32 tensor-core product. Fragments, g = lane / 4, tig = lane % 4:
//   A (16 x 32): a0 = A[g][4*tig .. +3]       a1 = A[g + 8][4*tig .. +3]
//                a2 = A[g][4*tig + 16 .. +3]  a3 = A[g + 8][4*tig + 16 .. +3]
//   B (32 x 8):  b.x = B[4*tig .. +3][g]      b.y = B[4*tig + 16 .. +3][g]
//   C (16 x 8):  as mma_m16n8k16_bf16's, int32.
__device__ __forceinline__ void mma_m16n8k32_s8(int (&c)[4], const uint32_t (&a)[4],
                                                const uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

__device__ __forceinline__ void mma_tile(float (&c)[4], const uint32_t (&a)[4],
                                         const uint2 b) {
  mma_m16n8k16_bf16(c, a, b);
}

__device__ __forceinline__ void mma_tile(int (&c)[4], const uint32_t (&a)[4],
                                         const uint2 b) {
  mma_m16n8k32_s8(c, a, b);
}

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

__device__ __forceinline__ int quant1(float v, float post) {
  return min(max(__float2int_rn(__fmul_rn(v, post)), -127), 127);
}

// clip(rint(v * post), +-127) of eight values, packed as eight int8.
__device__ __forceinline__ uint2 quant8(const F8& f, float post) {
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int i = 0; i < 8; ++i)
    w[i >> 2] |= (static_cast<uint32_t>(quant1(f.v[i], post)) & 0xffu) << (8 * (i & 3));
  return make_uint2(w[0], w[1]);
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

// The far tap of output position p of a 2x half-pixel bilinear upsample of n
// samples, clamped at both ends; the near tap is p / 2.
__device__ __forceinline__ int far_tap(int p, int n) {
  const int h = p >> 1;
  return (p & 1) ? min(h + 1, n - 1) : max(h - 1, 0);
}

__device__ __forceinline__ size_t pix_off(int cs, int Ws, int y, int x, int c) {
  return (static_cast<size_t>(y) * Ws + x) * cs + c;
}

// Eight channels of one stored pixel as float32 (times `pre` in int8 mode).
template <bool Q>
__device__ __forceinline__ F8 tap8(const void* xb, int i8, int cs, int Ws, int y, int x,
                                   int c, float pre) {
  const size_t off = pix_off(cs, Ws, y, x, c);
  F8 f = (Q && i8) ? unpack8_s8(__ldg(reinterpret_cast<const uint2*>(
                         static_cast<const int8_t*>(xb) + off)))
                   : unpack8(__ldg(reinterpret_cast<const uint4*>(
                         static_cast<const __nv_bfloat16*>(xb) + off)));
  if (Q) {
#pragma unroll
    for (int i = 0; i < 8; ++i) f.v[i] = __fmul_rn(f.v[i], pre);
  }
  return f;
}

// Eight channels of the pixel (gy, gx) that the GEMM reads, inside the image,
// as float32: pooled, upsampled in H, or upsampled in both axes.
template <int MODE, bool Q>
__device__ __forceinline__ F8 construct8(const void* xb, int i8, int cs, int Hs, int Ws,
                                         int gy, int gx, int c, float pre) {
  if (MODE == DIRECT) return tap8<Q>(xb, i8, cs, Ws, gy, gx, c, pre);
  if (MODE == POOL) {
    const F8 p00 = tap8<Q>(xb, i8, cs, Ws, 2 * gy, 2 * gx, c, pre);
    const F8 p01 = tap8<Q>(xb, i8, cs, Ws, 2 * gy, 2 * gx + 1, c, pre);
    const F8 p10 = tap8<Q>(xb, i8, cs, Ws, 2 * gy + 1, 2 * gx, c, pre);
    const F8 p11 = tap8<Q>(xb, i8, cs, Ws, 2 * gy + 1, 2 * gx + 1, c, pre);
    F8 r;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      r.v[i] = __fmul_rn(
          __fadd_rn(__fadd_rn(__fadd_rn(p00.v[i], p01.v[i]), p10.v[i]), p11.v[i]), 0.25f);
    return r;
  }
  const int yn = gy >> 1, yf = far_tap(gy, Hs);
  if (MODE == UPF) {
    return lerp8(tap8<Q>(xb, i8, cs, Ws, yf, gx, c, pre),
                 tap8<Q>(xb, i8, cs, Ws, yn, gx, c, pre));
  }
  const int xn = gx >> 1, xf = far_tap(gx, Ws);
  if (MODE == UPD) {  // W first, then H: the order of the reference's K6
    const F8 wf = lerp8(tap8<Q>(xb, i8, cs, Ws, yf, xf, c, pre),
                        tap8<Q>(xb, i8, cs, Ws, yf, xn, c, pre));
    const F8 wn = lerp8(tap8<Q>(xb, i8, cs, Ws, yn, xf, c, pre),
                        tap8<Q>(xb, i8, cs, Ws, yn, xn, c, pre));
    return lerp8(wf, wn);
  }
  const F8 hn = lerp8(tap8<Q>(xb, i8, cs, Ws, yf, xn, c, pre),
                      tap8<Q>(xb, i8, cs, Ws, yn, xn, c, pre));
  const F8 hf = lerp8(tap8<Q>(xb, i8, cs, Ws, yf, xf, c, pre),
                      tap8<Q>(xb, i8, cs, Ws, yn, xf, c, pre));
  return lerp8(hf, hn);
}

// At most 128 registers a thread, so that two blocks fit a multiprocessor and
// one block's tensor-core work covers the other's loads and barriers; with
// one block resident the kernel runs markedly slower on an H100.
template <int NT, int MODE, bool Q>
__global__ void __launch_bounds__(THREADS, 2) conv_packed_kernel(const ConvArgs a) {
  using Acc = typename std::conditional<Q, int, float>::type;
  constexpr int ES = Q ? 1 : 2;    // bytes per staged element
  constexpr int KK = Q ? 32 : 16;  // channels per mma step
  extern __shared__ __align__(16) unsigned char smem[];
  const int hpy = (a.ky - 1) / 2;
  const int hpx = (a.kx - 1) / 2;
  const int hw = TW + a.kx - 1;              // halo tile columns
  const int hh = TH + a.ky - 1;              // halo tile rows
  const int cchunk = a.cchunk;
  const int pstride = cchunk * ES + PAD_BYTES;  // bytes per halo pixel
  const int kc_count = cchunk / KK;
  const int tap_elems = kc_count * NT * 32;  // uint2 per (chunk, dy, tap)
  const int wrow_elems = a.ntaps * tap_elems;
  unsigned char* halo = smem;
  uint2* wrow = reinterpret_cast<uint2*>(smem + static_cast<size_t>(hh) * hw * pstride);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;    // fragment row group
  const int tig = lane & 3;   // thread in group
  const int x0 = blockIdx.x * TW;
  const int y0 = blockIdx.y * TH;
  const int cb = blockIdx.z % a.n_cb;
  const size_t b = blockIdx.z / a.n_cb;

  Acc acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0;

  int gch = 0;  // chunk index over all operands
  for (int op = 0; op < a.n_ops; ++op) {
    const int cin = a.c[op];
    const int cs = a.cs[op];
    const int i8 = Q ? a.in_i8[op] : 0;
    const void* xb = static_cast<const unsigned char*>(a.x[op]) +
                     b * a.Hs * a.Ws * cs * (i8 ? 1 : 2);
    // int8 mode: bf16 values are taken to the grid by 127/ax after the
    // prologue (before it when folded, as the reference's plain version
    // does); mode UPD dequantises an int8 input first.
    float pre = 1.0f, post = 1.0f;
    if (Q) {
      const float axc = fmaxf(__ldg(a.ax[op]), 1e-12f);
      const float inv = __fdiv_rn(127.0f, axc);
      if (!i8) {
        if (MODE == UPF) pre = inv; else post = inv;
      } else if (MODE == UPD) {
        pre = __fdiv_rn(axc, 127.0f);
        post = inv;
      }
    }
    const int n_chunks = (cin + cchunk - 1) / cchunk;
    for (int ch = 0; ch < n_chunks; ++ch, ++gch) {
      const int c_base = ch * cchunk;
      __syncthreads();  // the previous chunk's fragments are all read
      if (MODE != DIRECT || ((cin & 7) == 0 && (cs & 7) == 0)) {
        // 8 channels at a time (16 bytes of bf16, 8 of int8).
        const int v_per_pix = cchunk >> 3;
        const int total = hh * hw * v_per_pix;
        for (int i = tid; i < total; i += THREADS) {
          const int v = i % v_per_pix;
          const int pix = i / v_per_pix;
          const int gy = y0 + pix / hw - hpy;
          const int gx = x0 + pix % hw - hpx;
          const int c = c_base + v * 8;
          const bool inside = gy >= 0 && gy < a.H && gx >= 0 && gx < a.W && c < cin;
          unsigned char* dst = halo + pix * pstride + v * 8 * ES;
          if (Q) {
            uint2 val = make_uint2(0u, 0u);
            if (inside) {
              if (MODE == DIRECT && i8)
                val = __ldg(reinterpret_cast<const uint2*>(
                    static_cast<const int8_t*>(xb) + pix_off(cs, a.Ws, gy, gx, c)));
              else
                val = quant8(construct8<MODE, Q>(xb, i8, cs, a.Hs, a.Ws, gy, gx, c, pre),
                             post);
            }
            *reinterpret_cast<uint2*>(dst) = val;
          } else {
            uint4 val = make_uint4(0u, 0u, 0u, 0u);
            if (inside) {
              if (MODE == DIRECT)
                val = __ldg(reinterpret_cast<const uint4*>(
                    static_cast<const __nv_bfloat16*>(xb) + pix_off(cs, a.Ws, gy, gx, c)));
              else
                val = pack8(construct8<MODE, Q>(xb, i8, cs, a.Hs, a.Ws, gy, gx, c, pre));
            }
            *reinterpret_cast<uint4*>(dst) = val;
          }
        }
      } else {
        // cin in {6, 9, 10, ...}: element loads, zero-padded to the chunk.
        const int total = hh * hw * cchunk;
        for (int i = tid; i < total; i += THREADS) {
          const int c = i % cchunk;
          const int pix = i / cchunk;
          const int gy = y0 + pix / hw - hpy;
          const int gx = x0 + pix % hw - hpx;
          const bool inside =
              gy >= 0 && gy < a.H && gx >= 0 && gx < a.W && c_base + c < cin;
          unsigned char* dst = halo + pix * pstride;
          if (Q) {
            int8_t val = 0;
            if (inside) {
              const size_t off = pix_off(cs, a.Ws, gy, gx, c_base + c);
              val = i8 ? static_cast<const int8_t*>(xb)[off]
                       : static_cast<int8_t>(quant1(
                             __bfloat162float(static_cast<const __nv_bfloat16*>(xb)[off]),
                             post));
            }
            reinterpret_cast<int8_t*>(dst)[c] = val;
          } else {
            __nv_bfloat16 val = __float2bfloat16_rn(0.0f);
            if (inside)
              val = static_cast<const __nv_bfloat16*>(xb)[pix_off(cs, a.Ws, gy, gx,
                                                                   c_base + c)];
            reinterpret_cast<__nv_bfloat16*>(dst)[c] = val;
          }
        }
      }

      for (int dy = 0; dy < a.ky; ++dy) {
        __syncthreads();  // halo tile written; previous weight row consumed
        const uint2* wsrc =
            a.wfrag +
            (static_cast<size_t>(cb * a.total_chunks + gch) * a.ky + dy) * wrow_elems;
        for (int i = tid; i < wrow_elems; i += THREADS) wrow[i] = __ldg(wsrc + i);
        __syncthreads();

        const unsigned char* arow = halo + (warp + dy) * hw * pstride;
        for (int dx = 0; dx < a.kx; ++dx) {
          for (int kc = 0; kc < kc_count; ++kc) {
            // The A registers lie at the same byte offsets for both element
            // types: KK elements are 32 bytes, a register 4.
            uint32_t af[2][4];
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              const unsigned char* p = arow + (mt * 16 + g + dx) * pstride + kc * 32 + tig * 4;
              af[mt][0] = *reinterpret_cast<const uint32_t*>(p);
              af[mt][1] = *reinterpret_cast<const uint32_t*>(p + 8 * pstride);
              af[mt][2] = *reinterpret_cast<const uint32_t*>(p + 16);
              af[mt][3] = *reinterpret_cast<const uint32_t*>(p + 8 * pstride + 16);
            }
            const uint2* bp = wrow + dx * tap_elems + kc * NT * 32 + lane;
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              const uint2 bfrag = bp[nt * 32];
              mma_tile(acc[0][nt], af[0], bfrag);
              mma_tile(acc[1][nt], af[1], bfrag);
            }
            if (MODE == UPF && dx == 1) {
              // The centre tap's fragment holds s[row][j] itself: keep only
              // the edge pixel's row and multiply by the edge taps. The
              // conditions are uniform over the warp.
#pragma unroll
              for (int mt = 0; mt < 2; ++mt) {
                const int xs = x0 + mt * 16;  // column of fragment row 0
                if (xs == 0) {
                  const uint32_t e[4] = {g == 0 ? af[mt][0] : 0u, 0u,
                                         g == 0 ? af[mt][2] : 0u, 0u};
                  const uint2* ep = wrow + 3 * tap_elems + kc * NT * 32 + lane;
#pragma unroll
                  for (int nt = 0; nt < NT; ++nt) mma_tile(acc[mt][nt], e, ep[nt * 32]);
                }
                const int r = a.W - 1 - xs;   // fragment row of the last column
                if (r >= 0 && r < 16) {
                  const uint32_t e[4] = {g == r ? af[mt][0] : 0u,
                                         g + 8 == r ? af[mt][1] : 0u,
                                         g == r ? af[mt][2] : 0u,
                                         g + 8 == r ? af[mt][3] : 0u};
                  const uint2* ep = wrow + 4 * tap_elems + kc * NT * 32 + lane;
#pragma unroll
                  for (int nt = 0; nt < NT; ++nt) mma_tile(acc[mt][nt], e, ep[nt * 32]);
                }
              }
            }
          }
        }
      }
    }
  }

  // Epilogue: (int8: scale,) bias, LeakyReLU, one rounding, masked stores.
  const int oy = y0 + warp;
  if (oy >= a.H) return;
  const int cout = a.cout;
  const int co_base = cb * NT * 8;
  const bool pair_store = (cout & 1) == 0;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int ox = x0 + mt * 16 + g + half * 8;
      if (ox >= a.W) continue;
      const size_t obase = ((b * a.H + oy) * a.W + ox) * cout;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int co = co_base + nt * 8 + 2 * tig;
        if (co >= cout) continue;
        const bool has1 = co + 1 < cout;
        float v0 = static_cast<float>(acc[mt][nt][half * 2]);
        float v1 = static_cast<float>(acc[mt][nt][half * 2 + 1]);
        if (Q) {
          v0 *= __ldg(a.scale + co);
          if (has1) v1 *= __ldg(a.scale + co + 1);
        }
        v0 += __ldg(a.bias + co);
        if (has1) v1 += __ldg(a.bias + co + 1);
        if (a.has_slope) {
          v0 = v0 >= 0.0f ? v0 : a.slope * v0;
          v1 = v1 >= 0.0f ? v1 : a.slope * v1;
        }
        if (Q && a.out_i8) {
          int8_t* op = static_cast<int8_t*>(a.out) + obase;
          const int q0 = quant1(v0, 1.0f), q1 = quant1(v1, 1.0f);
          if (pair_store) {
            *reinterpret_cast<char2*>(op + co) = make_char2(q0, q1);
          } else {
            op[co] = static_cast<int8_t>(q0);
            if (has1) op[co + 1] = static_cast<int8_t>(q1);
          }
        } else {
          __nv_bfloat16* op = static_cast<__nv_bfloat16*>(a.out) + obase;
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
}

long long smem_bytes(int ky, int kx, int ntaps, int cchunk, int n_tiles, int q) {
  const int es = q ? 1 : 2, kk = q ? 32 : 16;
  const long long halo =
      static_cast<long long>(TH + ky - 1) * (TW + kx - 1) * (cchunk * es + PAD_BYTES);
  const long long wrow = static_cast<long long>(ntaps) * (cchunk / kk) * n_tiles * 32 * 8;
  return halo + wrow;
}

template <int NT, int MODE, bool Q>
int launch_one(const ConvArgs& a, int B, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(conv_packed_kernel<NT, MODE, Q>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((a.W + TW - 1) / TW, (a.H + TH - 1) / TH, B * a.n_cb);
  conv_packed_kernel<NT, MODE, Q><<<grid, THREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE, bool Q>
int launch_nt(const ConvArgs& a, int B, int n_tiles, size_t smem, cudaStream_t s) {
  switch (n_tiles) {
    case 1: return launch_one<1, MODE, Q>(a, B, smem, s);
    case 2: return launch_one<2, MODE, Q>(a, B, smem, s);
    case 4: return launch_one<4, MODE, Q>(a, B, smem, s);
    case 8: return launch_one<8, MODE, Q>(a, B, smem, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int MODE>
int launch_mode(ConvArgs a, int B, int n_tiles, int q, void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || a.H <= 0 || a.W <= 0) return 0;
  const int kk = q ? 32 : 16;
  if (a.ky < 1 || (a.ky & 1) == 0 || a.kx < 1 || (a.kx & 1) == 0 || a.cchunk < kk ||
      a.cchunk % kk || a.cout < 1 || a.n_ops < 1 || a.n_ops > MAX_OPS ||
      (q && !a.scale) || (!q && a.out_i8))
    return invalid;
  a.total_chunks = 0;
  for (int i = 0; i < a.n_ops; ++i) {
    if (a.c[i] < 1 || a.cs[i] < a.c[i] || (q ? !a.ax[i] : a.in_i8[i] != 0)) return invalid;
    // Every prologue but the direct one loads 8 channels at once.
    if (MODE != DIRECT && ((a.c[i] & 7) || (a.cs[i] & 7))) return invalid;
    a.total_chunks += (a.c[i] + a.cchunk - 1) / a.cchunk;
  }
  a.n_cb = (a.cout + n_tiles * 8 - 1) / (n_tiles * 8);
  if (static_cast<long long>(B) * a.n_cb > 65535 || (a.H + TH - 1) / TH > 65535)
    return invalid;
  const size_t smem =
      static_cast<size_t>(smem_bytes(a.ky, a.kx, a.ntaps, a.cchunk, n_tiles, q));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return q ? launch_nt<MODE, true>(a, B, n_tiles, smem, s)
           : launch_nt<MODE, false>(a, B, n_tiles, smem, s);
}

// The arguments of the four fused entry points: one operand x of c channels.
ConvArgs fused_args(const void* x, int c, int in_i8, const void* ax, const void* wfrag,
                    const void* bias, const void* scale, void* out, int out_i8, int H,
                    int W, int Hs, int Ws, int cout, int ky, int kx, int ntaps, int cchunk,
                    int has_slope, float slope) {
  ConvArgs a = {};
  a.x[0] = x;
  a.c[0] = c;
  a.cs[0] = c;
  a.in_i8[0] = in_i8;
  a.ax[0] = static_cast<const float*>(ax);
  a.n_ops = 1;
  a.wfrag = static_cast<const uint2*>(wfrag);
  a.bias = static_cast<const float*>(bias);
  a.scale = static_cast<const float*>(scale);
  a.out = out;
  a.out_i8 = out_i8;
  a.H = H; a.W = W; a.Hs = Hs; a.Ws = Ws;
  a.cout = cout;
  a.ky = ky; a.kx = kx; a.ntaps = ntaps;
  a.cchunk = cchunk;
  a.has_slope = has_slope;
  a.slope = slope;
  return a;
}

}  // namespace

// Every entry point takes, beside its tensors: q (0 bfloat16, 1 int8); in
// int8 mode in_i8 (the operand is int8 on its grid), ax (device pointer to
// the operand's float32 calibrated |x| maximum), scale (cout float32, the
// int32 sum's dequantisation, 127/ax_out folded in when out_i8) and out_i8
// (store int8 instead of bf16). wfrag holds bf16 or int8 weights in fragment
// order (see the file head) for chunks of cchunk channels per operand and
// blocks of n_tiles*8 output channels; bias is float32.
extern "C" {

// Shared memory one block needs, in bytes (also used by the Python planner).
long long rrin_conv_packed_smem(int ky, int kx, int ntaps, int cchunk, int n_tiles, int q) {
  return smem_bytes(ky, kx, ntaps, cchunk, n_tiles, q);
}

// xs: n_ops pointers to (B,H,W,strides[i]) NHWC tensors of which the first
// cs[i] channels enter the conv, in order; out: (B,H,W,cout).
int rrin_conv_packed_launch(const void* const* xs, const int* cs, const int* strides,
                            const int* in_i8, const void* const* ax, int n_ops,
                            const void* wfrag, const void* bias, const void* scale,
                            void* out, int out_i8, int B, int H, int W, int cout, int k,
                            int cchunk, int n_tiles, int has_slope, float slope, int q,
                            void* stream) {
  if (n_ops < 1 || n_ops > MAX_OPS) return static_cast<int>(cudaErrorInvalidValue);
  ConvArgs a = {};
  for (int i = 0; i < n_ops; ++i) {
    a.x[i] = xs[i];
    a.c[i] = cs[i];
    a.cs[i] = strides[i];
    a.in_i8[i] = in_i8[i];
    a.ax[i] = static_cast<const float*>(ax[i]);
  }
  a.n_ops = n_ops;
  a.wfrag = static_cast<const uint2*>(wfrag);
  a.bias = static_cast<const float*>(bias);
  a.scale = static_cast<const float*>(scale);
  a.out = out;
  a.out_i8 = out_i8;
  a.H = H; a.W = W; a.Hs = H; a.Ws = W;
  a.cout = cout;
  a.ky = k; a.kx = k; a.ntaps = k;
  a.cchunk = cchunk;
  a.has_slope = has_slope;
  a.slope = slope;
  return launch_mode<DIRECT>(a, B, n_tiles, q, stream);
}

// x: (B,2H,2W,c) full resolution; out: (B,H,W,cout) = conv_k(avg_pool_2x(x)).
int rrin_conv_pool_packed_launch(const void* x, int c, int in_i8, const void* ax,
                                 const void* wfrag, const void* bias, const void* scale,
                                 void* out, int out_i8, int B, int H, int W, int cout, int k,
                                 int cchunk, int n_tiles, int has_slope, float slope, int q,
                                 void* stream) {
  return launch_mode<POOL>(
      fused_args(x, c, in_i8, ax, wfrag, bias, scale, out, out_i8, H, W, 2 * H, 2 * W,
                 cout, k, k, k, cchunk, has_slope, slope),
      B, n_tiles, q, stream);
}

// x: (B,Hs,Ws,c) half resolution; out: (B,2Hs,2Ws,cout) =
// conv_k(upsample_2x_bilinear(x)).
int rrin_conv_up_m_packed_launch(const void* x, int c, int in_i8, const void* ax,
                                 const void* wfrag, const void* bias, const void* scale,
                                 void* out, int out_i8, int B, int Hs, int Ws, int cout,
                                 int k, int cchunk, int n_tiles, int has_slope, float slope,
                                 int q, void* stream) {
  return launch_mode<UP>(
      fused_args(x, c, in_i8, ax, wfrag, bias, scale, out, out_i8, 2 * Hs, 2 * Ws, Hs, Ws,
                 cout, k, k, k, cchunk, has_slope, slope),
      B, n_tiles, q, stream);
}

// The function of rrin_conv_up_m_packed_launch, k in {1, 3, 5}; in int8 an
// int8 input is dequantised before it is interpolated.
int rrin_conv_up_packed_launch(const void* x, int c, int in_i8, const void* ax,
                               const void* wfrag, const void* bias, const void* scale,
                               void* out, int out_i8, int B, int Hs, int Ws, int cout, int k,
                               int cchunk, int n_tiles, int has_slope, float slope, int q,
                               void* stream) {
  return launch_mode<UPD>(
      fused_args(x, c, in_i8, ax, wfrag, bias, scale, out, out_i8, 2 * Hs, 2 * Ws, Hs, Ws,
                 cout, k, k, k, cchunk, has_slope, slope),
      B, n_tiles, q, stream);
}

// x: (B,Hs,Ws,c) half resolution; out: (B,2Hs,2Ws,cout) =
// conv_3(upsample_2x_bilinear(x)); wfrag holds the folded weights with five
// taps per dy row and 2*cout output channels, bias (and scale) are 2*cout
// long (see the file head).
int rrin_conv_up_f_packed_launch(const void* x, int c, int in_i8, const void* ax,
                                 const void* wfrag, const void* bias, const void* scale,
                                 void* out, int out_i8, int B, int Hs, int Ws, int cout,
                                 int cchunk, int n_tiles, int has_slope, float slope, int q,
                                 void* stream) {
  return launch_mode<UPF>(
      fused_args(x, c, in_i8, ax, wfrag, bias, scale, out, out_i8, 2 * Hs, Ws, Hs, Ws,
                 2 * cout, 3, 3, 5, cchunk, has_slope, slope),
      B, n_tiles, q, stream);
}

}  // extern "C"
