// The convolutions of the packed serving path on NHWC bfloat16: one
// implicit-GEMM core with four load prologues, one C entry point each.
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
//   conv_up_f_packed  the same function for k = 3 with the W-upsample folded
//                     into per-output-parity weights on the host: the block
//                     builds only the H-interpolated rows, at half width,
//                     and the GEMM emits two output columns per pixel.
//
// All add a float32 bias and an optional LeakyReLU to the float32 sum and
// round once to bfloat16 at the store. Values built in a prologue are
// computed in float32 and rounded once to bfloat16 (round to nearest even)
// as they enter shared memory.
//
// GEMM view: M = pixels, N = channels per pixel of the output, K = taps x
// input channels. mma.sync.m16n8k16 (bf16 in, f32 accumulate):
//   * a block computes 8 rows x 32 columns of pixels for one block of NT*8
//     <= 64 output channels (blockIdx.z walks batch x channel blocks); warp
//     w owns row w as two m-tiles of 16 consecutive pixels;
//   * input channels are walked operand by operand in chunks of at most 64;
//     for each chunk the halo tile (8+ky-1) x (32+kx-1) x chunk is staged in
//     shared memory (zero outside the image: SAME padding at the resolution
//     the conv runs at), each pixel's channels padded by 8 elements so the
//     eight pixel rows of an A fragment fall on distinct banks;
//   * the weights arrive in B-fragment order
//     [channel block][chunk][dy][tap][k16][n-tile][lane] (one uint2 a lane)
//     and are streamed into shared memory one dy row at a time.
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

#include "mma_bf16.cuh"

namespace {

constexpr int TH = 8;            // pixel rows per block = warps per block
constexpr int TW = 32;           // pixel columns per block = 2 m-tiles
constexpr int THREADS = TH * 32;
constexpr int CPAD = 8;          // bf16 elements of padding per halo pixel
constexpr int MAX_OPS = 4;       // operands of one conv_packed call

enum Mode { DIRECT = 0, POOL = 1, UP = 2, UPF = 3 };

struct ConvArgs {
  const __nv_bfloat16* x[MAX_OPS];
  int c[MAX_OPS];    // channels of each operand that enter the conv
  int cs[MAX_OPS];   // its pixel stride in elements (>= c)
  int n_ops;
  const uint2* wfrag;
  const float* bias;
  __nv_bfloat16* out;
  int H, W;          // rows and columns of the GEMM's pixels
  int Hs, Ws;        // rows and columns of the stored operands
  int cout;          // channels per GEMM pixel of the output
  int ky, kx;        // taps that slide in y and in x
  int ntaps;         // weight taps per dy row (kx, + 2 edge taps when folded)
  int cchunk, total_chunks, n_cb;
  int has_slope;
  float slope;
};

struct F8 {
  float v[8];
};

__device__ __forceinline__ uint4 ld8(const __nv_bfloat16* xb, int cs, int Ws, int y, int x,
                                     int c) {
  return __ldg(reinterpret_cast<const uint4*>(
      xb + (static_cast<size_t>(y) * Ws + x) * cs + c));
}

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

// The far tap of output position p of a 2x half-pixel bilinear upsample of n
// samples, clamped at both ends; the near tap is p / 2.
__device__ __forceinline__ int far_tap(int p, int n) {
  const int h = p >> 1;
  return (p & 1) ? min(h + 1, n - 1) : max(h - 1, 0);
}

// Eight channels of the pixel (gy, gx) that the GEMM reads, inside the image.
template <int MODE>
__device__ __forceinline__ uint4 fetch8(const __nv_bfloat16* xb, int cs, int Hs, int Ws,
                                        int gy, int gx, int c) {
  if (MODE == DIRECT) {
    return ld8(xb, cs, Ws, gy, gx, c);
  } else if (MODE == POOL) {
    const F8 p00 = unpack8(ld8(xb, cs, Ws, 2 * gy, 2 * gx, c));
    const F8 p01 = unpack8(ld8(xb, cs, Ws, 2 * gy, 2 * gx + 1, c));
    const F8 p10 = unpack8(ld8(xb, cs, Ws, 2 * gy + 1, 2 * gx, c));
    const F8 p11 = unpack8(ld8(xb, cs, Ws, 2 * gy + 1, 2 * gx + 1, c));
    F8 r;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      r.v[i] = __fmul_rn(
          __fadd_rn(__fadd_rn(__fadd_rn(p00.v[i], p01.v[i]), p10.v[i]), p11.v[i]), 0.25f);
    return pack8(r);
  } else {
    const int yn = gy >> 1, yf = far_tap(gy, Hs);
    if (MODE == UPF) {
      return pack8(lerp8(unpack8(ld8(xb, cs, Ws, yf, gx, c)),
                         unpack8(ld8(xb, cs, Ws, yn, gx, c))));
    }
    const int xn = gx >> 1, xf = far_tap(gx, Ws);
    const F8 hn = lerp8(unpack8(ld8(xb, cs, Ws, yf, xn, c)),
                        unpack8(ld8(xb, cs, Ws, yn, xn, c)));
    const F8 hf = lerp8(unpack8(ld8(xb, cs, Ws, yf, xf, c)),
                        unpack8(ld8(xb, cs, Ws, yn, xf, c)));
    return pack8(lerp8(hf, hn));
  }
}

// At most 128 registers a thread, so that two blocks fit a multiprocessor and
// one block's tensor-core work covers the other's loads and barriers; with
// one block resident the kernel runs markedly slower on an H100.
template <int NT, int MODE>
__global__ void __launch_bounds__(THREADS, 2) conv_packed_kernel(const ConvArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int hpy = (a.ky - 1) / 2;
  const int hpx = (a.kx - 1) / 2;
  const int hw = TW + a.kx - 1;              // halo tile columns
  const int hh = TH + a.ky - 1;              // halo tile rows
  const int cchunk = a.cchunk;
  const int cstride = cchunk + CPAD;         // elements per halo pixel
  const int kc_count = cchunk / 16;
  const int tap_elems = kc_count * NT * 32;  // uint2 per (chunk, dy, tap)
  const int wrow_elems = a.ntaps * tap_elems;
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
  const int cb = blockIdx.z % a.n_cb;
  const size_t b = blockIdx.z / a.n_cb;

  float acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0f;

  int gch = 0;  // chunk index over all operands
  for (int op = 0; op < a.n_ops; ++op) {
    const int cin = a.c[op];
    const int cs = a.cs[op];
    const __nv_bfloat16* xb = a.x[op] + b * a.Hs * a.Ws * cs;
    const int n_chunks = (cin + cchunk - 1) / cchunk;
    for (int ch = 0; ch < n_chunks; ++ch, ++gch) {
      const int c_base = ch * cchunk;
      __syncthreads();  // the previous chunk's fragments are all read
      if (MODE != DIRECT || ((cin & 7) == 0 && (cs & 7) == 0)) {
        // 16-byte loads: 8 channels at a time.
        const int v_per_pix = cchunk >> 3;
        const int total = hh * hw * v_per_pix;
        for (int i = tid; i < total; i += THREADS) {
          const int v = i % v_per_pix;
          const int pix = i / v_per_pix;
          const int gy = y0 + pix / hw - hpy;
          const int gx = x0 + pix % hw - hpx;
          const int c = c_base + v * 8;
          uint4 val = make_uint4(0u, 0u, 0u, 0u);
          if (gy >= 0 && gy < a.H && gx >= 0 && gx < a.W && c < cin)
            val = fetch8<MODE>(xb, cs, a.Hs, a.Ws, gy, gx, c);
          *reinterpret_cast<uint4*>(halo + pix * cstride + v * 8) = val;
        }
      } else {
        // cin in {6, 9, 10, ...}: element loads, zero-padded to the chunk.
        const int total = hh * hw * cchunk;
        for (int i = tid; i < total; i += THREADS) {
          const int c = i % cchunk;
          const int pix = i / cchunk;
          const int gy = y0 + pix / hw - hpy;
          const int gx = x0 + pix % hw - hpx;
          __nv_bfloat16 val = __float2bfloat16_rn(0.0f);
          if (gy >= 0 && gy < a.H && gx >= 0 && gx < a.W && c_base + c < cin)
            val = xb[(static_cast<size_t>(gy) * a.Ws + gx) * cs + c_base + c];
          halo[pix * cstride + c] = val;
        }
      }

      for (int dy = 0; dy < a.ky; ++dy) {
        __syncthreads();  // halo tile written; previous weight row consumed
        const uint2* wsrc =
            a.wfrag +
            (static_cast<size_t>(cb * a.total_chunks + gch) * a.ky + dy) * wrow_elems;
        for (int i = tid; i < wrow_elems; i += THREADS) wrow[i] = __ldg(wsrc + i);
        __syncthreads();

        const __nv_bfloat16* arow = halo + (warp + dy) * hw * cstride;
        for (int dx = 0; dx < a.kx; ++dx) {
          for (int kc = 0; kc < kc_count; ++kc) {
            uint32_t af[2][4];
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              const __nv_bfloat16* p =
                  arow + (mt * 16 + g + dx) * cstride + kc * 16 + 2 * tig;
              af[mt][0] = *reinterpret_cast<const uint32_t*>(p);
              af[mt][1] = *reinterpret_cast<const uint32_t*>(p + 8 * cstride);
              af[mt][2] = *reinterpret_cast<const uint32_t*>(p + 8);
              af[mt][3] = *reinterpret_cast<const uint32_t*>(p + 8 * cstride + 8);
            }
            const uint2* bp = wrow + dx * tap_elems + kc * NT * 32 + lane;
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              const uint2 bfrag = bp[nt * 32];
              mma_m16n8k16_bf16(acc[0][nt], af[0], bfrag);
              mma_m16n8k16_bf16(acc[1][nt], af[1], bfrag);
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
                  for (int nt = 0; nt < NT; ++nt)
                    mma_m16n8k16_bf16(acc[mt][nt], e, ep[nt * 32]);
                }
                const int r = a.W - 1 - xs;   // fragment row of the last column
                if (r >= 0 && r < 16) {
                  const uint32_t e[4] = {g == r ? af[mt][0] : 0u,
                                         g + 8 == r ? af[mt][1] : 0u,
                                         g == r ? af[mt][2] : 0u,
                                         g + 8 == r ? af[mt][3] : 0u};
                  const uint2* ep = wrow + 4 * tap_elems + kc * NT * 32 + lane;
#pragma unroll
                  for (int nt = 0; nt < NT; ++nt)
                    mma_m16n8k16_bf16(acc[mt][nt], e, ep[nt * 32]);
                }
              }
            }
          }
        }
      }
    }
  }

  // Epilogue: bias, LeakyReLU, one rounding to bf16, masked stores.
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
      __nv_bfloat16* op = a.out + ((b * a.H + oy) * a.W + ox) * cout;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int co = co_base + nt * 8 + 2 * tig;
        if (co >= cout) continue;
        float v0 = acc[mt][nt][half * 2] + __ldg(a.bias + co);
        float v1 = acc[mt][nt][half * 2 + 1];
        const bool has1 = co + 1 < cout;
        if (has1) v1 += __ldg(a.bias + co + 1);
        if (a.has_slope) {
          v0 = v0 >= 0.0f ? v0 : a.slope * v0;
          v1 = v1 >= 0.0f ? v1 : a.slope * v1;
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

long long smem_bytes(int ky, int kx, int ntaps, int cchunk, int n_tiles) {
  const long long halo =
      static_cast<long long>(TH + ky - 1) * (TW + kx - 1) * (cchunk + CPAD) * 2;
  const long long wrow = static_cast<long long>(ntaps) * (cchunk / 16) * n_tiles * 32 * 8;
  return halo + wrow;
}

template <int NT, int MODE>
int launch_one(const ConvArgs& a, int B, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(conv_packed_kernel<NT, MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((a.W + TW - 1) / TW, (a.H + TH - 1) / TH, B * a.n_cb);
  conv_packed_kernel<NT, MODE><<<grid, THREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE>
int launch_mode(ConvArgs a, int B, int n_tiles, void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || a.H <= 0 || a.W <= 0) return 0;
  if (a.ky < 1 || (a.ky & 1) == 0 || a.kx < 1 || (a.kx & 1) == 0 || a.cchunk < 16 ||
      (a.cchunk & 15) || a.cout < 1 || a.n_ops < 1 || a.n_ops > MAX_OPS)
    return invalid;
  a.total_chunks = 0;
  for (int i = 0; i < a.n_ops; ++i) {
    if (a.c[i] < 1 || a.cs[i] < a.c[i]) return invalid;
    // Every prologue but the direct one loads 8 channels (16 bytes) at once.
    if (MODE != DIRECT && ((a.c[i] & 7) || (a.cs[i] & 7))) return invalid;
    a.total_chunks += (a.c[i] + a.cchunk - 1) / a.cchunk;
  }
  a.n_cb = (a.cout + n_tiles * 8 - 1) / (n_tiles * 8);
  if (static_cast<long long>(B) * a.n_cb > 65535 || (a.H + TH - 1) / TH > 65535)
    return invalid;
  const size_t smem =
      static_cast<size_t>(smem_bytes(a.ky, a.kx, a.ntaps, a.cchunk, n_tiles));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_tiles) {
    case 1: return launch_one<1, MODE>(a, B, smem, s);
    case 2: return launch_one<2, MODE>(a, B, smem, s);
    case 4: return launch_one<4, MODE>(a, B, smem, s);
    case 8: return launch_one<8, MODE>(a, B, smem, s);
    default: return invalid;
  }
}

// The arguments of the three fused entry points: one operand x of c channels.
ConvArgs fused_args(const void* x, int c, const void* wfrag, const void* bias, void* out,
                    int H, int W, int Hs, int Ws, int cout, int ky, int kx, int ntaps,
                    int cchunk, int has_slope, float slope) {
  ConvArgs a = {};
  a.x[0] = static_cast<const __nv_bfloat16*>(x);
  a.c[0] = c;
  a.cs[0] = c;
  a.n_ops = 1;
  a.wfrag = static_cast<const uint2*>(wfrag);
  a.bias = static_cast<const float*>(bias);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.H = H; a.W = W; a.Hs = Hs; a.Ws = Ws;
  a.cout = cout;
  a.ky = ky; a.kx = kx; a.ntaps = ntaps;
  a.cchunk = cchunk;
  a.has_slope = has_slope;
  a.slope = slope;
  return a;
}

}  // namespace

extern "C" {

// Shared memory one block needs, in bytes (also used by the Python planner).
long long rrin_conv_packed_smem(int ky, int kx, int ntaps, int cchunk, int n_tiles) {
  return smem_bytes(ky, kx, ntaps, cchunk, n_tiles);
}

// xs: n_ops pointers to (B,H,W,strides[i]) bf16 NHWC tensors of which the
// first cs[i] channels enter the conv, in order; wfrag: weights in fragment
// order (see the file head) for chunks of cchunk channels per operand and
// blocks of n_tiles*8 output channels; bias: cout float32; out: (B,H,W,cout).
int rrin_conv_packed_launch(const void* const* xs, const int* cs, const int* strides,
                            int n_ops, const void* wfrag, const void* bias, void* out,
                            int B, int H, int W, int cout, int k, int cchunk, int n_tiles,
                            int has_slope, float slope, void* stream) {
  if (n_ops < 1 || n_ops > MAX_OPS) return static_cast<int>(cudaErrorInvalidValue);
  ConvArgs a = {};
  for (int i = 0; i < n_ops; ++i) {
    a.x[i] = static_cast<const __nv_bfloat16*>(xs[i]);
    a.c[i] = cs[i];
    a.cs[i] = strides[i];
  }
  a.n_ops = n_ops;
  a.wfrag = static_cast<const uint2*>(wfrag);
  a.bias = static_cast<const float*>(bias);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.H = H; a.W = W; a.Hs = H; a.Ws = W;
  a.cout = cout;
  a.ky = k; a.kx = k; a.ntaps = k;
  a.cchunk = cchunk;
  a.has_slope = has_slope;
  a.slope = slope;
  return launch_mode<DIRECT>(a, B, n_tiles, stream);
}

// x: (B,2H,2W,c) full resolution; out: (B,H,W,cout) = conv_k(avg_pool_2x(x)).
int rrin_conv_pool_packed_launch(const void* x, int c, const void* wfrag, const void* bias,
                                 void* out, int B, int H, int W, int cout, int k,
                                 int cchunk, int n_tiles, int has_slope, float slope,
                                 void* stream) {
  return launch_mode<POOL>(
      fused_args(x, c, wfrag, bias, out, H, W, 2 * H, 2 * W, cout, k, k, k, cchunk,
                 has_slope, slope),
      B, n_tiles, stream);
}

// x: (B,Hs,Ws,c) half resolution; out: (B,2Hs,2Ws,cout) =
// conv_k(upsample_2x_bilinear(x)).
int rrin_conv_up_m_packed_launch(const void* x, int c, const void* wfrag, const void* bias,
                                 void* out, int B, int Hs, int Ws, int cout, int k,
                                 int cchunk, int n_tiles, int has_slope, float slope,
                                 void* stream) {
  return launch_mode<UP>(
      fused_args(x, c, wfrag, bias, out, 2 * Hs, 2 * Ws, Hs, Ws, cout, k, k, k, cchunk,
                 has_slope, slope),
      B, n_tiles, stream);
}

// x: (B,Hs,Ws,c) half resolution; out: (B,2Hs,2Ws,cout) =
// conv_3(upsample_2x_bilinear(x)); wfrag holds the folded weights with five
// taps per dy row and 2*cout output channels, bias is 2*cout long (see the
// file head).
int rrin_conv_up_f_packed_launch(const void* x, int c, const void* wfrag, const void* bias,
                                 void* out, int B, int Hs, int Ws, int cout, int cchunk,
                                 int n_tiles, int has_slope, float slope, void* stream) {
  return launch_mode<UPF>(
      fused_args(x, c, wfrag, bias, out, 2 * Hs, Ws, Hs, Ws, 2 * cout, 3, 3, 5, cchunk,
                 has_slope, slope),
      B, n_tiles, stream);
}

}  // extern "C"
