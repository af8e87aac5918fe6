// The float32 modes of the fused-resample convolutions K7 and K8 of the
// packed serving path on NHWC tensors: one implicit-GEMM core on mma.sync
// with two load prologues. They replace the Pallas kernels of
// rrin_tpu/ops/conv_packed.py named beside each (K7 _kernel_body_pool, K8
// _kernel_body_up_m) for float32 operands; their bfloat16 and int8 modes,
// and all three element types of K5, K6 and K9, run on the wgmma core of
// conv_sm90.cuh.
//
//   conv_pool_packed  (K7) conv(avg_pool_2x(x)): the block pools the 2x
//                     footprint of its halo tile while loading;
//   conv_up_m_packed  (K8) conv(upsample_2x_bilinear(x)), H interpolated
//                     first, as upsample_2x_bilinear does.
//
// "3xTF32": the reference contracts float32 operands at full float32
// precision, which a single TF32 product (10 mantissa bits) misses by three
// orders of magnitude. Every operand is split into two TF32 parts, hi =
// rna(x) and lo = rna(x - hi); the host splits the weights once, the kernel
// splits each activation as it loads an A fragment from the float32 halo
// tile; mma.sync.m16n8k8.tf32 sums lo_a*hi_b + hi_a*lo_b + hi_a*hi_b of one
// k-step (the dropped lo_a*lo_b and the rounding of lo are about 2^-22 of
// each product), which is added to a float32 accumulator with round to
// nearest (mma_tile says why). Prologue values are float32, stored as they
// are; the epilogue adds bias and LeakyReLU and stores float32. Three
// products per tf32 step: the kernels are bound by the tensor cores'
// float32-accurate rate, a third of the TF32 peak.
//
// GEMM view: M = pixels, N = channels per pixel of the output, K = taps x
// input channels (KK = 8 per mma, 32 bytes):
//   * a block computes 8 rows x 32 columns of pixels for one block of NT*8
//     <= 64 output channels (blockIdx.z walks batch x channel blocks); warp
//     w owns row w as two m-tiles of 16 consecutive pixels;
//   * input channels are walked in chunks of at most 32; for each chunk the
//     halo tile (8+k-1) x (32+k-1) x chunk is built in shared memory (zero
//     outside the image: SAME padding at the resolution the conv runs at),
//     each pixel padded by 16 bytes so the eight pixel rows of an A fragment
//     fall on distinct banks;
//   * the weights arrive in B-fragment order
//     [channel block][chunk][dy][tap][k-step][n-tile][lane] (one uint4 a
//     lane: the hi pair, then the lo pair) and are streamed into shared
//     memory one dy row at a time.
// Redundant halo loads across channel blocks and neighbouring tiles are
// served by the L2 cache. Ragged edges are masked at the store; nothing
// assumes W % 32 or H % 8.
//
// Plain C entry points; each returns cudaGetLastError() after the launch,
// runs on the given stream, allocates nothing and does not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_prologue.cuh"

namespace {

constexpr int TH = 8;            // pixel rows per block = warps per block
constexpr int TW = 32;           // pixel columns per block = 2 m-tiles
constexpr int THREADS = TH * 32;
constexpr int PAD_BYTES = 16;    // padding per halo pixel
constexpr int KK = 8;            // channels per tf32 mma step (32 bytes)

enum Mode { POOL = 0, UP_M = 1 };

struct ConvArgs {
  const float* x;
  int c;               // channels of x (a multiple of 8)
  const void* wfrag;
  const float* bias;
  void* out;
  int H, W;          // rows and columns of the GEMM's pixels
  int Hs, Ws;        // rows and columns of the stored operands
  int cout;          // channels per GEMM pixel of the output
  int k;             // taps in y and in x
  int cchunk, n_chunks, n_cb;
  int has_slope;
  float slope;
};

// tf32 x tf32 -> f32 tensor-core product, one element a register, with
// g = lane / 4 and tig = lane % 4:
//   A (16 x 8):  a0 = A[g][tig]   a1 = A[g + 8][tig]
//                a2 = A[g][tig + 4]   a3 = A[g + 8][tig + 4]
//   B (8 x 8):   b0 = B[tig][g]   b1 = B[tig + 4][g]
//   C (16 x 8):  c0, c1 = C[g][2*tig .. +1]  c2, c3 = C[g + 8][2*tig .. +1]
__device__ __forceinline__ void mma_m16n8k8_tf32(float (&c)[4], const uint32_t (&a)[4],
                                                 uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x rounded to tf32 (nearest, ties away from zero), as a float32 bit pattern.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// One m-tile's A operand as read from the halo tile: the tf32 hi parts (r)
// and lo parts (lo).
struct AFrag {
  uint32_t r[4];
  uint32_t lo[4];
};

__device__ __forceinline__ AFrag load_a(const unsigned char* p, int pstride) {
  AFrag f;
  f.r[0] = *reinterpret_cast<const uint32_t*>(p);
  f.r[1] = *reinterpret_cast<const uint32_t*>(p + 8 * pstride);
  f.r[2] = *reinterpret_cast<const uint32_t*>(p + 16);
  f.r[3] = *reinterpret_cast<const uint32_t*>(p + 8 * pstride + 16);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float x = __uint_as_float(f.r[i]);
    f.r[i] = tf32_rna(x);
    f.lo[i] = tf32_rna(__fsub_rn(x, __uint_as_float(f.r[i])));
  }
  return f;
}

// 3xTF32, the small products first, summed from zero on the tensor cores
// and added to the accumulator with round to nearest: the tensor cores add
// to their accumulator by truncation, which over the hundreds of k-steps of
// a wide conv sums to a bias of about one float32 step of the result a
// step (1e-4 at K = 4608 in a first version that accumulated on them).
// b: the hi pair of rows tig, tig + 4, then their lo parts.
__device__ __forceinline__ void mma_tile(float (&c)[4], const AFrag& a, const uint4 b) {
  float t[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  mma_m16n8k8_tf32(t, a.lo, b.x, b.y);
  mma_m16n8k8_tf32(t, a.r, b.z, b.w);
  mma_m16n8k8_tf32(t, a.r, b.x, b.y);
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] = __fadd_rn(c[i], t[i]);
}

// Eight channels of the pixel (gy, gx) that the GEMM reads, inside the image:
// pooled 2x2, or upsampled in both axes, H first (K8, the order of
// upsample_2x_bilinear).
template <int MODE>
__device__ __forceinline__ F8 construct8(const float* xb, int cs, int Hs, int Ws, int gy,
                                         int gx, int c) {
  auto t = [&](int y, int x) { return load8_f32(xb, cs, Ws, y, x, c); };
  if constexpr (MODE == POOL) {
    return avg4_8(t(2 * gy, 2 * gx), t(2 * gy, 2 * gx + 1), t(2 * gy + 1, 2 * gx),
                  t(2 * gy + 1, 2 * gx + 1));
  } else {
    const int yn = gy >> 1, yf = far_tap(gy, Hs);
    const int xn = gx >> 1, xf = far_tap(gx, Ws);
    return lerp8(lerp8(t(yf, xf), t(yn, xf)), lerp8(t(yf, xn), t(yn, xn)));
  }
}

// At most 128 registers a thread, so that two blocks fit a multiprocessor and
// one block's tensor-core work covers the other's loads and barriers; with
// one block resident the kernel runs markedly slower on an H100.
template <int NT, int MODE>
__global__ void __launch_bounds__(THREADS, 2) conv_packed_kernel(const ConvArgs a) {
  constexpr int ES = 4;                 // bytes per staged element
  extern __shared__ __align__(16) unsigned char smem[];
  const int hp = (a.k - 1) / 2;
  const int hw = TW + a.k - 1;               // halo tile columns
  const int hh = TH + a.k - 1;               // halo tile rows
  const int cchunk = a.cchunk;
  const int pstride = cchunk * ES + PAD_BYTES;  // bytes per halo pixel
  const int kc_count = cchunk / KK;
  const int tap_elems = kc_count * NT * 32;  // uint4 per (chunk, dy, tap)
  const int wrow_elems = a.k * tap_elems;
  unsigned char* halo = smem;
  uint4* wrow = reinterpret_cast<uint4*>(smem + static_cast<size_t>(hh) * hw * pstride);
  const uint4* wfrag = static_cast<const uint4*>(a.wfrag);

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

  const float* xb = a.x + b * a.Hs * a.Ws * a.c;
  for (int gch = 0; gch < a.n_chunks; ++gch) {
    const int c_base = gch * cchunk;
    __syncthreads();  // the previous chunk's fragments are all read
    // 8 channels (32 bytes) at a time.
    const int v_per_pix = cchunk >> 3;
    for (int i = tid; i < hh * hw * v_per_pix; i += THREADS) {
      const int v = i % v_per_pix;
      const int pix = i / v_per_pix;
      const int gy = y0 + pix / hw - hp;
      const int gx = x0 + pix % hw - hp;
      const int c = c_base + v * 8;
      const bool inside = gy >= 0 && gy < a.H && gx >= 0 && gx < a.W && c < a.c;
      F8 val = {};
      if (inside) val = construct8<MODE>(xb, a.c, a.Hs, a.Ws, gy, gx, c);
      store8_f32(halo + pix * pstride + v * 8 * ES, val);
    }

    for (int dy = 0; dy < a.k; ++dy) {
      __syncthreads();  // halo tile written; previous weight row consumed
      const uint4* wsrc =
          wfrag + (static_cast<size_t>(cb * a.n_chunks + gch) * a.k + dy) * wrow_elems;
      for (int i = tid; i < wrow_elems; i += THREADS) wrow[i] = __ldg(wsrc + i);
      __syncthreads();

      const unsigned char* arow = halo + (warp + dy) * hw * pstride;
      for (int dx = 0; dx < a.k; ++dx) {
        for (int kc = 0; kc < kc_count; ++kc) {
          // KK channels are 32 bytes, a register 4.
          AFrag af[2];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            af[mt] = load_a(arow + (mt * 16 + g + dx) * pstride + kc * 32 + tig * 4, pstride);
          const uint4* bp = wrow + dx * tap_elems + kc * NT * 32 + lane;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const uint4 bfrag = bp[nt * 32];
            mma_tile(acc[0][nt], af[0], bfrag);
            mma_tile(acc[1][nt], af[1], bfrag);
          }
        }
      }
    }
  }

  // Epilogue: bias, LeakyReLU, masked stores.
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
      float* op = static_cast<float*>(a.out) + ((b * a.H + oy) * a.W + ox) * cout;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int co = co_base + nt * 8 + 2 * tig;
        if (co >= cout) continue;
        const bool has1 = co + 1 < cout;
        float v0 = acc[mt][nt][half * 2] + __ldg(a.bias + co);
        float v1 = acc[mt][nt][half * 2 + 1];
        if (has1) v1 += __ldg(a.bias + co + 1);
        if (a.has_slope) {
          v0 = v0 >= 0.0f ? v0 : a.slope * v0;
          v1 = v1 >= 0.0f ? v1 : a.slope * v1;
        }
        if (pair_store) {
          *reinterpret_cast<float2*>(op + co) = make_float2(v0, v1);
        } else {
          op[co] = v0;
          if (has1) op[co + 1] = v1;
        }
      }
    }
  }
}

long long smem_bytes(int k, int cchunk, int n_tiles) {
  const long long halo =
      static_cast<long long>(TH + k - 1) * (TW + k - 1) * (cchunk * 4 + PAD_BYTES);
  const long long wrow = static_cast<long long>(k) * (cchunk / KK) * n_tiles * 32 * 16;
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
  // The prologues load 8 channels at once.
  if (a.k < 1 || (a.k & 1) == 0 || a.cchunk < KK || a.cchunk % KK || a.cout < 1 || a.c < 8 ||
      a.c % 8)
    return invalid;
  a.n_chunks = (a.c + a.cchunk - 1) / a.cchunk;
  a.n_cb = (a.cout + n_tiles * 8 - 1) / (n_tiles * 8);
  if (static_cast<long long>(B) * a.n_cb > 65535 || (a.H + TH - 1) / TH > 65535)
    return invalid;
  const size_t smem = static_cast<size_t>(smem_bytes(a.k, a.cchunk, n_tiles));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_tiles) {
    case 1: return launch_one<1, MODE>(a, B, smem, s);
    case 2: return launch_one<2, MODE>(a, B, smem, s);
    case 4: return launch_one<4, MODE>(a, B, smem, s);
    case 8: return launch_one<8, MODE>(a, B, smem, s);
    default: return invalid;
  }
}

// The arguments of an entry point: one operand x of c channels.
ConvArgs fused_args(const void* x, int c, const void* wfrag, const void* bias, void* out,
                    int H, int W, int Hs, int Ws, int cout, int k,
                    int cchunk, int has_slope, float slope) {
  ConvArgs a = {};
  a.x = static_cast<const float*>(x);
  a.c = c;
  a.wfrag = wfrag;
  a.bias = static_cast<const float*>(bias);
  a.out = out;
  a.H = H; a.W = W; a.Hs = Hs; a.Ws = Ws;
  a.cout = cout;
  a.k = k;
  a.cchunk = cchunk;
  a.has_slope = has_slope;
  a.slope = slope;
  return a;
}

}  // namespace

// Every entry point takes float32 tensors, their shapes, the plan and the
// slope: wfrag holds the weights split in two TF32 planes, in fragment order
// (see the file head), for chunks of cchunk channels and blocks of n_tiles*8
// output channels; bias is float32; the output is float32.
extern "C" {

// Shared memory one block needs, in bytes (also used by the Python planner).
long long rrin_conv_packed_smem(int k, int cchunk, int n_tiles) {
  return smem_bytes(k, cchunk, n_tiles);
}

// x: (B,2H,2W,c) full resolution; out: (B,H,W,cout) = conv_k(avg_pool_2x(x)).
int rrin_conv_pool_packed_f32_launch(const void* x, int c, const void* wfrag,
                                     const void* bias, void* out, int B, int H, int W,
                                     int cout, int k, int cchunk, int n_tiles, int has_slope,
                                     float slope, void* stream) {
  return launch_mode<POOL>(fused_args(x, c, wfrag, bias, out, H, W, 2 * H, 2 * W, cout, k,
                                      cchunk, has_slope, slope),
                           B, n_tiles, stream);
}

// x: (B,Hs,Ws,c) half resolution; out: (B,2Hs,2Ws,cout) =
// conv_k(upsample_2x_bilinear(x)), H interpolated first.
int rrin_conv_up_m_packed_f32_launch(const void* x, int c, const void* wfrag,
                                     const void* bias, void* out, int B, int Hs, int Ws,
                                     int cout, int k, int cchunk, int n_tiles, int has_slope,
                                     float slope, void* stream) {
  return launch_mode<UP_M>(fused_args(x, c, wfrag, bias, out, 2 * Hs, 2 * Ws, Hs, Ws, cout, k,
                                      cchunk, has_slope, slope),
                           B, n_tiles, stream);
}

}  // extern "C"
