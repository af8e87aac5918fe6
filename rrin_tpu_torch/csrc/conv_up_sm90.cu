// K7, K8 and K9 of the packed serving path on Hopper (sm_90a): the fused
// resample+conv sites of the U-Net, conv(resample(x)) + bias + an optional
// LeakyReLU on NHWC tensors, in bfloat16, int8 or float32 (3xTF32, the _f32
// entry points), as the producer modes POOL, UP and UPF of the wgmma core in
// conv_sm90.cuh (its head gives the design); and the weight prep of every
// kernel on that core (bf16 and float32).
//
//   conv_pool_packed  replaces _kernel_body_pool (rrin_tpu/ops/conv_packed.py,
//                     pallas_call at :1115): conv(avg_pool_2x(x)). The block
//                     builds the pooled halo tile from the full-resolution
//                     tensor (2x2 mean in float32, rounded once; in int8 a
//                     bf16 input is quantised after the pool, int8 codes are
//                     pooled and re-rounded); k in {3, 5}.
//   conv_up_m_packed  replaces _kernel_body_up_m (pallas_call at :1845):
//                     conv(upsample_2x_bilinear(x)). The block builds the
//                     upsampled halo tile (H interpolated first, then W, on
//                     the int8 codes in int8) from the half-resolution tensor;
//                     k in {3, 5}.
//   conv_up_f_packed  replaces _kernel_body_up_f (pallas_call at :2373): the
//                     same function for k = 3 with the W-upsample folded into
//                     per-output-parity weights. The block builds only the
//                     H-interpolated rows, at half width, and the GEMM emits
//                     two output columns per pixel: N = (parity, cout), and
//                     the output (B, 2Hs, Ws, 2*cout) is the NHWC result
//                     (B, 2Hs, 2Ws, cout) byte for byte. The stencil assumes
//                     s[-1] = s[Ws] = 0 where the upsample clamps; the exact
//                     difference is the edge pixel times two more weight taps
//                     (3: left, 4: right), added in the epilogue. In float32
//                     (3xTF32) N = 2*cout is 128 at u3c1, above the float32
//                     core's 64: the two channel blocks are the two output
//                     parities, and each builds the tile's halo.
//
// What bounds them on an H100: operations (77 GFLOP at each of K8's and
// K9's 1080p sites, 0.078 ms at 989 TFLOP/s bf16), with bytes close behind
// at K9's widest site (200 MB, 0.060 ms) and ahead at K7's (d1c1: 200 MB,
// 0.060 ms, against 53.5 GFLOP, 0.054 ms): the pool reads four stored pixels
// for every pixel that the GEMM reads, so K7's producers move four times the
// bytes they write. In float32 all three are bound by operations at 165
// TFLOP/s (three TF32 products per product): K7 0.441 ms over its two 1080p
// sites (d1c1 0.324, d2c1 0.117), K8 0.467 ms at u2c1, K9 0.467 ms at each
// of its 1080p sites. Float32 K7 reads four stored float32 pixels for each
// pooled value; at d1c1 (N = 32 in two channel blocks, each building the
// pooled halo) that is the input twice, 534 MB, 0.16 ms at 3.35 TB/s.
//
// Plain C entry points; each returns cudaGetLastError() after the launch,
// runs on the given stream, allocates nothing and does not synchronise.

#include "conv_sm90.cuh"

namespace {

// [rho][dx+1][kx]: the coefficient of w[:, kx] in the folded weight that
// output column 2j+rho applies to half-resolution column j+dx.
__constant__ float kUpfA[2][3][3] = {
    {{0.75f, 0.25f, 0.0f}, {0.25f, 0.75f, 0.75f}, {0.0f, 0.0f, 0.25f}},
    {{0.25f, 0.0f, 0.0f}, {0.75f, 0.75f, 0.25f}, {0.0f, 0.25f, 0.75f}}};

// The channel counts of the operands whose concat a weight tensor's cin
// runs over (K5: 1..4, the others: 1).
struct Cins {
  int c[MAX_OPS];
  int n;
};

// x rounded to tf32 as the host's conv_packed._tf32 rounds it: the low 13
// bits of the magnitude rounded off, to nearest, ties away from zero, on the
// bits (so that the planes are bit-equal to their plain version).
__device__ __forceinline__ float tf32_bits(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}

// One weight of the core's layout per thread, from float32 (k, k, cin, cout)
// weights: the conv's own (K5-K8) or folded (K9: the stencil taps
// summed in kx order from 0, then the edge taps, each product and sum
// rounded in float32, as conv_packed._upf_fold computes them), zero where an
// operand's chunk or the output channels are padding; rounded once to bf16,
// or (F32) split into its hi (plane 0) or lo (plane 1) TF32 part. Folded,
// the first 2*cout threads also write the bias of both output parities.
template <bool F32>
__global__ void conv_up_prep_kernel(const float* __restrict__ w, const float* __restrict__ bias,
                                    void* __restrict__ out, float* __restrict__ bias_out, int k,
                                    const Cins cins, int cin, int cout, int cchunk, int n_tiles,
                                    int n_chunks, int folded, int total) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;  // total < 2^31
  if (folded && idx < 2 * cout) bias_out[idx] = bias[idx % cout];
  if (idx >= total) return;
  // bf16: [cb][chunk][dy][tap][k-step][n-tile][r][g][tig][p], innermost last;
  // F32: [cb][chunk][dy][tap][k-step][plane][n-tile][r][g][e]
  int t, nt, ks, cl_ks, plane = 0, g;
  if constexpr (F32) {
    const int e = idx & 3;
    g = (idx >> 2) & 7;
    const int r = (idx >> 5) & 1;
    t = idx >> 6;
    nt = t % n_tiles;
    t /= n_tiles;
    plane = t & 1;
    t >>= 1;
    ks = t % (cchunk / 8);
    t /= cchunk / 8;
    cl_ks = ks * 8 + r * 4 + e;
  } else {
    const int p = idx & 1;
    const int tig = (idx >> 1) & 3;
    g = (idx >> 3) & 7;
    const int r = (idx >> 6) & 1;
    t = idx >> 7;
    nt = t % n_tiles;
    t /= n_tiles;
    ks = t % (cchunk / 16);
    t /= cchunk / 16;
    cl_ks = ks * 16 + r * 8 + tig * 2 + p;
  }
  const int ntaps = folded ? 5 : k;
  const int tap = t % ntaps;
  t /= ntaps;
  const int dy = t % k;
  t /= k;
  const int ch = t % n_chunks;
  const int cb = t / n_chunks;
  // chunk ch of the operand it falls in: its channel cl, the concat's ci
  int chl = ch, row0 = 0, c_op = 0;
  for (int i = 0; i < cins.n; ++i) {
    const int nch = (cins.c[i] + cchunk - 1) / cchunk;
    if (chl < nch) {
      c_op = cins.c[i];
      break;
    }
    chl -= nch;
    row0 += cins.c[i];
  }
  const int cl = chl * cchunk + cl_ks;
  const int ci = row0 + cl;
  const int n = (cb * n_tiles + nt) * 8 + g;
  float v = 0.0f;
  if (cl < c_op && n < (folded ? 2 * cout : cout)) {
    const int co = folded ? n % cout : n;
    auto wt = [&](int x) {
      return __ldg(w + ((static_cast<size_t>(dy) * k + x) * cin + ci) * cout + co);
    };
    if (!folded) {
      v = wt(tap);
    } else {
      const int rho = n / cout;
      if (tap < 3) {
        for (int x = 0; x < 3; ++x) {
          const float c = kUpfA[rho][tap][x];
          if (c != 0.0f) v = __fadd_rn(v, __fmul_rn(c, wt(x)));
        }
      } else if (tap == 3) {
        v = rho == 0 ? __fmul_rn(0.25f, __fsub_rn(wt(1), wt(0))) : __fmul_rn(0.25f, wt(0));
      } else {
        v = rho == 0 ? __fmul_rn(0.25f, wt(2)) : __fmul_rn(0.25f, __fsub_rn(wt(1), wt(2)));
      }
    }
  }
  if constexpr (F32) {
    const float hi = tf32_bits(v);
    static_cast<float*>(out)[idx] = plane ? tf32_bits(__fsub_rn(v, hi)) : hi;
  } else {
    static_cast<__nv_bfloat16*>(out)[idx] = __float2bfloat16_rn(v);
  }
}

}  // namespace

// Every entry point without _f32 takes, beside its tensors: q (0 bfloat16,
// 1 int8); in int8 mode in_i8 (x holds int8 codes), ax (device pointer to
// x's float32 calibrated |x| maximum), scale (n_out float32, the int32 sum's
// dequantisation, 127/ax_out folded in when out_i8) and out_i8 (store int8
// instead of bf16). wfrag holds bf16 or int8 weights in the layout of
// conv_sm90.cuh for chunks of cchunk channels and blocks of n_tiles*8 output
// channels (n_tiles in {1, 2, 4, 8, 16}); bias is float32.
extern "C" {

// Shared memory one block needs, in bytes (also computed by the Python
// planner, which checks that the two agree); K7 and K8 share a layout but
// for K7's resident weights. res_chunks: K7's channel chunks where all
// output channels are one block, else 0.
long long rrin_conv_up_sm90_smem(int k, int cchunk, int n_tiles, int q, int folded,
                                 int res_chunks) {
  return make_layout(k, cchunk, n_tiles * 8, q, folded, res_chunks).total;
}

// x: (B,2H,2W,c) full resolution; out: (B,H,W,cout) = conv_k(avg_pool_2x(x)),
// k in {3, 5}; wfrag in K8's layout (the conv's own weights).
int rrin_conv_pool_packed_launch(const void* x, int c, int in_i8, const void* ax,
                                 const void* wfrag, const void* bias, const void* scale,
                                 void* out, int out_i8, int B, int H, int W, int cout, int k,
                                 int cchunk, int n_tiles, int has_slope, float slope, int q,
                                 void* stream) {
  return launch_mode<POOL>(up_args(x, c, in_i8, ax, wfrag, bias, scale, out, out_i8, H, W,
                                   2 * H, 2 * W, cout, k, cchunk, has_slope, slope),
                           B, n_tiles, q, stream);
}

// x: (B,Hs,Ws,c) half resolution; out: (B,2Hs,2Ws,cout) =
// conv_k(upsample_2x_bilinear(x)), k in {3, 5}.
int rrin_conv_up_m_packed_launch(const void* x, int c, int in_i8, const void* ax,
                                 const void* wfrag, const void* bias, const void* scale,
                                 void* out, int out_i8, int B, int Hs, int Ws, int cout,
                                 int k, int cchunk, int n_tiles, int has_slope, float slope,
                                 int q, void* stream) {
  return launch_mode<UP>(up_args(x, c, in_i8, ax, wfrag, bias, scale, out, out_i8, 2 * Hs,
                                 2 * Ws, Hs, Ws, cout, k, cchunk, has_slope, slope),
                         B, n_tiles, q, stream);
}

// float32: x (B,Hs,Ws,c), out (B,2Hs,2Ws,cout), as conv_up_f_packed; wfrag
// holds the folded weights in the float32 layout (two TF32 planes) for
// n_tiles in {1, 2, 4, 8}, bias is 2*cout long.
int rrin_conv_up_f_packed_f32_launch(const void* x, int c, const void* wfrag, const void* bias,
                                     void* out, int B, int Hs, int Ws, int cout, int cchunk,
                                     int n_tiles, int has_slope, float slope, void* stream) {
  UpArgs a = up_args(x, c, 0, nullptr, wfrag, bias, nullptr, out, 0, 2 * Hs, Ws, Hs, Ws,
                     2 * cout, 3, cchunk, has_slope, slope);
  a.promote = g_f32_promote;
  return launch_mode<UPF>(a, B, n_tiles, F32, stream);
}

// float32: x (B,2H,2W,c) full resolution, out (B,H,W,cout) =
// conv_k(avg_pool_2x(x)), k in {3, 5}; wfrag holds the conv's own weights in
// the float32 layout (two TF32 planes) for n_tiles in {1, 2, 4, 8}.
int rrin_conv_pool_packed_f32_launch(const void* x, int c, const void* wfrag,
                                     const void* bias, void* out, int B, int H, int W,
                                     int cout, int k, int cchunk, int n_tiles, int has_slope,
                                     float slope, void* stream) {
  UpArgs a = up_args(x, c, 0, nullptr, wfrag, bias, nullptr, out, 0, H, W, 2 * H, 2 * W, cout,
                     k, cchunk, has_slope, slope);
  a.promote = g_f32_promote;
  return launch_mode<POOL>(a, B, n_tiles, F32, stream);
}

// float32: x (B,Hs,Ws,c) half resolution, out (B,2Hs,2Ws,cout) =
// conv_k(upsample_2x_bilinear(x)), H interpolated first, k in {3, 5};
// wfrag as rrin_conv_pool_packed_f32_launch's.
int rrin_conv_up_m_packed_f32_launch(const void* x, int c, const void* wfrag,
                                     const void* bias, void* out, int B, int Hs, int Ws,
                                     int cout, int k, int cchunk, int n_tiles, int has_slope,
                                     float slope, void* stream) {
  UpArgs a = up_args(x, c, 0, nullptr, wfrag, bias, nullptr, out, 0, 2 * Hs, 2 * Ws, Hs, Ws,
                     cout, k, cchunk, has_slope, slope);
  a.promote = g_f32_promote;
  return launch_mode<UP>(a, B, n_tiles, F32, stream);
}

// Set the float32 promotion interval of this library's later launches (K7,
// K8 and K9; conv_packed_sm90.cu has its own for K5 and K6); returns the one
// it replaces.
int rrin_conv_f32_promotion(int k_steps) { return set_f32_promotion(k_steps); }

// x: (B,Hs,Ws,c) half resolution; out: (B,2Hs,2Ws,cout) =
// conv_3(upsample_2x_bilinear(x)); wfrag holds the folded weights with five
// taps per dy row and 2*cout output channels, bias (and scale) are 2*cout
// long (see conv_sm90.cuh).
int rrin_conv_up_f_packed_launch(const void* x, int c, int in_i8, const void* ax,
                                 const void* wfrag, const void* bias, const void* scale,
                                 void* out, int out_i8, int B, int Hs, int Ws, int cout,
                                 int cchunk, int n_tiles, int has_slope, float slope, int q,
                                 void* stream) {
  return launch_mode<UPF>(up_args(x, c, in_i8, ax, wfrag, bias, scale, out, out_i8, 2 * Hs,
                                  Ws, Hs, Ws, 2 * cout, 3, cchunk, has_slope, slope),
                          B, n_tiles, q, stream);
}

// w: float32 (k, k, cin, cout), contiguous, cin the sum of the n_ops
// operands' channels cins[i] (n_ops > 1 only unfolded); out: the bf16
// layout of conv_sm90.cuh for (cchunk, n_tiles), or with f32 its float32
// layout (two TF32 planes), each operand's channels padded to
// whole chunks, folded (k = 3, five taps, 2*cout output channels) when
// `folded`, and then bias_out (2*cout float32) the float32 bias (cout)
// repeated; bias and bias_out are unused otherwise.
int rrin_conv_up_prep_launch(const void* w, const void* bias, void* out, void* bias_out, int k,
                             const int* cins, int n_ops, int cout, int cchunk, int n_tiles,
                             int folded, int f32, void* stream) {
  const int kk = f32 ? 8 : 16;
  if (k < 1 || n_ops < 1 || n_ops > MAX_OPS || cout < 1 || cchunk < kk || cchunk % kk ||
      n_tiles < 1 || (folded && (k != 3 || n_ops != 1 || !bias || !bias_out)))
    return kInvalid;
  Cins c = {};
  c.n = n_ops;
  int cin = 0, n_chunks = 0;
  for (int i = 0; i < n_ops; ++i) {
    if (cins[i] < 1) return kInvalid;
    c.c[i] = cins[i];
    cin += cins[i];
    n_chunks += (cins[i] + cchunk - 1) / cchunk;
  }
  const int n_out = folded ? 2 * cout : cout;
  const int n_cb = (n_out + n_tiles * 8 - 1) / (n_tiles * 8);
  const long long total = static_cast<long long>(n_cb) * n_chunks * k * (folded ? 5 : k) *
                          cchunk * n_tiles * 8 * (f32 ? 2 : 1);  // >= 2*cout
  if (total > 0x7fffffffLL) return kInvalid;
  const unsigned blocks = static_cast<unsigned>((total + 255) / 256);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* b = static_cast<const float*>(bias);
  float* bo = static_cast<float*>(bias_out);
  if (f32)
    conv_up_prep_kernel<true><<<blocks, 256, 0, s>>>(wf, b, out, bo, k, c, cin, cout, cchunk,
                                                     n_tiles, n_chunks, folded,
                                                     static_cast<int>(total));
  else
    conv_up_prep_kernel<false><<<blocks, 256, 0, s>>>(wf, b, out, bo, k, c, cin, cout, cchunk,
                                                      n_tiles, n_chunks, folded,
                                                      static_cast<int>(total));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
