// K5 and K6 of the packed serving path on Hopper (sm_90a), in bfloat16, int8
// and float32 (3xTF32, the _f32 entry points), as the producer modes DIRECT
// and UPW of the wgmma core in conv_sm90.cuh (its head gives the design), and
// K1 of the plain path as DIRECT with one bf16 operand (k 3, 5, 7) or as the
// core's streamed mode (every other odd k).
//
//   conv_packed     replaces _kernel_body (rrin_tpu/ops/conv_packed.py,
//                   pallas_call at :506): stride-1 SAME conv over the channel
//                   concat of 1..4 operands given separately, k in {3, 5,
//                   7}; the K-loop walks the operands chunk by chunk, so the
//                   concat never exists in device memory. In int8 an operand
//                   is int8 on its grid already (copied as it is) or bf16
//                   (quantised by 127/ax as it is stored), and the weights
//                   are int8 per output channel, pre-scaled per operand on
//                   the host, so that one int32 sum serves all operands.
//   conv_up_packed  replaces _kernel_body_up (pallas_call at :824):
//                   conv(upsample_2x_bilinear(x)) from the half-resolution
//                   tensor, k in {1, 3, 5}, the upsampled halo tile built W
//                   first, then H, as the reference's upsample_2x_packed
//                   rounds; in int8 an int8 input is dequantised (times
//                   ax/127) before it is interpolated and the value
//                   quantised after, as the reference's plain version does.
//   conv_phase_sm90 replaces _phase_kernel (rrin_tpu/ops/conv_phase.py,
//                   pallas_call at :164) at every odd k it is given: the same
//                   conv of one bf16 operand, + float32 bias + optional
//                   LeakyReLU on a float32 sum, rounded once to bf16, which
//                   is what K5 computes for one operand; k in {3, 5, 7} on
//                   DIRECT itself, any other odd k on the streamed mode
//                   (DIRECT's walk at runtime k over the blocks of at most
//                   13 x 13 taps that the stencil is split into, the weights
//                   streamed one dy row of a block a stage). Its sites (the plain U-Net's convs with
//                   cout <= 64) take the pooled, upsampled or concatenated
//                   tensor that the plain path materialises, and the stems'
//                   cin 6/9/10/16, which DIRECT gathers. Its weights are laid
//                   out by the prep kernel in K5's layout.
//
// What bounds them on an H100: operations. K5 does 988 GFLOP in the 14
// launches of one flow U-Net at 1088x1920 (0.999 ms at 989 TFLOP/s bf16),
// most of it at full and half resolution with N = 32 or 64 output channels,
// where the ldmatrix reads of A cost about as much shared-memory bandwidth
// as the tensor work; the head (cout 4), u4c2 and the cin-6 stem are
// bytes-bound (the stems' channels are padded to a chunk of 16 or 32 in the
// tensor work). K6 does 305 GFLOP at each of its two 4K sites (0.309 ms).
// In float32 the same work is bound at 165 TFLOP/s (three TF32 products per
// product at the 495 TFLOP/s TF32 peak): about 5.5 ms for K5's flow U-Net,
// 1.85 ms at each K6 site; halo and weight bytes double (weights quadruple), so
// the chunks are 8-16 channels and N <= 64. K1 at k 9, the stems of the
// stem_kernel = 9 cascade: 2 * 81 * cin * cout multiply-adds a pixel, bound by
// operations as at k 7, as are the wider k (k 99 at cin 16, cout 64: 9801
// x 16 x 64 multiply-adds a pixel).
//
// Plain C entry points; each returns cudaGetLastError() after the launch,
// runs on the given stream, allocates nothing and does not synchronise.

#include "conv_sm90.cuh"

namespace {

// The streamed mode: a.ops[0] the one bf16 operand, any odd k (a tile stores
// TW - (b - 1) columns, b <= STREAM_D the widest block of k's split), N = 8
// * n_tiles up to 64.
int launch_stream(UpArgs a, int B, int n_tiles, void* stream) {
  if (B <= 0 || a.H <= 0 || a.W <= 0) return 0;
  const Operand& o = a.ops[0];
  if (a.k < 1 || a.k % 2 == 0 || a.cchunk < 16 || a.cchunk % 16 ||
      (a.cchunk & (a.cchunk - 1)) || a.cchunk > 128 || a.n_out < 1 || o.c < 1 || o.cs < o.c)
    return kInvalid;
  a.n_ops = 1;
  a.ops[0].chunk0 = 0;
  a.n_chunks = (o.c + a.cchunk - 1) / a.cchunk;
  a.ntaps = a.k;
  a.n_cb = (a.n_out + n_tiles * 8 - 1) / (n_tiles * 8);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_tiles) {
    case 1: return launch_stream_one<8>(a, B, s);
    case 2: return launch_stream_one<16>(a, B, s);
    case 4: return launch_stream_one<32>(a, B, s);
    case 8: return launch_stream_one<64>(a, B, s);
  }
  return kInvalid;
}

}  // namespace

// Every bf16/int8 entry point takes, beside its tensors: q (0 bfloat16, 1 int8); in
// int8 mode in_i8 (the operand holds int8 codes), ax (device pointer to the
// operand's float32 calibrated |x| maximum), scale (cout float32, the int32
// sum's dequantisation, 127/ax_out folded in when out_i8) and out_i8 (store
// int8 instead of bf16). wfrag holds bf16 or int8 weights in the layout of
// conv_sm90.cuh for chunks of cchunk channels (each operand's channels padded
// to whole chunks) and blocks of n_tiles*8 output channels (n_tiles in {1, 2,
// 4, 8, 16}); bias is float32.
extern "C" {

// Shared memory one block needs, in bytes (also computed by the Python
// planner, which checks that the two agree). et: 0 bfloat16, 1 int8, 2
// float32; res_chunks: K5's channel chunks (over all operands) where all
// output channels are one block, else 0.
long long rrin_conv_packed_sm90_smem(int k, int cchunk, int n_tiles, int et, int res_chunks) {
  return make_layout(k, cchunk, n_tiles * 8, et, 0, res_chunks).total;
}

// The same for K1's streamed mode (bf16, the k other than 3, 5 and 7).
long long rrin_conv_stream_sm90_smem(int k, int cchunk, int n_tiles) {
  return make_layout_stream(k, cchunk, n_tiles * 8).total;
}

// The streamed mode's split of a k x k stencil along each axis (the Python
// planner checks that it agrees): writes the tap origin and size of each of
// its blocks, at most max_blocks, and returns how many it has.
int rrin_conv_stream_sm90_blocks(int k, int* origins, int* sizes, int max_blocks) {
  if (k < 1) return 0;
  const StreamSplit sp = stream_split(k);
  for (int i = 0; i < sp.n && i < max_blocks; ++i) {
    origins[i] = sp.origin(i);
    sizes[i] = sp.size(i);
  }
  return sp.n;
}

// xs: n_ops pointers to (B,H,W,strides[i]) NHWC tensors of which the first
// cs[i] channels enter the conv, in order; out: (B,H,W,cout).
int rrin_conv_packed_launch(const void* const* xs, const int* cs, const int* strides,
                            const int* in_i8, const void* const* ax, int n_ops,
                            const void* wfrag, const void* bias, const void* scale, void* out,
                            int out_i8, int B, int H, int W, int cout, int k, int cchunk,
                            int n_tiles, int has_slope, float slope, int q, void* stream) {
  if (n_ops < 1 || n_ops > MAX_OPS) return kInvalid;
  UpArgs a = up_args(nullptr, 0, 0, nullptr, wfrag, bias, scale, out, out_i8, H, W, H, W, cout,
                     k, cchunk, has_slope, slope);
  a.n_ops = n_ops;
  for (int i = 0; i < n_ops; ++i)
    a.ops[i] = Operand{xs[i], cs[i], strides[i], in_i8[i], static_cast<const float*>(ax[i]), 0};
  return launch_mode<DIRECT>(a, B, n_tiles, q, stream);
}

// float32 operands and output: xs, cs and strides as above; wfrag holds the
// float32 layout (two TF32 planes) for n_tiles in {1, 2, 4, 8}.
int rrin_conv_packed_f32_launch(const void* const* xs, const int* cs, const int* strides,
                                int n_ops, const void* wfrag, const void* bias, void* out,
                                int B, int H, int W, int cout, int k, int cchunk, int n_tiles,
                                int has_slope, float slope, void* stream) {
  if (n_ops < 1 || n_ops > MAX_OPS) return kInvalid;
  UpArgs a = up_args(nullptr, 0, 0, nullptr, wfrag, bias, nullptr, out, 0, H, W, H, W, cout, k,
                     cchunk, has_slope, slope);
  a.n_ops = n_ops;
  a.promote = g_f32_promote;
  for (int i = 0; i < n_ops; ++i) a.ops[i] = Operand{xs[i], cs[i], strides[i], 0, nullptr, 0};
  return launch_mode<DIRECT>(a, B, n_tiles, F32, stream);
}

// float32: x (B,Hs,Ws,c), out (B,2Hs,2Ws,cout), as conv_up_packed.
int rrin_conv_up_packed_f32_launch(const void* x, int c, const void* wfrag, const void* bias,
                                   void* out, int B, int Hs, int Ws, int cout, int k,
                                   int cchunk, int n_tiles, int has_slope, float slope,
                                   void* stream) {
  UpArgs a = up_args(x, c, 0, nullptr, wfrag, bias, nullptr, out, 0, 2 * Hs, 2 * Ws, Hs, Ws,
                     cout, k, cchunk, has_slope, slope);
  a.promote = g_f32_promote;
  return launch_mode<UPW>(a, B, n_tiles, F32, stream);
}

// Set the float32 promotion interval of this library's later launches (at
// most k_steps k-steps, as whole slabs of k; below k: every k-step); returns
// the one it replaces.
int rrin_conv_f32_promotion(int k_steps) { return set_f32_promotion(k_steps); }

// K1: x (B,H,W,cs) bf16, of which the first c channels enter the conv; out
// (B,H,W,cout) bf16; wfrag in conv_packed's layout for one operand (bf16),
// any odd k: DIRECT at k in {3, 5, 7}, the streamed mode at the others
// (n_tiles in {1, 2, 4, 8} there).
int rrin_conv_phase_sm90_launch(const void* x, int c, int cs, const void* wfrag,
                                const void* bias, void* out, int B, int H, int W, int cout,
                                int k, int cchunk, int n_tiles, int has_slope, float slope,
                                void* stream) {
  UpArgs a = up_args(nullptr, 0, 0, nullptr, wfrag, bias, nullptr, out, 0, H, W, H, W, cout, k,
                     cchunk, has_slope, slope);
  a.n_ops = 1;
  a.ops[0] = Operand{x, c, cs, 0, nullptr, 0};
  if (built_for(DIRECT, k)) return launch_mode<DIRECT>(a, B, n_tiles, BF16, stream);
  return launch_stream(a, B, n_tiles, stream);
}

// x: (B,Hs,Ws,c) half resolution; out: (B,2Hs,2Ws,cout) =
// conv_k(upsample_2x_bilinear(x)), k in {1, 3, 5}, W interpolated first.
int rrin_conv_up_packed_launch(const void* x, int c, int in_i8, const void* ax,
                               const void* wfrag, const void* bias, const void* scale,
                               void* out, int out_i8, int B, int Hs, int Ws, int cout, int k,
                               int cchunk, int n_tiles, int has_slope, float slope, int q,
                               void* stream) {
  return launch_mode<UPW>(up_args(x, c, in_i8, ax, wfrag, bias, scale, out, out_i8, 2 * Hs,
                                  2 * Ws, Hs, Ws, cout, k, cchunk, has_slope, slope),
                          B, n_tiles, q, stream);
}

}  // extern "C"
