// The Hopper (sm_90a) core of the packed serving path's convolutions:
// conv(load(x)) + bias + an optional LeakyReLU on NHWC tensors, in bfloat16,
// int8 or float32, on wgmma, with five producer modes that differ only in
// how they build the halo tile of a channel chunk:
//
//   POOL    (K7)  the 2x2 mean of the full-resolution tensor;
//   UP      (K8)  the 2x bilinear upsample of the half-resolution tensor, H
//                 interpolated first, then W (int8: on the codes);
//   UPF     (K9)  the H-interpolated rows only, at half width (the
//                 W-upsample is folded into the weights);
//   UPW     (K6)  the 2x bilinear upsample, W first, then H (int8: an int8
//                 input is dequantised first, the value quantised after);
//   DIRECT  (K5)  the stored pixels of 1..4 operands, chunk by chunk (a chunk
//                 never straddles two operands, so the channel concat never
//                 exists in device memory), zero outside the image; with one
//                 bf16 operand also K1 (conv2d_fused of the plain path) at
//                 k 3, 5 and 7.
//
// K1 at every other odd k (1, 9, 11, ...: ModelConfig's stem_kernel and
// down_kernels may ask for any) runs a sixth kernel, the streamed mode
// (conv_stream_sm90_kernel, bf16, one operand): DIRECT's halo builder and
// consumer walk with k a runtime argument, so that it is instantiated once
// per N and not per k, and with the weights streamed. The k x k stencil is
// split into blocks of at most STREAM_D x STREAM_D taps (stream_split: n =
// ceil(k / STREAM_D) blocks a side, balanced; one block up to k = 13), and
// the conv is the sum of the convs by its blocks: block (by, bx) reads the
// input shifted by its tap origin. The kernel walks (channel chunk, block)
// pairs; each pair has a halo tile of TH + b - 1 rows at the block's origin
// (one or two buffers), and each of the block's dy rows is a pipeline stage,
// its b taps x cchunk x N weights one contiguous cp.async.bulk into a ring
// of two slabs. A stage is then a conv with one row of taps over the halo
// shifted by dy rows, which is the k = 1 walk of DIRECT's consumer
// (mma_rows<0, MT, 1>): a halo row feeds one wgmma, not up to k. Every pair
// accumulates into the same registers. Halo rows keep their 64 columns, so
// a tile stores 64 - (b - 1) of them, b the widest block (52 to 57 from k =
// 13 on), and no shared-memory extent grows with k beyond the block.
//
// conv_up_sm90.cu holds the entry points of POOL, UP and UPF and the weight
// prep; conv_packed_sm90.cu those of DIRECT (K5, K1), UPW and the streamed
// mode. Two files, built in parallel, because the template instantiations of
// all five modes in one take twice as long to compile.
//
// The design:
//
//   * wgmma: a tile is TH rows x 64 columns of GEMM pixels and N output
//     channels (all of a site's channels up to 128, so each halo tile is
//     built once). Two consumer warpgroups each own MT = TH/2 rows;
//     one row of 64 pixels is the M of one wgmma.mma_async m64nNk16 (bf16,
//     f32 sums) or m64nNk32 (s8, s32 sums). The last k - 1 columns of a row
//     are not stored (the next tile starts there), so the halo tile is 64
//     columns wide. A comes from registers: ldmatrix.x4 from the halo tile,
//     whose pixels are padded by 16 bytes so that the eight rows of a matrix
//     fall on distinct banks; a tap shift (dy, dx) is an address offset, and
//     one halo row loaded for (dx, k-step) feeds the wgmma of every output
//     row it reaches (up to k dy taps), which cuts the A reads from shared
//     memory by a third (MT = 2) or a half (MT = 4), more at k = 7. One
//     32-byte k-step is 16 bf16 or 32 int8 values, so both element types
//     share the layout and the addressing. B (the weights) comes from shared
//     memory through a descriptor, K-major, no swizzle: core matrices of 8
//     channels-out x 16 bytes, 128 bytes apart along K (LBO) and 256 bytes
//     apart along N (SBO).
//   * a producer/consumer pipeline inside the block (warp specialisation):
//     a producer warpgroup builds the next channel chunks' halo tiles into a
//     ring of three buffers (two where three do not fit) while the consumers
//     run wgmma on the current one, and one producer thread brings each
//     chunk's weights by cp.async.bulk (one contiguous copy per dy row).
//     The resampling modes compute their halo (arithmetic, which a copy
//     engine cannot do): a producer thread builds whole halo columns, loads
//     every stored pixel a column (K7: a batch of its rows) reads, all in
//     flight at once, and writes the column's rows from registers, so each
//     stored value is loaded once per column. DIRECT copies: 16-byte (bf16)
//     or 8-byte (int8 codes) cp.async, zero-filled outside the image through
//     the source size, completed on the buffer's mbarrier by
//     cp.async.mbarrier.arrive.noinc, so a producer thread issues the next
//     chunk's copies without waiting for the last; a bf16 operand of an int8
//     conv is quantised as it is stored, and an operand whose channels or
//     pixel stride are no multiple of 8 (the stems, cin 6/9/10) is gathered
//     a channel at a time and zero-padded to the chunk. Completion is on
//     mbarriers: full[b] (128 producer arrivals plus the copy's bytes),
//     empty[b] (one arrival per consumer warp). setmaxnreg moves registers
//     from the producers to the consumers.
//   * persistent blocks: one block per multiprocessor walks the tiles, so a
//     tile's epilogue overlaps the producer's work on the next tile.
//   * the folded kernel's edge taps: only tiles that hold half-column 0 or
//     Ws-1 have them, and there the producers compute the edge pixel's
//     products with taps 3 and 4 from the halo tile they built (float32
//     sums of bf16 products, exact int32 sums, or in float32 float32
//     products with the weight's hi + lo, which is exact) into shared
//     memory; the consumers add them to the accumulators of that pixel. Both
//     edge terms share the stencil's per-channel int8 scale.
//   * the epilogue adds the bias (int8: after the scale), applies the
//     LeakyReLU, rounds once (bf16, or rint and a clip to the int8 grid; a
//     float32 output is stored as it is) and stages each 64-pixel row in
//     shared memory, from which the warpgroup stores it with 16-byte
//     coalesced stores. Ragged edges are masked; nothing assumes W % 64,
//     H % TH or n_out % N.
//   * float32 (element type F32, every mode): the halo tile holds float32
//     values as they are (a 32-byte k-step is 8
//     channels, so the ldmatrix addressing is the bf16 one and each 32-bit
//     word of a matrix row one channel, which is the tf32 A fragment of
//     wgmma m64nNk8); the weights arrive as two planes, hi = rna_tf32(w) and
//     lo = rna_tf32(w - hi), each a whole B tile of the bf16 geometry (8
//     channels-out x 16 bytes = 4 channels-in per core matrix). The
//     consumers split each A fragment the same way and issue lo_a*hi_b +
//     hi_a*lo_b + hi_a*hi_b ("3xTF32": about 2^-22 of each product is lost).
//     Promotion rule: the tensor cores add to their accumulator by
//     truncation, so products are summed there only over at most 9 k-steps
//     of an output row (whole (dx, k-step) slabs), from zero, into a second
//     set of registers, which is then added to the float32 accumulator with
//     round to nearest (consume_f32; a whole tile was 5x the 1e-5 bar at
//     K = 4608 on an H100, 9 k-steps as good as 1). The two sets take MT x N registers a thread, so N <= 64
//     and MT x N <= 128 (mt_of); halo, weights and staged row take twice
//     (weights four times) the bf16 bytes, so chunks are thinner (8
//     channels at every model site). Each mode has a float32 halo builder
//     that rounds as its plain version: K7 pools item by item (four
//     channels of a pooled value, four 16-byte loads, so that every
//     producer thread works, where a column walk would leave half of them
//     idle at 8-channel chunks); K6, K8 and K9 walk columns, K8 with two
//     threads a column, streaming its stored rows through the registers
//     (k = 5 reads eight, 128 floats). K7-K9 walk the channel blocks of a
//     spatial tile as consecutive tiles (cb_inner), so that a halo that two
//     blocks build is read from device memory once.
//
// The weights arrive in the layout the descriptor reads:
// [channel block][chunk][dy][tap][k-step][n-tile][r][g][16 bytes], with the
// 16 bytes holding channels-in 8r .. 8r+7 (bf16), 16r .. 16r+15 (int8) or
// 4r .. 4r+3 (float32) of the k-step for channel-out n-tile*8 + g (float32:
// [k-step][plane][n-tile]..., the lo plane one B tile after the hi plane);
// chunks run operand by operand,
// each operand's channels zero-padded to a whole chunk; the folded kernel's
// rows hold five taps (three stencil taps, then the two edge taps), of which
// only the stencil taps are copied. conv_up_prep_kernel (conv_up_sm90.cu)
// writes the bf16 or float32 layout from the model's float32 (k, k, cin,
// cout) weights in one launch, K9's fold included.
//
// Rounding points are those of the plain versions: a resampled value in
// float32 from separately rounded products and sums, one bf16 rounding (or,
// int8, rint on the grid: a bf16 input is scaled by 127/ax before the
// H-interpolation in K9 and quantised after the pool in K7, the
// interpolation in K8 and K6, and as it is stored in K5; int8 codes are
// pooled or interpolated as they are and re-rounded in K7 and K8,
// dequantised by ax/127 before K6 interpolates, copied as they are in K5).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "conv_prologue.cuh"

namespace {

constexpr int TW = 64;           // GEMM pixels per block row = M of one wgmma
constexpr int PAD_BYTES = 16;    // padding per halo pixel and per staged row
constexpr int NPROD = 128;       // the producer warpgroup
constexpr int NCONS = 2;         // consumer warpgroups
constexpr int THREADS = NPROD + NCONS * 128;
// setmaxnreg moves registers inside the block's allocation, which is the
// 168 a thread (65536 / 384, rounded down to 8) that ptxas gives a 384-thread
// block at launch: the warpgroups' new counts must sum to 3 x 168, or the
// consumers' increase waits forever.
constexpr int LAUNCH_REGS = 168;
constexpr int PROD_REGS = 136;
constexpr int CONS_REGS = 184;
static_assert(NPROD / 128 * PROD_REGS + NCONS * CONS_REGS == THREADS / 128 * LAUNCH_REGS,
              "setmaxnreg counts must sum to the block's allocation");
constexpr int SMEM_MAX = 232448;

enum Mode { UP = 0, UPF = 1, POOL = 2, UPW = 3, DIRECT = 4 };

// Element types of the operands: bfloat16 (float32 sums), int8 (int32 sums),
// float32 (3xTF32, float32 sums).
enum Elem { BF16 = 0, I8 = 1, F32 = 2 };

constexpr int MAX_OPS = 4;      // operands of one DIRECT conv

// Rows of GEMM pixels per consumer warpgroup: its accumulators hold MT x N/2
// registers a thread; in float32 as many again hold the products not yet
// promoted (consume_f32), so MT x N <= 128 there, and at k = 7, whose
// weights take N = 16 at most, six rows (each halo row loaded once feeds up
// to seven output rows; eight do not fit shared memory).
__host__ __device__ constexpr int mt_of(int n, int et, int k) {
  return et == F32 ? (n <= 16 && k == 7 ? 6 : (n <= 32 ? 4 : 2)) : (n <= 64 ? 4 : 2);
}

// The block's shared memory: nbuf buffers (three where they fit, else two),
// each a halo tile and, unless the weights are resident, the chunk's
// weights; the resident weights (every chunk's, loaded once per block);
// each consumer warpgroup's staged output row; the bias and scale of the
// tile's output channels; the folded kernel's edge sums, two tiles' worth;
// mbarriers full[3], empty[3], edge_empty[2], weights_resident.
//
// A halo row is TW = 64 columns: the wgmma rows past the tw stored columns
// read k - 1 columns more, which come from the next halo row (or the region
// after the last one); no stored pixel depends on them.
struct Layout {
  int hh, hw, pstride;   // halo rows, columns, bytes per pixel
  int halo_bytes;        // rounded up to 128
  int w_bytes;           // one chunk's stencil weights
  int buf_bytes;
  int wres;              // weights resident: every chunk's, at wres_off
  int stage_bytes;       // one consumer warpgroup's staged row
  int nbuf;
  int wres_off, stage_off, bs_off, edge_off, bar_off, total;
  int slab_off;          // the streamed mode: its ring of two weight slabs
};

constexpr int NBARS = 9;

__host__ __device__ inline int up128(int b) { return (b + 127) / 128 * 128; }

__host__ __device__ inline Layout make_layout_n(int k, int cchunk, int n, int et, int folded,
                                               int nbuf, int res_chunks) {
  Layout L;
  const int es = et == I8 ? 1 : (et == F32 ? 4 : 2);  // a halo element
  const int wes = et == F32 ? 8 : es;                 // a weight: float32, two TF32 planes
  const int oes = et == F32 ? 4 : 2;                  // a staged output element
  const int th = NCONS * mt_of(n, et, k);
  L.hh = th + k - 1;
  L.hw = TW;
  L.pstride = cchunk * es + PAD_BYTES;
  L.halo_bytes = up128(L.hh * L.hw * L.pstride);
  L.w_bytes = k * k * cchunk * n * wes;
  L.wres = res_chunks > 0;
  L.buf_bytes = L.halo_bytes + (L.wres ? 0 : L.w_bytes);
  L.stage_bytes = up128(TW * (oes * n + PAD_BYTES));
  L.nbuf = nbuf;
  L.wres_off = nbuf * L.buf_bytes;
  L.stage_off = L.wres_off + (L.wres ? res_chunks * L.w_bytes : 0);
  L.bs_off = L.stage_off + NCONS * L.stage_bytes;
  L.edge_off = L.bs_off + 2 * n * 4;
  L.bar_off = L.edge_off + (folded ? 2 * 2 * th * n * 4 : 0);
  L.total = L.bar_off + NBARS * 8;
  return L;
}

// Three buffers that hold their chunk's weights where they fit; else, for
// K7 where the block's tiles share one channel block (res_chunks = its
// chunks, 0 otherwise), three halo buffers beside resident weights where
// those fit; else two buffers with their weights.
__host__ __device__ inline Layout make_layout(int k, int cchunk, int n, int et, int folded,
                                              int res_chunks) {
  const Layout L3 = make_layout_n(k, cchunk, n, et, folded, 3, 0);
  if (L3.total <= SMEM_MAX) return L3;
  if (res_chunks > 0) {
    const Layout R3 = make_layout_n(k, cchunk, n, et, folded, 3, res_chunks);
    if (R3.total <= SMEM_MAX) return R3;
  }
  return make_layout_n(k, cchunk, n, et, folded, 2, 0);
}

// The streamed mode's stencil split (conv_packed._stream_blocks): along each
// axis n = ceil(k / STREAM_D) blocks, block i of size(i) taps from tap
// origin(i), the sizes k / n or one more (the larger first).
constexpr int STREAM_D = 13;

struct StreamSplit {
  int n, base, rem;
  __host__ __device__ int size(int i) const { return base + (i < rem); }
  __host__ __device__ int origin(int i) const { return i * base + (i < rem ? i : rem); }
  __host__ __device__ int widest() const { return base + (rem > 0); }
};

__host__ __device__ inline StreamSplit stream_split(int k) {
  StreamSplit s;
  s.n = (k + STREAM_D - 1) / STREAM_D;
  s.base = k / s.n;
  s.rem = k % s.n;
  return s;
}

// The streamed mode (bf16, one operand, any odd k), sized by the widest
// block b of k's split (b = k up to 13): two halo buffers of TH + b - 1
// rows where they fit, else one; then the ring of two slabs (one dy row of
// a block's weights each: b taps x cchunk x N); the staged rows, bias and
// scale as make_layout_n; mbarriers hfull[2], hempty[2], wfull[2],
// wempty[2] (StreamBars). A wgmma row reads up to b - 1 pixels past the
// last halo row of a buffer, which land in the slabs (at most (b - 1) x
// pstride bytes, less than one slab) and feed only columns that are not
// stored.
__host__ __device__ inline Layout make_layout_stream(int k, int cchunk, int n) {
  const int b = stream_split(k).widest();
  Layout L = make_layout_n(b, cchunk, n, BF16, 0, 2, 0);
  L.w_bytes = b * cchunk * n * 2;
  L.buf_bytes = L.halo_bytes;
  for (int nbuf = 2; nbuf >= 1; --nbuf) {  // one buffer that does not fit: total says so
    L.nbuf = nbuf;
    L.slab_off = nbuf * L.halo_bytes;
    L.stage_off = L.slab_off + 2 * L.w_bytes;
    L.bs_off = L.stage_off + NCONS * L.stage_bytes;
    L.edge_off = L.bs_off + 2 * n * 4;
    L.bar_off = L.edge_off;
    L.total = L.bar_off + NBARS * 8;
    if (L.total <= SMEM_MAX) break;
  }
  return L;
}

// The streamed mode's mbarriers, at bar_off: hfull[b] (b < 2), hempty[b],
// wfull[s] (s < 2), wempty[s].
enum StreamBars { HFULL = 0, HEMPTY = 2, WFULL = 4, WEMPTY = 6 };

// One operand of a DIRECT conv: its first c channels enter the conv, cs
// is its pixel stride in elements; its chunks are chunk0, chunk0 + 1, ...
struct Operand {
  const void* x;
  int c, cs;
  int in_i8;                 // int8 mode: x holds int8 codes already
  const float* ax;           // int8 mode: x's calibrated |x| maximum
  int chunk0;
};

struct UpArgs {
  const void* x;             // the resampling modes' one input
  int cin;
  int in_i8;                 // int8 mode: x holds int8 codes already
  const float* ax;           // int8 mode: x's calibrated |x| maximum
  Operand ops[MAX_OPS];      // DIRECT: its operands (x, cin, in_i8, ax unused)
  int n_ops;
  const unsigned char* wb;   // weights in the layout above
  const float* bias;
  const float* scale;        // int8 mode: per output channel
  void* out;
  int out_i8;
  int H, W;                  // rows and columns of the GEMM's pixels
  int Hs, Ws;                // rows and columns of x (K7: 2H, 2W)
  int n_out;                 // channels per GEMM pixel of the output
  int k;                     // taps in y and in x
  int ntaps;                 // weight taps per dy row (k, or 5 when folded)
  int cchunk, n_chunks, n_cb;
  int tw;                       // GEMM columns a tile stores: TW - (k - 1)
                                // (streamed: TW - (b - 1), b its widest block)
  int tiles_x, tiles_y, tiles;  // the tiles that the persistent blocks walk
  int has_slope;
  float slope;
  int promote;               // float32: k-steps per promotion interval (consume_f32)
};

// float32: the longest promotion interval, in k-steps of 8 channels of one
// tap (consume_f32), that chip_smoke.py's probe found to hold the float32
// bar at d4c2 (K = 4608) and u1c2 on an H100: 0.43 of it, as at 1 k-step,
// against 5x the bar with no promotion before the end of the tile. Each
// library that includes this header has its own, read by its float32 entry
// points; its rrin_conv_f32_promotion changes it for a measurement.
int g_f32_promote = 9;

// Set this library's promotion interval; return the one it replaces.
inline int set_f32_promotion(int k_steps) {
  const int old = g_f32_promote;
  g_f32_promote = k_steps;
  return old;
}

// The chunks whose weights may stay resident: K7's and K5's, all of them,
// where the block's tiles share one channel block; none else. (K6, K8 and
// K9 keep the per-chunk copies: at their sites resident weights do not fit,
// and the branches cost K9 a fifth of its time at u3c1 on the H100.)
template <int MODE>
__host__ __device__ inline int resident_chunks(const UpArgs& a) {
  return (MODE == POOL || MODE == DIRECT) && a.n_cb == 1 ? a.n_chunks : 0;
}

// One tile: tw columns x TH rows of GEMM pixels of batch element b, output
// channels cb*N .. cb*N + N-1. The wgmma rows run over 64 columns, of which
// the last k - 1 are not stored, so that the halo tile that the producers
// build is exactly 64 columns wide. Tile t's channel block is its innermost
// index where `inner` (cb_inner below), else the outermost but b.
struct TileXY {
  int x0, y0, cb;
  size_t b;
};

__device__ __forceinline__ TileXY tile_of(const UpArgs& a, int t, int th, bool inner) {
  TileXY r;
  if (inner) {
    r.cb = t % a.n_cb;
    t /= a.n_cb;
  }
  r.x0 = (t % a.tiles_x) * a.tw;
  t /= a.tiles_x;
  r.y0 = (t % a.tiles_y) * th;
  t /= a.tiles_y;
  if (!inner) {
    r.cb = t % a.n_cb;
    t /= a.n_cb;
  }
  r.b = t;
  return r;
}

// Tile order: in float32 the resampling modes (K7-K9) walk the channel
// blocks of one spatial tile as consecutive tiles, so that the blocks that
// build the same halo tile run side by side and the second finds the input
// in L2 (their sites' inputs exceed it: K7's d1c1 reads 267 MB twice); with
// an even grid each block keeps one channel block. Elsewhere the channel
// block is the outer index.
template <int MODE, int ET>
__host__ __device__ constexpr bool cb_inner() {
  return ET == F32 && (MODE == POOL || MODE == UP || MODE == UPF);
}

// ------------------------------------------------------------ PTX wrappers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// Global -> shared copy of `bytes` (a multiple of 16) completing on `bar`.
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src, uint32_t bytes,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Global -> shared copy of BYTES (16 or 8) bytes, of which the first
// src_bytes are read and the rest zero-filled (src_bytes = 0: all zero).
template <int BYTES>
__device__ __forceinline__ void cp_async_zfill(void* dst, const void* src, uint32_t src_bytes) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_u32(dst)), "l"(src),
                 "r"(src_bytes)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;" ::"r"(smem_u32(dst)), "l"(src),
                 "r"(src_bytes)
                 : "memory");
}

// One arrival on `bar` once every cp.async that this thread issued before
// has landed; .noinc: the arrival is one of the count the barrier expects.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(PENDING) : "memory");
}

// Pin a register: its value is live (and may have changed) here, so the
// compiler neither moves its uses across this point nor reuses it before.
// Keeps a wgmma's A registers from being reallocated while the asynchronous
// product still reads them, and the accumulators from being read before
// wgmma.wait_group.
__device__ __forceinline__ void keep(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void keep(int& r) { asm volatile("" : "+r"(r)::"memory"); }
__device__ __forceinline__ void keep(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }

// K-major, no-swizzle shared-memory descriptor of a B tile: 16-byte-unit
// start address, LBO 128 bytes (the two core matrices of a k-step), SBO 256
// bytes (n-tile to n-tile).
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(256 >> 4) << 32);
}

// wgmma.mma_async with A from registers, D += A x B over one k-step, for
// each N this file instantiates: m64nNk16 bf16 -> f32 and m64nNk32 s8 -> s32.
// A (per warp, rows 16w .. 16w+15 of the 64): a0 = row g, bytes 4*tig .. +3
// of the first 16; a1 = row g+8, same; a2, a3 = the same rows, bytes 16+;
// D: d[4j + 2h + i] = row g + 8h, column 8j + 2*tig + i.

__device__ __forceinline__ void wgmma_rs(float (&d)[4], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(int (&d)[4], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 {"
      "%0, %1, %2, %3"
      "}, {%4, %5, %6, %7}, %8, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(int (&d)[8], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(int (&d)[16], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(int (&d)[32], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(int (&d)[64], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// wgmma.mma_async with tf32 A from registers, D = A x B (+ D unless
// scale_d is 0) over one k-step of 8 channels, m64nNk8 tf32 -> f32. The tf32
// form takes no transpose operands: B must be K-major, which b_desc's layout
// is (a core-matrix row is 16 bytes along K). A per warp: a0 = A[g][tig],
// a1 = A[g+8][tig], a2 = A[g][tig+4], a3 = A[g+8][tig+4], which is what
// ldmatrix.x4 gives from the halo tile's float32 pixels (each 32-bit word of
// a 16-byte matrix row one channel). D as the bf16 form.
__device__ __forceinline__ void wgmma_tf32(float (&d)[4], const uint32_t (&a)[4], uint64_t desc,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3"
      "}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[8], const uint32_t (&a)[4], uint64_t desc,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[16], const uint32_t (&a)[4], uint64_t desc,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4], uint64_t desc,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// x rounded to tf32 (nearest, ties away from zero), as a float32 bit pattern.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// clip(rint(v), +-127) as an int8 code in the low byte: clipped first (the
// same result for finite v), then rounded half to even by adding 1.5 * 2^23,
// whose float32 sum holds rint(v) in its low mantissa bits; full-rate float
// and integer instructions in place of a float-to-int conversion.
__device__ __forceinline__ uint32_t code8(float v) {
  const float c = fminf(fmaxf(v, -127.0f), 127.0f);
  return static_cast<uint32_t>(__float_as_int(__fadd_rn(c, 12582912.0f)) - 0x4B400000) & 0xffu;
}

// clip(rint(v * post), +-127) of eight values, packed as eight int8.
__device__ __forceinline__ uint2 codes8(const F8& f, float post) {
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int i = 0; i < 8; ++i) w[i >> 2] |= code8(__fmul_rn(f.v[i], post)) << (8 * (i & 3));
  return make_uint2(w[0], w[1]);
}

// One channel group of one halo column: the stored rows y0/2 - HB .. +NR-1
// (edge rows repeated, which is the upsample's clamp of its far tap) at the
// stored column(s) that the column interpolates, K9 its own, K6 and K8 the
// near and the far one; all loads in flight at once.
template <int MODE, int NR>
struct Column {
  static constexpr int NC = MODE == UPF ? 1 : 2;
  uint4 s[NR][NC];
};

// Eight channels of halo row r of a column, as float32, from its near (jn)
// and far (jf) stored rows: H-interpolated (K9); H-interpolated at both
// stored columns and then W-interpolated (K8); or W-interpolated in both
// stored rows and then H-interpolated (K6), as the plain versions round.
template <int MODE, bool Q, int NR>
__device__ __forceinline__ F8 column8(const Column<MODE, NR>& col, int jn, int jf, int i8,
                                      float pre) {
  if constexpr (MODE == UPW) {
    const F8 wf = lerp8(widen8<Q>(col.s[jf][1], i8, pre), widen8<Q>(col.s[jf][0], i8, pre));
    const F8 wn = lerp8(widen8<Q>(col.s[jn][1], i8, pre), widen8<Q>(col.s[jn][0], i8, pre));
    return lerp8(wf, wn);
  }
  const F8 h0 = lerp8(widen8<Q>(col.s[jf][0], i8, pre), widen8<Q>(col.s[jn][0], i8, pre));
  if constexpr (MODE == UPF) {
    return h0;
  } else {
    const F8 h1 = lerp8(widen8<Q>(col.s[jf][1], i8, pre), widen8<Q>(col.s[jn][1], i8, pre));
    return lerp8(h1, h0);
  }
}

// The halo tile of one channel chunk, a column at a time: producer thread p
// builds channel group v = p % vpp of halo columns p / vpp, + NPROD / vpp,
// ... below TW (the columns beyond feed only the wgmma rows that are not
// stored), CB columns at a time with all their loads in flight. Halo row r
// of a column is GEMM row gy = y0 - HP + r, whose near stored row is
// y0/2 + floor((r - HP) / 2) (y0 is even) and far one a row below (gy odd)
// or above: both are compile-time offsets into the column's rows, which
// start HB = max(HP, 1) rows above y0/2 (k = 1: row 0's far row is above).
template <int N, int MODE, bool Q, int K>
__device__ __forceinline__ void build_halo(const UpArgs& a, const Layout& L,
                                           unsigned char* halo, const void* xb,
                                           const TileXY& T, int c_base, int i8, float pre,
                                           float post, int p) {
  constexpr int ES = Q ? 1 : 2;
  constexpr int TH = NCONS * mt_of(N, Q ? I8 : BF16, K);
  constexpr int HP = (K - 1) / 2;
  constexpr int HB = HP > 0 ? HP : 1;
  constexpr int NR = TH / 2 + 2 * HB;  // stored rows of a column
  constexpr int HH = TH + K - 1;       // halo rows
  constexpr int CB = (MODE == UPF || (K == 3 && TH == 4)) ? 2 : 1;  // within the registers
  const int vpp = a.cchunk >> 3;       // a power of two <= 16
  const int v = p % vpp;
  const int cstep = NPROD / vpp;
  const int c = c_base + v * 8;
  const int sb = (T.y0 >> 1) - HB;
  for (int hx0 = p / vpp; hx0 < TW; hx0 += CB * cstep) {
    Column<MODE, NR> col[CB];
    bool col_in[CB];
#pragma unroll
    for (int b = 0; b < CB; ++b) {
      const int gx = T.x0 - HP + hx0 + b * cstep;
      col_in[b] = hx0 + b * cstep < TW && gx >= 0 && gx < a.W && c < a.cin;
      if (col_in[b]) {
        const int x0 = MODE == UPF ? gx : gx >> 1;
        const int x1 = MODE == UPF ? gx : far_tap(gx, a.Ws);
#pragma unroll
        for (int j = 0; j < NR; ++j) {
          const int sy = min(max(sb + j, 0), a.Hs - 1);
          col[b].s[j][0] = load8<Q>(xb, i8, a.cin, a.Ws, sy, x0, c);
          if constexpr (MODE != UPF) col[b].s[j][1] = load8<Q>(xb, i8, a.cin, a.Ws, sy, x1, c);
        }
      }
    }
#pragma unroll
    for (int b = 0; b < CB; ++b) {
      if (hx0 + b * cstep >= TW) continue;
      unsigned char* dst = halo + (hx0 + b * cstep) * L.pstride + v * 8 * ES;
      // K6 at k <= 3: each stored row W-interpolated once, for every halo
      // row that reads it (the same values column8 computes per halo row;
      // at k = 5 the floats of eight rows would not fit the registers).
      constexpr bool WFIRST = MODE == UPW && K <= 3;
      F8 wrow[WFIRST ? NR : 1];
      if constexpr (WFIRST) {
        if (col_in[b]) {
#pragma unroll
          for (int j = 0; j < NR; ++j)
            wrow[j] =
                lerp8(widen8<Q>(col[b].s[j][1], i8, pre), widen8<Q>(col[b].s[j][0], i8, pre));
        }
      }
#pragma unroll
      for (int r = 0; r < HH; ++r) {
        const int jn = HB + ((r - HP) >> 1);
        const int jf = jn + (((r - HP) & 1) ? 1 : -1);
        const int gy = T.y0 - HP + r;
        const bool in = col_in[b] && gy >= 0 && gy < a.H;
        unsigned char* d = dst + r * L.hw * L.pstride;
        F8 f;
        if (in) {
          if constexpr (WFIRST)
            f = lerp8(wrow[jf], wrow[jn]);
          else
            f = column8<MODE, Q, NR>(col[b], jn, jf, i8, pre);
        }
        if (Q) {
          uint2 val = make_uint2(0u, 0u);
          if (in) val = codes8(f, post);
          *reinterpret_cast<uint2*>(d) = val;
        } else {
          uint4 val = make_uint4(0u, 0u, 0u, 0u);
          if (in) val = pack8(f);
          *reinterpret_cast<uint4*>(d) = val;
        }
      }
    }
  }
}

// The float32 halo tile of one channel chunk (K6 in float32), a column at a
// time as build_halo does: each stored row that the column reads is
// W-interpolated once as it is loaded (its two stored columns), and halo row
// r is the H-interpolation of its far and near rows, every product and sum
// rounded in float32 as the plain version rounds; stored as float32.
template <int N, int K>
__device__ __forceinline__ void build_halo_upw_f32(const UpArgs& a, const Layout& L,
                                                   unsigned char* halo, const float* xb,
                                                   const TileXY& T, int c_base, int p) {
  constexpr int TH = NCONS * mt_of(N, F32, K);
  constexpr int HP = (K - 1) / 2;
  constexpr int HB = HP > 0 ? HP : 1;
  constexpr int NR = TH / 2 + 2 * HB;  // stored rows of a column
  constexpr int HH = TH + K - 1;       // halo rows
  const int vpp = a.cchunk >> 3;       // a power of two <= 16
  const int v = p % vpp;
  const int cstep = NPROD / vpp;
  const int c = c_base + v * 8;
  const int sb = (T.y0 >> 1) - HB;
  for (int hx = p / vpp; hx < TW; hx += cstep) {
    const int gx = T.x0 - HP + hx;
    const bool col_in = gx >= 0 && gx < a.W && c < a.cin;
    F8 wrow[NR];
    if (col_in) {
      const int x0 = gx >> 1, x1 = far_tap(gx, a.Ws);
#pragma unroll
      for (int j = 0; j < NR; ++j) {
        const int sy = min(max(sb + j, 0), a.Hs - 1);
        wrow[j] = lerp8(load8_f32(xb, a.cin, a.Ws, sy, x1, c),
                        load8_f32(xb, a.cin, a.Ws, sy, x0, c));
      }
    }
    unsigned char* dst = halo + hx * L.pstride + v * 8 * 4;
#pragma unroll
    for (int r = 0; r < HH; ++r) {
      const int jn = HB + ((r - HP) >> 1);
      const int jf = jn + (((r - HP) & 1) ? 1 : -1);
      const int gy = T.y0 - HP + r;
      F8 f = {};
      if (col_in && gy >= 0 && gy < a.H) f = lerp8(wrow[jf], wrow[jn]);
      store8_f32(dst + r * L.hw * L.pstride, f);
    }
  }
}

// The float32 halo tile of one channel chunk of K9 (UPF in float32), a
// column at a time as build_halo_upw_f32 walks it: the column's stored rows
// at its own half-resolution column, all loads in flight, and halo row r the
// H-interpolation of its far and near rows, rounded in float32 as
// upsample_2x_bilinear rounds; stored as float32.
template <int N>
__device__ __forceinline__ void build_halo_upf_f32(const UpArgs& a, const Layout& L,
                                                   unsigned char* halo, const float* xb,
                                                   const TileXY& T, int c_base, int p) {
  constexpr int TH = NCONS * mt_of(N, F32, 3);
  constexpr int NR = TH / 2 + 2;  // stored rows of a column (k = 3: HP = HB = 1)
  constexpr int HH = TH + 2;      // halo rows
  const int vpp = a.cchunk >> 3;  // a power of two <= 16
  const int v = p % vpp;
  const int cstep = NPROD / vpp;
  const int c = c_base + v * 8;
  const int sb = (T.y0 >> 1) - 1;
  for (int hx = p / vpp; hx < TW; hx += cstep) {
    const int gx = T.x0 - 1 + hx;
    const bool col_in = gx >= 0 && gx < a.W && c < a.cin;
    F8 row[NR];
    if (col_in) {
#pragma unroll
      for (int j = 0; j < NR; ++j)
        row[j] = load8_f32(xb, a.cin, a.Ws, min(max(sb + j, 0), a.Hs - 1), gx, c);
    }
    unsigned char* dst = halo + hx * L.pstride + v * 8 * 4;
#pragma unroll
    for (int r = 0; r < HH; ++r) {
      const int jn = 1 + ((r - 1) >> 1);
      const int jf = jn + (((r - 1) & 1) ? 1 : -1);
      const int gy = T.y0 - 1 + r;
      F8 f = {};
      if (col_in && gy >= 0 && gy < a.H) f = lerp8(row[jf], row[jn]);
      store8_f32(dst + r * L.hw * L.pstride, f);
    }
  }
}

// min(jn, jf) of halo row r of an upsampling mode (build_halo): the first of
// the two stored rows that the row reads; it grows by one every two rows.
__host__ __device__ constexpr int up_lo_row(int r, int hp, int hb) {
  return hb + ((r - hp) >> 1) - (((r - hp) & 1) ? 0 : 1);
}

// Halo rows R0 .. R1-1 of one column of K8's float32 halo tile (UP in
// float32): halo row r is the H-interpolation of its far and near stored
// rows at the column's near (x0) and at its far (x1) stored column, then the
// W-interpolation of those two (H first, as upsample_2x_bilinear rounds and
// column8 computes for UP), each product and sum rounded in float32; stored
// as float32, zero where `in` is false for the column or gy is outside the
// image. The stored rows stream through the registers, at most LIVE of them
// (both stored columns, 16 floats a row) at once: the rows that the next
// halo rows read are loaded while the current ones are built (k = 5 at N <=
// 32 reads eight rows, 128 floats, beyond the producers' 136 registers).
// Every index is compile-time (r and j are unrolled).
template <int N, int K, int R0, int R1>
__device__ __forceinline__ void upm_rows_f32(const UpArgs& a, const Layout& L,
                                             unsigned char* dst, const float* xb,
                                             const TileXY& T, int x0, int x1, int c,
                                             bool in) {
  constexpr int TH = NCONS * mt_of(N, F32, K);
  constexpr int HP = (K - 1) / 2;
  constexpr int HB = HP > 0 ? HP : 1;
  constexpr int NR = TH / 2 + 2 * HB;  // stored rows of a column
  constexpr int LIVE = 4;
  const int sb = (T.y0 >> 1) - HB;
  F8 s[NR][2];  // [stored row][near, far column]; only a window is live
#pragma unroll
  for (int r = R0; r < R1; ++r) {
    // rows below up_lo_row(r) are read no more: LIVE rows from it on in flight
    const int from =
        r == R0 ? up_lo_row(R0, HP, HB) : min(NR, up_lo_row(r - 1, HP, HB) + LIVE);
    const int to = min(NR, up_lo_row(r, HP, HB) + LIVE);
#pragma unroll
    for (int j = 0; j < NR; ++j) {
      if (j >= from && j < to) {
        const int sy = min(max(sb + j, 0), a.Hs - 1);
        s[j][0] = load8_f32(xb, a.cin, a.Ws, sy, x0, c);
        s[j][1] = load8_f32(xb, a.cin, a.Ws, sy, x1, c);
      }
    }
    const int jn = HB + ((r - HP) >> 1);
    const int jf = jn + (((r - HP) & 1) ? 1 : -1);
    const int gy = T.y0 - HP + r;
    F8 f = {};
    if (in && gy >= 0 && gy < a.H)
      f = lerp8(lerp8(s[jf][1], s[jn][1]), lerp8(s[jf][0], s[jn][0]));
    store8_f32(dst + r * L.hw * L.pstride, f);
  }
}

// The float32 halo tile of one channel chunk of K8 (UP in float32), a column
// at a time as build_halo walks it (upm_rows_f32). At chunks of 8 channels
// (every model site) the producers outnumber the 64 columns two to one, so
// each column is built by two threads, one half of its rows each (a stored
// row that both halves read is loaded twice); wider chunks give each thread
// whole columns.
template <int N, int K>
__device__ __forceinline__ void build_halo_upm_f32(const UpArgs& a, const Layout& L,
                                                   unsigned char* halo, const float* xb,
                                                   const TileXY& T, int c_base, int p) {
  constexpr int HP = (K - 1) / 2;
  constexpr int HH = NCONS * mt_of(N, F32, K) + K - 1;  // halo rows, even
  const int vpp = a.cchunk >> 3;  // a power of two <= 16
  const bool split = vpp == 1;
  const int v = split ? 0 : p % vpp;
  const int cstep = split ? TW : NPROD / vpp;
  const int c = c_base + v * 8;
  for (int hx = split ? p % TW : p / vpp; hx < TW; hx += cstep) {
    const int gx = T.x0 - HP + hx;
    const bool in = gx >= 0 && gx < a.W && c < a.cin;
    // clamped, so that every load is in bounds (and needs no branch); what
    // lies outside the image or past cin is stored as zero
    const int gxc = min(max(gx, 0), a.W - 1), cc = min(c, a.cin - 8);
    const int x0 = gxc >> 1, x1 = far_tap(gxc, a.Ws);
    unsigned char* dst = halo + hx * L.pstride + v * 8 * 4;
    if (!split || p < TW)
      upm_rows_f32<N, K, 0, HH / 2>(a, L, dst, xb, T, x0, x1, cc, in);
    if (!split || p >= TW)
      upm_rows_f32<N, K, HH / 2, HH>(a, L, dst, xb, T, x0, x1, cc, in);
  }
}

// The 2x2 mean of four stored pixels' eight bf16 channels in float32, as
// avg_pool_2x sums them: ((p00 + p01) + p10) + p11, then times 1/4, each
// step rounded.
__device__ __forceinline__ F8 pool8(const uint4 (&s)[4]) {
  return avg4_8(unpack8(s[0]), unpack8(s[1]), unpack8(s[2]), unpack8(s[3]));
}

// The pooled int8 codes of four stored pixels' eight int8 codes: rint of
// their sum over four (half to even; |sum| <= 508, so no clip is needed),
// which is what avg_pool_2x in float32 and a rounding to the grid give, in
// exact integer arithmetic on 16-bit lanes: each code is biased by 128 (an
// XOR of its sign bit) and zero-extended to a lane, the four lanes summed to
// v = sum + 512, and (v + 1 + bit 2 of v) >> 2 = rint(sum / 4) + 128 keeps
// the code, biased, in the lane's low byte.
__device__ __forceinline__ uint2 pool_codes8(const uint2 (&s)[4]) {
  uint32_t w[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    uint32_t lane[2];  // channels 4h + {0, 1} and 4h + {2, 3}
#pragma unroll
    for (int l = 0; l < 2; ++l) {
      const uint32_t sel = l ? 0x4342u : 0x4140u;  // two bytes, zero-extended
      uint32_t x[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        x[k] = __byte_perm((h ? s[k].y : s[k].x) ^ 0x80808080u, 0u, sel);
      const uint32_t v = __vadd2(__vadd2(x[0], x[1]), __vadd2(x[2], x[3]));
      lane[l] = __vadd2(v, 0x00010001u + ((v >> 2) & 0x00010001u)) >> 2;
    }
    w[h] = __byte_perm(lane[0], lane[1], 0x6420u) ^ 0x80808080u;
  }
  return make_uint2(w[0], w[1]);
}

// The pooled halo tile of one channel chunk (K7), a column at a time:
// producer thread p builds channel group v = p % vpp of halo columns
// p / vpp, + NPROD / vpp, ... below TW. Halo row r of column hx is pooled
// pixel (gy, gx) = (y0 - HP + r, x0 - HP + hx), the mean of stored pixels
// (2gy + i, 2gx + j). The four loads of each of RB rows are in flight at
// once: two rows of bf16 (32 registers; more spill), three of int8 codes (24
// registers; two or four rows ran slower at d1c1 or d2c1 on the H100). I8:
// x holds int8 codes, which are pooled in integer arithmetic (pool_codes8).
template <int N, bool Q, int K, bool I8>
__device__ __forceinline__ void build_halo_pool(const UpArgs& a, const Layout& L,
                                                unsigned char* halo, const void* xb,
                                                const TileXY& T, int c_base, float post,
                                                int p) {
  using Raw = typename std::conditional<I8, uint2, uint4>::type;
  constexpr int ES = Q ? 1 : 2;
  constexpr int TH = NCONS * mt_of(N, Q ? Elem::I8 : BF16, K);
  constexpr int HP = (K - 1) / 2;
  constexpr int HH = TH + K - 1;  // halo rows
  constexpr int RB = I8 ? 3 : 2;  // rows per batch
  const int vpp = a.cchunk >> 3;  // a power of two <= 16
  const int v = p % vpp;
  const int cstep = NPROD / vpp;
  const int c = c_base + v * 8;
  const Raw* src = static_cast<const Raw*>(xb);
  for (int hx = p / vpp; hx < TW; hx += cstep) {
    const int gx = T.x0 - HP + hx;
    const bool col_in = gx >= 0 && gx < a.W && c < a.cin;
    unsigned char* dst = halo + hx * L.pstride + v * 8 * ES;
#pragma unroll
    for (int r0 = 0; r0 < HH; r0 += RB) {
      Raw s[RB][4];
      bool in[RB];
#pragma unroll
      for (int j = 0; j < RB; ++j) {
        const int gy = T.y0 - HP + r0 + j;
        in[j] = col_in && r0 + j < HH && gy >= 0 && gy < a.H;
        if (in[j]) {
#pragma unroll
          for (int i = 0; i < 4; ++i)  // 8 channels: one Raw
            s[j][i] =
                __ldg(src + pix_off(a.cin, a.Ws, 2 * gy + (i >> 1), 2 * gx + (i & 1), c) / 8);
        }
      }
#pragma unroll
      for (int j = 0; j < RB; ++j) {
        if (r0 + j >= HH) continue;
        unsigned char* d = dst + (r0 + j) * L.hw * L.pstride;
        if constexpr (I8) {
          uint2 val = make_uint2(0u, 0u);
          if (in[j]) val = pool_codes8(s[j]);
          *reinterpret_cast<uint2*>(d) = val;
        } else if (Q) {
          uint2 val = make_uint2(0u, 0u);
          if (in[j]) val = codes8(pool8(s[j]), post);
          *reinterpret_cast<uint2*>(d) = val;
        } else {
          uint4 val = make_uint4(0u, 0u, 0u, 0u);
          if (in[j]) val = pack8(pool8(s[j]));
          *reinterpret_cast<uint4*>(d) = val;
        }
      }
    }
  }
}

// The pooled float32 halo tile of one channel chunk (K7 in float32), item by
// item: item i is channels 4u .. 4u+3 (u = i % upp, upp = cchunk / 4) of
// halo pixel i / upp (row r, column hx), for i = p, + NPROD, ... below HH x
// TW x upp, so that every producer thread works (a column walk leaves half
// of them idle at chunks of 8 channels, and the pool reads no stored value
// twice, so a column gains nothing). An item is pooled pixel (gy, gx) = (y0
// - HP + r, x0 - HP + hx): avg4_4 of stored pixels (2gy + i, 2gx + j), four
// 16-byte loads, RB items in flight. Two neighbouring threads read the two
// halves of one 32-byte sector, so a warp's load touches 16 lines, not 32.
// Stored as float32, zero outside the image and past cin.
template <int N, int K>
__device__ __forceinline__ void build_halo_pool_f32(const UpArgs& a, const Layout& L,
                                                    unsigned char* halo, const float* xb,
                                                    const TileXY& T, int c_base, int p) {
  constexpr int TH = NCONS * mt_of(N, F32, K);
  constexpr int HP = (K - 1) / 2;
  constexpr int HH = TH + K - 1;  // halo rows
  constexpr int RB = 2;           // items in flight
  const int ushift = 31 - __clz(a.cchunk >> 2);  // upp, a power of two
  const int umask = (1 << ushift) - 1;
  const int items = (HH * TW) << ushift;
  for (int i0 = p; i0 < items; i0 += RB * NPROD) {
    float4 s[RB][4];
    bool in[RB];
#pragma unroll
    for (int j = 0; j < RB; ++j) {
      const int i = i0 + j * NPROD;
      const int pix = i >> ushift;
      const int gy = T.y0 - HP + pix / TW, gx = T.x0 - HP + pix % TW;
      const int c = c_base + ((i & umask) << 2);
      in[j] = i < items && gy >= 0 && gy < a.H && gx >= 0 && gx < a.W && c < a.cin;
      if (in[j]) {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          s[j][q] = __ldg(reinterpret_cast<const float4*>(
              xb + pix_off(a.cin, a.Ws, 2 * gy + (q >> 1), 2 * gx + (q & 1), c)));
      }
    }
#pragma unroll
    for (int j = 0; j < RB; ++j) {
      const int i = i0 + j * NPROD;
      if (i >= items) continue;
      float4 f = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (in[j]) f = avg4_4(s[j][0], s[j][1], s[j][2], s[j][3]);
      *reinterpret_cast<float4*>(halo + (i >> ushift) * L.pstride + (i & umask) * 16) = f;
    }
  }
}

// Eight gathered elements (raw: an int8 code, bf16 or float32 bits each, 0
// outside the image) stored as one channel group of a halo pixel: bf16 and
// float32 as they are, or int8 codes (a bf16 element quantised by `post`;
// zero stays zero).
template <int ET>
__device__ __forceinline__ void store_raw8(unsigned char* dst, const uint32_t (&raw)[8], int i8,
                                           float post) {
  constexpr bool Q = ET == I8;
  if constexpr (ET == F32) {
    uint4* d = reinterpret_cast<uint4*>(dst);
    d[0] = make_uint4(raw[0], raw[1], raw[2], raw[3]);
    d[1] = make_uint4(raw[4], raw[5], raw[6], raw[7]);
    return;
  }
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    if (Q) {
      const uint32_t code = i8 ? raw[e] : code8(__fmul_rn(__uint_as_float(raw[e] << 16), post));
      w[e >> 2] |= (code & 0xffu) << (8 * (e & 3));
    } else {
      w[e >> 1] |= raw[e] << (16 * (e & 1));
    }
  }
  if (Q)
    *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
  else
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
}

// One element of operand o as store_raw8 takes it.
template <int ET>
__device__ __forceinline__ uint32_t raw1(const unsigned char* xb, size_t off, int i8) {
  if constexpr (ET == F32) return reinterpret_cast<const uint32_t*>(xb)[off];
  return i8 ? static_cast<uint32_t>(xb[off])
            : static_cast<uint32_t>(reinterpret_cast<const uint16_t*>(xb)[off]);
}

// The halo tile of one channel chunk of operand o (K5): producer thread p
// fills channel group v = i % vpp of halo pixel i / vpp for i = p, + NPROD,
// ..., below HH x TW, zero outside the image and past the operand's
// channels, and arrives on the chunk's full barrier `bar` (DIRECT arrives
// itself: a copy arrives when its bytes have landed).
//   * copy: bf16 or float32 values, or int8 codes in int8 mode, whose
//     channels and pixel stride are multiples of 8: one cp.async of 8
//     channels per item (float32: two of 4, 16 bytes each);
//   * quantise: a bf16 operand of an int8 conv, 8 channels a load, RB loads
//     in flight, clip(rint(v * 127/ax)) stored as 8 codes;
//   * gather: any other operand (the stems, cin 6/9/10): channel by
//     channel, the loads of RB items in flight at once (one item at a
//     time, the int8 stem's producers held the block).
// K = 0 (the streamed mode): k is a.k, the tile has L.hh rows (TH + b - 1,
// b the widest block) and T's origin is the block's; else the compile-time
// K.
template <int N, int ET, int K>
__device__ __forceinline__ void build_halo_direct(const UpArgs& a, const Layout& L,
                                                  unsigned char* halo, const Operand& o,
                                                  const TileXY& T, int c_base, uint64_t* bar,
                                                  int p) {
  constexpr bool Q = ET == I8;
  constexpr int ES = Q ? 1 : (ET == F32 ? 4 : 2);
  constexpr int TH = NCONS * mt_of(N, ET, K);
  const int k = K > 0 ? K : a.k;
  const int HP = (k - 1) / 2;
  const int HH = K > 0 ? TH + k - 1 : L.hh;
  constexpr int RB = 4;
  const int i8 = Q ? o.in_i8 : 0;
  const int xes = ET == F32 ? 4 : (i8 ? 1 : 2);  // bytes per element of the operand
  const unsigned char* xb =
      static_cast<const unsigned char*>(o.x) + T.b * a.H * a.W * o.cs * xes;
  const int vshift = 31 - __clz(a.cchunk >> 3);  // vpp = cchunk / 8, a power of two
  const int vmask = (1 << vshift) - 1;
  const int items = (HH * TW) << vshift;
  // Item i: halo pixel i / vpp (row r, column hx), channels c .. c+7; `in`:
  // inside the image and c below the operand's channels.
  auto item = [&](int i, int& c, bool& in) {
    const int pix = i >> vshift;
    const int gy = T.y0 - HP + pix / TW, gx = T.x0 - HP + pix % TW;
    c = c_base + ((i & vmask) << 3);
    in = gy >= 0 && gy < a.H && gx >= 0 && gx < a.W && c < o.c;
    return pix_off(o.cs, a.W, in ? gy : 0, in ? gx : 0, in ? c : 0);
  };
  auto dst_of = [&](int i) {
    return halo + (i >> vshift) * L.pstride + (i & vmask) * 8 * ES;
  };
  const bool vec = (o.c & 7) == 0 && (o.cs & 7) == 0;
  if (vec && (!Q || i8)) {
    for (int i = p; i < items; i += NPROD) {
      int c;
      bool in;
      const size_t off = item(i, c, in);
      if constexpr (ET == F32) {
        cp_async_zfill<16>(dst_of(i), xb + off * ES, in ? 16 : 0);
        cp_async_zfill<16>(dst_of(i) + 16, xb + off * ES + 16, in ? 16 : 0);
      } else {
        cp_async_zfill<8 * ES>(dst_of(i), xb + off * ES, in ? 8 * ES : 0);
      }
    }
    cp_async_arrive(bar);
    return;
  }
  float post = 1.0f;
  if (Q && !i8) post = __fdiv_rn(127.0f, fmaxf(__ldg(o.ax), 1e-12f));
  if (vec) {  // Q, a bf16 operand
    for (int i0 = p; i0 < items; i0 += RB * NPROD) {
      uint4 s[RB];
      bool in[RB];
#pragma unroll
      for (int j = 0; j < RB; ++j) {
        int c;
        const size_t off = item(i0 + j * NPROD, c, in[j]);
        in[j] = in[j] && i0 + j * NPROD < items;
        if (in[j]) s[j] = __ldg(reinterpret_cast<const uint4*>(xb + off * 2));
      }
#pragma unroll
      for (int j = 0; j < RB; ++j) {
        const int i = i0 + j * NPROD;
        if (i >= items) continue;
        uint2 val = make_uint2(0u, 0u);
        if (in[j]) val = codes8(unpack8(s[j]), post);
        *reinterpret_cast<uint2*>(dst_of(i)) = val;
      }
    }
  } else {
    for (int i0 = p; i0 < items; i0 += RB * NPROD) {
      uint32_t raw[RB][8];  // an element each: int8 code, bf16 or float32 bits, 0 outside
#pragma unroll
      for (int j = 0; j < RB; ++j) {
        int c;
        bool in;
        const size_t off = item(i0 + j * NPROD, c, in);
        in = in && i0 + j * NPROD < items;
#pragma unroll
        for (int e = 0; e < 8; ++e)
          raw[j][e] = in && c + e < o.c ? raw1<ET>(xb, off + e, i8) : 0u;
      }
#pragma unroll
      for (int j = 0; j < RB; ++j)
        if (i0 + j * NPROD < items) store_raw8<ET>(dst_of(i0 + j * NPROD), raw[j], i8, post);
    }
  }
  mbar_arrive(bar);  // releases the halo writes
}

// 16 bytes of an edge pixel against 16 bytes of an edge tap: eight bf16
// products in float32, or sixteen int8 products in int32 (exact).
__device__ __forceinline__ float dot16(const uint4 s, const uint4 w, float acc) {
  const F8 a = unpack8(s), b = unpack8(w);
#pragma unroll
  for (int i = 0; i < 8; ++i) acc = fmaf(a.v[i], b.v[i], acc);
  return acc;
}

// float32: 16 bytes of an edge pixel (four channels) against the hi and lo
// TF32 planes of an edge tap; hi + lo is the float32 weight to 2^-22, and
// exact in float32.
__device__ __forceinline__ float dot16(const uint4 s, const uint4 hi, const uint4 lo,
                                       float acc) {
  const uint32_t sv[4] = {s.x, s.y, s.z, s.w}, h[4] = {hi.x, hi.y, hi.z, hi.w},
                 l[4] = {lo.x, lo.y, lo.z, lo.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    acc = fmaf(__uint_as_float(sv[i]), __fadd_rn(__uint_as_float(h[i]), __uint_as_float(l[i])),
               acc);
  return acc;
}

__device__ __forceinline__ int dot16(const uint4 s, const uint4 w, int acc) {
  acc = __dp4a(static_cast<int>(s.x), static_cast<int>(w.x), acc);
  acc = __dp4a(static_cast<int>(s.y), static_cast<int>(w.y), acc);
  acc = __dp4a(static_cast<int>(s.z), static_cast<int>(w.z), acc);
  return __dp4a(static_cast<int>(s.w), static_cast<int>(w.w), acc);
}

// The producer warpgroup walks the block's tiles; per channel chunk it waits
// for a free buffer, has the chunk's weights copied in (or, resident, every
// chunk's once before the first tile), builds the halo tile, and (K9, edge
// tiles) adds the edge pixel's products with the edge taps to its sums,
// which it hands over with the tile's last chunk.
template <int N, int MODE, int ET, int K>
__device__ __forceinline__ void produce(const UpArgs& a, const Layout& L, unsigned char* smem,
                                        uint64_t* bars, int p) {
  constexpr bool Q = ET == I8;
  using Acc = typename std::conditional<Q, int, float>::type;
  constexpr int ES = Q ? 1 : (ET == F32 ? 8 : 2);  // bytes of a weight
  constexpr int TH = NCONS * mt_of(N, ET, K);
  constexpr int EPT = (TH * N + NPROD - 1) / NPROD;  // edge sums per thread and side
  const int hp = (a.k - 1) / 2;
  const int i8 = Q ? a.in_i8 : 0;
  // int8: a bf16 input goes to the grid by 127/ax, before the
  // H-interpolation in K9 and after the pool (K7) or the interpolation (K6,
  // K8), as the reference's plain versions do; int8 codes are pooled or
  // interpolated as they are and rounded again (K7, K8), or dequantised by
  // ax/127 before the interpolation (K6). (K5 quantises per operand.)
  float pre = 1.0f, post = 1.0f;
  if (Q && MODE != DIRECT && (!i8 || MODE == UPW)) {
    const float axc = fmaxf(__ldg(a.ax), 1e-12f);
    const float inv = __fdiv_rn(127.0f, axc);
    if (MODE == UPF) pre = inv; else post = inv;
    if (MODE == UPW && i8) pre = __fdiv_rn(axc, 127.0f);
  }
  const uint32_t tap_bytes = static_cast<uint32_t>(a.cchunk) * N * ES;
  const uint32_t row_bytes = a.k * tap_bytes;  // the stencil taps of one dy row
  uint32_t cnt = 0;   // chunks produced, over the block's tiles
  uint32_t ecnt = 0;  // edge tiles produced
  const bool wres = (MODE == POOL || MODE == DIRECT) && L.wres;
  if (wres && p == 0) {  // one channel block: cb 0's weights, in chunk order
    mbar_arrive_expect_tx(&bars[8], a.n_chunks * a.k * row_bytes);
    for (int i = 0; i < a.n_chunks * a.k; ++i)
      bulk_g2s(smem + L.wres_off + i * row_bytes,
               a.wb + static_cast<size_t>(i) * a.ntaps * tap_bytes, row_bytes, &bars[8]);
  }
  for (int t = blockIdx.x; t < a.tiles; t += gridDim.x) {
    const TileXY T = tile_of(a, t, TH, cb_inner<MODE, ET>());
    const void* xb = static_cast<const unsigned char*>(a.x) +
                     T.b * a.Hs * a.Ws * a.cin * (ET == F32 ? 4 : (i8 ? 1 : 2));
    const unsigned char* wblock =
        a.wb + static_cast<size_t>(T.cb) * a.n_chunks * a.k * a.ntaps * tap_bytes;
    // K9: does this tile hold half-column 0 (side 0) or Ws-1 (side 1)?
    const bool side[2] = {MODE == UPF && T.x0 == 0, MODE == UPF && a.W - 1 < T.x0 + a.tw};
    Acc esum[2][EPT];
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int e = 0; e < EPT; ++e) esum[s][e] = 0;

    for (int gch = 0; gch < a.n_chunks; ++gch, ++cnt) {
      const int buf = cnt % L.nbuf;
      unsigned char* halo = smem + buf * L.buf_bytes;
      const unsigned char* wchunk =
          wblock + static_cast<size_t>(gch) * a.k * a.ntaps * tap_bytes;
      mbar_wait(&bars[3 + buf], ((cnt / L.nbuf) & 1) ^ 1);
      if (p == 0 && wres) {
        mbar_arrive(&bars[buf]);
      } else if (p == 0) {
        mbar_arrive_expect_tx(&bars[buf], a.k * row_bytes);
        for (int dy = 0; dy < a.k; ++dy)
          bulk_g2s(halo + L.halo_bytes + dy * row_bytes,
                   wchunk + static_cast<size_t>(dy) * a.ntaps * tap_bytes, row_bytes,
                   &bars[buf]);
      }
      if constexpr (MODE == DIRECT) {
        // the operand of chunk gch: chunk0 grows with the operand index
        int op = 0;
#pragma unroll
        for (int i = 1; i < MAX_OPS; ++i) op += i < a.n_ops && gch >= a.ops[i].chunk0;
        const Operand o = a.ops[op];
        build_halo_direct<N, ET, K>(a, L, halo, o, T, (gch - o.chunk0) * a.cchunk, &bars[buf], p);
        continue;  // it has arrived on full[buf]
      } else if constexpr (ET == F32) {
        const float* xf = static_cast<const float*>(xb);
        if constexpr (MODE == UPF)
          build_halo_upf_f32<N>(a, L, halo, xf, T, gch * a.cchunk, p);
        else if constexpr (MODE == UPW)
          build_halo_upw_f32<N, K>(a, L, halo, xf, T, gch * a.cchunk, p);
        else if constexpr (MODE == POOL)
          build_halo_pool_f32<N, K>(a, L, halo, xf, T, gch * a.cchunk, p);
        else
          build_halo_upm_f32<N, K>(a, L, halo, xf, T, gch * a.cchunk, p);
      } else if constexpr (MODE == POOL) {
        if (Q && i8)
          build_halo_pool<N, Q, K, Q>(a, L, halo, xb, T, gch * a.cchunk, post, p);
        else
          build_halo_pool<N, Q, K, false>(a, L, halo, xb, T, gch * a.cchunk, post, p);
      } else
        build_halo<N, MODE, Q, K>(a, L, halo, xb, T, gch * a.cchunk, i8, pre, post, p);
      if (MODE == UPF && (side[0] || side[1])) {
        named_sync(1, NPROD);  // the whole halo tile is written
        // Thread p's sums are channel n = p % N of tile rows o / N for
        // o = p + NPROD * e (NPROD is a multiple of N): each weight it loads
        // serves all of its rows.
        const int n = p % N;
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          if (!side[s]) continue;
          const int hx0 = (s ? a.W - 1 - T.x0 : -T.x0) + hp;  // the edge pixel's halo column
          const unsigned char* wtap =
              wchunk + (3 + s) * tap_bytes + (n >> 3) * 256 + (n & 7) * 16;
#pragma unroll
          for (int dy = 0; dy < 3; ++dy) {
            // 16-byte units along the chunk's channels: k-step u / 2, half u
            // % 2 (float32: a k-step of 8 channels holds the hi plane, then
            // the lo plane, each N * 32 bytes)
            constexpr int XES = ET == F32 ? 4 : (Q ? 1 : 2);  // bytes of a halo element
            constexpr int KSTEP = ET == F32 ? N * 64 : N * 32;
#pragma unroll 1
            for (int u = 0; u < a.cchunk * XES / 16; ++u) {
              const unsigned char* wp =
                  wtap + static_cast<size_t>(dy) * a.ntaps * tap_bytes + (u >> 1) * KSTEP +
                  (u & 1) * 128;
              const uint4 wv = __ldg(reinterpret_cast<const uint4*>(wp));
              uint4 wlo = make_uint4(0u, 0u, 0u, 0u);
              if constexpr (ET == F32) wlo = __ldg(reinterpret_cast<const uint4*>(wp + N * 32));
#pragma unroll
              for (int e = 0; e < EPT; ++e) {
                const int o = p + NPROD * e;
                if (o >= TH * N) continue;
                const uint4 sv = *reinterpret_cast<const uint4*>(
                    halo + ((o / N + dy) * L.hw + hx0) * L.pstride + u * 16);
                if constexpr (ET == F32)
                  esum[s][e] = dot16(sv, wv, wlo, esum[s][e]);
                else
                  esum[s][e] = dot16(sv, wv, esum[s][e]);
              }
            }
          }
        }
        if (gch == a.n_chunks - 1) {  // [side][tile row][channel] of buffer ecnt % 2
          const int eb = ecnt & 1;
          mbar_wait(&bars[6 + eb], ((ecnt >> 1) & 1) ^ 1);
          Acc* edge = reinterpret_cast<Acc*>(smem + L.edge_off) + eb * 2 * TH * N;
#pragma unroll
          for (int s = 0; s < 2; ++s)
#pragma unroll
            for (int e = 0; e < EPT; ++e) {
              const int o = p + NPROD * e;
              if (side[s] && o < TH * N) edge[s * TH * N + o] = esum[s][e];
            }
        }
      }
      mbar_arrive(&bars[buf]);  // releases the halo (and edge) writes
    }
    if (MODE == UPF && (side[0] || side[1])) ++ecnt;
  }
}

// The products of one (dx, k-step) of a chunk for a consumer warpgroup, a
// halo row at a time: halo row HR (shifted by dx) is the A operand of the
// warpgroup's output row mt = HR - dy for every dy, so it is loaded once
// (ldmatrix into register buffer HR % 2) for up to K wgmmas, each against
// the B descriptor of its dy. At most two rows are in flight; the other
// buffer's registers stay pinned until the row that read them is complete.
template <int HR, int MT, int K, int NR, typename Acc>
__device__ __forceinline__ void mma_rows(Acc (&acc)[MT][NR], uint32_t (&A)[2][4],
                                         uint32_t a_addr, uint32_t row_stride, uint32_t w_addr,
                                         uint32_t dy_stride) {
  ldmatrix_x4(A[HR & 1], a_addr + HR * row_stride);
  wgmma_fence();
#pragma unroll
  for (int dy = 0; dy < K; ++dy) {
    const int mt = HR - dy;
    if (mt >= 0 && mt < MT)
      wgmma_rs(acc[mt < 0 ? 0 : (mt < MT ? mt : MT - 1)], A[HR & 1],
               b_desc(w_addr + dy * dy_stride));
  }
  wgmma_commit();
  wgmma_wait<1>();
#pragma unroll
  for (int i = 0; i < 4; ++i) keep(A[(HR & 1) ^ 1][i]);
  if constexpr (HR + 1 < MT + K - 1)
    mma_rows<HR + 1, MT, K>(acc, A, a_addr, row_stride, w_addr, dy_stride);
}

// The epilogue of one tile, from the accumulators to device memory: (K9's
// edge sums,) (int8: scale,) bias, LeakyReLU, one rounding into the
// warpgroup's staged row (its pixels padded by 16 bytes, so that the eight
// rows of a store fall on distinct banks), then 16-byte coalesced stores of
// the row's valid pixels. bs holds the tile's bias and scale (N each, zero
// past n_out).
template <int N, int MODE, int ET, int MT, int NR, typename Acc>
__device__ __forceinline__ void epilogue(const UpArgs& a, const TileXY& T,
                                         const Acc (&acc)[MT][NR], const float* bs,
                                         const Acc* edge, unsigned char* stage, bool side0,
                                         bool side1, bool has_slope, float slope, int wg,
                                         int warp, int lane) {
  constexpr bool Q = ET == I8;
  constexpr int TH = NCONS * MT;
  const int g = lane >> 2, tig = lane & 3;
  const bool oq = Q && a.out_i8;
  const int oes = ET == F32 ? 4 : (oq ? 1 : 2);
  const int sstride = N * oes + PAD_BYTES;
  const int n0 = T.cb * N;
  const int n_out = a.n_out;
  const int nval = min(N, n_out - n0);
  const int np = min(a.tw, a.W - T.x0);
  const bool vec = (nval * oes) % 16 == 0 && (n_out * oes) % 16 == 0;
  const int t0 = (warp << 5) | lane;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int ty = wg * MT + mt;
    const int oy = T.y0 + ty;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = 16 * warp + g + 8 * h;
      const bool e0 = MODE == UPF && side0 && m == 0;
      const bool e1 = MODE == UPF && side1 && m == a.W - 1 - T.x0;
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        const int n = 8 * j + 2 * tig;
        Acc s0 = acc[mt][4 * j + 2 * h], s1 = acc[mt][4 * j + 2 * h + 1];
        if (e0) {
          s0 += edge[ty * N + n];
          s1 += edge[ty * N + n + 1];
        }
        if (e1) {
          s0 += edge[(TH + ty) * N + n];
          s1 += edge[(TH + ty) * N + n + 1];
        }
        float v0 = static_cast<float>(s0), v1 = static_cast<float>(s1);
        if (Q) {
          const float2 sc = *reinterpret_cast<const float2*>(bs + N + n);
          v0 *= sc.x;
          v1 *= sc.y;
        }
        const float2 bb = *reinterpret_cast<const float2*>(bs + n);
        v0 += bb.x;
        v1 += bb.y;
        if (has_slope) {
          v0 = v0 >= 0.0f ? v0 : slope * v0;
          v1 = v1 >= 0.0f ? v1 : slope * v1;
        }
        unsigned char* sp = stage + m * sstride + n * oes;
        if constexpr (ET == F32)
          *reinterpret_cast<float2*>(sp) = make_float2(v0, v1);
        else if (oq)
          *reinterpret_cast<uint16_t*>(sp) = static_cast<uint16_t>(
              code8(v0) | (code8(v1) << 8));
        else
          *reinterpret_cast<__nv_bfloat162*>(sp) = __floats2bfloat162_rn(v0, v1);
      }
    }
    named_sync(3 + wg, 128);  // the row is staged
    if (oy < a.H) {
      unsigned char* orow = static_cast<unsigned char*>(a.out) +
                            (((T.b * a.H + oy) * a.W + T.x0) * n_out + n0) * oes;
      if (vec) {
        const int cpr = nval * oes / 16;
        for (int i = t0; i < np * cpr; i += 128) {
          const int m = i / cpr, c = i % cpr;
          *reinterpret_cast<uint4*>(orow + static_cast<size_t>(m) * n_out * oes + c * 16) =
              *reinterpret_cast<const uint4*>(stage + m * sstride + c * 16);
        }
      } else {
        for (int i = t0; i < np * nval; i += 128) {
          const int m = i / nval, n = i % nval;
          unsigned char* d = orow + (static_cast<size_t>(m) * n_out + n) * oes;
          const unsigned char* sp = stage + m * sstride + n * oes;
          if constexpr (ET == F32) {
            *reinterpret_cast<float*>(d) = *reinterpret_cast<const float*>(sp);
          } else {
            d[0] = sp[0];
            if (oes == 2) d[1] = sp[1];
          }
        }
      }
    }
    named_sync(3 + wg, 128);  // the row is stored; the stage may be reused
  }
}

// A consumer warpgroup walks the block's tiles: the K-loop over (chunk, dx,
// k-step, halo row) into MT rows of 64 pixels x N channels, then the
// epilogue, which overlaps the producer's next chunks.
template <int N, int MODE, int ET, int K>
__device__ __forceinline__ void consume(const UpArgs& a, const Layout& L, unsigned char* smem,
                                        uint64_t* bars, int ct) {
  constexpr bool Q = ET == I8;
  using Acc = typename std::conditional<Q, int, float>::type;
  constexpr int KK = Q ? 32 : 16;
  constexpr int MT = mt_of(N, ET, K);
  constexpr int TH = NCONS * MT;
  constexpr int NR = N / 2;
  const int wg = ct >> 7;
  const int warp = (ct >> 5) & 3;
  const int lane = ct & 31;
  const int ks_n = a.cchunk / KK;
  const uint32_t row_stride = L.hw * L.pstride;  // one halo row
  // This lane's ldmatrix row address: pixel 16*warp + lane % 8 (+8 for
  // matrices 1 and 3), bytes 16 .. 31 of the k-step for matrices 2 and 3.
  const uint32_t lane_off = wg * MT * row_stride +
                            (16 * warp + (lane & 7) + ((lane >> 3) & 1) * 8) * L.pstride +
                            (lane >> 4) * 16;
  const uint32_t base = smem_u32(smem);
  float* bs = reinterpret_cast<float*>(smem + L.bs_off);
  unsigned char* stage = smem + L.stage_off + wg * L.stage_bytes;
  const bool has_slope = a.has_slope;
  const float slope = a.slope;
  uint32_t cnt = 0, ecnt = 0;
  int bs_cb = -1;  // the channel block whose bias and scale bs holds
  Acc acc[MT][NR];
  uint32_t A[2][4];
  const bool wres = (MODE == POOL || MODE == DIRECT) && L.wres;
  if (wres) mbar_wait(&bars[8], 0);  // the resident weights have arrived

  for (int t = blockIdx.x; t < a.tiles; t += gridDim.x) {
    const TileXY T = tile_of(a, t, TH, false);
    if (T.cb != bs_cb) {
      named_sync(2, NCONS * 128);  // the last tile's epilogue is done with bs
      for (int i = ct; i < N; i += NCONS * 128) {
        const int co = T.cb * N + i;
        bs[i] = co < a.n_out ? __ldg(a.bias + co) : 0.0f;
        bs[N + i] = Q && co < a.n_out ? __ldg(a.scale + co) : 0.0f;
      }
      named_sync(2, NCONS * 128);
      bs_cb = T.cb;
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < NR; ++i) acc[mt][i] = 0;
    for (int gch = 0; gch < a.n_chunks; ++gch, ++cnt) {
      const int buf = cnt % L.nbuf;
      mbar_wait(&bars[buf], (cnt / L.nbuf) & 1);
      const uint32_t a_s = base + buf * L.buf_bytes + lane_off;
      const uint32_t w_s = wres ? base + L.wres_off + gch * L.w_bytes
                                : base + buf * L.buf_bytes + L.halo_bytes;
      // B of (dy, dx, k-step) at w_s + ((dy * K + dx) * ks_n + ks) * N * 32
#pragma unroll 1
      for (int dx = 0; dx < K; ++dx)
#pragma unroll 1
        for (int ks = 0; ks < ks_n; ++ks)
          mma_rows<0, MT, K>(acc, A, a_s + dx * L.pstride + ks * 32, row_stride,
                             w_s + (dx * ks_n + ks) * (N * 32), K * ks_n * (N * 32));
      wgmma_wait<0>();
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < NR; ++i) keep(acc[mt][i]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        keep(A[0][i]);
        keep(A[1][i]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&bars[3 + buf]);
    }

    const bool side0 = MODE == UPF && T.x0 == 0;
    const bool side1 = MODE == UPF && a.W - 1 < T.x0 + a.tw;
    const Acc* edge = reinterpret_cast<const Acc*>(smem + L.edge_off) + (ecnt & 1) * 2 * TH * N;
    epilogue<N, MODE, ET>(a, T, acc, bs, edge, stage, side0, side1, has_slope, slope, wg, warp,
                          lane);
    if (side0 || side1) {  // this tile's edge sums are read
      __syncwarp();
      if (lane == 0) mbar_arrive(&bars[6 + (ecnt & 1)]);
      ++ecnt;
    }
  }
}

// float32: halo row `addr` (ldmatrix) split into tf32 parts, hi = rna(x) in
// hl[0] and lo = rna(x - hi) in hl[1].
__device__ __forceinline__ void split_a(uint32_t (&hl)[2][4], uint32_t addr) {
  ldmatrix_x4(hl[0], addr);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float x = __uint_as_float(hl[0][i]);
    hl[0][i] = tf32_rna(x);
    hl[1][i] = tf32_rna(__fsub_rn(x, __uint_as_float(hl[0][i])));
  }
}

// float32 (3xTF32): the products of one (dx, k-step) of a chunk, a halo row
// at a time as mma_rows issues them. Halo row HR, split into its tf32 parts
// in register buffer HR % 4 (row 0 by the caller, row HR + 1 here while row
// HR's products run: the ring of four keeps it clear of the two groups in
// flight, and of the last group of the slab before), is the A operand of
// output row mt = HR - dy for each dy: lo_a*hi_b + hi_a*lo_b + hi_a*hi_b
// (the small products first, B's hi and lo planes one B tile apart) into
// its promotion sum P[mt], issued product by product over the rows (up to
// 6 % faster at k 7 than three in a row on one P[mt], the same sums). The
// first product of a promotion interval starts
// P[mt] from zero (scale-d = 0): `fresh` (the interval starts with this (dx,
// k-step), whose first product for row mt is at dy = 0) or `each` (every
// k-step is an interval: P[mt] is added to the accumulator as soon as the
// row's group completes).
template <int HR, int MT, int K, int N, int NR>
__device__ __forceinline__ void mma_rows_f32(float (&acc)[MT][NR], float (&P)[MT][NR],
                                             uint32_t (&A)[4][2][4], uint32_t a_addr,
                                             uint32_t row_stride, uint32_t w_addr,
                                             uint32_t dy_stride, bool fresh, bool each) {
  static_assert((MT + K - 2) % 4 != 0, "the next slab's row 0 would reuse a buffer in flight");
  uint32_t(&hl)[2][4] = A[HR % 4];
  wgmma_fence();
  // product j of every row in turn: no two consecutive wgmmas share P[r]
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int dy = 0; dy < K; ++dy) {
      const int mt = HR - dy;
      if (mt >= 0 && mt < MT) {
        const int r = mt < 0 ? 0 : (mt < MT ? mt : MT - 1);
        const uint32_t hi_b = w_addr + dy * dy_stride;
        if (j == 0) wgmma_tf32(P[r], hl[1], b_desc(hi_b), !(each || (fresh && dy == 0)));
        if (j == 1) wgmma_tf32(P[r], hl[0], b_desc(hi_b + N * 32), 1);
        if (j == 2) wgmma_tf32(P[r], hl[0], b_desc(hi_b), 1);
      }
    }
  wgmma_commit();
  if constexpr (HR + 1 < MT + K - 1) split_a(A[(HR + 1) % 4], a_addr + (HR + 1) * row_stride);
  if (each) {
    wgmma_wait<0>();
#pragma unroll
    for (int dy = 0; dy < K; ++dy) {
      const int mt = HR - dy;
      if (mt >= 0 && mt < MT) {
        const int r = mt < 0 ? 0 : (mt < MT ? mt : MT - 1);
#pragma unroll
        for (int i = 0; i < NR; ++i) {
          keep(P[r][i]);
          acc[r][i] = __fadd_rn(acc[r][i], P[r][i]);
        }
      }
    }
  } else {
    wgmma_wait<1>();
  }
#pragma unroll
  for (int b = 0; b < 4; ++b)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      keep(A[b][0][i]);
      keep(A[b][1][i]);
    }
  if constexpr (HR + 1 < MT + K - 1)
    mma_rows_f32<HR + 1, MT, K, N>(acc, P, A, a_addr, row_stride, w_addr, dy_stride, fresh,
                                   each);
}

// The float32 consumer warpgroup: consume's walk with 3xTF32 products. The
// tensor cores add to their accumulator by truncation, which over the
// thousands of products of a wide conv sums to a bias (1e-4 at K = 4608 in a
// first mma.sync version that accumulated on them, against a 1e-5 bar), so
// products are summed on the tensor cores only over a promotion interval of
// at most a.promote k-steps of an output row, as whole (dx, k-step) slabs of
// a tile (each holds K k-steps; fewer than K: every k-step), in P, from zero;
// then P is added to the float32 accumulator on the CUDA cores with round to
// nearest.
template <int N, int MODE, int K>
__device__ __forceinline__ void consume_f32(const UpArgs& a, const Layout& L,
                                            unsigned char* smem, uint64_t* bars, int ct) {
  constexpr int MT = mt_of(N, F32, K);
  constexpr int NR = N / 2;
  constexpr uint32_t KSTEP = N * 64;  // the B tiles of one k-step: hi plane, lo plane
  const int wg = ct >> 7;
  const int warp = (ct >> 5) & 3;
  const int lane = ct & 31;
  const int ks_n = a.cchunk / 8;
  const uint32_t row_stride = L.hw * L.pstride;
  const uint32_t lane_off = wg * MT * row_stride +
                            (16 * warp + (lane & 7) + ((lane >> 3) & 1) * 8) * L.pstride +
                            (lane >> 4) * 16;
  const uint32_t base = smem_u32(smem);
  float* bs = reinterpret_cast<float*>(smem + L.bs_off);
  unsigned char* stage = smem + L.stage_off + wg * L.stage_bytes;
  const bool has_slope = a.has_slope;
  const float slope = a.slope;
  const int promote = a.promote / K;  // whole slabs of at most a.promote k-steps
  const bool each = promote <= 0;
  const int slabs = a.n_chunks * K * ks_n;  // of one tile
  uint32_t cnt = 0, ecnt = 0;
  int bs_cb = -1;
  float acc[MT][NR], P[MT][NR];
  uint32_t A[4][2][4];
  const bool wres = (MODE == POOL || MODE == DIRECT) && L.wres;  // as produce's
  if (wres) mbar_wait(&bars[8], 0);

  for (int t = blockIdx.x; t < a.tiles; t += gridDim.x) {
    const TileXY T = tile_of(a, t, NCONS * MT, cb_inner<MODE, F32>());
    if (T.cb != bs_cb) {
      named_sync(2, NCONS * 128);
      for (int i = ct; i < N; i += NCONS * 128) {
        const int co = T.cb * N + i;
        bs[i] = co < a.n_out ? __ldg(a.bias + co) : 0.0f;
        bs[N + i] = 0.0f;
      }
      named_sync(2, NCONS * 128);
      bs_cb = T.cb;
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < NR; ++i) acc[mt][i] = 0.0f;
    int slab = 0;
    for (int gch = 0; gch < a.n_chunks; ++gch, ++cnt) {
      const int buf = cnt % L.nbuf;
      mbar_wait(&bars[buf], (cnt / L.nbuf) & 1);
      const uint32_t a_s = base + buf * L.buf_bytes + lane_off;
      const uint32_t w_s = wres ? base + L.wres_off + gch * L.w_bytes
                                : base + buf * L.buf_bytes + L.halo_bytes;
#pragma unroll 1
      for (int dx = 0; dx < K; ++dx)
#pragma unroll 1
        for (int ks = 0; ks < ks_n; ++ks) {
          const uint32_t a_dk = a_s + dx * L.pstride + ks * 32;
          split_a(A[0], a_dk);
          mma_rows_f32<0, MT, K, N>(acc, P, A, a_dk, row_stride, w_s + (dx * ks_n + ks) * KSTEP,
                                    K * ks_n * KSTEP, !each && slab % promote == 0, each);
          ++slab;
          if (!each && (slab % promote == 0 || slab == slabs)) {
            wgmma_wait<0>();
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
              for (int i = 0; i < NR; ++i) {
                keep(P[mt][i]);
                acc[mt][i] = __fadd_rn(acc[mt][i], P[mt][i]);
              }
          }
        }
      wgmma_wait<0>();
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < NR; ++i) keep(P[mt][i]);
#pragma unroll
      for (int b = 0; b < 4; ++b)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          keep(A[b][0][i]);
          keep(A[b][1][i]);
        }
      __syncwarp();
      if (lane == 0) mbar_arrive(&bars[3 + buf]);
    }
    // K9: the edge sums of the tile's half-columns 0 and Ws-1, as consume
    const bool side0 = MODE == UPF && T.x0 == 0;
    const bool side1 = MODE == UPF && a.W - 1 < T.x0 + a.tw;
    const float* edge =
        reinterpret_cast<const float*>(smem + L.edge_off) + (ecnt & 1) * 2 * NCONS * MT * N;
    epilogue<N, MODE, F32>(a, T, acc, bs, edge, stage, side0, side1, has_slope, slope, wg, warp,
                           lane);
    if (side0 || side1) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&bars[6 + (ecnt & 1)]);
      ++ecnt;
    }
  }
}

// 384 threads: the producer warpgroup, then two consumer warpgroups; one
// persistent block per multiprocessor (its shared memory and the consumers'
// registers) walks the tiles t = blockIdx.x, + gridDim.x, ...
template <int N, int MODE, int ET, int K>
__global__ void __launch_bounds__(THREADS, 1) conv_up_sm90_kernel(const UpArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = make_layout(a.k, a.cchunk, N, ET, MODE == UPF, resident_chunks<MODE>(a));
  // full[3], empty[3], edge_empty[2], weights_resident
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bar_off);
  if (threadIdx.x == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(&bars[i], NPROD + 1);  // + the weights' arrival
    for (int i = 3; i < 8; ++i) mbar_init(&bars[i], NCONS * 4);
    mbar_init(&bars[8], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x < NPROD) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PROD_REGS));
    produce<N, MODE, ET, K>(a, L, smem, bars, threadIdx.x);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONS_REGS));
    if constexpr (ET == F32)
      consume_f32<N, MODE, K>(a, L, smem, bars, threadIdx.x - NPROD);
    else
      consume<N, MODE, ET, K>(a, L, smem, bars, threadIdx.x - NPROD);
  }
}

// ------------------------------------- the streamed mode (K1 at any odd k)

// The streamed mode's producer warpgroup: per (channel chunk, block) pair it
// waits for a free halo buffer and builds the halo tile at the block's
// origin (DIRECT's builder at runtime k, which arrives on hfull itself);
// thread 0 then copies the block's weight slabs (its taps of one dy row
// each, contiguous in K5's layout) into the slab ring, one stage at a time.
template <int N>
__device__ __forceinline__ void produce_stream(const UpArgs& a, const Layout& L,
                                               unsigned char* smem, uint64_t* bars, int p) {
  constexpr int TH = NCONS * mt_of(N, BF16, 0);
  const StreamSplit sp = stream_split(a.k);
  const uint32_t tap_bytes = static_cast<uint32_t>(a.cchunk) * N * 2;
  const size_t row_bytes = static_cast<size_t>(a.k) * tap_bytes;  // a dy row of a chunk
  uint32_t hc = 0, wc = 0;  // halo tiles and slabs produced, over the block's tiles
  for (int t = blockIdx.x; t < a.tiles; t += gridDim.x) {
    const TileXY T = tile_of(a, t, TH, false);
    const unsigned char* wblock = a.wb + static_cast<size_t>(T.cb) * a.n_chunks * a.k * row_bytes;
    for (int gch = 0; gch < a.n_chunks; ++gch)
#pragma unroll 1
      for (int by = 0; by < sp.n; ++by)
#pragma unroll 1
        for (int bx = 0; bx < sp.n; ++bx, ++hc) {
          const int hb = hc % L.nbuf;
          TileXY B = T;  // the block's halo origin: its taps' offset
          B.y0 += sp.origin(by);
          B.x0 += sp.origin(bx);
          mbar_wait(&bars[HEMPTY + hb], ((hc / L.nbuf) & 1) ^ 1);
          build_halo_direct<N, BF16, 0>(a, L, smem + hb * L.halo_bytes, a.ops[0], B,
                                        gch * a.cchunk, &bars[HFULL + hb], p);
          if (p != 0) continue;
          const uint32_t bytes = sp.size(bx) * tap_bytes;
          const unsigned char* wrow = wblock + (static_cast<size_t>(gch) * a.k + sp.origin(by)) *
                                                   row_bytes + sp.origin(bx) * tap_bytes;
          for (int dy = 0; dy < sp.size(by); ++dy, ++wc) {
            const int s = wc & 1;
            mbar_wait(&bars[WEMPTY + s], ((wc >> 1) & 1) ^ 1);
            mbar_arrive_expect_tx(&bars[WFULL + s], bytes);
            bulk_g2s(smem + L.slab_off + s * L.w_bytes, wrow + dy * row_bytes, bytes,
                     &bars[WFULL + s]);
          }
        }
  }
}

// The streamed mode's consumer warpgroup: per (chunk, block) pair it waits
// for the halo tile, then per stage (dy of the block) for its slab, and
// contracts it as DIRECT's consumer contracts a k = 1 conv over the halo
// shifted by dy rows (mma_rows<0, MT, 1>: one halo row per wgmma, the
// block's taps in x); the slab is released after the stage's products
// complete, the halo after the pair's last stage. Every pair of a tile sums
// into the same accumulators. Epilogue as DIRECT's.
template <int N>
__device__ __forceinline__ void consume_stream(const UpArgs& a, const Layout& L,
                                               unsigned char* smem, uint64_t* bars, int ct) {
  constexpr int MT = mt_of(N, BF16, 0);
  constexpr int TH = NCONS * MT;
  constexpr int NR = N / 2;
  const StreamSplit sp = stream_split(a.k);
  const int wg = ct >> 7;
  const int warp = (ct >> 5) & 3;
  const int lane = ct & 31;
  const int ks_n = a.cchunk / 16;
  const uint32_t row_stride = L.hw * L.pstride;
  // this lane's ldmatrix row address, as consume's
  const uint32_t lane_off = wg * MT * row_stride +
                            (16 * warp + (lane & 7) + ((lane >> 3) & 1) * 8) * L.pstride +
                            (lane >> 4) * 16;
  const uint32_t base = smem_u32(smem);
  float* bs = reinterpret_cast<float*>(smem + L.bs_off);
  unsigned char* stage = smem + L.stage_off + wg * L.stage_bytes;
  uint32_t hc = 0, wc = 0;
  int bs_cb = -1;
  float acc[MT][NR];
  uint32_t A[2][4];
  for (int t = blockIdx.x; t < a.tiles; t += gridDim.x) {
    const TileXY T = tile_of(a, t, TH, false);
    if (T.cb != bs_cb) {
      named_sync(2, NCONS * 128);  // the last tile's epilogue is done with bs
      for (int i = ct; i < N; i += NCONS * 128) {
        const int co = T.cb * N + i;
        bs[i] = co < a.n_out ? __ldg(a.bias + co) : 0.0f;
        bs[N + i] = 0.0f;
      }
      named_sync(2, NCONS * 128);
      bs_cb = T.cb;
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < NR; ++i) acc[mt][i] = 0.0f;
    for (int gch = 0; gch < a.n_chunks; ++gch)
#pragma unroll 1
      for (int by = 0; by < sp.n; ++by)
#pragma unroll 1
        for (int bx = 0; bx < sp.n; ++bx, ++hc) {
          const int hb = hc % L.nbuf;
          const int ty = sp.size(by), tx = sp.size(bx);
          mbar_wait(&bars[HFULL + hb], (hc / L.nbuf) & 1);
          const uint32_t a_s = base + hb * L.halo_bytes + lane_off;
#pragma unroll 1
          for (int dy = 0; dy < ty; ++dy, ++wc) {
            const int s = wc & 1;
            mbar_wait(&bars[WFULL + s], (wc >> 1) & 1);
            const uint32_t w_s = base + L.slab_off + s * L.w_bytes;
            // B of (dx, k-step) of this dy row at w_s + (dx * ks_n + ks) * N * 32
#pragma unroll 1
            for (int dx = 0; dx < tx; ++dx)
#pragma unroll 1
              for (int ks = 0; ks < ks_n; ++ks)
                mma_rows<0, MT, 1>(acc, A, a_s + dy * row_stride + dx * L.pstride + ks * 32,
                                   row_stride, w_s + (dx * ks_n + ks) * (N * 32), 0);
            wgmma_wait<0>();
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
              for (int i = 0; i < NR; ++i) keep(acc[mt][i]);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              keep(A[0][i]);
              keep(A[1][i]);
            }
            __syncwarp();
            if (lane == 0) mbar_arrive(&bars[WEMPTY + s]);
          }
          __syncwarp();
          if (lane == 0) mbar_arrive(&bars[HEMPTY + hb]);
        }
    epilogue<N, DIRECT, BF16>(a, T, acc, bs, static_cast<const float*>(nullptr), stage, false,
                              false, a.has_slope, a.slope, wg, warp, lane);
  }
}

// 384 threads, one persistent block per multiprocessor, as conv_up_sm90_kernel.
template <int N>
__global__ void __launch_bounds__(THREADS, 1) conv_stream_sm90_kernel(const UpArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = make_layout_stream(a.k, a.cchunk, N);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bar_off);
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&bars[HFULL + i], NPROD);  // one arrival per producer thread
      mbar_init(&bars[HEMPTY + i], NCONS * 4);
      mbar_init(&bars[WFULL + i], 1);  // the copy's arrival and its bytes
      mbar_init(&bars[WEMPTY + i], NCONS * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x < NPROD) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PROD_REGS));
    produce_stream<N>(a, L, smem, bars, threadIdx.x);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONS_REGS));
    consume_stream<N>(a, L, smem, bars, threadIdx.x - NPROD);
  }
}

constexpr int kInvalid = static_cast<int>(cudaErrorInvalidValue);

template <int N, int MODE, int ET, int K>
int launch_one(UpArgs a, int B, cudaStream_t s) {
  const Layout L = make_layout(a.k, a.cchunk, N, ET, MODE == UPF, resident_chunks<MODE>(a));
  if (L.total > SMEM_MAX) return kInvalid;
  cudaError_t err = cudaFuncSetAttribute(
      conv_up_sm90_kernel<N, MODE, ET, K>, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(err);
  constexpr int TH = NCONS * mt_of(N, ET, K);
  a.tw = TW - (K - 1);
  a.tiles_x = (a.W + a.tw - 1) / a.tw;
  a.tiles_y = (a.H + TH - 1) / TH;
  const long long tiles = static_cast<long long>(a.tiles_x) * a.tiles_y * B * a.n_cb;
  if (tiles > 0x7fffffffLL) return kInvalid;
  a.tiles = static_cast<int>(tiles);
  const int grid = a.tiles < sms ? a.tiles : sms;
  conv_up_sm90_kernel<N, MODE, ET, K><<<grid, THREADS, L.total, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// N = 8 * n_tiles; float32 up to 64 (mt_of).
template <int MODE, int ET, int K>
int launch_n(const UpArgs& a, int B, int n_tiles, cudaStream_t s) {
  switch (n_tiles) {
    case 1: return launch_one<8, MODE, ET, K>(a, B, s);
    case 2: return launch_one<16, MODE, ET, K>(a, B, s);
    case 4: return launch_one<32, MODE, ET, K>(a, B, s);
    case 8: return launch_one<64, MODE, ET, K>(a, B, s);
    case 16:
      if constexpr (ET != F32) return launch_one<128, MODE, ET, K>(a, B, s);
      break;
  }
  return kInvalid;
}

// The kernel sizes each mode is built for, in every element type: K7 and K8
// k in {3, 5}, K9 k = 3, K6 k in {1, 3, 5}, K5 (and K1) k in {3, 5, 7}.
constexpr bool built_for(int mode, int k) {
  return mode == UPF      ? k == 3
         : mode == UPW    ? (k == 1 || k == 3 || k == 5)
         : mode == DIRECT ? (k == 3 || k == 5 || k == 7)
                          : (k == 3 || k == 5);
}

template <int MODE, int ET>
int launch_k(const UpArgs& a, int B, int n_tiles, cudaStream_t s) {
  switch (a.k) {
    case 1:
      if constexpr (built_for(MODE, 1)) return launch_n<MODE, ET, 1>(a, B, n_tiles, s);
      break;
    case 3:
      if constexpr (built_for(MODE, 3)) return launch_n<MODE, ET, 3>(a, B, n_tiles, s);
      break;
    case 5:
      if constexpr (built_for(MODE, 5)) return launch_n<MODE, ET, 5>(a, B, n_tiles, s);
      break;
    case 7:
      if constexpr (built_for(MODE, 7)) return launch_n<MODE, ET, 7>(a, B, n_tiles, s);
      break;
  }
  return kInvalid;
}

// et: the element type (Elem); float32 takes no int8 arguments and
// a.promote.
template <int MODE>
int launch_mode(UpArgs a, int B, int n_tiles, int et, void* stream) {
  if (B <= 0 || a.H <= 0 || a.W <= 0) return 0;
  const bool q = et == I8;
  const int kk = q ? 32 : (et == F32 ? 8 : 16);
  if (!built_for(MODE, a.k) || a.cchunk < kk || a.cchunk % kk || (a.cchunk & (a.cchunk - 1)) ||
      a.cchunk > 128 || a.n_out < 1 || n_tiles < 1 || (q ? !a.scale : a.out_i8) ||
      et < BF16 || et > F32)
    return kInvalid;
  if (MODE == DIRECT) {  // chunks run operand by operand
    if (a.n_ops < 1 || a.n_ops > MAX_OPS) return kInvalid;
    a.n_chunks = 0;
    for (int i = 0; i < a.n_ops; ++i) {
      Operand& o = a.ops[i];
      if (o.c < 1 || o.cs < o.c || (q ? !o.ax : o.in_i8)) return kInvalid;
      o.chunk0 = a.n_chunks;
      a.n_chunks += (o.c + a.cchunk - 1) / a.cchunk;
    }
  } else {
    if (a.cin < 8 || a.cin % 8 || (q ? !a.ax : a.in_i8)) return kInvalid;
    a.n_chunks = (a.cin + a.cchunk - 1) / a.cchunk;
  }
  a.ntaps = MODE == UPF ? 5 : a.k;
  a.n_cb = (a.n_out + n_tiles * 8 - 1) / (n_tiles * 8);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (et == F32) return launch_k<MODE, F32>(a, B, n_tiles, s);
  return q ? launch_k<MODE, I8>(a, B, n_tiles, s) : launch_k<MODE, BF16>(a, B, n_tiles, s);
}

template <int N>
int launch_stream_one(UpArgs a, int B, cudaStream_t s) {
  const Layout L = make_layout_stream(a.k, a.cchunk, N);
  if (L.total > SMEM_MAX) return kInvalid;
  cudaError_t err = cudaFuncSetAttribute(
      conv_stream_sm90_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(err);
  constexpr int TH = NCONS * mt_of(N, BF16, 0);
  a.tw = TW - (stream_split(a.k).widest() - 1);
  a.tiles_x = (a.W + a.tw - 1) / a.tw;
  a.tiles_y = (a.H + TH - 1) / TH;
  const long long tiles = static_cast<long long>(a.tiles_x) * a.tiles_y * B * a.n_cb;
  if (tiles > 0x7fffffffLL) return kInvalid;
  a.tiles = static_cast<int>(tiles);
  const int grid = a.tiles < sms ? a.tiles : sms;
  conv_stream_sm90_kernel<N><<<grid, THREADS, L.total, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

UpArgs up_args(const void* x, int c, int in_i8, const void* ax, const void* wb,
               const void* bias, const void* scale, void* out, int out_i8, int H, int W,
               int Hs, int Ws, int n_out, int k, int cchunk, int has_slope, float slope) {
  UpArgs a = {};
  a.x = x;
  a.cin = c;
  a.in_i8 = in_i8;
  a.ax = static_cast<const float*>(ax);
  a.wb = static_cast<const unsigned char*>(wb);
  a.bias = static_cast<const float*>(bias);
  a.scale = static_cast<const float*>(scale);
  a.out = out;
  a.out_i8 = out_i8;
  a.H = H; a.W = W; a.Hs = Hs; a.Ws = Ws;
  a.n_out = n_out;
  a.k = k;
  a.cchunk = cchunk;
  a.has_slope = has_slope;
  a.slope = slope;
  return a;
}

}  // namespace
