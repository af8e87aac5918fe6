// The tensor-core primitive of conv_phase.cu (K1).
//
// mma.sync.m16n8k16, bf16 in, f32 accumulate. Fragment layout, with
// g = lane / 4 and tig = lane % 4:
//   A (16 x 16, row major):  a0 = A[g][2*tig .. +1]      a1 = A[g + 8][2*tig .. +1]
//                            a2 = A[g][2*tig + 8 .. +1]  a3 = A[g + 8][2*tig + 8 .. +1]
//   B (16 x 8):              b.x = B[2*tig .. +1][g]     b.y = B[2*tig + 8 .. +1][g]
//   C (16 x 8, f32):         c0, c1 = C[g][2*tig .. +1]  c2, c3 = C[g + 8][2*tig .. +1]

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

__device__ __forceinline__ void mma_m16n8k16_bf16(float (&c)[4], const uint32_t (&a)[4],
                                                  const uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}
