// Fragment helpers for mma.sync m16n8k16 (bf16 in, f32 accumulate) of the
// int4 dequant-matmul kernel (and pack_bf16, shared by the wgmma kernels).
//
// Fragment layout of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16x16, row-major): a0 = A[g][2t..2t+1], a1 = A[g+8][2t..], a2 = A[g][2t+8..],
//                         a3 = A[g+8][2t+8..]
//   B (16x8, k-major):    b0 = B[2t..2t+1][g], b1 = B[2t+8..2t+9][g]
//   C (16x8, f32):        c0, c1 = C[g][2t..2t+1], c2, c3 = C[g+8][2t..2t+1]
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> one register of two bf16, the lower column in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// four 8x8 b16 matrices from shared memory: lanes 8i .. 8i + 7 point at the
// rows of matrix i, and lane (g, t) receives row g, columns 2t, 2t + 1 of
// each (with .trans: rows 2t, 2t + 1 of column g), the lower in the low half
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

}  // namespace
