// Fragment helpers for mma.sync m16n8k16 (bf16 in, f32 accumulate), shared by
// the int4 dequant-matmul and fused-MLP kernels of this directory (and
// pack_bf16 by the wgmma kernels).
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

__device__ __forceinline__ uint32_t load_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The B fragment (b0, b1) of one k16 x n8 tile of a row-major [k][n] matrix
// in shared memory: lanes 0-15 point at the 16 rows k of the tile (8 columns
// from n0, 16-byte aligned); .trans hands lane (g, t) B[2t..2t+1][g] and
// B[2t+8..2t+9][g], the layout above. Lanes 16-31 pass addresses too (any
// valid row); ldmatrix .x2 ignores them.
__device__ __forceinline__ void ldmatrix_b_trans(uint32_t& b0, uint32_t& b1,
                                                 const __nv_bfloat16* row_ptr) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(row_ptr));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(b0), "=r"(b1)
               : "r"(addr));
}

}  // namespace
