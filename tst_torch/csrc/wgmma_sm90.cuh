// Hopper (sm_90a) building blocks of the flash-attention and fused-MLP
// kernels (and the int4 kernel's copies): the warpgroup product wgmma
// m64n64k16 (bf16 in, f32 accumulate) with B, and A, read from shared memory
// through 128-byte-swizzle matrix descriptors, or A from registers; 16-byte
// cp.async copies into the same swizzled layout; the fences and barriers
// around them; the aligned start of dynamic shared memory.
//
// Tile layout in shared memory ("sw128 tile"): a [64 rows][64 cols] bf16
// block holds 128 bytes a row, and the 16-byte chunk c of row r sits at
// chunk c ^ (r % 8) of that row: the layout that TMA's SWIZZLE_128B writes
// and that wgmma's 128-byte swizzle mode reads. A [64][D] tile is D/64 such
// blocks, 8 KB apart, each 1024-byte aligned. The same bytes are read two
// ways, so no operand is ever staged transposed:
//   K-major: the product's reduction runs along the row (Q as the B operand
//     of S^T = K·Q^T reduces over D). 8-row groups 1024 bytes apart (SBO);
//     a k16 step moves the start address 32 bytes along the row; columns
//     64..127 are the next block.
//   MN-major: the reduction runs down the rows (Q as the B operand of
//     dK += dS^T·Q reduces over the queries; N = D lies along the row). The
//     descriptor's transpose bit; 8-row groups 1024 bytes apart (SBO); a
//     k16 step moves 16 rows = 2048 bytes. Every product here is n64, one
//     64-column block, so the offset between blocks (LBO) is never read.
//
// Accumulator of a m64n64 product, per thread of the warpgroup (warp w,
// lane = 4g + t): d[4j + e] = C[16w + g + 8·(e / 2)][8j + 2t + e % 2],
// j < 8. The A operand from registers, k16 step kk of a [64][64] matrix X:
// {X[g][16kk+2t..], X[g+8][16kk+2t..], X[g][16kk+8+2t..], X[g+8][16kk+8+2t..]}
// (rows of warp w), each register two bf16, the lower column in the low
// half: the accumulator of one product, rounded to bf16, is the A operand
// of the next (pack_a below).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_bf16.cuh"  // pack_bf16

namespace {

constexpr int kSw128Block = 64 * 64 * 2;  // bytes of one [64][64] bf16 block

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the first 1024-byte-aligned address of dynamic shared memory (the
// requested size carries 1024 bytes of slack for it)
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  const uint32_t a = smem_u32(raw);
  return raw + ((1024 - (a & 1023)) & 1023);
}

// byte offset of element (r, c) in a sw128 tile
__device__ __forceinline__ uint32_t sw128_offset(int r, int c) {
  return (c / 64) * kSw128Block + r * 128 + ((((c % 64) / 8) ^ (r % 8)) * 16) + (c % 8) * 2;
}

// 128-byte-swizzle descriptor at shared address `addr`: start address >> 4
// (bits 0-13), LBO 16 bytes (bits 16-29; not read), SBO 1024 bytes (bits
// 32-45), base offset 0 (every tile is 1024-byte aligned), swizzle mode 1
// = 128 bytes (bits 62-63)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

// k16 step kk of a sw128 tile at `tile`, read K-major
__device__ __forceinline__ uint64_t desc_k_major(uint32_t tile, int kk) {
  return sw128_desc(tile + (kk / 4) * kSw128Block + (kk % 4) * 32);
}

// k16 step kk (rows 16kk ..) of column block cb of a sw128 tile, read MN-major
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t tile, int cb, int kk) {
  return sw128_desc(tile + cb * kSw128Block + kk * 2048);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

// the same, writing zeros and reading nothing where `valid` is false
__device__ __forceinline__ void cp_async16_zfill(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// copies made by this thread (cp.async, st.shared) become visible to the
// async proxy that wgmma reads shared memory through; a barrier after it
// extends that to the other threads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// barrier `id` (1..15; 0 is __syncthreads) over `n` threads
__device__ __forceinline__ void named_barrier(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving reads of an accumulator across the
// wgmma_wait that completes it
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define TST_WGMMA_D32                                                                    \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define TST_WGMMA_OUT32(d)                                                                   \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),        \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),           \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),           \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

// d (64x64) = A·B (+ d when `accumulate`): A and B in shared memory, both
// read K-major
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " TST_WGMMA_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : TST_WGMMA_OUT32(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64x64) += A·B: A from registers (the layout above), B in shared memory
// read MN-major (the transpose bit)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " TST_WGMMA_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : TST_WGMMA_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64x64) = A·B (+ d when `accumulate`): A from registers, B in shared
// memory read K-major
__device__ __forceinline__ void wgmma_rs_k(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " TST_WGMMA_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : TST_WGMMA_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

#undef TST_WGMMA_D32
#undef TST_WGMMA_OUT32

// the A operand of four k16 steps from a 64x64 f32 accumulator, rounded to bf16
__device__ __forceinline__ void pack_a(uint32_t (&a)[4][4], const float (&d)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) a[kk][i] = pack_bf16(d[8 * kk + 2 * i], d[8 * kk + 2 * i + 1]);
  }
}

}  // namespace
