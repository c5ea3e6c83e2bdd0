// Hopper (sm_90a) building blocks of the fused-MLP products and of the
// flash-attention forward and dK/dV kernels: warpgroup wgmma m64nNk16 (bf16
// in, f32 accumulate) at N = 128 and 256, A read K-major and B read MN-major
// (or, for S = Q·K^T, K-major too) from 128-byte-swizzled tiles in shared
// memory (the tile layout of wgmma_sm90.cuh, which TMA's SWIZZLE_128B
// writes); TMA tile copies (2-D and 3-D), bulk copies of contiguous bytes and
// the mbarriers they complete; the host's tensor maps; setmaxnreg.
//
// A B tile [64 k rows][N] is N/64 sw128 blocks of [64][64], 8 KB apart. Read
// MN-major (the descriptor's transpose bit), the product runs down the rows:
// 8-row groups 1024 bytes apart (SBO), a k16 step moves 16 rows = 2048
// bytes, and the leading byte offset (LBO) is the distance between the
// 64-column blocks along N, 8 KB; at n64 it is never read, which is why the
// attention kernels leave it at 16 bytes.
//
// Accumulator of a m64nN product, per thread of the warpgroup (warp w, lane
// = 4g + t): d[4j + e] = C[16w + g + 8·(e / 2)][8j + 2t + e % 2], j < N/8.
#pragma once

#include <cuda.h>  // CUtensorMap
#include <cudaTypedefs.h>  // PFN_cuTensorMapEncodeTiled
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_sm90.cuh"

namespace {

// k16 step kk (rows 16kk ..) of the MN-major B tile at shared address
// `tile`, its 64-column blocks kSw128Block bytes apart (LBO)
__device__ __forceinline__ uint64_t desc_mn_wide(uint32_t tile, int kk) {
  return (sw128_desc(tile + kk * 2048) & ~(static_cast<uint64_t>(0x3FFF) << 16)) |
         (static_cast<uint64_t>(kSw128Block >> 4) << 16);
}

// mbarriers in shared memory: `count` arrivals complete a phase; a TMA copy
// adds the bytes it still owes (expect_tx) and pays them on arrival
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// wait until the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// TMA: the box at (c0 along the row, c1 down the rows) of the tensor `map`
// describes, into shared memory at `dst`, paid to barrier `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                         int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, "
      "%4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// the same box of a 3-D tensor map, at (c0 along the row, c1 down the rows,
// c2 across the outer dimension); rows past the map's extent arrive as zeros
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, "
      "%4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// `bytes` contiguous bytes (a multiple of 16, both ends 16-byte aligned) from
// global `src` into shared memory at `dst`, paid to barrier `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// hand registers back (a producer) or take them (the consumers): every warp
// of a warpgroup runs the same one
template <int N>
__device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// a TMA map of a row-major bf16 tensor of `rank` (2 or 3) dimensions,
// `dims` innermost first and `strides` the bytes between steps of the outer
// ones, read in boxes `box` into 128-byte-swizzled tiles (box[0] = 64
// elements: one swizzle row); elements outside the tensor read as zero
inline cudaError_t encode_tensor_map(CUtensorMap* map, const void* base, int rank,
                                     const cuuint64_t* dims, const cuuint64_t* strides,
                                     const cuuint32_t* box) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                             cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess) return cudaErrorNotSupported;
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }
  const cuuint32_t steps[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base),
                            dims, strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int N>
__device__ __forceinline__ void fence_acc_n(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define TST_WGMMA_D_N128 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, " \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, " \
  "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define TST_WGMMA_OUT_N128(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), \
  "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
  "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
  "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), \
  "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
  "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), \
  "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), \
  "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), \
  "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
  "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), \
  "+f"(d[62]), "+f"(d[63])
#define TST_WGMMA_D_N256 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, " \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, " \
  "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, " \
  "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, " \
  "%87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, " \
  "%104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, " \
  "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127}"
#define TST_WGMMA_OUT_N256(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), \
  "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
  "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
  "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), \
  "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
  "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), \
  "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), \
  "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), \
  "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
  "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), \
  "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), \
  "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), \
  "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), \
  "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), \
  "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), \
  "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), \
  "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), \
  "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), \
  "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), \
  "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), \
  "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])

// d (64 x N) = A·B, or += with `accumulate`: A in shared memory read
// K-major, B in shared memory read MN-major (imm-trans-b = 1)
__device__ __forceinline__ void wgmma_ss_mn(float (&d)[64], uint64_t a, uint64_t b,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " TST_WGMMA_D_N128
      ", %64, %65, p, 1, 1, 0, 1;\n}\n"
      : TST_WGMMA_OUT_N128(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 128) = A·B^T, or += with `accumulate`: A and B in shared memory,
// both read K-major (S = Q·K^T with 128 keys)
__device__ __forceinline__ void wgmma_ss_kk(float (&d)[64], uint64_t a, uint64_t b,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " TST_WGMMA_D_N128
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : TST_WGMMA_OUT_N128(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_ss_mn(float (&d)[128], uint64_t a, uint64_t b,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " TST_WGMMA_D_N256
      ", %128, %129, p, 1, 1, 0, 1;\n}\n"
      : TST_WGMMA_OUT_N256(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

#undef TST_WGMMA_D_N128
#undef TST_WGMMA_OUT_N128
#undef TST_WGMMA_D_N256
#undef TST_WGMMA_OUT_N256

}  // namespace
