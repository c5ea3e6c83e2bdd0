// Tiles, copies and the schedule of the flash-attention kernels for Hopper
// (sm_90a), shared by the forward (flash_attention_fwd.cu) and the backward
// (flash_attention_bwd.cu). Those replace the TPU kernels of
// tst/kernels/flash_attention.py (forward `_fwd_kernel_oneshot` :99,
// `_fwd_kernel` :274, `_fwd_kernel_oneshot_chunked` :464; backward
// `_bwd_dkv_kernel_oneshot` :553, `_bwd_dkv_kernel` :778,
// `_bwd_fused_nolse_kernel` :590, `_bwd_fused_chunked_kernel` :650, the dQ
// kernels :518, :732), as each file's note says.
//
// Two tile shapes, both in the 128-byte-swizzled layout that wgmma reads
// (wgmma_sm90.cuh):
//   * 64-row tiles: a [64][D] bf16 tile is D/64 blocks of [64][64], 8 KB
//     apart. The 64-row kernels kept for packed rows (the forward at D=64,
//     dK/dV and dQ at both), for dK/dV at D=128 and for non-causal dQ at
//     D=128 stage their tiles so, by 16-byte cp.async (load_tile); the
//     persistent dK/dV kernel's ring holds its Q and dO so (TMA boxes of
//     [64][64]).
//   * 128-row tiles: a [128][D] bf16 tile is D/64 blocks of [128][64], 16 KB
//     apart (kRowBlock), as TMA writes a box of 64 columns by 128 rows. The
//     forward's Q, K and V, the dK/dV kernel's K and V and the dQ kernel's
//     Q, dO, K and V are such tiles; a
//     consumer warpgroup reads the 64 rows it owns 8 KB into each block (the
//     swizzle repeats every 8 rows, 1024 bytes, so any 8-row offset keeps it).
//
// What bounds the kernels (chip_smoke.py's _attention_bounds; PERF.md §6):
// at S=512 the forward is bound by its bytes (0.0203 ms at D=64, 0.126 ms at
// D=128) and dK/dV by its products (0.0305, 0.174 ms); at S=16384, D=64 both
// by their products (4.864 and 9.73 ms). Either way a kernel of one
// warpgroup a block, staging its own tiles by cp.async and waiting for each
// product, left the tensor cores idle through every copy and softmax. The
// redesigns (the forward at every shape but packed rows at D=64; dK/dV at
// D=64 unsegmented, the 64-key kernel being faster elsewhere; dQ unsegmented
// but non-causal at D=128) share:
//   * The persistent schedule (sched_tile): one block an SM walks the tiles
//     of the whole call, longest first across the grid (the tile order puts
//     the longest causal rows first), taking them in rounds of gridDim.x in
//     snake order, so that a block that drew a long tile in one round draws
//     a short one in the next. Each tile is computed whole by one block:
//     the results do not depend on which SM computes them, and are bit-equal
//     across calls.
//   * One producer warp (a warpgroup that hands its registers back with
//     setmaxnreg, three of its warps idle) issues every TMA copy into rings
//     of full / empty mbarriers; two consumer warpgroups take the registers
//     and run the products. The split must add up to the block's 384 x 168
//     registers (40 + 2 x 232 a thread's share, or 24 + 2 x 240), or the
//     consumers' setmaxnreg waits forever. Tensor maps are 3-D,
//     [B][S][heads·D] innermost last, with a box inside one batch row: a
//     tile that reaches past S is filled with zeros by TMA instead of
//     reading the next batch's rows.
//   * exp2 by one MUFU instruction (fast_exp2).
// Measured and not kept: keeping a second wgmma group in flight across the
// softmax, and a wgmma behind a branch on the consumer's index (ptxas
// serializes both: C7514, C7520); see the two kernels' notes.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_sm90.cuh"  // TMA, mbarriers, setmaxnreg, wgmma n128; wgmma_sm90.cuh

namespace {

constexpr int kTile = 64;   // rows of a query tile and of a KV tile (the 64-row kernels)
constexpr int kStages = 2;  // depth of the 64-row kernels' tile rings
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
// finite start of the running max (the reference's DEFAULT_MASK_VALUE)
constexpr float kMaxInit = -0.7f * 3.4028234663852886e38f;

constexpr int kRows = 128;               // rows of a TMA-loaded tile
constexpr int kRowBlock = kRows * 128;   // bytes of one [128][64] bf16 sw128 block
constexpr int kHalfBlock = 64 * 128;     // a consumer's 64 rows into such a block
constexpr int kWarpSpecThreads = 384;    // producer warpgroup + two consumer warpgroups
constexpr int kConsumerWarps = 8;        // arrivals that give a ring stage back
constexpr int kMaxDevices = 32;

template <int D>
struct FlashTile {
  static_assert(D == 64 || D == 128, "head dim must be 64 or 128");
  static constexpr int kBlocks = D / 64;                   // 64-column blocks of a tile
  static constexpr int kTileBytes = kBlocks * kSw128Block;  // one [64][D] bf16 tile
  static constexpr int kTile128Bytes = kBlocks * kRowBlock;  // one [128][D] bf16 tile
};

// k16 step kk of a sw128 tile whose 64-column blocks are `block` bytes
// apart, read K-major (the reduction runs along the row)
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int block, int kk) {
  return sw128_desc(tile + (kk / 4) * block + (kk % 4) * 32);
}

// k16 step kk (rows 16kk ..) of column block cb of such a tile, read MN-major
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int block, int cb, int kk) {
  return sw128_desc(tile + cb * block + kk * 2048);
}

// the A operand (wgmma_sm90.cuh's register layout) of D/16 k16 steps of the
// 64 rows of a sw128 tile at `tile` (64-column blocks `block` bytes apart):
// this thread's rows 16·warp + g and + 8
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[D / 16][4], uint32_t tile, int block, int warp,
                                       int g, int t) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 16 * warp + g + 8 * (i & 1), col = 16 * kk + 8 * (i >> 1) + 2 * t;
      const uint32_t off =
          (col / 64) * block + r * 128 + ((((col % 64) / 8) ^ (r % 8)) * 16) + (col % 8) * 2;
      asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(a[kk][i]) : "r"(tile + off));
    }
  }
}

// the A operand of eight k16 steps from a 64x128 f32 accumulator, rounded to bf16
__device__ __forceinline__ void pack_a128(uint32_t (&a)[8][4], const float (&d)[64]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) a[kk][i] = pack_bf16(d[8 * kk + 2 * i], d[8 * kk + 2 * i + 1]);
  }
}

// 2^x on the special-function unit alone (ex2.approx.ftz: one MUFU
// instruction; exp2f adds range fix-ups for denormal results, which here are
// probabilities below 2^-126, flushed to 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// arrive at named barrier `id` without waiting (the other side bar.syncs)
__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// the tile that block `blk` of `grid` takes in round `round`: rounds of
// `grid` tiles, in snake order
__host__ __device__ __forceinline__ int sched_tile(int round, int blk, int grid) {
  return round * grid + ((round & 1) ? grid - 1 - blk : blk);
}

// the number of SMs of `device` (read once), or 0 on error
inline int sm_count(int device) {
  static int cached[kMaxDevices] = {0};
  if (device < 0 || device >= kMaxDevices) return 0;
  if (cached[device] == 0 &&
      cudaDeviceGetAttribute(&cached[device], cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess) {
    return 0;
  }
  return cached[device];
}

// `device` made current (a no-op when it is)
inline cudaError_t use_device(int device) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidValue;
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err == cudaSuccess && cur != device) err = cudaSetDevice(device);
  return err;
}

// a 3-D TMA map of a [B, S, heads·D] bf16 tensor (the model layout
// [B, S, heads, D]) in boxes of [rows][64] within one batch row
inline cudaError_t heads_map(CUtensorMap* map, const void* base, int B, int S, int heads, int D,
                             int rows) {
  const cuuint64_t width = (cuuint64_t)heads * D;
  const cuuint64_t dims[3] = {width, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[2] = {width * 2, width * 2 * (cuuint64_t)S};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  return encode_tensor_map(map, base, 3, dims, strides, box);
}

// cp.async a [64][D] bf16 tile (rows `stride` elements apart) into the sw128
// tile at shared address `dst`; thread `tid` of `kThreads`
template <int D, int kThreads>
__device__ __forceinline__ void load_tile(uint32_t dst, const __nv_bfloat16* src, long stride,
                                          int tid) {
#pragma unroll
  for (int i = tid; i < kTile * D / 8; i += kThreads) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    cp_async16(dst + sw128_offset(r, c), src + (long)r * stride + c);
  }
}

// write a warpgroup's 64 x D block of f32 accumulators as bf16: this
// thread's rows 16·warp + g and + 8 of `out`, rows `stride` elements apart
template <int D>
__device__ __forceinline__ void store_tile(const float (&acc)[D / 64][32], __nv_bfloat16* out,
                                           long stride, int warp, int g, int t) {
  __nv_bfloat16* lo = out + (long)(16 * warp + g) * stride;
  __nv_bfloat16* hi = lo + 8 * stride;
#pragma unroll
  for (int cb = 0; cb < D / 64; ++cb) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = cb * 64 + 8 * j + 2 * t;
      *reinterpret_cast<uint32_t*>(lo + c) = pack_bf16(acc[cb][4 * j], acc[cb][4 * j + 1]);
      *reinterpret_cast<uint32_t*>(hi + c) = pack_bf16(acc[cb][4 * j + 2], acc[cb][4 * j + 3]);
    }
  }
}

// the same for the rows of a 128-row tile: only rows below `rows` (the rest
// lie past the sequence) are written
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 64][32], __nv_bfloat16* out,
                                           long stride, int warp, int g, int t, int rows) {
  const int r = 16 * warp + g;
  __nv_bfloat16* lo = out + (long)r * stride;
  __nv_bfloat16* hi = lo + 8 * stride;
#pragma unroll
  for (int cb = 0; cb < D / 64; ++cb) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = cb * 64 + 8 * j + 2 * t;
      if (r < rows) {
        *reinterpret_cast<uint32_t*>(lo + c) = pack_bf16(acc[cb][4 * j], acc[cb][4 * j + 1]);
      }
      if (r + 8 < rows) {
        *reinterpret_cast<uint32_t*>(hi + c) = pack_bf16(acc[cb][4 * j + 2], acc[cb][4 * j + 3]);
      }
    }
  }
}

}  // namespace
