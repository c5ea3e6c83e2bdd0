// Tiles of the flash-attention kernels for Hopper (sm_90a), shared by the
// forward (flash_attention_fwd.cu) and the backward (flash_attention_bwd.cu):
// the tile size, the size of a [64][D] bf16 tile in the 128-byte-swizzled
// layout that wgmma reads (wgmma_sm90.cuh), and the copies of a tile in
// (cp.async) and of a warpgroup's accumulators out (bf16 stores).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "wgmma_sm90.cuh"

namespace {

constexpr int kTile = 64;   // rows of a query tile and of a KV tile
constexpr int kStages = 2;  // depth of a warpgroup's tile ring
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct FlashTile {
  static_assert(D == 64 || D == 128, "head dim must be 64 or 128");
  static constexpr int kBlocks = D / 64;                   // 64-column blocks of a tile
  static constexpr int kTileBytes = kBlocks * kSw128Block;  // one [64][D] bf16 tile
};

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

}  // namespace
