// Causal GQA flash-attention forward for Hopper (sm_90a), bf16 in, bf16 out
// plus an f32 logsumexp; plain, or segment-masked for packed rows. Both
// products are warpgroup wgmma.
//
// Replaces the TPU kernels `_fwd_kernel_oneshot` (tst/kernels/flash_attention.py:99,
// whole KV in one tile) and `_fwd_kernel` (tst/kernels/flash_attention.py:274,
// tiled online softmax with above-diagonal tiles skipped), both with and
// without their `has_seg` branch (:108, :276), and the segment-sparse
// `_fwd_kernel_oneshot_chunked` (:464, via :346) that the TPU dispatches for
// packed rows at S >= 2048. One kernel covers all of these: the TPU's
// one-shot/tiled/chunked split and its folded `pos_mod` view are VMEM
// schedules, not semantics. The segmented instance (kSeg) is a second
// instantiation of the same template.
//
// Semantics (the reference's, not its block layout):
//   o[b, i, h, :] = sum_j softmax_j(q[b,i,h]·k[b,j,h/G] / sqrt(D), j <= i) v[b,j,h/G]
//   lse[b, h, i]  = logsumexp_j of the same scaled, masked logits (f32)
// with packed rows (kSeg) the softmax runs over seg_start(i) <= j <= i only
// (seg_starts.cuh).
// q [B,S,H,D], k/v [B,S,KVH,D] contiguous in the model layout, read in place
// with strides; query head h reads KV head h / (H/KVH) (heads are KV-major).
// Logits accumulate in f32 and are scaled by 1/sqrt(D) in f32 (log2 units);
// the running max starts at a finite large negative value, so exp(-inf -
// -inf) never appears; probabilities are rounded to bf16 before the P·V
// product, which accumulates in f32, as the reference does.
//
// What bounds it on an H100, at the train step's call (q [32,512,14,64],
// k/v [32,512,2,64], bf16): device memory must carry ~68 MB (q and o 29 MB
// each; k and v 8 MB; lse 0.9 MB), 20.3 us at 3.35 TB/s, against 15.1 GFLOP
// over the 58.8 M (query, key) pairs the causal mask keeps, 15.3 us at the
// dense bf16 peak (989 TFLOP/s): bound by its bytes, with the products close
// behind once they run at the tensor cores' full rate. K and V (8 MB) are
// read by every query tile of every head of their group, so they come from
// L2: ~264 MB of L2 reads a call.
//
// What the design does about it:
//   * one warpgroup (128 threads) per (64-row query tile, head, batch),
//     longest causal rows launched first; warp w owns query rows 16w..16w+16;
//   * S = Q·K^T and O += P·V on wgmma m64n64k16: Q and K from shared memory,
//     both K-major; P from registers (the S accumulator rounded to bf16 in
//     place, pack_a) and V read MN-major through the descriptor's transpose
//     bit, so V is never staged transposed;
//   * Q is copied once and K and V walk a 2-stage ring, all by 16-byte
//     cp.async into the 128-byte-swizzled tiles wgmma reads: an iteration
//     waits for its own copies, passes one barrier and starts the next tile's
//     copies before its products, so staging overlaps the products;
//   * online softmax on the accumulator layout (wgmma_sm90.cuh): rows
//     16w + g and + 8, row max and sum over the 4 lanes of a row by shuffles;
//     the O accumulator is rescaled by exp2(m_old - m_new) before each P·V;
//   * the KV loop stops at the diagonal tile, so tiles above it are never
//     read, and only the diagonal tile is masked.
// Packed rows (kSeg): a query tile [p0, p0+64) visits KV tiles from
// floor(seg_start(p0)/64) up to the diagonal (`_tile_run_condition` :239);
// samples are ~300 tokens, so most boundaries fall inside a tile, and every
// tile below the largest start of the query tile is masked per element
// (col <= row && col >= seg_start(row)), not only the diagonal one. A row
// whose first visited tiles lie wholly before its segment sees only -inf
// there: its running max stays at the finite start value, its weights are
// exp2(-inf) = 0 and l stays 0, and the first tile holding its own columns
// rescales that zero state by exp2(kMaxInit - m) = 0. Every row sees at
// least its own column, so l > 0 at the end.
// Not yet: TMA and a producer warp (cp.async takes instruction slots from
// the consumer), more than one consumer warpgroup a block, 16-byte stores
// of O.
// Measured and not kept (PERF.md §6): two warpgroups a block taking a GQA
// group's heads round-robin over one shared K/V ring (1.38x slower: a
// seventh of the blocks, each warpgroup held to the ring's lockstep), and
// waiting for a tile's P·V only after the next tile's S (within the noise).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_sm90.cuh"
#include "seg_starts.cuh"

namespace {

constexpr float kLn2 = 0.6931471805599453f;
// finite start of the running max (the reference's DEFAULT_MASK_VALUE)
constexpr float kMaxInit = -0.7f * 3.4028234663852886e38f;

// dynamic shared memory: the Q tile, then a ring of (K tile, V tile) stages,
// and the slack of aligned_smem; 41 KB at D=64, 81 KB at D=128
template <int D>
constexpr int fwd_smem() {
  return (1 + 2 * kStages) * FlashTile<D>::kTileBytes + 1024;
}

// one warpgroup per (query tile, head, batch); `seg` (int32 [B, kMaxSegs])
// is read only when kSeg
template <int D, bool kSeg>
__global__ void __launch_bounds__(128)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, const int* __restrict__ seg,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int S, int H, int KVH,
                 float scale_log2) {
  constexpr int kBlocks = FlashTile<D>::kBlocks;
  constexpr int kTileBytes = FlashTile<D>::kTileBytes;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t q_s = smem_u32(aligned_smem(smem_raw));  // Q[query][d], sw128
  const uint32_t ring = q_s + kTileBytes;  // stages of (K[key][d], V[key][d])

  const int q_tile = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int g = (tid % 32) / 4;
  const int t = tid % 4;

  const long q_stride = (long)H * D;  // elements between consecutive positions
  const long kv_stride = (long)KVH * D;
  const long q_off = ((long)b * S + (long)q_tile * kTile) * q_stride + (long)h * D;
  const int row_lo = q_tile * kTile + 16 * warp + g;  // sequence position of rows g, g + 8
  // packed rows: the segment starts of rows row_lo and row_lo + 8, the first
  // KV tile the query tile needs, and its largest start (KV tiles that begin
  // below it are masked per element)
  int st_lo = 0, st_hi = 0, kv_first = 0, st_max = 0;
  if constexpr (kSeg) {
    const int* sb = seg + (long)b * kMaxSegs;
    st_lo = seg_start(sb, row_lo);
    st_hi = seg_start(sb, row_lo + 8);
    kv_first = seg_start(sb, q_tile * kTile) / kTile;
    st_max = seg_start(sb, q_tile * kTile + kTile - 1);
  }
  const int n_kv = q_tile - kv_first + 1;

  // the j-th visited KV tile into ring stage j % kStages
  auto load_kv = [&](int j) {
    const long kv_off = ((long)b * S + (long)(kv_first + j) * kTile) * kv_stride + (long)kvh * D;
    const uint32_t st = ring + (j % kStages) * 2 * kTileBytes;
    load_tile<D, 128>(st, k + kv_off, kv_stride, tid);
    load_tile<D, 128>(st + kTileBytes, v + kv_off, kv_stride, tid);
  };
  load_tile<D, 128>(q_s, q + q_off, q_stride, tid);
  load_kv(0);
  cp_async_commit();

  float acc[kBlocks][32];
#pragma unroll
  for (int cb = 0; cb < kBlocks; ++cb) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[cb][i] = 0.f;
  }
  // running max (log2 units) and this thread's partial row sums, rows g and g+8
  float m_lo = kMaxInit, m_hi = kMaxInit;
  float l_lo = 0.f, l_hi = 0.f;

  for (int j = 0; j < n_kv; ++j) {
    cp_async_wait<0>();  // KV tile j's copies (this thread's), and Q's
    fence_proxy_async();
    __syncthreads();     // all of them; every warp is done with tile j - 1
    if (j + 1 < n_kv) load_kv(j + 1);
    cp_async_commit();

    const int kv_tile = kv_first + j;
    const int kv0 = kv_tile * kTile;
    const uint32_t k_t = ring + (j % kStages) * 2 * kTileBytes;
    const uint32_t v_t = k_t + kTileBytes;

    // S = Q K^T: queries x keys
    float s[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss(s, desc_k_major(q_s, kk), desc_k_major(k_t, kk), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(s);

    // scale (log2 units), mask the diagonal tile (and, packed, every tile
    // that starts below a row's segment), row max over the 4 lanes of a row
    const bool masked = kSeg ? kv_tile == q_tile || kv0 < st_max : kv_tile == q_tile;
    float mx_lo = kMaxInit, mx_hi = kMaxInit;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const bool hi = (i & 2) != 0;
      const int col = 8 * (i / 4) + 2 * t + (i & 1);  // key within the tile
      float x = s[i] * scale_log2;
      if (masked) {
        if constexpr (kSeg) {
          const int key = kv0 + col;
          if (key > row_lo + (hi ? 8 : 0) || key < (hi ? st_hi : st_lo)) x = -INFINITY;
        } else {
          if (col > 16 * warp + g + (hi ? 8 : 0)) x = -INFINITY;
        }
      }
      s[i] = x;
      if (hi) {
        mx_hi = fmaxf(mx_hi, x);
      } else {
        mx_lo = fmaxf(mx_lo, x);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
    }
    const float mn_lo = fmaxf(m_lo, mx_lo);
    const float mn_hi = fmaxf(m_hi, mx_hi);
    const float corr_lo = exp2f(m_lo - mn_lo);
    const float corr_hi = exp2f(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;

    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if (i & 2) {
        s[i] = exp2f(s[i] - mn_hi);
        sum_hi += s[i];
      } else {
        s[i] = exp2f(s[i] - mn_lo);
        sum_lo += s[i];
      }
    }
    l_lo = l_lo * corr_lo + sum_lo;
    l_hi = l_hi * corr_hi + sum_hi;
#pragma unroll
    for (int cb = 0; cb < kBlocks; ++cb) {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[cb][i] *= (i & 2) ? corr_hi : corr_lo;
    }

    // O += P V: P rounded to bf16 A fragments, V read MN-major
    uint32_t pa[4][4];
    pack_a(pa, s);
    wgmma_fence();
#pragma unroll
    for (int cb = 0; cb < kBlocks; ++cb) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs(acc[cb], pa[kk], desc_mn_major(v_t, cb, kk));
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int cb = 0; cb < kBlocks; ++cb) fence_acc(acc[cb]);
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
#pragma unroll
  for (int cb = 0; cb < kBlocks; ++cb) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[cb][i] /= (i & 2) ? l_hi : l_lo;
  }
  store_tile<D>(acc, o + q_off, q_stride, warp, g, t);
  if (t == 0) {
    float* lse_bh = lse + ((long)b * H + h) * S;
    lse_bh[row_lo] = (m_lo + log2f(l_lo)) * kLn2;
    lse_bh[row_lo + 8] = (m_hi + log2f(l_hi)) * kLn2;
  }
}

template <int D, bool kSeg>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, const void* seg, void* o,
                       void* lse, int B, int S, int H, int KVH, float scale_log2,
                       cudaStream_t st) {
  constexpr int smem = fwd_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<D, kSeg>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  flash_fwd_kernel<D, kSeg><<<dim3(S / kTile, H, B), 128, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(seg),
      static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), S, H, KVH, scale_log2);
  return cudaGetLastError();
}

template <bool kSeg>
int fwd(const void* q, const void* k, const void* v, const void* seg, void* o, void* lse, int B,
        int S, int H, int KVH, int D, float scale, int device, void* stream) {
  if (B <= 0 || S <= 0 || S % kTile != 0 || KVH <= 0 || H % KVH != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float scale_log2 = scale * kLog2e;
  if (D == 64) {
    return (int)launch_fwd<64, kSeg>(q, k, v, seg, o, lse, B, S, H, KVH, scale_log2, st);
  }
  if (D == 128) {
    return (int)launch_fwd<128, kSeg>(q, k, v, seg, o, lse, B, S, H, KVH, scale_log2, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C entries for ctypes. Pointers are device pointers of contiguous
// tensors (seg: int32 [B, kMaxSegs]); `stream` is a cudaStream_t. Each
// returns the launch's cudaError_t.
extern "C" int tst_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                       void* lse, int B, int S, int H, int KVH, int D,
                                       float scale, int device, void* stream) {
  return fwd<false>(q, k, v, nullptr, o, lse, B, S, H, KVH, D, scale, device, stream);
}

extern "C" int tst_flash_attention_fwd_seg(const void* q, const void* k, const void* v,
                                           const void* seg, void* o, void* lse, int B, int S,
                                           int H, int KVH, int D, float scale, int device,
                                           void* stream) {
  if (seg == nullptr) return (int)cudaErrorInvalidValue;
  return fwd<true>(q, k, v, seg, o, lse, B, S, H, KVH, D, scale, device, stream);
}
