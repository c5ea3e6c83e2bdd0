// Causal GQA flash-attention backward for Hopper (sm_90a): two kernels, one
// for dK/dV and one for dQ, bf16 in and out, f32 accumulation; plain, or
// segment-masked for packed rows. Every product is a warpgroup wgmma.
//
// Replaces the TPU backward kernels of tst/kernels/flash_attention.py:
//   _bwd_fused_nolse_kernel (:590, via _flash_bwd_fused :836), the fused
//     dq/dk/dv of the single-KV-tile regime;
//   _bwd_dq_kernel_oneshot (:518) and _bwd_dkv_kernel_oneshot (:553), via
//     _flash_bwd :934, the one-shot forms from the saved lse;
//   _bwd_dq_kernel (:732, via _flash_bwd) and _bwd_dkv_kernel (:778, via
//     _dkv_tiled :1041), the tiled forms.
// and, for packed rows, the `has_seg` branches of all five (:521, :556, :603,
// :734, :780) and the segment-sparse `_bwd_fused_chunked_kernel` (:650, via
// `_flash_bwd_fused` :854) that the TPU dispatches at S >= 2048.
// They share one semantics; their one-shot / tiled / fused / chunked split is
// a TPU VMEM schedule, so these two kernels cover all of them. The segmented
// kernels (kSeg) are second instantiations of the same templates.
//
// Semantics (the reference's): with the forward's f32 lse [B,H,S] and
// di[b,h,i] = sum_d o·do (f32, computed by the caller from the bf16 o),
//   P[i,j]  = exp(scale·q_i·k_j - lse_i) for j <= i (and, packed,
//             j >= seg_start(i): seg_starts.cuh), else exactly 0
//   dv_j    = sum over the G = H/KVH query heads of a KV head, sum_i P[i,j] do_i
//   dS[i,j] = P[i,j] · (do_i·v_j - di_i)
//   dq_i    = scale · sum_j dS[i,j] k_j
//   dk_j    = scale · group sum, sum_i dS[i,j] q_i
// q/do/dq [B,S,H,D], k/v/dk/dv [B,S,KVH,D], contiguous, read in place with
// strides. P is recomputed as the forward made it: f32 logits scaled in f32,
// minus the f32 lse (both in log2 units); P and scale·dS are rounded to bf16
// only as operands of the products.
//
// What bounds it on an H100, at the train step's call (q [32,512,14,64], k/v
// [32,512,2,64], bf16): the causal mask keeps 58.8 M (query, key) pairs over
// the 448 (b, h), 2·D = 128 operations a pair for each product.
//   dK/dV: S^T, dP^T, dV, dK: 30.1 GFLOP, 30.5 us at the dense bf16 peak
//     (989 TFLOP/s), against 77 MB (q, do 29 MB each; k, v, dk, dv 4 MB each;
//     lse, di 0.9 MB each), 23 us at 3.35 TB/s: bound by its products.
//   dQ: S, dP, dQ: 22.6 GFLOP, 22.8 us, against 98 MB (q, do, dq; k, v; lse,
//     di), 29.3 us: bound by its bytes.
//   (chip_smoke.py computes both bounds from each run's shapes and masks.)
//   The two kernels stay separate, with no dq by atomics: S and dP are
//   computed in both, 7 products a pair where a fused kernel would do 5.
//
// What the design does about each limit of the earlier mma.sync design:
//   * products: wgmma m64n64k16 for all of them. dK/dV: S^T = K·Q^T and
//     dP^T = V·dO^T with both operands in shared memory; P^T and scale·dS^T
//     go from the accumulators to registers as bf16 and are the A operand of
//     dV += P^T·dO and dK += scale·dS^T·Q, which read dO and Q MN-major
//     through the descriptor's transpose bit. dQ: S = Q·K^T, dP = dO·V^T from
//     shared memory, dQ += scale·dS·K with K read MN-major. Tiles are staged
//     once, in the 128-byte-swizzled layout wgmma reads (wgmma_sm90.cuh), so
//     there is no transposed copy and no bank-conflicted scalar store;
//   * staging overlaps the products: each warpgroup walks its tiles through a
//     2-stage ring loaded ahead by 16-byte cp.async (dK/dV: Q, dO, lse, di
//     and, packed, the segment starts; dQ: K and V). An iteration waits for
//     its own copies and passes one barrier of its own warpgroup (named, of
//     128 threads, in dK/dV; in dQ the block is one warpgroup), then starts
//     the next tile's copies before its products: one barrier an iteration
//     where there were two block-wide ones;
//   * the GQA loop is balanced: a dK/dV block (one 64-row KV tile, one KV
//     head) hands its (query head, query tile) pairs round-robin to W
//     warpgroups (W = 3 at D = 64, 2 at D = 128, as registers allow), each
//     with its own dK and dV accumulators and its own ring. The block of KV
//     tile 0, 7 heads x 8 query tiles = 56 pairs at the train shape, is
//     19 pairs deep instead of 56. At the end the warpgroups' accumulators
//     are summed in shared memory in a fixed order (0, then 1, then 2): no
//     atomics, each dk/dv/dq element written once, bit-equal across calls;
//   * dQ: one warpgroup per (64-row query tile, head, batch) walks the KV
//     tiles up to the diagonal, longest rows launched first;
//   * masks as before: only the diagonal tile is masked when unpacked, and a
//     masked entry is set to 0 rather than computed as exp(-inf - lse).
//     Packed rows (kSeg): dQ visits KV tiles from floor(seg_start(p0)/64) up
//     to the diagonal, as the forward does; a dK/dV block for KV tile
//     [c0, c0+64) visits query tiles from the diagonal up to the first start
//     > c0+63 (rows from there on start their segment after the whole tile),
//     or S. A tile pair is masked per element (col <= row && col >=
//     seg_start(row)) when it is diagonal or the query tile's largest start
//     lies beyond the KV tile's first column; the dK/dV ring stage carries
//     each query's start beside its lse and di.
// Not yet: TMA and a producer warp (cp.async costs the consumers issue
// slots), overlap of one pair's dV/dK products with the next pair's S^T.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "seg_starts.cuh"
#include "wgmma_sm90.cuh"

namespace {

constexpr int kTile = 64;  // rows of a query tile and of a KV tile
constexpr int kStages = 2;  // depth of each warpgroup's tile ring
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Bwd {
  static_assert(D == 64 || D == 128, "head dim must be 64 or 128");
  static constexpr int kBlocks = D / 64;                   // 64-column blocks of a tile
  static constexpr int kTileBytes = kBlocks * kSw128Block;  // one [64][D] bf16 tile
  // dK/dV: warpgroups a block (each 128 threads), K and V, then a ring per
  // warpgroup of (Q tile, dO tile, lse[64], di[64], starts[64]) stages
  static constexpr int kDkvGroups = D == 64 ? 3 : 2;
  static constexpr int kDkvStage = 2 * kTileBytes + 1024;  // stats padded to keep tiles aligned
  static constexpr int kDkvSmem = 2 * kTileBytes + kDkvGroups * kStages * kDkvStage + 1024;
  // dQ: one warpgroup; Q and dO, then a ring of (K tile, V tile) stages
  static constexpr int kDqSmem = 2 * kTileBytes + kStages * 2 * kTileBytes + 1024;
  // the final sum of the dK/dV warpgroups' accumulators fits in their rings
  static_assert((kDkvGroups - 1) * 2 * 64 * D * 4 <= kDkvGroups * kStages * kDkvStage, "");
};

// the first 1024-byte-aligned address of dynamic shared memory (the
// requested size carries 1024 bytes of slack for it)
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  const uint32_t a = smem_u32(raw);
  return raw + ((1024 - (a & 1023)) & 1023);
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

// dK, dV: one block per (KV tile, KV head, batch), W warpgroups. Warpgroup
// w takes pairs w, w + W, ... of the (query head, query tile) pairs that see
// the tile; warp i of a warpgroup owns KV rows 16i .. 16i+16. `seg` (int32
// [B, kMaxSegs]) is read only when kSeg.
template <int D, bool kSeg>
__global__ void __launch_bounds__(Bwd<D>::kDkvGroups * 128, 1)
flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ di,
                     const int* __restrict__ seg, __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int S, int H, int KVH, float scale) {
  using T = Bwd<D>;
  constexpr int W = T::kDkvGroups;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const uint32_t k_s = smem_u32(smem);  // K[key][d], sw128
  const uint32_t v_s = k_s + T::kTileBytes;
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int g = (tid % 32) / 4;
  const int t = tid % 4;
  unsigned char* ring = smem + 2 * T::kTileBytes + wg * kStages * T::kDkvStage;

  const int kv_tile = blockIdx.x;  // tile 0 has the most query tiles: launched first
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int groups = H / KVH;
  const float scale_log2 = scale * kLog2e;
  const int kv0 = kv_tile * kTile;
  // one past the last query tile that sees this KV tile: packed, the rows
  // from the first start after the tile on start their segment after it
  int q_end = S / kTile;
  const int* sb = nullptr;
  if constexpr (kSeg) {
    sb = seg + (long)b * kMaxSegs;
    q_end = (seg_end(sb, kv0 + kTile - 1, S) + kTile - 1) / kTile;
  }
  const int nq = q_end - kv_tile;
  const int n_pairs = groups * nq;
  const int n_mine = wg < n_pairs ? (n_pairs - wg + W - 1) / W : 0;

  const long q_stride = (long)H * D;
  const long kv_stride = (long)KVH * D;
  const long kv_off = ((long)b * S + kv0) * kv_stride + (long)kvh * D;
  load_tile<D, W * 128>(k_s, k + kv_off, kv_stride, threadIdx.x);
  load_tile<D, W * 128>(v_s, v + kv_off, kv_stride, threadIdx.x);
  cp_async_commit();

  // this warpgroup's j-th pair into ring stage j % kStages
  auto load_pair = [&](int j) {
    const int p = wg + j * W;
    const int h = kvh * groups + p / nq;
    const int q0 = (kv_tile + p % nq) * kTile;
    unsigned char* st = ring + (j % kStages) * T::kDkvStage;
    const long q_off = ((long)b * S + q0) * q_stride + (long)h * D;
    load_tile<D, 128>(smem_u32(st), q + q_off, q_stride, tid);
    load_tile<D, 128>(smem_u32(st) + T::kTileBytes, dout + q_off, q_stride, tid);
    float* lse_s = reinterpret_cast<float*>(st + 2 * T::kTileBytes);
    const long r0 = ((long)b * H + h) * S + q0;
    if (tid < 16) {
      cp_async16(smem_u32(lse_s + 4 * tid), lse + r0 + 4 * tid);
    } else if (tid < 32) {
      cp_async16(smem_u32(lse_s + kTile + 4 * (tid - 16)), di + r0 + 4 * (tid - 16));
    } else if (kSeg && tid >= 64) {
      reinterpret_cast<int*>(lse_s + 2 * kTile)[tid - 64] = seg_start(sb, q0 + tid - 64);
    }
  };

  if (n_mine > 0) load_pair(0);
  cp_async_commit();
  cp_async_wait<1>();  // K and V (this thread's copies)
  fence_proxy_async();
  __syncthreads();     // all of K and V

  float acc_dk[T::kBlocks][32], acc_dv[T::kBlocks][32];
#pragma unroll
  for (int cb = 0; cb < T::kBlocks; ++cb) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc_dk[cb][i] = acc_dv[cb][i] = 0.f;
  }

  for (int j = 0; j < n_mine; ++j) {
    cp_async_wait<0>();  // pair j's copies (this thread's)
    fence_proxy_async();
    named_barrier(1 + wg, 128);  // all of pair j; every warp done with pair j - 1
    if (j + 1 < n_mine) load_pair(j + 1);
    cp_async_commit();

    const int p = wg + j * W;
    const int q_tile = kv_tile + p % nq;
    const int q0 = q_tile * kTile;
    unsigned char* st = ring + (j % kStages) * T::kDkvStage;
    const uint32_t q_t = smem_u32(st);  // Q[query][d], sw128
    const uint32_t do_t = q_t + T::kTileBytes;
    const float* lse_s = reinterpret_cast<const float*>(st + 2 * T::kTileBytes);
    const float* di_s = lse_s + kTile;
    const int* st_s = reinterpret_cast<const int*>(di_s + kTile);

    // S^T = K Q^T and dP^T = V dO^T: keys x queries
    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss(s, desc_k_major(k_s, kk), desc_k_major(q_t, kk), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss(dp, desc_k_major(v_s, kk), desc_k_major(do_t, kk), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(s);
    fence_acc(dp);

    const bool diag = q_tile == kv_tile;
    // packed: masked per element when a query's segment starts after kv0
    const bool masked = kSeg ? diag || st_s[kTile - 1] > kv0 : diag;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = 8 * (i / 4) + 2 * t + (i & 1);     // query within the tile
      const int row = 16 * warp + g + ((i & 2) ? 8 : 0);  // key within the tile
      bool off;
      if constexpr (kSeg) {
        off = masked && (kv0 + row > q0 + col || kv0 + row < st_s[col]);
      } else {
        off = masked && col < row;
      }
      const float pv = off ? 0.f : exp2f(s[i] * scale_log2 - lse_s[col] * kLog2e);
      s[i] = pv;                                   // P^T
      dp[i] = pv * (dp[i] - di_s[col]) * scale;    // scale·dS^T
    }
    uint32_t pa[4][4], dsa[4][4];
    pack_a(pa, s);
    pack_a(dsa, dp);

    // dV += P^T dO and dK += scale·dS^T Q, dO and Q read MN-major
    wgmma_fence();
#pragma unroll
    for (int cb = 0; cb < T::kBlocks; ++cb) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs(acc_dv[cb], pa[kk], desc_mn_major(do_t, cb, kk));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs(acc_dk[cb], dsa[kk], desc_mn_major(q_t, cb, kk));
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int cb = 0; cb < T::kBlocks; ++cb) {
      fence_acc(acc_dv[cb]);
      fence_acc(acc_dk[cb]);
    }
  }

  // sum the warpgroups' accumulators in a fixed order, through the rings
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem + 2 * T::kTileBytes);
  constexpr int kRegs = T::kBlocks * 32;
  if (wg > 0) {
    float* mine = red + (wg - 1) * 2 * kRegs * 128;
#pragma unroll
    for (int cb = 0; cb < T::kBlocks; ++cb) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        mine[(cb * 32 + i) * 128 + tid] = acc_dk[cb][i];
        mine[(kRegs + cb * 32 + i) * 128 + tid] = acc_dv[cb][i];
      }
    }
  }
  __syncthreads();
  if (wg == 0) {
#pragma unroll
    for (int w = 1; w < W; ++w) {
      const float* theirs = red + (w - 1) * 2 * kRegs * 128;
#pragma unroll
      for (int cb = 0; cb < T::kBlocks; ++cb) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          acc_dk[cb][i] += theirs[(cb * 32 + i) * 128 + tid];
          acc_dv[cb][i] += theirs[(kRegs + cb * 32 + i) * 128 + tid];
        }
      }
    }
    store_tile<D>(acc_dk, dk + kv_off, kv_stride, warp, g, t);
    store_tile<D>(acc_dv, dv + kv_off, kv_stride, warp, g, t);
  }
}

// dQ: one warpgroup per (query tile, head, batch); warp i owns query rows
// 16i .. 16i+16 of the tile. `seg` (int32 [B, kMaxSegs]) is read only when
// kSeg.
template <int D, bool kSeg>
__global__ void __launch_bounds__(128)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ di,
                    const int* __restrict__ seg, __nv_bfloat16* __restrict__ dq, int S, int H,
                    int KVH, float scale) {
  using T = Bwd<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const uint32_t q_s = smem_u32(smem);  // Q[query][d], sw128
  const uint32_t do_s = q_s + T::kTileBytes;
  const uint32_t ring = do_s + T::kTileBytes;  // stages of (K[key][d], V[key][d])

  const int q_tile = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int g = (tid % 32) / 4;
  const int t = tid % 4;
  const float scale_log2 = scale * kLog2e;

  const long q_stride = (long)H * D;
  const long kv_stride = (long)KVH * D;
  const long q_off = ((long)b * S + (long)q_tile * kTile) * q_stride + (long)h * D;
  const int row_lo = q_tile * kTile + 16 * warp + g;  // sequence position of rows g, g + 8
  const long stat = ((long)b * H + h) * S;
  const float lse_lo = lse[stat + row_lo] * kLog2e, lse_hi = lse[stat + row_lo + 8] * kLog2e;
  const float di_lo = di[stat + row_lo], di_hi = di[stat + row_lo + 8];
  // packed rows: the segment starts of rows row_lo and row_lo + 8, the first
  // KV tile the query tile needs, and its largest start
  int st_lo = 0, st_hi = 0, kv_first = 0, st_max = 0;
  if constexpr (kSeg) {
    const int* sb = seg + (long)b * kMaxSegs;
    st_lo = seg_start(sb, row_lo);
    st_hi = seg_start(sb, row_lo + 8);
    kv_first = seg_start(sb, q_tile * kTile) / kTile;
    st_max = seg_start(sb, q_tile * kTile + kTile - 1);
  }
  const int n_kv = q_tile - kv_first + 1;

  auto load_kv = [&](int j) {
    const long kv_off = ((long)b * S + (long)(kv_first + j) * kTile) * kv_stride + (long)kvh * D;
    const uint32_t st = ring + (j % kStages) * 2 * T::kTileBytes;
    load_tile<D, 128>(st, k + kv_off, kv_stride, tid);
    load_tile<D, 128>(st + T::kTileBytes, v + kv_off, kv_stride, tid);
  };
  load_tile<D, 128>(q_s, q + q_off, q_stride, tid);
  load_tile<D, 128>(do_s, dout + q_off, q_stride, tid);
  load_kv(0);
  cp_async_commit();

  float acc[T::kBlocks][32];
#pragma unroll
  for (int cb = 0; cb < T::kBlocks; ++cb) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[cb][i] = 0.f;
  }

  for (int j = 0; j < n_kv; ++j) {
    cp_async_wait<0>();  // KV tile j's copies (this thread's)
    fence_proxy_async();
    __syncthreads();     // the block is this one warpgroup
    if (j + 1 < n_kv) load_kv(j + 1);
    cp_async_commit();

    const int kv_tile = kv_first + j;
    const uint32_t k_t = ring + (j % kStages) * 2 * T::kTileBytes;
    const uint32_t v_t = k_t + T::kTileBytes;

    // S = Q K^T and dP = dO V^T: queries x keys
    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss(s, desc_k_major(q_s, kk), desc_k_major(k_t, kk), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss(dp, desc_k_major(do_s, kk), desc_k_major(v_t, kk), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(s);
    fence_acc(dp);

    const bool diag = kv_tile == q_tile;
    const bool masked = kSeg ? diag || kv_tile * kTile < st_max : diag;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const bool hi = (i & 2) != 0;
      const int col = 8 * (i / 4) + 2 * t + (i & 1);  // key within the tile
      const int row = 16 * warp + g + (hi ? 8 : 0);   // query within the tile
      bool off;
      if constexpr (kSeg) {
        const int key = kv_tile * kTile + col;
        off = masked && (key > row_lo + (hi ? 8 : 0) || key < (hi ? st_hi : st_lo));
      } else {
        off = masked && col > row;
      }
      const float pv = off ? 0.f : exp2f(s[i] * scale_log2 - (hi ? lse_hi : lse_lo));
      dp[i] = pv * (dp[i] - (hi ? di_hi : di_lo)) * scale;  // scale·dS
    }
    uint32_t dsa[4][4];
    pack_a(dsa, dp);

    // dQ += scale·dS K, K read MN-major
    wgmma_fence();
#pragma unroll
    for (int cb = 0; cb < T::kBlocks; ++cb) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs(acc[cb], dsa[kk], desc_mn_major(k_t, cb, kk));
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int cb = 0; cb < T::kBlocks; ++cb) fence_acc(acc[cb]);
  }

  store_tile<D>(acc, dq + q_off, q_stride, warp, g, t);
}

template <int D, bool kSeg>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* di, const void* seg, void* dk, void* dv,
                       int B, int S, int H, int KVH, float scale, cudaStream_t st) {
  constexpr int smem = Bwd<D>::kDkvSmem;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<D, kSeg>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_kernel<D, kSeg><<<dim3(S / kTile, KVH, B), Bwd<D>::kDkvGroups * 128, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(di),
      static_cast<const int*>(seg), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), S, H, KVH, scale);
  return cudaGetLastError();
}

template <int D, bool kSeg>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* di, const void* seg, void* dq, int B, int S,
                      int H, int KVH, float scale, cudaStream_t st) {
  constexpr int smem = Bwd<D>::kDqSmem;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D, kSeg>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<D, kSeg><<<dim3(S / kTile, H, B), 128, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(di),
      static_cast<const int*>(seg), static_cast<__nv_bfloat16*>(dq), S, H, KVH, scale);
  return cudaGetLastError();
}

bool bad_shape(int B, int S, int H, int KVH) {
  return B <= 0 || S <= 0 || S % kTile != 0 || KVH <= 0 || H % KVH != 0;
}

template <bool kSeg>
int bwd_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
            const void* di, const void* seg, void* dk, void* dv, int B, int S, int H, int KVH,
            int D, float scale, int device, void* stream) {
  if (bad_shape(B, S, H, KVH)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) {
    return (int)launch_dkv<64, kSeg>(q, k, v, dout, lse, di, seg, dk, dv, B, S, H, KVH, scale, st);
  }
  if (D == 128) {
    return (int)launch_dkv<128, kSeg>(q, k, v, dout, lse, di, seg, dk, dv, B, S, H, KVH, scale,
                                      st);
  }
  return (int)cudaErrorInvalidValue;
}

template <bool kSeg>
int bwd_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
           const void* di, const void* seg, void* dq, int B, int S, int H, int KVH, int D,
           float scale, int device, void* stream) {
  if (bad_shape(B, S, H, KVH)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) {
    return (int)launch_dq<64, kSeg>(q, k, v, dout, lse, di, seg, dq, B, S, H, KVH, scale, st);
  }
  if (D == 128) {
    return (int)launch_dq<128, kSeg>(q, k, v, dout, lse, di, seg, dq, B, S, H, KVH, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C entries for ctypes. Pointers are device pointers of contiguous
// tensors (lse, di: f32 [B,H,S]; seg: int32 [B, kMaxSegs]); `stream` is a
// cudaStream_t. Each returns the launch's cudaError_t.
extern "C" int tst_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                           const void* dout, const void* lse, const void* di,
                                           void* dk, void* dv, int B, int S, int H, int KVH,
                                           int D, float scale, int device, void* stream) {
  return bwd_dkv<false>(q, k, v, dout, lse, di, nullptr, dk, dv, B, S, H, KVH, D, scale, device,
                        stream);
}

extern "C" int tst_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                          const void* dout, const void* lse, const void* di,
                                          void* dq, int B, int S, int H, int KVH, int D,
                                          float scale, int device, void* stream) {
  return bwd_dq<false>(q, k, v, dout, lse, di, nullptr, dq, B, S, H, KVH, D, scale, device,
                       stream);
}

extern "C" int tst_flash_attention_bwd_dkv_seg(const void* q, const void* k, const void* v,
                                               const void* dout, const void* lse, const void* di,
                                               const void* seg, void* dk, void* dv, int B, int S,
                                               int H, int KVH, int D, float scale, int device,
                                               void* stream) {
  if (seg == nullptr) return (int)cudaErrorInvalidValue;
  return bwd_dkv<true>(q, k, v, dout, lse, di, seg, dk, dv, B, S, H, KVH, D, scale, device,
                       stream);
}

extern "C" int tst_flash_attention_bwd_dq_seg(const void* q, const void* k, const void* v,
                                              const void* dout, const void* lse, const void* di,
                                              const void* seg, void* dq, int B, int S, int H,
                                              int KVH, int D, float scale, int device,
                                              void* stream) {
  if (seg == nullptr) return (int)cudaErrorInvalidValue;
  return bwd_dq<true>(q, k, v, dout, lse, di, seg, dq, B, S, H, KVH, D, scale, device, stream);
}
