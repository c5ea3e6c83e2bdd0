// GQA flash-attention forward for Hopper (sm_90a), bf16 in, bf16 out plus an
// f32 logsumexp; causal, causal and segment-masked for packed rows, or
// non-causal (every key visible: the ring's past blocks). Both products are
// warpgroup wgmma.
//
// Replaces the TPU kernels `_fwd_kernel_oneshot` (tst/kernels/flash_attention.py:99,
// whole KV in one tile) and `_fwd_kernel` (tst/kernels/flash_attention.py:274,
// tiled online softmax with above-diagonal tiles skipped), both with and
// without their `has_seg` branch (:108, :276) and their `causal=False`
// branch (:121, :291, :305), and the segment-sparse
// `_fwd_kernel_oneshot_chunked` (:464, via :346) that the TPU dispatches for
// packed rows at S >= 2048. The TPU's one-shot/tiled/chunked split and its
// folded `pos_mod` view are VMEM schedules, not semantics.
//
// Semantics (the reference's, not its block layout):
//   o[b, i, h, :] = sum_j softmax_j(q[b,i,h]·k[b,j,h/G] / sqrt(D), j <= i) v[b,j,h/G]
//   lse[b, h, i]  = logsumexp_j of the same scaled, masked logits (f32)
// with packed rows (kSeg) the softmax runs over seg_start(i) <= j <= i only
// (seg_starts.cuh), and without the causal mask (kCausal false) over all j < S. q [B,S,H,D], k/v [B,S,KVH,D] contiguous in the model
// layout; query head h reads KV head h / (H/KVH). Logits accumulate in f32
// and are scaled by 1/sqrt(D) in f32 in log2 units; the running max starts
// at the finite kMaxInit, so exp(-inf - -inf) never appears; probabilities
// are rounded to bf16 before the P·V product, which accumulates in f32.
//
// What bounds it on an H100 (chip_smoke.py's _attention_bounds; PERF.md §6):
//   * S=512, D=64 (the train step, q [32,512,14,64]): ~68 MB of q, o, k, v,
//     lse, 0.0203 ms at 3.35 TB/s, against 15.1 GFLOP, 0.0153 ms at 989
//     TFLOP/s: bytes, with the products close behind. Each block has 1-4 KV
//     tiles a query tile, so its fixed cost a tile (Q's copy, the first S
//     and softmax, the last P·V, the stores) weighs as much as the loop.
//   * S=512, D=128 (Llama-3-8B, q [40,512,32,128]): 420 MB, 0.126 ms:
//     bytes. The 64-row design re-read each K/V tile for every 64 query rows
//     from L2 and, at 81 KB of shared memory and ~170 registers, ran two
//     blocks an SM with the softmax and both products in series.
//   * S=16384, D=64 (the long preset, q [10,16384,14,64]): 4.81 TFLOP,
//     4.864 ms: operations. The special-function unit's exp2 costs as much
//     as the products here (one exp2 a (query, key) pair: ~16 a clock an SM
//     against ~16.7 pairs a clock of bf16 tensor work at D=64), so the
//     softmax can only hide under the other warpgroup's products.
//
// What the design does about it:
//   * a persistent grid, one block an SM, walks the (128-row query tile,
//     head, batch) tiles of the whole call longest-causal-first, in snake
//     rounds (flash_sm90.cuh sched_tile); the heads of one KV head's group
//     run side by side, so their K and V tiles come from L2 once;
//   * a producer warp (warpgroup 0, setmaxnreg down to 40) issues every copy
//     by TMA through 3-D tensor maps: Q once a tile into two Q stages (the
//     next tile's Q lands while this one's last products run), K and V of
//     128 keys into rings of 3 stages (D=64) or 2 (D=128), each with full
//     and empty mbarriers. Rows past S arrive as zeros, so any S that is a
//     multiple of 64 works, and are never stored;
//   * two consumer warpgroups (setmaxnreg up to 232) own query rows 0-63 and
//     64-127 of the tile and read the same K/V stages: each K/V byte staged
//     serves 128 query rows. S = Q·K^T is one wgmma m64n128k16 chain (Q and
//     K K-major from shared memory), O += P·V is m64n64k16 with P from
//     registers (the S accumulator rounded to bf16) and V read MN-major;
//   * the two consumers take turns (named barriers 1 and 2, ping-pong): one
//     issues its S of tile j and its P·V of tile j - 1 together and passes
//     the turn, then runs its softmax while the other's products run;
//   * exp2 is one MUFU instruction (ex2.approx.ftz); the row max is taken
//     over the raw logits and scaled once (the scale is positive);
//   * only the diagonal tile is masked per element; packed rows visit KV
//     tiles from floor(seg_start(first row) / 128) and mask per element
//     every tile below a consumer's largest start. A row whose first visited
//     tiles lie before its segment keeps the finite start max, its weights
//     are exp2(-inf) = 0, and the first tile with its own columns rescales
//     that zero state by exp2(kMaxInit - m) = 0;
//   * non-causal (kCausal false), every query tile visits all KV tiles, each
//     the same work, so the snake order stays balanced; only a last tile that
//     ends past S (S = 64 mod 128) is masked per element, at the keys past S.
//     A simple branch of the same design, not yet tuned for its shapes.
// Packed rows at D=64 (the packed Qwen step, [k·B, 1024, 14, 64]) keep the
// 64-row kernel below (flash_fwd_tiled_kernel): there, at ~300-token samples,
// 128-row tiles compute more of the masked area than they save (PERF.md §6).
// At D=128 (the bench's packed Llama-3-8B legs, [5, 1024, 32, 128]) the
// persistent kernel wins all the same: 0.1147-0.1154 ms against the 64-row
// kernel's 0.1486-0.1498 at the bench's own starts, 0.1465-0.1475 against
// 0.2044-0.2047 at random ones.
// Measured and not kept (PERF.md §6; NVIDIA H100 80GB HBM3, 700 W): issuing
// tile j+1's S before tile j's softmax in each warpgroup (wgmma_wait<1>):
// ptxas serializes the pipeline (C7514: the softmax reads an accumulator
// inside the pipeline stage), 14.7 against 12.7 ms at S=16384; skipping a
// consumer's tiles that lie before its segment: a wgmma behind a branch on
// the consumer's index is serialized too (C7520); no ping-pong (15.4 ms);
// 3 K/V stages at D=128 with one Q stage; Q held as A fragments in
// registers (both within noise). Not yet: TMA stores of O, a third consumer
// warpgroup (192-row tiles) at D=64.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_sm90.cuh"
#include "seg_starts.cuh"

namespace {

// dynamic shared memory: Q in two stages (the next tile's loads while this
// one's last products run), K and V rings, their full / empty mbarriers, and
// the slack of aligned_smem. 129 KB at D=64 (3 K/V stages), 193 KB at D=128 (2).
template <int D>
struct Fwd {
  static constexpr int kBlocks = D / 64;
  static constexpr int kTileBytes = FlashTile<D>::kTile128Bytes;  // [128][D] bf16
  static constexpr int kQStages = 2;
  static constexpr int kKVStages = D == 64 ? 3 : 2;
  static constexpr int kBars = 2 * kQStages + 4 * kKVStages;
  static constexpr int kBarOff = (kQStages + 2 * kKVStages) * kTileBytes;
  static constexpr int kSmem = kBarOff + 8 * kBars + 1024;
  // registers a thread after setmaxnreg: the producer's warpgroup and the consumers'
  static constexpr int kProducerRegs = 40;
  static constexpr int kConsumerRegs = 232;
};

// which tile of the call: query tile (128 rows; the longest causal rows
// first), head, batch; and the KV tiles it visits
struct FwdTile {
  int qt, h, b, kv_first, n_kv;
};

template <bool kSeg, bool kCausal>
__device__ __forceinline__ FwdTile fwd_tile(int tile, int n_qt, int H, int B,
                                            const int* __restrict__ seg) {
  FwdTile f;
  f.qt = n_qt - 1 - tile / (H * B);
  const int rem = tile % (H * B);
  f.h = rem % H;  // the heads of one KV head's group run side by side: K and V shared in L2
  f.b = rem / H;
  f.kv_first = 0;
  if constexpr (kSeg) f.kv_first = seg_start(seg + (long)f.b * kMaxSegs, f.qt * kRows) / kRows;
  f.n_kv = kCausal ? f.qt - f.kv_first + 1 : n_qt;  // non-causal: every KV tile
  return f;
}

// one persistent block an SM: warpgroup 0 the producer (one thread issues
// every copy), warpgroups 1 and 2 the consumers of query rows 0-63 and
// 64-127 of each tile. `seg` (int32 [B, kMaxSegs]) is read only when kSeg;
// packed rows are causal.
template <int D, bool kSeg, bool kCausal>
__global__ void __launch_bounds__(kWarpSpecThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const int* __restrict__ seg,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int B, int S, int H,
                 int KVH, float scale_log2) {
  static_assert(kCausal || !kSeg, "packed rows are causal");
  using F = Fwd<D>;
  constexpr int kQS = F::kQStages, kKV = F::kKVStages, kTB = F::kTileBytes;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t q_s = smem_u32(aligned_smem(smem_raw));
  const uint32_t k_s = q_s + kQS * kTB;
  const uint32_t v_s = k_s + kKV * kTB;
  const uint32_t bars = q_s + F::kBarOff;
  auto q_full = [&](int i) { return bars + 8 * i; };
  auto q_empty = [&](int i) { return bars + 8 * (kQS + i); };
  auto k_full = [&](int i) { return bars + 8 * (2 * kQS + i); };
  auto k_empty = [&](int i) { return bars + 8 * (2 * kQS + kKV + i); };
  auto v_full = [&](int i) { return bars + 8 * (2 * kQS + 2 * kKV + i); };
  auto v_empty = [&](int i) { return bars + 8 * (2 * kQS + 3 * kKV + i); };

  const int n_qt = (S + kRows - 1) / kRows;
  const int n_tiles = n_qt * H * B;
  const int groups = H / KVH;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kQS; ++i) {
      mbar_init(q_full(i), 1);
      mbar_init(q_empty(i), kConsumerWarps);
    }
    for (int i = 0; i < kKV; ++i) {
      mbar_init(k_full(i), 1);
      mbar_init(k_empty(i), kConsumerWarps);
      mbar_init(v_full(i), 1);
      mbar_init(v_empty(i), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // the producer
    regs_dealloc<F::kProducerRegs>();
    if (threadIdx.x == 0) {
      int qi = 0, kvi = 0;
      for (int r = 0;; ++r) {
        const int tile = sched_tile(r, blockIdx.x, gridDim.x);
        if (tile >= n_tiles) break;
        const FwdTile f = fwd_tile<kSeg, kCausal>(tile, n_qt, H, B, seg);
        const int kvh = f.h / groups;
        const int qs = qi % kQS;
        if (qi >= kQS) mbar_wait(q_empty(qs), (qi / kQS - 1) & 1);
        mbar_expect_tx(q_full(qs), kTB);
#pragma unroll
        for (int cb = 0; cb < F::kBlocks; ++cb) {  // rows past S arrive as zeros
          tma_load_3d(q_s + qs * kTB + cb * kRowBlock, &tq, q_full(qs), f.h * D + cb * 64,
                      f.qt * kRows, f.b);
        }
        ++qi;
        for (int j = 0; j < f.n_kv; ++j, ++kvi) {
          const int st = kvi % kKV;
          const int kv0 = (f.kv_first + j) * kRows;
          if (kvi >= kKV) mbar_wait(k_empty(st), (kvi / kKV - 1) & 1);
          mbar_expect_tx(k_full(st), kTB);
#pragma unroll
          for (int cb = 0; cb < F::kBlocks; ++cb) {
            tma_load_3d(k_s + st * kTB + cb * kRowBlock, &tk, k_full(st), kvh * D + cb * 64, kv0,
                        f.b);
          }
          if (kvi >= kKV) mbar_wait(v_empty(st), (kvi / kKV - 1) & 1);
          mbar_expect_tx(v_full(st), kTB);
#pragma unroll
          for (int cb = 0; cb < F::kBlocks; ++cb) {
            tma_load_3d(v_s + st * kTB + cb * kRowBlock, &tv, v_full(st), kvh * D + cb * 64, kv0,
                        f.b);
          }
        }
      }
    }
    return;
  }

  regs_alloc<F::kConsumerRegs>();
  const int c = threadIdx.x / 128 - 1;  // this consumer's rows: 64c .. 64c + 63 of a tile
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int g = (tid % 32) / 4;
  const int t = tid % 4;
  const bool lead = tid % 32 == 0;  // gives ring stages back for its warp
  // ping-pong: named barrier 1 + c is "consumer c may issue"; each consumer
  // issues its products, then passes the turn, so that one's softmax runs
  // under the other's products. Consumer 0 takes the first turn.
  const int my_turn = 1 + c, their_turn = 2 - c;
  if (c == 1) named_arrive(1, 256);

  int qi = 0, kvi = 0;
  for (int r = 0;; ++r) {
    const int tile = sched_tile(r, blockIdx.x, gridDim.x);
    if (tile >= n_tiles) break;
    const FwdTile f = fwd_tile<kSeg, kCausal>(tile, n_qt, H, B, seg);
    const int q0 = f.qt * kRows + 64 * c;             // this consumer's first row
    const int row_lo = q0 + 16 * warp + g;            // rows of this thread: row_lo, row_lo + 8
    // packed rows: the segment starts of this thread's rows and the largest
    // start of the consumer's rows (KV tiles that begin below it are masked
    // per element)
    int st_lo = 0, st_hi = 0, st_max = 0;
    if constexpr (kSeg) {
      const int* sb = seg + (long)f.b * kMaxSegs;
      st_lo = seg_start(sb, row_lo);
      st_hi = seg_start(sb, row_lo + 8);
      st_max = seg_start(sb, q0 + 63);
    }
    const int qs = qi % kQS;
    const uint32_t q_t = q_s + qs * kTB + c * kHalfBlock;
    mbar_wait(q_full(qs), (qi / kQS) & 1);

    float acc[F::kBlocks][32];
#pragma unroll
    for (int cb = 0; cb < F::kBlocks; ++cb) {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[cb][i] = 0.f;
    }
    // running max (log2 units) and this thread's partial row sums, rows g and g+8
    float m_lo = kMaxInit, m_hi = kMaxInit, l_lo = 0.f, l_hi = 0.f;
    float s[64];
    uint32_t pa[8][4];

    // S = Q K^T for KV tile j (the kvi-th load): queries x 128 keys
    auto issue_s = [&](int st) {
      const uint32_t k_t = k_s + st * kTB;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wgmma_ss_kk(s, desc_k(q_t, kRowBlock, kk), desc_k(k_t, kRowBlock, kk), kk > 0);
      }
    };
    // O += P V, P rounded to bf16 A fragments, V read MN-major
    auto issue_pv = [&](int st) {
      const uint32_t v_t = v_s + st * kTB;
#pragma unroll
      for (int cb = 0; cb < F::kBlocks; ++cb) {
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) wgmma_rs(acc[cb], pa[kk], desc_mn(v_t, kRowBlock, cb, kk));
      }
    };
    // the online softmax of KV tile j: mask, row max (raw logits; the scale
    // is positive, so the max of the scaled logits is the scaled max), P =
    // exp2(s·scale - m) into pa, the sums; returns the O rescale factors.
    // Non-causal, only keys past S are masked (a last tile at S = 64 mod 128)
    auto softmax = [&](int j, float& corr_lo, float& corr_hi) {
      const int kv0 = (f.kv_first + j) * kRows;
      bool masked;
      if constexpr (kCausal) {
        masked = kSeg ? (f.kv_first + j == f.qt || kv0 < st_max) : f.kv_first + j == f.qt;
      } else {
        masked = kv0 + kRows > S;
      }
      float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const bool hi = (i & 2) != 0;
        float x = s[i];
        if (masked) {
          const int key = kv0 + 8 * (i / 4) + 2 * t + (i & 1);
          if constexpr (kCausal) {
            const int row = row_lo + (hi ? 8 : 0);
            if (key > row || (kSeg && key < (hi ? st_hi : st_lo))) x = -INFINITY;
          } else {
            if (key >= S) x = -INFINITY;
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
      const float mn_lo = fmaxf(m_lo, mx_lo * scale_log2);
      const float mn_hi = fmaxf(m_hi, mx_hi * scale_log2);
      corr_lo = exp2f(m_lo - mn_lo);
      corr_hi = exp2f(m_hi - mn_hi);
      m_lo = mn_lo;
      m_hi = mn_hi;
      float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        if (i & 2) {
          s[i] = fast_exp2(fmaf(s[i], scale_log2, -mn_hi));
          sum_hi += s[i];
        } else {
          s[i] = fast_exp2(fmaf(s[i], scale_log2, -mn_lo));
          sum_lo += s[i];
        }
      }
      l_lo = l_lo * corr_lo + sum_lo;
      l_hi = l_hi * corr_hi + sum_hi;
      pack_a128(pa, s);
    };
    auto release = [&](uint32_t bar) {
      if (lead) mbar_arrive(bar);
    };

    // Point j of the tile issues S of KV tile j and P·V of tile j - 1, both
    // in flight together; the last point (j = n_kv) issues only the last
    // P·V. The softmax of tile j follows, while the other consumer's
    // products run.
    float corr_lo = 1.f, corr_hi = 1.f;
    for (int j = 0; j <= f.n_kv; ++j) {
      const bool last = j == f.n_kv;
      const int st = (kvi + j) % kKV;
      const int prev = (kvi + j + kKV - 1) % kKV;
      named_barrier(my_turn, 256);
      wgmma_fence();
      if (!last) {
        mbar_wait(k_full(st), ((kvi + j) / kKV) & 1);
        issue_s(st);
        wgmma_commit();
      }
      if (j > 0) {
        mbar_wait(v_full(prev), ((kvi + j - 1) / kKV) & 1);
        issue_pv(prev);
        wgmma_commit();
      }
      named_arrive(their_turn, 256);
      wgmma_wait<0>();
      fence_acc_n(s);
#pragma unroll
      for (int cb = 0; cb < F::kBlocks; ++cb) fence_acc(acc[cb]);
      if (!last) {
        release(k_empty(st));
        if (j == f.n_kv - 1) release(q_empty(qs));
      }
      if (j > 0) release(v_empty(prev));
      if (!last) {
        softmax(j, corr_lo, corr_hi);
        if (j > 0) {
#pragma unroll
          for (int cb = 0; cb < F::kBlocks; ++cb) {
#pragma unroll
            for (int i = 0; i < 32; ++i) acc[cb][i] *= (i & 2) ? corr_hi : corr_lo;
          }
        }
      }
    }
    kvi += f.n_kv;
    ++qi;

#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
      l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
    }
#pragma unroll
    for (int cb = 0; cb < F::kBlocks; ++cb) {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[cb][i] /= (i & 2) ? l_hi : l_lo;
    }
    const long q_stride = (long)H * D;
    store_rows<D>(acc, o + ((long)f.b * S + q0) * q_stride + (long)f.h * D, q_stride, warp, g, t,
                  S - q0);
    if (t == 0) {
      float* lse_bh = lse + ((long)f.b * H + f.h) * S;
      if (row_lo < S) lse_bh[row_lo] = (m_lo + log2f(l_lo)) * kLn2;
      if (row_lo + 8 < S) lse_bh[row_lo + 8] = (m_hi + log2f(l_hi)) * kLn2;
    }
  }
  if (c == 0) named_barrier(my_turn, 256);  // consumer 1's last turn handed over
}

// dynamic shared memory: the Q tile, then a ring of (K tile, V tile) stages,
// and the slack of aligned_smem; 41 KB at D=64, 81 KB at D=128
template <int D>
constexpr int fwd_tiled_smem() {
  return (1 + 2 * kStages) * FlashTile<D>::kTileBytes + 1024;
}

// The 64-row design this file had before the persistent kernel above,
// kept for packed rows at D=64 only, where it is faster (flash_fwd_tiled;
// PERF.md §6): one warpgroup per (64-row query tile, head, batch), longest
// causal rows launched first; Q and a 2-stage K/V ring by cp.async; S = Q·K^T
// and O += P·V on wgmma m64n64k16, each waited for before the softmax. A
// query tile visits KV tiles from floor(seg_start(p0)/64), so at ~300-token
// samples it computes less of the masked area than 128-row tiles. `seg`
// (int32 [B, kMaxSegs]) is read only when kSeg
template <int D, bool kSeg>
__global__ void __launch_bounds__(128)
flash_fwd_tiled_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
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
cudaError_t launch_fwd_tiled(const void* q, const void* k, const void* v, const void* seg,
                             void* o, void* lse, int B, int S, int H, int KVH, float scale_log2,
                             cudaStream_t st) {
  constexpr int smem = fwd_tiled_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_tiled_kernel<D, kSeg>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  flash_fwd_tiled_kernel<D, kSeg><<<dim3(S / kTile, H, B), 128, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(seg),
      static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), S, H, KVH, scale_log2);
  return cudaGetLastError();
}

template <int D, bool kSeg, bool kCausal>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, const void* seg, void* o,
                       void* lse, int B, int S, int H, int KVH, float scale_log2, int device,
                       cudaStream_t st) {
  static unsigned smem_set = 0;
  constexpr int smem = Fwd<D>::kSmem;
  cudaError_t err = cudaSuccess;
  if (!(smem_set & (1u << device))) {
    err = cudaFuncSetAttribute(flash_fwd_kernel<D, kSeg, kCausal>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_set |= 1u << device;
  }
  CUtensorMap tq, tk, tv;
  err = heads_map(&tq, q, B, S, H, D, kRows);
  if (err == cudaSuccess) err = heads_map(&tk, k, B, S, KVH, D, kRows);
  if (err == cudaSuccess) err = heads_map(&tv, v, B, S, KVH, D, kRows);
  if (err != cudaSuccess) return err;
  const int tiles = (S + kRows - 1) / kRows * H * B;
  const int sms = sm_count(device);
  if (sms == 0) return cudaErrorInvalidValue;
  flash_fwd_kernel<D, kSeg, kCausal><<<tiles < sms ? tiles : sms, kWarpSpecThreads, smem, st>>>(
      tq, tk, tv, static_cast<const int*>(seg), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), B, S, H, KVH, scale_log2);
  return cudaGetLastError();
}

template <bool kSeg, bool kCausal>
int fwd(const void* q, const void* k, const void* v, const void* seg, void* o, void* lse, int B,
        int S, int H, int KVH, int D, float scale, int device, void* stream) {
  if (B <= 0 || S <= 0 || S % kTile != 0 || KVH <= 0 || H % KVH != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float scale_log2 = scale * kLog2e;
  if (D == 64) {
    if constexpr (kSeg) {  // packed rows at D=64: the 64-row kernel (PERF.md §6)
      return (int)launch_fwd_tiled<64, true>(q, k, v, seg, o, lse, B, S, H, KVH, scale_log2, st);
    } else {
      return (int)launch_fwd<64, false, kCausal>(q, k, v, seg, o, lse, B, S, H, KVH, scale_log2,
                                                 device, st);
    }
  }
  if (D == 128) {
    return (int)launch_fwd<128, kSeg, kCausal>(q, k, v, seg, o, lse, B, S, H, KVH, scale_log2,
                                               device, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C entries for ctypes. Pointers are device pointers of contiguous
// tensors (seg: int32 [B, kMaxSegs]); `stream` is a cudaStream_t. Each
// returns the launch's cudaError_t. `_full`: non-causal, every key visible.
extern "C" int tst_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                       void* lse, int B, int S, int H, int KVH, int D,
                                       float scale, int device, void* stream) {
  return fwd<false, true>(q, k, v, nullptr, o, lse, B, S, H, KVH, D, scale, device, stream);
}

extern "C" int tst_flash_attention_fwd_full(const void* q, const void* k, const void* v, void* o,
                                            void* lse, int B, int S, int H, int KVH, int D,
                                            float scale, int device, void* stream) {
  return fwd<false, false>(q, k, v, nullptr, o, lse, B, S, H, KVH, D, scale, device, stream);
}

extern "C" int tst_flash_attention_fwd_seg(const void* q, const void* k, const void* v,
                                           const void* seg, void* o, void* lse, int B, int S,
                                           int H, int KVH, int D, float scale, int device,
                                           void* stream) {
  if (seg == nullptr) return (int)cudaErrorInvalidValue;
  return fwd<true, true>(q, k, v, seg, o, lse, B, S, H, KVH, D, scale, device, stream);
}
