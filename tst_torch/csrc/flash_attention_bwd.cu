// GQA flash-attention backward for Hopper (sm_90a): two kernels, one for
// dK/dV and one for dQ, bf16 in and out, f32 accumulation; causal, causal
// and segment-masked for packed rows, or non-causal (every key visible: the
// ring's past blocks). Every product is a warpgroup wgmma.
//
// Replaces the TPU backward kernels of tst/kernels/flash_attention.py:
//   _bwd_fused_nolse_kernel (:590, via _flash_bwd_fused :836), the fused
//     dq/dk/dv of the single-KV-tile regime;
//   _bwd_dq_kernel_oneshot (:518) and _bwd_dkv_kernel_oneshot (:553), via
//     _flash_bwd :934, the one-shot forms from the saved lse;
//   _bwd_dq_kernel (:732, via _flash_bwd) and _bwd_dkv_kernel (:778, via
//     _dkv_tiled :1041), the tiled forms.
// and their `causal=False` branches (:536, :570, :622, :747, :795), and, for
// packed rows, the `has_seg` branches of all five (:521, :556, :603,
// :734, :780) and the segment-sparse `_bwd_fused_chunked_kernel` (:650, via
// `_flash_bwd_fused` :854) that the TPU dispatches at S >= 2048. Their
// one-shot / tiled / fused / chunked split is a TPU VMEM schedule.
//
// Semantics (the reference's): with the forward's f32 lse [B,H,S] and
// di[b,h,i] = sum_d o·do (f32, computed by the caller from the bf16 o),
//   P[i,j]  = exp(scale·q_i·k_j - lse_i) for j <= i (and, packed,
//             j >= seg_start(i): seg_starts.cuh), else exactly 0; for
//             every j when non-causal
//   dv_j    = sum over the G = H/KVH query heads of a KV head, sum_i P[i,j] do_i
//   dS[i,j] = P[i,j] · (do_i·v_j - di_i)
//   dq_i    = scale · sum_j dS[i,j] k_j
//   dk_j    = scale · group sum, sum_i dS[i,j] q_i
// q/do/dq [B,S,H,D], k/v/dk/dv [B,S,KVH,D], contiguous. P is recomputed as
// the forward made it (f32 logits scaled in f32, minus the f32 lse, both in
// log2 units); P and scale·dS are rounded to bf16 only as operands of the
// products. Each output element is written once, with no atomics, in one
// fixed order: bit-equal across calls.
//
// What bounds dK/dV on an H100 (chip_smoke.py's _attention_bounds; PERF.md
// §6): four products a (query, key) pair the mask keeps, S^T, dP^T, dV, dK,
// 2·D operations each:
//   * S=512, D=64 (the train step, q [32,512,14,64]): 30.1 GFLOP, 0.0305 ms
//     at 989 TFLOP/s, against 77 MB, 0.023 ms: operations;
//   * S=512, D=128 (Llama-3-8B, q [40,512,32,128]): 0.174 ms: operations,
//     with 128 f32 accumulators of dK and dV a thread besides the operands;
//   * S=16384, D=64 (the long preset, q [10,16384,14,64]): 9.62 TFLOP,
//     9.73 ms: operations. The block of KV tile 0 walks all 7 heads x 256
//     query tiles; the 64-key design's grid started the longest blocks of
//     later (head, batch) late, and each of its warpgroups staged its own
//     Q, dO, lse, di, so no staged byte served two of them.
// dQ (S, dP, dQ: three products a pair) is bound by its bytes at S=512
// (0.0293 ms at D=64, 0.1768 at D=128) and by its operations at S=16384
// (7.30 ms). Its 64-row design (one warpgroup a query tile, cp.async, each
// copy and product waited for) left the tensor cores idle through every copy
// and every dS. What the persistent dQ kernel does about it:
//   * the forward's schedule: one block an SM over (128-row query tile,
//     head, batch) tiles, longest causal rows first, in snake rounds, the
//     heads of one KV head side by side;
//   * a producer warp (setmaxnreg down to 24) loads Q, dO (TMA) and the
//     rows' lse and di (bulk copies; only rows below S) once a tile into
//     Q stages, and K and V of each 128-key tile into rings (2 Q and 3 K/V
//     stages at D=64, 1 and 2 at D=128);
//   * two consumer warpgroups (up to 240 registers) own rows 0-63 and 64-127
//     and read the same K/V stages; at point j a consumer issues S and dP of
//     tile j (m64n128, Q and dO K-major) with dQ += scale·dS·K of tile j - 1
//     (dS from registers, K MN-major) and passes the turn, so its dS runs
//     under the other's products; V(j) is given back after point j, K(j)
//     after point j + 1;
//   * rows past S (S = 64 mod 128) are masked like keys past S: their lse
//     and di were never loaded.
// The C entries take it unsegmented: causal at both head dims, non-causal
// at D=64. Packed rows (both head dims) and non-causal D=128 keep the 64-row
// kernel (flash_bwd_dq_tiled_kernel), which was faster there in one
// interleaved call: a 128-row tile walks both halves' segment ranges, as
// the forward's did; non-causal at [1, 4096, 32, 128] the persistent kernel
// read 1.187-1.205 ms against 1.148-1.157 (PERF.md §6). At D=128 ptxas
// serializes the persistent kernel's wgmma for registers (C7512: S, dP and
// two dQ accumulators, 224 a thread), and it still won at [40, 512, 32, 128]
// (PERF.md §6).
//
// dK/dV at D=64 unsegmented (the train step, the long preset), what the
// design does about it:
//   * a persistent grid, one block an SM, walks the (128-key tile, KV head,
//     batch) tiles longest first (tile 0 has the most query tiles) in snake
//     rounds (flash_sm90.cuh sched_tile);
//   * a producer warp (warpgroup 0, setmaxnreg down to 24) loads K and V of
//     the tile once, into two buffers (the next tile's while this one's last
//     pairs run), and each (query head, 64-row query tile) pair's Q, dO by
//     TMA and lse, di by bulk copy into a ring of 3 stages. Keys past S
//     arrive as zeros and are never stored;
//   * two consumer warpgroups (setmaxnreg up to 240) own keys 0-63 and
//     64-127 and read every staged pair: each staged byte serves both. Each
//     keeps its dK and dV in registers over all of the tile's pairs, so no
//     sum across warpgroups is needed, and holds K and V as A fragments in
//     registers for the whole tile;
//   * S^T = K·Q^T and dP^T = V·dO^T, then dV += P^T·dO and dK += dS^T·Q
//     (P^T, dS^T from the accumulators as bf16 A fragments, packed two
//     elements at a time; dO and Q read MN-major). Pair p+1's S^T and dP^T
//     are in flight with pair p's dV and dK, and the two consumers issue in
//     ping-pong order (named barriers 1 and 2). dK is scaled by 1/sqrt(64) =
//     1/8 once after its sum rather than dS before its rounding: a power of
//     two, so the same bits for one multiply fewer an element;
//   * masks per element only where a query tile reaches a key tile (the
//     diagonal); a masked entry is set to 0. Non-causal (kCausal false), a
//     key tile's pairs start at query tile 0 and nothing is masked: keys
//     past S (S = 64 mod 128) get values that are never stored.
// Packed rows (both head dims) and D=128 take the 64-key kernel
// (flash_bwd_dkv_tiled_kernel, below). Packed, a 128-key tile walks the
// query tiles up to the segment end of its last key, so at ~300-token
// samples its first 64 keys run pairs they do not see. At D=128 the
// persistent design, with one wgmma group in flight and no ping-pong, left
// ptxas short of registers (C7512, 432 bytes spilled).
// Measured and not kept (PERF.md §6; NVIDIA H100 80GB HBM3, 700 W): the
// persistent design at D=128, 0.663-0.666 ms against the 64-key kernel's
// 0.579-0.583 at q [40,512,32,128], and packed at [5,1024,32,128] 0.422-0.424
// against 0.406-0.408 (random starts), 0.267 against 0.276-0.277 (the bench's
// starts); skipping the pairs a consumer does not see (a wgmma behind a
// branch on the consumer's index: ptxas serializes the pipeline, C7520; 29.4
// against 21.4 ms at S=16384); a ring of 4 stages (within noise); ping-pong
// at D=128 (0.82 against 0.63 ms). K and V in registers and ping-pong were
// kept: 20.5 against 21.4 ms at S=16384 (each alone within noise).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_sm90.cuh"
#include "seg_starts.cuh"

namespace {

// kTile, kStages, the tile sizes, aligned_smem, load_tile, store_tile:
// flash_sm90.cuh
template <int D>
struct Bwd {
  static constexpr int kBlocks = FlashTile<D>::kBlocks;
  static constexpr int kTileBytes = FlashTile<D>::kTileBytes;
  // dQ: one warpgroup; Q and dO, then a ring of (K tile, V tile) stages
  static constexpr int kDqSmem = 2 * kTileBytes + kStages * 2 * kTileBytes + 1024;
};

// dK/dV: K and V of a 128-key tile in two buffers (the next tile's copies
// while this one's last pairs run), then a ring of 3 pair stages: Q [64][D],
// dO [64][D], and 1 KB of row statistics (lse[64], di[64]; the rest keeps
// the next stage's tiles aligned), and the mbarriers: 116 KB at D=64.
template <int D>
struct Dkv {
  static constexpr int kBlocks = D / 64;
  static constexpr int kKVBytes = FlashTile<D>::kTile128Bytes;  // one [128][D] tile
  static constexpr int kQBytes = FlashTile<D>::kTileBytes;      // one [64][D] tile
  static constexpr int kStatBytes = 1024;
  static constexpr int kStageBytes = 2 * kQBytes + kStatBytes;
  static constexpr int kRing = 3;
  static constexpr int kRingOff = 2 * 2 * kKVBytes;
  static constexpr int kBarOff = kRingOff + kRing * kStageBytes;
  static constexpr int kSmem = kBarOff + 8 * (4 + 2 * kRing) + 1024;
  static constexpr int kProducerRegs = 24;
  static constexpr int kConsumerRegs = 240;
};

// which tile of the call: KV tile (128 keys; tile 0, seen by the most query
// tiles, first), KV head, batch; and its (query head, 64-row query tile)
// pairs, head-major: the query tiles from the first that sees a key of the
// tile to the last
struct DkvTile {
  int kvt, kvh, b, q_first, nq, n_pairs;
};

template <bool kCausal>
__device__ __forceinline__ DkvTile dkv_tile(int tile, int KVH, int B, int S, int groups) {
  DkvTile f;
  f.kvt = tile / (KVH * B);
  const int rem = tile % (KVH * B);
  f.kvh = rem % KVH;
  f.b = rem / KVH;
  f.q_first = kCausal ? f.kvt * kRows / kTile : 0;  // non-causal: every query tile
  f.nq = S / kTile - f.q_first;
  f.n_pairs = groups * f.nq;
  return f;
}

// which tile of the persistent dQ kernel: query tile (128 rows; the longest
// causal rows first), head, batch; and the KV tiles it visits (the forward's
// fwd_tile, without packed rows)
struct DqTile {
  int qt, h, b, kv_first, n_kv;
};

template <bool kCausal>
__device__ __forceinline__ DqTile dq_tile(int tile, int n_qt, int H, int B) {
  DqTile f;
  f.qt = n_qt - 1 - tile / (H * B);
  const int rem = tile % (H * B);
  f.h = rem % H;  // the heads of one KV head's group side by side: K and V shared in L2
  f.b = rem / H;
  f.kv_first = 0;
  f.n_kv = kCausal ? f.qt + 1 : n_qt;  // non-causal: every KV tile
  return f;
}

// dK, dV: one persistent block an SM over (KV tile, KV head, batch) tiles.
// Warpgroup 0 is the producer: its first warp's lane 0 loads K and V once a
// tile and every pair's Q, dO, lse, di into the ring. Warpgroups 1 and 2 own
// keys 0-63 and 64-127 of the tile, each with its own dK and dV in registers
// over all of the tile's pairs: no sum across warpgroups. D=64 only: at
// D=128 the two accumulators alone take 128 registers a thread, and the
// kernel spilled and ran slower than the 64-key one (PERF.md §6).
template <int D, bool kCausal>
__global__ void __launch_bounds__(kWarpSpecThreads, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                     const float* __restrict__ lse, const float* __restrict__ di,
                     __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int B, int S,
                     int H, int KVH, float scale) {
  static_assert(D == 64, "the persistent dK/dV kernel serves D=64; D=128 takes the 64-key one");
  using T = Dkv<D>;
  constexpr int kR = T::kRing;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const uint32_t base = smem_u32(smem);
  const uint32_t bars = base + T::kBarOff;
  auto kv_full = [&](int i) { return bars + 8 * i; };
  auto kv_empty = [&](int i) { return bars + 8 * (2 + i); };
  auto full = [&](int i) { return bars + 8 * (4 + i); };
  auto empty = [&](int i) { return bars + 8 * (4 + kR + i); };
  auto stage = [&](int i) { return T::kRingOff + i * T::kStageBytes; };  // byte offset

  const int groups = H / KVH;
  const int n_tiles = (S + kRows - 1) / kRows * KVH * B;
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(kv_full(i), 1);
      mbar_init(kv_empty(i), kConsumerWarps);
    }
    for (int i = 0; i < kR; ++i) {
      mbar_init(full(i), 1);
      mbar_init(empty(i), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // the producer
    regs_dealloc<T::kProducerRegs>();
    if (threadIdx.x == 0) {
      int ti = 0, pi = 0;
      for (int r = 0;; ++r, ++ti) {
        const int tile = sched_tile(r, blockIdx.x, gridDim.x);
        if (tile >= n_tiles) break;
        const DkvTile f = dkv_tile<kCausal>(tile, KVH, B, S, groups);
        const int kvs = ti % 2;
        if (ti >= 2) mbar_wait(kv_empty(kvs), (ti / 2 - 1) & 1);
        const uint32_t k_t = base + kvs * 2 * T::kKVBytes;
        mbar_expect_tx(kv_full(kvs), 2 * T::kKVBytes);
#pragma unroll
        for (int cb = 0; cb < T::kBlocks; ++cb) {  // keys past S arrive as zeros
          tma_load_3d(k_t + cb * kRowBlock, &tk, kv_full(kvs), f.kvh * D + cb * 64,
                      f.kvt * kRows, f.b);
          tma_load_3d(k_t + T::kKVBytes + cb * kRowBlock, &tv, kv_full(kvs),
                      f.kvh * D + cb * 64, f.kvt * kRows, f.b);
        }
        for (int p = 0; p < f.n_pairs; ++p, ++pi) {
          const int h = f.kvh * groups + p / f.nq;
          const int q0 = (f.q_first + p % f.nq) * kTile;
          const int st = pi % kR;
          if (pi >= kR) mbar_wait(empty(st), (pi / kR - 1) & 1);
          const uint32_t s_t = base + stage(st);
          const long r0 = ((long)f.b * H + h) * S + q0;
          mbar_expect_tx(full(st), 2 * T::kQBytes + 512);
#pragma unroll
          for (int cb = 0; cb < T::kBlocks; ++cb) {
            tma_load_3d(s_t + cb * kSw128Block, &tq, full(st), h * D + cb * 64, q0, f.b);
            tma_load_3d(s_t + T::kQBytes + cb * kSw128Block, &tdo, full(st), h * D + cb * 64,
                        q0, f.b);
          }
          bulk_load(s_t + 2 * T::kQBytes, lse + r0, 256, full(st));
          bulk_load(s_t + 2 * T::kQBytes + 256, di + r0, 256, full(st));
        }
      }
    }
    return;
  }

  regs_alloc<T::kConsumerRegs>();
  const int c = threadIdx.x / 128 - 1;  // this consumer's keys: 64c .. 64c + 63 of a tile
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int g = (tid % 32) / 4;
  const int t = tid % 4;
  const bool lead = tid % 32 == 0;
  const float scale_log2 = scale * kLog2e;
  // ping-pong: named barrier 1 + c is "consumer c may issue"
  const int my_turn = 1 + c, their_turn = 2 - c;
  if (c == 1) named_arrive(1, 256);

  int ti = 0, pi = 0;
  for (int r = 0;; ++r, ++ti) {
    const int tile = sched_tile(r, blockIdx.x, gridDim.x);
    if (tile >= n_tiles) break;
    const DkvTile f = dkv_tile<kCausal>(tile, KVH, B, S, groups);
    const int kvs = ti % 2;
    const uint32_t k_t = base + kvs * 2 * T::kKVBytes + c * kHalfBlock;  // K[key][d], sw128
    const uint32_t v_t = k_t + T::kKVBytes;
    const int key0 = f.kvt * kRows + 64 * c;  // this consumer's first key
    const int key_tile = key0 / kTile;
    mbar_wait(kv_full(kvs), (ti / 2) & 1);

    float acc_dk[T::kBlocks][32], acc_dv[T::kBlocks][32];
#pragma unroll
    for (int cb = 0; cb < T::kBlocks; ++cb) {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc_dk[cb][i] = acc_dv[cb][i] = 0.f;
    }
    float s[32], dp[32];
    uint32_t pa[4][4], dsa[4][4];

    // K and V as A fragments, read once a tile from the sw128 tiles
    uint32_t ka[D / 16][4], va[D / 16][4];
    load_a<D>(ka, k_t, kRowBlock, warp, g, t);
    load_a<D>(va, v_t, kRowBlock, warp, g, t);
    // S^T = K Q^T and dP^T = V dO^T of pair stage st: keys x queries
    auto issue_sdp = [&](int st) {
      const uint32_t q_t = base + stage(st);
      const uint32_t do_t = q_t + T::kQBytes;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) wgmma_rs_k(s, ka[kk], desc_k_major(q_t, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) wgmma_rs_k(dp, va[kk], desc_k_major(do_t, kk), kk > 0);
    };
    // dV += P^T dO and dK += dS^T Q, dO and Q read MN-major
    auto issue_dvdk = [&](int st) {
      const uint32_t q_t = base + stage(st);
      const uint32_t do_t = q_t + T::kQBytes;
#pragma unroll
      for (int cb = 0; cb < T::kBlocks; ++cb) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_rs(acc_dv[cb], pa[kk], desc_mn_major(do_t, cb, kk));
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_rs(acc_dk[cb], dsa[kk], desc_mn_major(q_t, cb, kk));
      }
    };
    // P^T and dS^T of pair p (stage st) into pa, dsa, packed to bf16 two
    // elements at a time, so that s and dp die as they are read. dK is
    // scaled once after its sum instead of dS before its rounding: the same
    // bits, as scale = 1/sqrt(64) = 1/8 is a power of two
    auto elementwise = [&](int p, int st) {
      const unsigned char* stat = smem + stage(st) + 2 * T::kQBytes;
      const float* lse_s = reinterpret_cast<const float*>(stat);
      const float* di_s = lse_s + kTile;
      const int q_tile = f.q_first + p % f.nq;
      const int q0 = q_tile * kTile;
      // masked per element where a query precedes a key: the diagonal, and
      // for consumer 1 the query tile below it; never when non-causal
      const bool masked = kCausal && q_tile <= key_tile;
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        float pv[2], ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * (i / 4) + 2 * t + e;           // query within the tile
          const int row = 16 * warp + g + ((i & 2) ? 8 : 0);  // key within the consumer's 64
          const bool off = masked && key0 + row > q0 + col;
          pv[e] = off ? 0.f : fast_exp2(s[i + e] * scale_log2 - lse_s[col] * kLog2e);  // P^T
          ds[e] = pv[e] * (dp[i + e] - di_s[col]);  // dS^T
        }
        pa[i / 8][(i % 8) / 2] = pack_bf16(pv[0], pv[1]);
        dsa[i / 8][(i % 8) / 2] = pack_bf16(ds[0], ds[1]);
      }
    };
    auto release = [&](uint32_t bar) {
      if (lead) mbar_arrive(bar);
    };

    // pair 0's S^T and dP^T; then each step issues pair p's dV and dK
    // products and pair p + 1's S^T and dP^T, all in flight together
    named_barrier(my_turn, 256);
    mbar_wait(full(pi % kR), (pi / kR) & 1);
    wgmma_fence();
    issue_sdp(pi % kR);
    wgmma_commit();
    named_arrive(their_turn, 256);
    wgmma_wait<0>();
    fence_acc(s);
    fence_acc(dp);
    elementwise(0, pi % kR);
    for (int p = 0; p < f.n_pairs; ++p) {
      const int st = (pi + p) % kR, nxt = (pi + p + 1) % kR;
      const bool more = p + 1 < f.n_pairs;
      named_barrier(my_turn, 256);
      wgmma_fence();
      issue_dvdk(st);
      wgmma_commit();
      if (more) {
        mbar_wait(full(nxt), ((pi + p + 1) / kR) & 1);
        issue_sdp(nxt);
        wgmma_commit();
      }
      named_arrive(their_turn, 256);
      wgmma_wait<0>();
      fence_acc(s);
      fence_acc(dp);
#pragma unroll
      for (int cb = 0; cb < T::kBlocks; ++cb) {
        fence_acc(acc_dv[cb]);
        fence_acc(acc_dk[cb]);
      }
      release(empty(st));
      if (more) elementwise(p + 1, nxt);
    }
    pi += f.n_pairs;
    release(kv_empty(kvs));

    const long kv_stride = (long)KVH * D;
    const long kv_off = ((long)f.b * S + key0) * kv_stride + (long)f.kvh * D;
#pragma unroll
    for (int cb = 0; cb < T::kBlocks; ++cb) {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc_dk[cb][i] *= scale;
    }
    store_rows<D>(acc_dk, dk + kv_off, kv_stride, warp, g, t, S - key0);
    store_rows<D>(acc_dv, dv + kv_off, kv_stride, warp, g, t, S - key0);
  }
  if (c == 0) named_barrier(my_turn, 256);  // consumer 1's last turn handed over
}

// the 64-key dK/dV kernel: warpgroups a block (each 128 threads), K and V,
// then a ring per warpgroup of (Q tile, dO tile, lse[64], di[64], starts[64])
// stages
template <int D>
struct DkvTiled {
  static constexpr int kBlocks = FlashTile<D>::kBlocks;
  static constexpr int kTileBytes = FlashTile<D>::kTileBytes;
  static constexpr int kDkvGroups = D == 64 ? 3 : 2;
  static constexpr int kDkvStage = 2 * kTileBytes + 1024;  // stats padded to keep tiles aligned
  static constexpr int kDkvSmem = 2 * kTileBytes + kDkvGroups * kStages * kDkvStage + 1024;
  // the final sum of the dK/dV warpgroups' accumulators fits in their rings
  static_assert((kDkvGroups - 1) * 2 * 64 * D * 4 <= kDkvGroups * kStages * kDkvStage, "");
};

// The 64-key design this file had before the persistent kernel above, kept
// for packed rows and at D=128, where it is faster (PERF.md §6): each
// warpgroup stages its own pairs by cp.async, and a KV tile visits the query
// tiles up to the first start after its own 64 keys, so it computes less of
// the masked area than a 128-key tile.
// dK, dV: one block per (KV tile, KV head, batch), W warpgroups. Warpgroup
// w takes pairs w, w + W, ... of the (query head, query tile) pairs that see
// the tile; warp i of a warpgroup owns KV rows 16i .. 16i+16. `seg` (int32
// [B, kMaxSegs]) is read only when kSeg; packed rows are causal.
// Non-causal, a KV tile visits every query tile and masks nothing.
template <int D, bool kSeg, bool kCausal>
__global__ void __launch_bounds__(DkvTiled<D>::kDkvGroups * 128, 1)
flash_bwd_dkv_tiled_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ di,
                     const int* __restrict__ seg, __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int S, int H, int KVH, float scale) {
  static_assert(kCausal || !kSeg, "packed rows are causal");
  using T = DkvTiled<D>;
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
  const int q_first = kCausal ? kv_tile : 0;  // the first query tile that sees the tile
  const int nq = q_end - q_first;
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
    const int q0 = (q_first + p % nq) * kTile;
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
    const int q_tile = q_first + p % nq;
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

    const bool diag = kCausal && q_tile == kv_tile;
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

    // dV += P^T dO and dK += dS^T Q, dO and Q read MN-major
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

// The 64-row dQ design this file had before the persistent kernel below,
// kept for packed rows and non-causal at D=128, where it is faster (bwd_dq
// below; PERF.md §6): one
// warpgroup per (64-row query tile, head, batch), longest causal rows
// launched first; Q, dO and a 2-stage K/V ring by cp.async, each copy and
// each product waited for: the tensor cores idle through every copy and
// every dS. Warp i owns query rows 16i .. 16i+16 of the tile. `seg` (int32
// [B, kMaxSegs]) is read only when kSeg; packed rows are causal.
// Non-causal, a query tile visits every KV tile and masks nothing.
template <int D, bool kSeg, bool kCausal>
__global__ void __launch_bounds__(128)
flash_bwd_dq_tiled_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ di,
                    const int* __restrict__ seg, __nv_bfloat16* __restrict__ dq, int S, int H,
                    int KVH, float scale) {
  static_assert(kCausal || !kSeg, "packed rows are causal");
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
  const int n_kv = kCausal ? q_tile - kv_first + 1 : (int)gridDim.x;  // non-causal: every KV tile

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

    const bool diag = kCausal && kv_tile == q_tile;
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

// the persistent dQ kernel's shared memory: Q and dO of a 128-row query tile
// in kQStages stages, each with 1 KB of its rows' lse and di; K and V rings
// of 128-key tiles; the mbarriers. 163 KB at D=64 (2 Q stages, 3 K/V
// stages), 194 KB at D=128 (1 and 2)
template <int D>
struct Dq {
  static constexpr int kBlocks = D / 64;
  static constexpr int kTB = FlashTile<D>::kTile128Bytes;  // one [128][D] tile
  static constexpr int kQStages = D == 64 ? 2 : 1;
  static constexpr int kKVStages = D == 64 ? 3 : 2;
  static constexpr int kStatBytes = 1024;
  static constexpr int kDoOff = kQStages * kTB;
  static constexpr int kKOff = 2 * kQStages * kTB;
  static constexpr int kVOff = kKOff + kKVStages * kTB;
  static constexpr int kStatOff = kVOff + kKVStages * kTB;
  static constexpr int kBarOff = kStatOff + kQStages * kStatBytes;
  static constexpr int kBars = 2 * kQStages + 4 * kKVStages;
  static constexpr int kSmem = kBarOff + 8 * kBars + 1024;
  static constexpr int kProducerRegs = 24;
  static constexpr int kConsumerRegs = 240;
};

// dQ, persistent: one block an SM over (128-row query tile, head, batch)
// tiles, the longest causal rows first, in snake rounds, the heads of one KV
// head side by side (their K and V tiles come from L2 once); the forward's
// schedule (flash_attention_fwd.cu fwd_tile). Warpgroup 0 is the producer
// (one thread: Q, dO, lse, di once a tile, K and V of every visited 128-key
// tile, by TMA and bulk copies into full / empty mbarrier rings); warpgroups
// 1 and 2 own query rows 0-63 and 64-127 of the tile, read the same K/V
// stages, and take turns (named barriers 1 and 2): at point j a consumer
// issues S = Q·K^T and dP = dO·V^T of KV tile j and dQ += scale·dS·K of tile
// j - 1 together, passes the turn, and computes dS of tile j while the other
// consumer's products run. V(j) is released after point j, K(j) after j + 1.
// Unsegmented rows only: packed rows take the 64-row kernel (PERF.md §6).
template <int D, bool kCausal>
__global__ void __launch_bounds__(kWarpSpecThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                    const float* __restrict__ lse, const float* __restrict__ di,
                    __nv_bfloat16* __restrict__ dq, int B, int S, int H, int KVH, float scale) {
  using F = Dq<D>;
  constexpr int kQS = F::kQStages, kKV = F::kKVStages, kTB = F::kTB;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const uint32_t base = smem_u32(smem);
  const uint32_t bars = base + F::kBarOff;
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
        const DqTile f = dq_tile<kCausal>(tile, n_qt, H, B);
        const int kvh = f.h / groups;
        const int qs = qi % kQS;
        const int q0 = f.qt * kRows;
        const int rows = min(kRows, S - q0);  // lse and di rows past S are never read
        if (qi >= kQS) mbar_wait(q_empty(qs), (qi / kQS - 1) & 1);
        mbar_expect_tx(q_full(qs), 2 * kTB + 8 * rows);
#pragma unroll
        for (int cb = 0; cb < F::kBlocks; ++cb) {  // rows past S arrive as zeros
          tma_load_3d(base + qs * kTB + cb * kRowBlock, &tq, q_full(qs), f.h * D + cb * 64, q0,
                      f.b);
          tma_load_3d(base + F::kDoOff + qs * kTB + cb * kRowBlock, &tdo, q_full(qs),
                      f.h * D + cb * 64, q0, f.b);
        }
        const long r0 = ((long)f.b * H + f.h) * S + q0;
        const uint32_t stat = base + F::kStatOff + qs * F::kStatBytes;
        bulk_load(stat, lse + r0, 4 * rows, q_full(qs));
        bulk_load(stat + 512, di + r0, 4 * rows, q_full(qs));
        ++qi;
        for (int j = 0; j < f.n_kv; ++j, ++kvi) {
          const int st = kvi % kKV;
          const int kv0 = (f.kv_first + j) * kRows;
          if (kvi >= kKV) mbar_wait(k_empty(st), (kvi / kKV - 1) & 1);
          mbar_expect_tx(k_full(st), kTB);
#pragma unroll
          for (int cb = 0; cb < F::kBlocks; ++cb) {  // keys past S arrive as zeros
            tma_load_3d(base + F::kKOff + st * kTB + cb * kRowBlock, &tk, k_full(st),
                        kvh * D + cb * 64, kv0, f.b);
          }
          if (kvi >= kKV) mbar_wait(v_empty(st), (kvi / kKV - 1) & 1);
          mbar_expect_tx(v_full(st), kTB);
#pragma unroll
          for (int cb = 0; cb < F::kBlocks; ++cb) {
            tma_load_3d(base + F::kVOff + st * kTB + cb * kRowBlock, &tv, v_full(st),
                        kvh * D + cb * 64, kv0, f.b);
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
  const float scale_log2 = scale * kLog2e;
  const int my_turn = 1 + c, their_turn = 2 - c;
  if (c == 1) named_arrive(1, 256);

  int qi = 0, kvi = 0;
  for (int r = 0;; ++r) {
    const int tile = sched_tile(r, blockIdx.x, gridDim.x);
    if (tile >= n_tiles) break;
    const DqTile f = dq_tile<kCausal>(tile, n_qt, H, B);
    const int q0 = f.qt * kRows + 64 * c;   // this consumer's first row
    const int row_lo = q0 + 16 * warp + g;  // rows of this thread: row_lo, row_lo + 8
    const int qs = qi % kQS;
    const uint32_t q_t = base + qs * kTB + c * kHalfBlock;
    const uint32_t do_t = base + F::kDoOff + qs * kTB + c * kHalfBlock;
    mbar_wait(q_full(qs), (qi / kQS) & 1);
    // this thread's rows' statistics (rows past S: never used), read before
    // the stage is given back
    const float* stat = reinterpret_cast<const float*>(smem + F::kStatOff + qs * F::kStatBytes);
    const int sr = 64 * c + 16 * warp + g;
    const float lse_lo = stat[sr] * kLog2e, lse_hi = stat[sr + 8] * kLog2e;
    const float di_lo = stat[128 + sr], di_hi = stat[128 + sr + 8];
    const bool past_lo = row_lo >= S, past_hi = row_lo + 8 >= S;

    float acc[F::kBlocks][32];
#pragma unroll
    for (int cb = 0; cb < F::kBlocks; ++cb) {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[cb][i] = 0.f;
    }
    float s[64], dp[64];
    uint32_t dsa[8][4];

    // S = Q K^T and dP = dO V^T of KV tile stage st: queries x 128 keys
    auto issue_sdp = [&](int st) {
      const uint32_t k_t = base + F::kKOff + st * kTB;
      const uint32_t v_t = base + F::kVOff + st * kTB;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wgmma_ss_kk(s, desc_k(q_t, kRowBlock, kk), desc_k(k_t, kRowBlock, kk), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wgmma_ss_kk(dp, desc_k(do_t, kRowBlock, kk), desc_k(v_t, kRowBlock, kk), kk > 0);
      }
    };
    // dQ += scale·dS K: dS as bf16 A fragments, K read MN-major
    auto issue_dq = [&](int st) {
      const uint32_t k_t = base + F::kKOff + st * kTB;
#pragma unroll
      for (int cb = 0; cb < F::kBlocks; ++cb) {
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) wgmma_rs(acc[cb], dsa[kk], desc_mn(k_t, kRowBlock, cb, kk));
      }
    };
    // scale·dS of KV tile j into dsa, two elements at a time: P recomputed
    // from the lse, masked to 0 where a key is not seen (the diagonal tile;
    // non-causal, keys past S) and on rows past S
    auto elementwise = [&](int j) {
      const int kv0 = (f.kv_first + j) * kRows;
      const bool masked = kCausal ? f.kv_first + j == f.qt : kv0 + kRows > S;
#pragma unroll
      for (int i = 0; i < 64; i += 2) {
        const bool hi = (i & 2) != 0;
        float ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = kv0 + 8 * (i / 4) + 2 * t + e;
          bool off = hi ? past_hi : past_lo;
          if (masked) off = off || (kCausal ? key > row_lo + (hi ? 8 : 0) : key >= S);
          const float pv = fast_exp2(s[i + e] * scale_log2 - (hi ? lse_hi : lse_lo));
          ds[e] = off ? 0.f : pv * (dp[i + e] - (hi ? di_hi : di_lo)) * scale;
        }
        dsa[i / 8][(i % 8) / 2] = pack_bf16(ds[0], ds[1]);
      }
    };
    auto release = [&](uint32_t bar) {
      if (lead) mbar_arrive(bar);
    };

    for (int j = 0; j <= f.n_kv; ++j) {
      const bool last = j == f.n_kv;
      const int st = (kvi + j) % kKV;
      const int prev = (kvi + j + kKV - 1) % kKV;
      named_barrier(my_turn, 256);
      wgmma_fence();
      if (!last) {
        mbar_wait(k_full(st), ((kvi + j) / kKV) & 1);
        mbar_wait(v_full(st), ((kvi + j) / kKV) & 1);
        issue_sdp(st);
        wgmma_commit();
      }
      if (j > 0) {
        issue_dq(prev);
        wgmma_commit();
      }
      named_arrive(their_turn, 256);
      wgmma_wait<0>();
      fence_acc_n(s);
      fence_acc_n(dp);
#pragma unroll
      for (int cb = 0; cb < F::kBlocks; ++cb) fence_acc(acc[cb]);
      if (!last) {
        release(v_empty(st));
        if (j == f.n_kv - 1) release(q_empty(qs));
      }
      if (j > 0) release(k_empty(prev));
      if (!last) elementwise(j);
    }
    kvi += f.n_kv;
    ++qi;

    const long q_stride = (long)H * D;
    store_rows<D>(acc, dq + ((long)f.b * S + q0) * q_stride + (long)f.h * D, q_stride, warp, g, t,
                  S - q0);
  }
  if (c == 0) named_barrier(my_turn, 256);  // consumer 1's last turn handed over
}

template <int D, bool kCausal>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* di, void* dk, void* dv, int B, int S, int H,
                       int KVH, float scale, int device, cudaStream_t st) {
  static unsigned smem_set = 0;
  constexpr int smem = Dkv<D>::kSmem;
  cudaError_t err = cudaSuccess;
  if (!(smem_set & (1u << device))) {
    err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<D, kCausal>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_set |= 1u << device;
  }
  CUtensorMap tq, tk, tv, tdo;
  err = heads_map(&tq, q, B, S, H, D, kTile);
  if (err == cudaSuccess) err = heads_map(&tdo, dout, B, S, H, D, kTile);
  if (err == cudaSuccess) err = heads_map(&tk, k, B, S, KVH, D, kRows);
  if (err == cudaSuccess) err = heads_map(&tv, v, B, S, KVH, D, kRows);
  if (err != cudaSuccess) return err;
  const int tiles = (S + kRows - 1) / kRows * KVH * B;
  const int sms = sm_count(device);
  if (sms == 0) return cudaErrorInvalidValue;
  flash_bwd_dkv_kernel<D, kCausal><<<tiles < sms ? tiles : sms, kWarpSpecThreads, smem, st>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse), static_cast<const float*>(di),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), B, S, H, KVH, scale);
  return cudaGetLastError();
}

template <int D, bool kSeg, bool kCausal>
cudaError_t launch_dkv_tiled(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* di, const void* seg, void* dk, void* dv,
                             int B, int S, int H, int KVH, float scale, cudaStream_t st) {
  constexpr int smem = DkvTiled<D>::kDkvSmem;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_tiled_kernel<D, kSeg, kCausal>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_tiled_kernel<D, kSeg, kCausal>
      <<<dim3(S / kTile, KVH, B), DkvTiled<D>::kDkvGroups * 128, smem, st>>>(
          static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
          static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
          static_cast<const float*>(lse), static_cast<const float*>(di),
          static_cast<const int*>(seg), static_cast<__nv_bfloat16*>(dk),
          static_cast<__nv_bfloat16*>(dv), S, H, KVH, scale);
  return cudaGetLastError();
}

template <int D, bool kCausal>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* di, void* dq, int B, int S, int H, int KVH,
                      float scale, int device, cudaStream_t st) {
  static unsigned smem_set = 0;
  constexpr int smem = Dq<D>::kSmem;
  cudaError_t err = cudaSuccess;
  if (!(smem_set & (1u << device))) {
    err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D, kCausal>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_set |= 1u << device;
  }
  CUtensorMap tq, tk, tv, tdo;
  err = heads_map(&tq, q, B, S, H, D, kRows);
  if (err == cudaSuccess) err = heads_map(&tdo, dout, B, S, H, D, kRows);
  if (err == cudaSuccess) err = heads_map(&tk, k, B, S, KVH, D, kRows);
  if (err == cudaSuccess) err = heads_map(&tv, v, B, S, KVH, D, kRows);
  if (err != cudaSuccess) return err;
  const int tiles = (S + kRows - 1) / kRows * H * B;
  const int sms = sm_count(device);
  if (sms == 0) return cudaErrorInvalidValue;
  flash_bwd_dq_kernel<D, kCausal><<<tiles < sms ? tiles : sms, kWarpSpecThreads, smem, st>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse), static_cast<const float*>(di),
      static_cast<__nv_bfloat16*>(dq), B, S, H, KVH, scale);
  return cudaGetLastError();
}

template <int D, bool kSeg, bool kCausal>
cudaError_t launch_dq_tiled(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* di, const void* seg, void* dq, int B,
                            int S, int H, int KVH, float scale, cudaStream_t st) {
  constexpr int smem = Bwd<D>::kDqSmem;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_tiled_kernel<D, kSeg, kCausal>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_tiled_kernel<D, kSeg, kCausal><<<dim3(S / kTile, H, B), 128, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(di),
      static_cast<const int*>(seg), static_cast<__nv_bfloat16*>(dq), S, H, KVH, scale);
  return cudaGetLastError();
}

bool bad_shape(int B, int S, int H, int KVH) {
  return B <= 0 || S <= 0 || S % kTile != 0 || KVH <= 0 || H % KVH != 0;
}

template <bool kSeg, bool kCausal>
int bwd_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
            const void* di, const void* seg, void* dk, void* dv, int B, int S, int H, int KVH,
            int D, float scale, int device, void* stream) {
  if (bad_shape(B, S, H, KVH)) return (int)cudaErrorInvalidValue;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the persistent kernel at D=64 unsegmented; the 64-key kernel for packed
  // rows and at D=128 (PERF.md §6)
  if (D == 64) {
    if constexpr (kSeg) {
      return (int)launch_dkv_tiled<64, true, true>(q, k, v, dout, lse, di, seg, dk, dv, B, S, H,
                                                   KVH, scale, st);
    } else {
      return (int)launch_dkv<64, kCausal>(q, k, v, dout, lse, di, dk, dv, B, S, H, KVH, scale,
                                          device, st);
    }
  }
  if (D == 128) {
    return (int)launch_dkv_tiled<128, kSeg, kCausal>(q, k, v, dout, lse, di, seg, dk, dv, B, S, H,
                                                     KVH, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}

template <bool kSeg, bool kCausal>
int bwd_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
           const void* di, const void* seg, void* dq, int B, int S, int H, int KVH, int D,
           float scale, int device, void* stream) {
  if (bad_shape(B, S, H, KVH)) return (int)cudaErrorInvalidValue;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the persistent kernel unsegmented, causal at both head dims and
  // non-causal at D=64; the 64-row kernel for packed rows and non-causal at
  // D=128, where it was faster in one interleaved call (PERF.md §6)
  if (D == 64) {
    if constexpr (kSeg) {
      return (int)launch_dq_tiled<64, true, true>(q, k, v, dout, lse, di, seg, dq, B, S, H, KVH,
                                                  scale, st);
    } else {
      return (int)launch_dq<64, kCausal>(q, k, v, dout, lse, di, dq, B, S, H, KVH, scale, device,
                                         st);
    }
  }
  if (D == 128) {
    if constexpr (kSeg || !kCausal) {
      return (int)launch_dq_tiled<128, kSeg, kCausal>(q, k, v, dout, lse, di, seg, dq, B, S, H,
                                                      KVH, scale, st);
    } else {
      return (int)launch_dq<128, true>(q, k, v, dout, lse, di, dq, B, S, H, KVH, scale, device,
                                       st);
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C entries for ctypes. Pointers are device pointers of contiguous
// tensors (lse, di: f32 [B,H,S]; seg: int32 [B, kMaxSegs]); `stream` is a
// cudaStream_t. Each returns the launch's cudaError_t. `_full`: non-causal,
// every key visible.
extern "C" int tst_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                           const void* dout, const void* lse, const void* di,
                                           void* dk, void* dv, int B, int S, int H, int KVH,
                                           int D, float scale, int device, void* stream) {
  return bwd_dkv<false, true>(q, k, v, dout, lse, di, nullptr, dk, dv, B, S, H, KVH, D, scale,
                              device, stream);
}

extern "C" int tst_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                          const void* dout, const void* lse, const void* di,
                                          void* dq, int B, int S, int H, int KVH, int D,
                                          float scale, int device, void* stream) {
  return bwd_dq<false, true>(q, k, v, dout, lse, di, nullptr, dq, B, S, H, KVH, D, scale, device,
                             stream);
}

extern "C" int tst_flash_attention_bwd_dkv_full(const void* q, const void* k, const void* v,
                                                const void* dout, const void* lse, const void* di,
                                                void* dk, void* dv, int B, int S, int H, int KVH,
                                                int D, float scale, int device, void* stream) {
  return bwd_dkv<false, false>(q, k, v, dout, lse, di, nullptr, dk, dv, B, S, H, KVH, D, scale,
                               device, stream);
}

extern "C" int tst_flash_attention_bwd_dq_full(const void* q, const void* k, const void* v,
                                               const void* dout, const void* lse, const void* di,
                                               void* dq, int B, int S, int H, int KVH, int D,
                                               float scale, int device, void* stream) {
  return bwd_dq<false, false>(q, k, v, dout, lse, di, nullptr, dq, B, S, H, KVH, D, scale,
                              device, stream);
}

extern "C" int tst_flash_attention_bwd_dkv_seg(const void* q, const void* k, const void* v,
                                               const void* dout, const void* lse, const void* di,
                                               const void* seg, void* dk, void* dv, int B, int S,
                                               int H, int KVH, int D, float scale, int device,
                                               void* stream) {
  if (seg == nullptr) return (int)cudaErrorInvalidValue;
  return bwd_dkv<true, true>(q, k, v, dout, lse, di, seg, dk, dv, B, S, H, KVH, D, scale, device,
                             stream);
}

extern "C" int tst_flash_attention_bwd_dq_seg(const void* q, const void* k, const void* v,
                                              const void* dout, const void* lse, const void* di,
                                              const void* seg, void* dq, int B, int S, int H,
                                              int KVH, int D, float scale, int device,
                                              void* stream) {
  if (seg == nullptr) return (int)cudaErrorInvalidValue;
  return bwd_dq<true, true>(q, k, v, dout, lse, di, seg, dq, B, S, H, KVH, D, scale, device,
                            stream);
}
