// Attention of a decode step over its KV cache, in one fixed order a query,
// for Hopper (sm_90a): out[b, t, h] (bf16) = softmax(q·kᵀ / sqrt(D), masked)
// · v over the S slots of row b's cache.
//
// Replaces the plain `jnp` attention of the reference's decode step
// (tst/models/decode.py:196-201, `_chunk_step`; no `pallas_call`). The port
// needs it as a kernel for one property the plain torch version lacks on the
// card: the result of a query depends only on the query and on the keys and
// values of the slots it may see, taken in slot order. It does not depend on
// how many queries share the call (T = 1 in a greedy step, gamma + 1 in
// speculative decode's verify chunk), on the cache's length, on where masked
// slots sit between the visible ones (rejected draft tokens), or on which
// heads share a block. torch's batched products and softmax choose their
// blocking by shape, so there a row's sums run in another order at another T
// or S; here they do not, and speculative decode's tokens are greedy
// decode's bit for bit (ROADMAP §3, F1).
//
// Semantics (the plain version, tst_torch/kernels/decode_attention.py): f32
// scores q·k (bf16 operands), an f32 softmax over the visible slots whose
// probabilities are rounded to bf16, f32 sums of p·v, the output rounded to
// bf16. Masked slots weigh nothing (the plain version's exact 0).
//
// What bounds it: the bytes of the visible slots' keys and values (a greedy
// step of Qwen2.5-0.5B, 32 rows at S=640: ~4.9 MB, 1.5 µs at 3.35 TB/s), and,
// at a decode step's sizes, the latency of the few dependent steps between
// the mask and the output. The design before this one ran one 128-thread
// block a (row, query, head): each query head of a GQA group read the same
// keys and values again (from L2), and each block walked every visible slot
// serially through four block-wide barriers.
//
// The structure, fixed by the visible slots' ranks r (0, 1, ... in slot
// order) and their count n alone (tst_decode_attention_rank_plan):
//   * a chunk is 64 ranks; one warp computes a chunk whole: its scores on
//     mma.sync m16n8k16 (the query heads as the 16 rows, D/16 k-steps in
//     order), their max and their sum of exp2(s - max) in one fixed tree, and
//     later its p·v (16-rank k-steps in order, from zero). A row of an MMA
//     depends only on its own operands, so a head's bits do not depend on the
//     heads beside it; ranks past n are -inf scores and zero values;
//   * a superchunk is kSuper chunks (1024 ranks at D=64, 768 at D=128), the
//     share of one block; the softmax's max M and sum L of a head over all
//     its chunks: each half-warp lane takes chunks i, i + 16, ... in order,
//     then a 4-step butterfly; p = bf16(exp2(s - M) / L); the output is the
//     chunks' p·v summed in chunk order within a superchunk, then the
//     superchunks' sums in order.
// Every rounding step is an explicit _rn intrinsic, so the kernels that share
// a step compile it alike. Nothing in that structure takes S or T.
//
// The design: one block a (row, query, KV head) and up to 16 of the KV
// head's query heads, so each key and value row is read once for its whole
// GQA group (G = 7 at Qwen2.5-0.5B's 14/2 heads, 4 at Llama-3-8B's 32/8),
// gathered by rank into swizzled shared memory by 16-byte cp.async and read
// by ldmatrix. Rows come in 64-dim stages (one at D=64, two at D=128) into
// 8 KB chunk buffers, and the one-kernel path takes only as many buffers as
// S has chunks, so two blocks fit an SM at S=640 at both head dims (a decode
// step runs 64-1280 blocks, each a short chain of dependent latencies). Two
// paths, chosen by S, give the same bits:
//   * S <= one superchunk (every decode step of the repository's presets but
//     the long cache): one kernel, decode_attention_kernel. Each warp scans
//     the whole mask itself (no barrier), gathers the keys of its chunks,
//     scores them, gathers their values into the same buffers while the
//     other warps finish, and three block-wide barriers (chunk statistics,
//     M and L, the chunks' p·v) lead to the output;
//   * longer caches: two kernels behind the one entry, a block a superchunk.
//     decode_scores_kernel scans the mask with the block (two barriers),
//     writes the ranks' slots, the scores and each chunk's max and sum to
//     scratch; decode_pv_kernel reads them, computes p·v and its superchunk's
//     sum, and the last of the row's blocks to finish (an atomic count, reset
//     by the first kernel) adds the superchunks' sums in order. So a call
//     launches one kernel or two; the wrapper counts calls of the entry.
// Measured and not kept (PERF.md §6): whole D=128 rows in 16 KB
// buffers and every superchunk's buffers in the one-kernel path (197 KB of
// shared memory, 214 registers at D=128: one block an SM, slower than the
// design before at Llama-3-8B's 32/8 heads, where 192-1280 blocks run).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma_sm90.cuh"  // smem_u32, cp.async; mma_bf16.cuh: mma_16816, ldmatrix, pack_bf16

namespace {

constexpr int kMaxDevices = 32;
constexpr int kChunk = 64;   // ranks a chunk: one warp's unit of work
constexpr int kHeads = 16;   // query heads a block: the rows of an MMA
constexpr int kMaxSlots = 27648;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;

constexpr int kBufBytes = kChunk * 128;  // a chunk buffer: 64 rows of 64 bf16

template <int D>
struct Dattn {
  static_assert(D == 64 || D == 128, "head dim must be 64 or 128");
  static constexpr int kWarps = D == 64 ? 8 : 6;
  static constexpr int kPerWarp = 2;                  // chunks a warp
  static constexpr int kSuper = kWarps * kPerWarp;   // chunks a superchunk (a block)
  static constexpr int kSuperRanks = kSuper * kChunk;
  static constexpr int kThreads = kWarps * 32;
  // dynamic shared memory: the superchunk's slots, its chunks' statistics,
  // the heads' M and L, the scan's counts, then a buffer a chunk (the
  // one-kernel path takes only the chunks S can hold)
  static constexpr int kSlotsOff = 0;
  static constexpr int kStatsOff = kSlotsOff + kSuperRanks * 4;
  static constexpr int kMLOff = kStatsOff + kSuper * kHeads * 8;
  static constexpr int kCountOff = kMLOff + kHeads * 8;
  static constexpr int kBufOff = (kCountOff + 64 + 127) / 128 * 128;
  static constexpr int kSmem = kBufOff + kSuper * kBufBytes;
};

// byte offset of 16-byte piece c (dims 8c .. 8c + 7 of the stage) of row r in
// a chunk buffer, swizzled within the row (ldmatrix without bank conflicts)
__device__ __forceinline__ uint32_t piece_off(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) * 16);
}

// The visible slots of 16-byte mask words [u0, u1) of a row whose bytes
// begin `lead` bytes into the aligned `abase`, in slot order: f(slot, rank)
// for each, ranks from rank0 → their count. A whole warp calls it.
template <class F>
__device__ __forceinline__ int scan_mask(const uint4* abase, int lead, int S, int u0, int u1,
                                         int rank0, int lane, F&& f) {
  int rank = rank0;
  for (int base = u0; base < u1; base += 32) {
    const int u = base + lane;
    unsigned bits = 0;
    if (u < u1) {
      const uint4 w = abase[u];
      const uint32_t x[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const int s = 16 * u + k - lead;
        if (((x[k / 4] >> (8 * (k % 4))) & 0xffu) && s >= 0 && s < S) bits |= 1u << k;
      }
    }
    const int mine = __popc(bits);
    int incl = mine;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += y;
    }
    int r = rank + incl - mine;
    while (bits) {
      const int k = __ffs(bits) - 1;
      bits &= bits - 1;
      f(16 * u + k - lead, r++);
    }
    rank += __shfl_sync(kFull, incl, 31);
  }
  return rank - rank0;
}

// gather dims 64·stage .. + 63 of the K or V rows of one chunk's ranks (rank
// i of the chunk at slot slots[i]; none past `valid`, which are zeros) into a
// chunk buffer: a warp, 16-byte cp.async
__device__ __forceinline__ void gather_chunk(uint32_t buf, const int* slots, int valid,
                                             const __nv_bfloat16* base, long stride, int stage,
                                             int lane) {
#pragma unroll 4
  for (int i = lane; i < kChunk * 8; i += 32) {
    const int r = i / 8, c = i % 8;
    const bool ok = r < valid;
    const __nv_bfloat16* src = ok ? base + (long)slots[r] * stride + 64 * stage + c * 8 : base;
    cp_async16_zfill(buf + piece_off(r, c), src, ok);
  }
}

// the A operand of the scores: rows g and g + 8 of the block's heads (zeros
// past `heads`), D/16 k-steps
template <int D>
__device__ __forceinline__ void load_q(uint32_t (&qa)[D / 16][4], const __nv_bfloat16* q0,
                                       int heads, int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = g + 8 * (i & 1), col = 16 * kk + 8 * (i >> 1) + 2 * t;
      qa[kk][i] = row < heads ? *reinterpret_cast<const uint32_t*>(q0 + row * D + col) : 0u;
    }
  }
}

// A chunk's scores, s[j][e] for rows g + 8·(e / 2) and rank 8j + 2t + e % 2
// of the chunk: the k-steps of one 64-dim stage (its keys in `buf`) added in
// order to s, which stage 0 starts from zero
template <int D>
__device__ __forceinline__ void chunk_scores(float (&s)[8][4], const uint32_t (&qa)[D / 16][4],
                                             uint32_t buf, int stage, int lane) {
  if (stage == 0) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    }
  }
#pragma unroll
  for (int k2 = 0; k2 < 4; k2 += 2) {
    const int kk = 4 * stage + k2;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t b[4];  // k-steps kk (b[0], b[1]) and kk + 1 (b[2], b[3]) of ranks 8j ..
      const int r = 8 * j + (lane & 7);
      ldmatrix_x4(b, buf + piece_off(r, 2 * k2 + lane / 8));
      mma_16816(s[j], qa[kk], b[0], b[1]);
      mma_16816(s[j], qa[kk + 1], b[2], b[3]);
    }
  }
}

// the scores in log2 units: one multiply; ranks at or past n are -inf
__device__ __forceinline__ void scale_scores(float (&s)[8][4], int rank0, int n,
                                             float scale_log2, int lane) {
  const int t = lane % 4;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = rank0 + 8 * j + 2 * t + (e & 1);
      s[j][e] = r < n ? __fmul_rn(s[j][e], scale_log2) : -INFINITY;
    }
  }
}

// a chunk's max and sum of exp2(s - max) for rows g (lo) and g + 8 (hi):
// this lane's values in order, then the 4 lanes of a row by xor (every lane
// gets the same sum)
__device__ __forceinline__ void chunk_stats(const float (&s)[8][4], float2& lo, float2& hi) {
  float m_lo = -INFINITY, m_hi = -INFINITY;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    m_lo = fmaxf(m_lo, fmaxf(s[j][0], s[j][1]));
    m_hi = fmaxf(m_hi, fmaxf(s[j][2], s[j][3]));
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    m_lo = fmaxf(m_lo, __shfl_xor_sync(kFull, m_lo, off));
    m_hi = fmaxf(m_hi, __shfl_xor_sync(kFull, m_hi, off));
  }
  float l_lo = 0.f, l_hi = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      l_lo = __fadd_rn(l_lo, exp2f(__fsub_rn(s[j][e], m_lo)));
      l_hi = __fadd_rn(l_hi, exp2f(__fsub_rn(s[j][e + 2], m_hi)));
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_lo = __fadd_rn(l_lo, __shfl_xor_sync(kFull, l_lo, off));
    l_hi = __fadd_rn(l_hi, __shfl_xor_sync(kFull, l_hi, off));
  }
  lo = make_float2(m_lo, l_lo);
  hi = make_float2(m_hi, l_hi);
}

// M and L of one head from its nc chunks' (max, sum) at st[c · cstride]: each
// lane of a half-warp takes chunks i, i + 16, ... in order, then a butterfly
// over the 16 lanes (each gets the same value)
__device__ __forceinline__ float2 head_stats(const float2* st, int cstride, int nc, int lane) {
  const int i = lane & 15;
  float m = -INFINITY;
  for (int c = i; c < nc; c += 16) m = fmaxf(m, st[(long)c * cstride].x);
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
  float l = 0.f;
  for (int c = i; c < nc; c += 16) {
    const float2 x = st[(long)c * cstride];
    l = __fadd_rn(l, __fmul_rn(x.y, exp2f(__fsub_rn(x.x, m))));
  }
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) l = __fadd_rn(l, __shfl_xor_sync(kFull, l, off));
  return make_float2(m, l);
}

// M and L of the block's heads into ml[]: warp w takes heads 2w, 2w + 1 (a
// half-warp each), then 2w + 2·kWarps, ...; `st(h)` is head h's first chunk
template <int W, class St>
__device__ __forceinline__ void heads_stats(float2* ml, int heads, int cstride, int nc, int warp,
                                            int lane, St&& st) {
  for (int h0 = 2 * warp; h0 < heads; h0 += 2 * W) {
    const int h = h0 + lane / 16;
    const float2 x = head_stats(st(h < heads ? h : h0), cstride, nc, lane);
    if ((lane & 15) == 0 && h < heads) ml[h] = x;
  }
}

// p = bf16(exp2(s - M) / L) of a chunk as the A operand of its p·v: k-step
// kk (ranks 16kk ..) from score tiles 2kk and 2kk + 1, rows g and g + 8
__device__ __forceinline__ void chunk_probs(uint32_t (&pa)[4][4], const float (&s)[8][4],
                                            float2 ml_lo, float2 ml_hi) {
  auto prob = [&](float x, float2 ml) { return __fdiv_rn(exp2f(__fsub_rn(x, ml.x)), ml.y); };
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    pa[kk][0] = pack_bf16(prob(s[2 * kk][0], ml_lo), prob(s[2 * kk][1], ml_lo));
    pa[kk][1] = pack_bf16(prob(s[2 * kk][2], ml_hi), prob(s[2 * kk][3], ml_hi));
    pa[kk][2] = pack_bf16(prob(s[2 * kk + 1][0], ml_lo), prob(s[2 * kk + 1][1], ml_lo));
    pa[kk][3] = pack_bf16(prob(s[2 * kk + 1][2], ml_hi), prob(s[2 * kk + 1][3], ml_hi));
  }
}

// p·v of one chunk over one 64-dim stage (its values in `buf`), from zero:
// the 16-rank k-steps in order, values read by ldmatrix.trans; acc[j][e] for
// row g + 8·(e / 2), dim 64·stage + 8j + 2t + e % 2
__device__ __forceinline__ void chunk_pv(float (&acc)[8][4], const uint32_t (&pa)[4][4],
                                         uint32_t buf, int lane) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {  // dims 16jp .. 16jp + 15: n tiles 2jp, 2jp + 1
      uint32_t b[4];
      const int r = 16 * kk + 8 * ((lane / 8) & 1) + (lane & 7);
      ldmatrix_x4_trans(b, buf + piece_off(r, 2 * jp + lane / 16));
      mma_16816(acc[2 * jp], pa[kk], b[0], b[1]);
      mma_16816(acc[2 * jp + 1], pa[kk], b[2], b[3]);
    }
  }
}

// a chunk's p·v, f32 [kHeads][D], into its (spent) buffer; the warp's reads
// of the buffer must be done
template <int D>
__device__ __forceinline__ void store_partial(unsigned char* buf,
                                              const float (&acc)[D / 64][8][4], int lane) {
  const int g = lane / 4, t = lane % 4;
  float* p = reinterpret_cast<float*>(buf);
#pragma unroll
  for (int st = 0; st < D / 64; ++st) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int d = 64 * st + 8 * j + 2 * t;
      *reinterpret_cast<float2*>(p + g * D + d) = make_float2(acc[st][j][0], acc[st][j][1]);
      *reinterpret_cast<float2*>(p + (g + 8) * D + d) = make_float2(acc[st][j][2], acc[st][j][3]);
    }
  }
}

// a warp's p·v of its chunk c (values of stage 0 already in flight to its
// buffer; the later stages gathered here, each after the one before is
// read), then the chunk's sum into the buffer
template <int D>
__device__ __forceinline__ void chunk_pv_all(const uint32_t (&pa)[4][4], unsigned char* buf,
                                             const int* slots, int valid,
                                             const __nv_bfloat16* vb, long stride, int lane) {
  float acc[D / 64][8][4];
  const uint32_t b = smem_u32(buf);
#pragma unroll
  for (int st = 0; st < D / 64; ++st) {
    if (st > 0) {
      __syncwarp();
      gather_chunk(b, slots, valid, vb, stride, st, lane);
      cp_async_commit();
    }
    cp_async_wait<0>();
    __syncwarp();
    chunk_pv(acc[st], pa, b, lane);
  }
  __syncwarp();
  store_partial<D>(buf, acc, lane);
}

// element i of the block's [heads][D] sum of its first nc chunks' p·v, in
// chunk order
__device__ __forceinline__ float fold_chunks(const unsigned char* bufs, int nc, int i) {
  float o = reinterpret_cast<const float*>(bufs)[i];
  for (int c = 1; c < nc; ++c) {
    o = __fadd_rn(o, reinterpret_cast<const float*>(bufs + c * kBufBytes)[i]);
  }
  return o;
}

// the block's place: row·T + query (bt), its KV head, and which of that
// head's query heads (up to kHeads from h0)
struct Place {
  int bt, b, kvh, h0, heads;
};

__device__ __forceinline__ Place place(int bt, int kvg, int T, int H, int KVH) {
  const int G = H / KVH, groups = (G + kHeads - 1) / kHeads;
  const int first = (kvg % groups) * kHeads;
  Place p;
  p.bt = bt;
  p.b = bt / T;
  p.kvh = kvg / groups;
  p.h0 = p.kvh * G + first;
  p.heads = min(kHeads, G - first);
  return p;
}

// a row's mask as 16-byte words from an aligned address: the row's bytes
// begin `lead` bytes into the first (a word never crosses a page, so the
// bytes around the row that the first and last words hold are safe to read
// and are ignored)
struct MaskRow {
  const uint4* words;
  int lead, n_words;
};

__device__ __forceinline__ MaskRow mask_row(const uint8_t* mask, int bt, int S) {
  const uint8_t* row = mask + (long)bt * S;
  MaskRow m;
  m.lead = (int)(reinterpret_cast<uintptr_t>(row) & 15);
  m.words = reinterpret_cast<const uint4*>(row - m.lead);
  m.n_words = (S + m.lead + 15) / 16;
  return m;
}

// Two-path scratch: the scores of the visible ranks [B·T][H][S] (log2 units),
// each chunk's (max, sum) [B·T][H][NC], each superchunk's p·v [B·T][H][Z][D],
// the slot of each rank [B·T][S], n [B·T], and the finished blocks of each
// (row, query, KV head group) [B·T][KVH·groups]; each 256-byte aligned
struct Scratch {
  float* scores;
  float2* stats;
  float* parts;
  int* slots;
  int* count;
  int* done;
};

inline size_t align256(size_t x) { return (x + 255) / 256 * 256; }

// the scratch's bytes (0: the one-kernel path takes none), and its pointers
// when `base` is given
inline size_t scratch_layout(int B, int T, int S, int H, int KVH, int D, unsigned char* base,
                             Scratch* sc) {
  const int super = D == 64 ? Dattn<64>::kSuperRanks : Dattn<128>::kSuperRanks;
  if (S <= super) return 0;
  const size_t bt = (size_t)B * T;
  const size_t nc = (S + kChunk - 1) / kChunk, z = (S + super - 1) / super;
  const size_t groups = (H / KVH + kHeads - 1) / kHeads;
  const size_t sizes[6] = {align256(bt * H * S * 4), align256(bt * H * nc * 8),
                           align256(bt * H * z * D * 4), align256(bt * S * 4),
                           align256(bt * 4), align256(bt * KVH * groups * 4)};
  if (base != nullptr) {
    size_t off = 0;
    unsigned char* p[6];
    for (int i = 0; i < 6; ++i) {
      p[i] = base + off;
      off += sizes[i];
    }
    sc->scores = reinterpret_cast<float*>(p[0]);
    sc->stats = reinterpret_cast<float2*>(p[1]);
    sc->parts = reinterpret_cast<float*>(p[2]);
    sc->slots = reinterpret_cast<int*>(p[3]);
    sc->count = reinterpret_cast<int*>(p[4]);
    sc->done = reinterpret_cast<int*>(p[5]);
  }
  size_t total = 0;
  for (size_t s : sizes) total += s;
  return total;
}

// A warp's scores of its chunks c = warp + W·i < nc (rank i of chunk c at
// slots[64c + i]; `valid` ranks from slots[0]): the keys gathered a 64-dim
// stage at a time into the chunks' buffers, the query heads' A operand loaded
// while the first stage is in flight
template <int D, int W>
__device__ __forceinline__ void warp_scores(float (&s)[2][8][4], const __nv_bfloat16* q0,
                                            int heads, uint32_t buf0, const int* slots, int nc,
                                            int valid, const __nv_bfloat16* kb, long stride,
                                            int warp, int lane) {
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int st = 0; st < D / 64; ++st) {
    if (st > 0) __syncwarp();  // the last stage's keys are read
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = warp + W * i;
      if (c < nc) {
        gather_chunk(buf0 + c * kBufBytes, slots + c * kChunk, valid - c * kChunk, kb, stride,
                     st, lane);
      }
    }
    cp_async_commit();
    if (st == 0) load_q<D>(qa, q0, heads, lane);
    cp_async_wait<0>();
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = warp + W * i;
      if (c < nc) chunk_scores<D>(s[i], qa, buf0 + c * kBufBytes, st, lane);
    }
  }
}

// a warp's first stage of values for its chunks, into their buffers (the
// keys there are read)
template <int W>
__device__ __forceinline__ void warp_values(uint32_t buf0, const int* slots, int nc, int valid,
                                            const __nv_bfloat16* vb, long stride, int warp,
                                            int lane) {
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = warp + W * i;
    if (c < nc) {
      gather_chunk(buf0 + c * kBufBytes, slots + c * kChunk, valid - c * kChunk, vb, stride, 0,
                   lane);
    }
  }
  cp_async_commit();
}

// The one-kernel path (S <= kSuperRanks): one block a (row·T + query, KV
// head group), grid (B·T, KVH·groups), its buffers only as many as S's
// chunks; warp w owns chunks w and w + kWarps.
template <int D>
__global__ void __launch_bounds__(Dattn<D>::kThreads, 2) decode_attention_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const uint8_t* __restrict__ mask,
    __nv_bfloat16* __restrict__ out, int T, int S, int H, int KVH, float scale_log2) {
  using A = Dattn<D>;
  constexpr int W = A::kWarps;
  extern __shared__ __align__(128) unsigned char smem[];
  int* slots = reinterpret_cast<int*>(smem + A::kSlotsOff);
  float2* stats = reinterpret_cast<float2*>(smem + A::kStatsOff);  // [chunk][head]
  float2* ml = reinterpret_cast<float2*>(smem + A::kMLOff);
  unsigned char* bufs = smem + A::kBufOff;
  const uint32_t buf0 = smem_u32(bufs);

  const Place pl = place(blockIdx.x, blockIdx.y, T, H, KVH);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const long kv_stride = (long)KVH * D;
  const __nv_bfloat16* kb = k + ((long)pl.b * S * KVH + pl.kvh) * D;
  const __nv_bfloat16* vb = v + ((long)pl.b * S * KVH + pl.kvh) * D;
  __nv_bfloat16* orow = out + ((long)pl.bt * H + pl.h0) * D;

  // 1. rank → slot: each warp scans the whole row, keeps its chunks' slots
  const MaskRow mr = mask_row(mask, pl.bt, S);
  const int n = scan_mask(mr.words, mr.lead, S, 0, mr.n_words, 0, lane, [&](int s, int r) {
    if ((r / kChunk) % W == warp) slots[r] = s;
  });
  if (n == 0) {  // nothing visible (a decode step always sees its own slot)
    for (int i = threadIdx.x; i < pl.heads * D; i += A::kThreads) orow[i] = __float2bfloat16(0.f);
    return;
  }
  const int nc = (n + kChunk - 1) / kChunk;
  __syncwarp();

  // 2. this warp's chunks' scores and statistics; then their values
  float s[A::kPerWarp][8][4];
  warp_scores<D, W>(s, q + ((long)pl.bt * H + pl.h0) * D, pl.heads, buf0, slots, nc, n, kb,
                    kv_stride, warp, lane);
#pragma unroll
  for (int i = 0; i < A::kPerWarp; ++i) {
    const int c = warp + W * i;
    if (c < nc) {
      scale_scores(s[i], c * kChunk, n, scale_log2, lane);
      float2 lo, hi;
      chunk_stats(s[i], lo, hi);
      if (t == 0 && g < pl.heads) stats[c * kHeads + g] = lo;
      if (t == 0 && g + 8 < pl.heads) stats[c * kHeads + g + 8] = hi;
    }
  }
  warp_values<W>(buf0, slots, nc, n, vb, kv_stride, warp, lane);
  __syncthreads();  // every chunk's statistics

  // 3. M and L of each head
  heads_stats<W>(ml, pl.heads, kHeads, nc, warp, lane, [&](int h) { return stats + h; });
  __syncthreads();
  const float2 ml_lo = ml[min(g, pl.heads - 1)], ml_hi = ml[min(g + 8, pl.heads - 1)];

  // 4. each chunk's p·v into its buffer
#pragma unroll
  for (int i = 0; i < A::kPerWarp; ++i) {
    const int c = warp + W * i;
    if (c < nc) {
      uint32_t pa[4][4];
      chunk_probs(pa, s[i], ml_lo, ml_hi);
      chunk_pv_all<D>(pa, bufs + c * kBufBytes, slots + c * kChunk, n - c * kChunk, vb,
                      kv_stride, lane);
    }
  }
  __syncthreads();  // every chunk's p·v

  // 5. their sum in chunk order
  for (int i = threadIdx.x; i < pl.heads * D; i += A::kThreads) {
    orow[i] = __float2bfloat16(fold_chunks(bufs, nc, i));
  }
}

// The two-kernel path, first kernel: a block a (row·T + query, superchunk z,
// KV head group), grid (B·T, Z, KVH·groups). The block scans the row's mask
// (warp w a span of its words: counts, then ranks), keeps the slots of its
// superchunk's ranks, scores its chunks, and writes the scores and each
// chunk's statistics; the KV head group 0 blocks write the slots and n.
template <int D>
__global__ void __launch_bounds__(Dattn<D>::kThreads, 1) decode_scores_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const uint8_t* __restrict__ mask, Scratch sc, int T, int S, int H, int KVH,
    float scale_log2) {
  using A = Dattn<D>;
  constexpr int W = A::kWarps;
  extern __shared__ __align__(128) unsigned char smem[];
  int* slots = reinterpret_cast<int*>(smem + A::kSlotsOff);
  int* wcount = reinterpret_cast<int*>(smem + A::kCountOff);
  const uint32_t buf0 = smem_u32(smem + A::kBufOff);

  const int z = blockIdx.y;
  const Place pl = place(blockIdx.x, blockIdx.z, T, H, KVH);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int lo = z * A::kSuperRanks;
  const int NC = (S + kChunk - 1) / kChunk;

  const MaskRow mr = mask_row(mask, pl.bt, S);
  const int per = ((mr.n_words + W - 1) / W + 31) / 32 * 32;
  const int u0 = min(mr.n_words, warp * per), u1 = min(mr.n_words, u0 + per);
  const int mine = scan_mask(mr.words, mr.lead, S, u0, u1, 0, lane, [](int, int) {});
  if (lane == 0) wcount[warp] = mine;
  __syncthreads();
  int before = 0, n = 0;
#pragma unroll
  for (int w = 0; w < W; ++w) {
    before += w < warp ? wcount[w] : 0;
    n += wcount[w];
  }
  scan_mask(mr.words, mr.lead, S, u0, u1, before, lane, [&](int s, int r) {
    if (r >= lo && r < lo + A::kSuperRanks) slots[r - lo] = s;
  });
  __syncthreads();
  if (z == 0 && threadIdx.x == 0) sc.done[pl.bt * gridDim.z + blockIdx.z] = 0;
  if (blockIdx.z == 0) {
    if (z == 0 && threadIdx.x == 0) sc.count[pl.bt] = n;
    for (int i = threadIdx.x; i < min(A::kSuperRanks, n - lo); i += A::kThreads) {
      sc.slots[(long)pl.bt * S + lo + i] = slots[i];
    }
  }
  if (lo >= n) return;
  const int nc = min(A::kSuper, (n - lo + kChunk - 1) / kChunk);

  const __nv_bfloat16* kb = k + ((long)pl.b * S * KVH + pl.kvh) * D;
  float s[A::kPerWarp][8][4];
  warp_scores<D, W>(s, q + ((long)pl.bt * H + pl.h0) * D, pl.heads, buf0, slots, nc, n - lo, kb,
                    (long)KVH * D, warp, lane);
#pragma unroll
  for (int i = 0; i < A::kPerWarp; ++i) {
    const int c = warp + W * i;
    if (c < nc) {
      const int r0 = lo + c * kChunk;
      scale_scores(s[i], r0, n, scale_log2, lane);
      float2 st_lo, st_hi;
      chunk_stats(s[i], st_lo, st_hi);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = g + 8 * half;
        if (row >= pl.heads) continue;
        const long head = (long)pl.bt * H + pl.h0 + row;
        if (t == 0) sc.stats[head * NC + z * A::kSuper + c] = half ? st_hi : st_lo;
        float* srow = sc.scores + head * S;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int r = r0 + 8 * j + 2 * t + e;
            if (r < n) srow[r] = s[i][j][2 * half + e];
          }
        }
      }
    }
  }
}

// The two-kernel path, second kernel (grid as the first's): M and L of the
// block's heads from every chunk's statistics, the values of its chunks, their
// p·v summed in chunk order; the last block of the (row·T + query, KV head
// group) to finish adds the superchunks' sums in order.
template <int D>
__global__ void __launch_bounds__(Dattn<D>::kThreads, 1) decode_pv_kernel(
    const __nv_bfloat16* __restrict__ v, Scratch sc, __nv_bfloat16* __restrict__ out, int T,
    int S, int H, int KVH) {
  using A = Dattn<D>;
  constexpr int W = A::kWarps;
  extern __shared__ __align__(128) unsigned char smem[];
  float2* ml = reinterpret_cast<float2*>(smem + A::kMLOff);
  int* last = reinterpret_cast<int*>(smem + A::kCountOff);
  unsigned char* bufs = smem + A::kBufOff;
  const uint32_t buf0 = smem_u32(bufs);

  const int z = blockIdx.y, Z = gridDim.y;
  const Place pl = place(blockIdx.x, blockIdx.z, T, H, KVH);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int lo = z * A::kSuperRanks;
  const int NC = (S + kChunk - 1) / kChunk;
  const int n = sc.count[pl.bt];
  __nv_bfloat16* orow = out + ((long)pl.bt * H + pl.h0) * D;
  if (n == 0) {
    if (z == 0) {
      for (int i = threadIdx.x; i < pl.heads * D; i += A::kThreads) {
        orow[i] = __float2bfloat16(0.f);
      }
    }
    return;
  }
  if (lo >= n) return;
  const int n_chunks = (n + kChunk - 1) / kChunk;
  const int n_super = (n_chunks + A::kSuper - 1) / A::kSuper;
  const int nc = min(A::kSuper, n_chunks - z * A::kSuper);

  const long kv_stride = (long)KVH * D;
  const __nv_bfloat16* vb = v + ((long)pl.b * S * KVH + pl.kvh) * D;
  const int* gslots = sc.slots + (long)pl.bt * S + lo;
  warp_values<W>(buf0, gslots, nc, n - lo, vb, kv_stride, warp, lane);
  const long head0 = (long)pl.bt * H + pl.h0;
  heads_stats<W>(ml, pl.heads, 1, n_chunks, warp, lane,
                 [&](int h) { return sc.stats + (head0 + h) * NC; });
  __syncthreads();
  const float2 ml_lo = ml[min(g, pl.heads - 1)], ml_hi = ml[min(g + 8, pl.heads - 1)];
#pragma unroll
  for (int i = 0; i < A::kPerWarp; ++i) {
    const int c = warp + W * i;
    if (c < nc) {
      float s[8][4];
      const int r0 = lo + c * kChunk;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = g + 8 * (e / 2);
        const float* srow = sc.scores + (head0 + min(row, pl.heads - 1)) * S;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int r = r0 + 8 * j + 2 * t + (e & 1);
          s[j][e] = r < n && row < pl.heads ? srow[r] : -INFINITY;
        }
      }
      uint32_t pa[4][4];
      chunk_probs(pa, s, ml_lo, ml_hi);
      chunk_pv_all<D>(pa, bufs + c * kBufBytes, gslots + c * kChunk, n - lo - c * kChunk, vb,
                      kv_stride, lane);
    }
  }
  __syncthreads();  // every chunk's p·v

  if (n_super == 1) {
    for (int i = threadIdx.x; i < pl.heads * D; i += A::kThreads) {
      orow[i] = __float2bfloat16(fold_chunks(bufs, nc, i));
    }
    return;
  }
  for (int i = threadIdx.x; i < pl.heads * D; i += A::kThreads) {
    sc.parts[((head0 + i / D) * Z + z) * D + i % D] = fold_chunks(bufs, nc, i);
  }
  __threadfence();
  __syncthreads();
  int* done = sc.done + pl.bt * gridDim.z + blockIdx.z;
  if (threadIdx.x == 0) *last = atomicAdd(done, 1) == n_super - 1;
  __syncthreads();
  if (!*last) return;
  __threadfence();
  for (int i = threadIdx.x; i < pl.heads * D; i += A::kThreads) {
    const float* p = sc.parts + (head0 + i / D) * Z * D + i % D;
    float o = __ldcg(p);
    for (int zz = 1; zz < n_super; ++zz) o = __fadd_rn(o, __ldcg(p + (long)zz * D));
    orow[i] = __float2bfloat16(o);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* mask, void* out,
                   void* scratch, long scratch_bytes, int B, int T, int S, int H, int KVH,
                   float scale, int device, cudaStream_t st) {
  using A = Dattn<D>;
  static unsigned smem_set = 0;
  cudaError_t err = cudaSuccess;
  if (!(smem_set & (1u << device))) {
    err = cudaFuncSetAttribute(decode_attention_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, A::kSmem);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(decode_scores_kernel<D>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, A::kSmem);
    }
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(decode_pv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 A::kSmem);
    }
    if (err != cudaSuccess) return err;
    smem_set |= 1u << device;
  }
  const int groups = (H / KVH + kHeads - 1) / kHeads;
  const float scale_log2 = scale * kLog2e;
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  const auto* mp = static_cast<const uint8_t*>(mask);
  auto* op = static_cast<__nv_bfloat16*>(out);
  const size_t need = scratch_layout(B, T, S, H, KVH, D, nullptr, nullptr);
  if (need == 0) {
    if (scratch != nullptr) return cudaErrorInvalidValue;
    const int chunks = (S + kChunk - 1) / kChunk;
    const int bufs = chunks < A::kSuper ? chunks : A::kSuper;
    decode_attention_kernel<D><<<dim3(B * T, KVH * groups), A::kThreads,
                                 A::kBufOff + bufs * kBufBytes, st>>>(qp, kp, vp, mp, op, T, S, H,
                                                                       KVH, scale_log2);
    return cudaGetLastError();
  }
  if (scratch == nullptr || scratch_bytes < (long)need) return cudaErrorInvalidValue;
  Scratch sc;
  scratch_layout(B, T, S, H, KVH, D, static_cast<unsigned char*>(scratch), &sc);
  const dim3 grid(B * T, (S + A::kSuperRanks - 1) / A::kSuperRanks, KVH * groups);
  decode_scores_kernel<D><<<grid, A::kThreads, A::kSmem, st>>>(qp, kp, mp, sc, T, S, H, KVH,
                                                               scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_pv_kernel<D><<<grid, A::kThreads, A::kSmem, st>>>(vp, sc, op, T, S, H, KVH);
  return cudaGetLastError();
}

bool bad_shape(int B, int T, int S, int H, int KVH, int D) {
  return B <= 0 || T <= 0 || S <= 0 || S > kMaxSlots || H <= 0 || KVH <= 0 || H % KVH != 0 ||
         (D != 64 && D != 128);
}

}  // namespace

// The bytes of scratch a call of tst_decode_attention at this shape needs:
// 0 where it takes the one-kernel path (S at most one superchunk), -1 for a
// shape it refuses.
extern "C" long tst_decode_attention_scratch(int B, int T, int S, int H, int KVH, int D) {
  if (bad_shape(B, T, S, H, KVH, D)) return -1;
  return (long)scratch_layout(B, T, S, H, KVH, D, nullptr, nullptr);
}

// The rank plan at head dim D: ranks a chunk and ranks a superchunk (the
// one-kernel path takes caches of up to that many slots). Neither takes S or
// T. Returns 0, or cudaErrorInvalidValue for a head dim it refuses.
extern "C" int tst_decode_attention_rank_plan(int D, int* chunk, int* super_ranks) {
  if (D != 64 && D != 128) return (int)cudaErrorInvalidValue;
  *chunk = kChunk;
  *super_ranks = D == 64 ? Dattn<64>::kSuperRanks : Dattn<128>::kSuperRanks;
  return 0;
}

// q [B, T, H, D], k and v [B, S, KVH, D] (bf16, contiguous), mask [B, T, S]
// (bool as bytes) → out [B, T, H, D] bf16. S up to 27648. `scratch` (device
// bytes, tst_decode_attention_scratch of them) is null on the one-kernel
// path.
extern "C" int tst_decode_attention(const void* q, const void* k, const void* v,
                                    const void* mask, void* out, void* scratch,
                                    long scratch_bytes, int B, int T, int S, int H, int KVH,
                                    int D, float scale, int device, void* stream) {
  if (bad_shape(B, T, S, H, KVH, D) || device < 0 || device >= kMaxDevices) {
    return (int)cudaErrorInvalidValue;
  }
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err == cudaSuccess && cur != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) {
    return (int)launch<64>(q, k, v, mask, out, scratch, scratch_bytes, B, T, S, H, KVH, scale,
                           device, st);
  }
  return (int)launch<128>(q, k, v, mask, out, scratch, scratch_bytes, B, T, S, H, KVH, scale,
                          device, st);
}
