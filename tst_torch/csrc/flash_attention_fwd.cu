// Causal GQA flash-attention forward for Hopper (sm_90a), bf16 in, bf16 out
// plus an f32 logsumexp; plain, or segment-masked for packed rows.
//
// Replaces the TPU kernels `_fwd_kernel_oneshot` (tst/kernels/flash_attention.py:99,
// whole KV in one tile) and `_fwd_kernel` (tst/kernels/flash_attention.py:274,
// tiled online softmax with above-diagonal tiles skipped), both with and
// without their `has_seg` branch (:108, :276), and the segment-sparse
// `_fwd_kernel_oneshot_chunked` (:464, via :346) that the TPU dispatches for
// packed rows at S >= 2048. One kernel covers all of these: the TPU's
// one-shot/tiled/chunked split and its folded `pos_mod` view are VMEM
// schedules, not semantics. The segmented instance (kSeg) is a second
// instantiation of the same template; the plain one compiles as before.
//
// Semantics (the reference's, not its block layout):
//   o[b, i, h, :] = sum_j softmax_j(q[b,i,h]·k[b,j,h/G] / sqrt(D), j <= i) v[b,j,h/G]
//   lse[b, h, i]  = logsumexp_j of the same scaled, masked logits (f32)
// with packed rows (kSeg) the softmax runs over seg_start(i) <= j <= i only
// (seg_starts.cuh).
// q [B,S,H,D], k/v [B,S,KVH,D] contiguous in the model layout, read in place
// with strides; query head h reads KV head h / (H/KVH) (heads are KV-major).
// Logits accumulate in f32 and are scaled by 1/sqrt(D) in f32; the running
// max starts at a finite large negative value, so exp(-inf - -inf) never
// appears; probabilities are rounded to bf16 before the P·V product, which
// accumulates in f32, as the reference does.
//
// What bounds it on an H100: a 64-row query tile reads up to 2·S·D bf16 of
// K and V (4·S·D bytes) for 4·64·S·D FLOPs of the two products: 64 FLOPs
// per byte, far below the card's ~295 if K and V came from device memory
// each time. They do not: one KV head's K and V (128 KB at S=512, D=64)
// are read by every query tile of every query head in its group, so they
// are served from L2. Over a whole call at the slice's shape (B=32, S=512,
// H=14, KVH=2, D=64) device memory must carry at least ~68 MB (q and o
// dominate) against 15.1 GFLOP of causal work: ~221 FLOPs per byte, so the
// byte and tensor-core bounds are close, and the kernel is compute-bound
// once its products run on tensor cores at full issue rate.
//
// What the design does about it (simple and correct first):
//   * one block of 4 warps per (64-row query tile, head, batch); each warp
//     owns 16 query rows, kept as mma.sync A fragments in registers;
//   * both products run on tensor cores with mma.sync m16n8k16 (bf16 in,
//     f32 accumulate); P never leaves registers: the f32 S accumulator is
//     re-packed into the A fragment of the P·V product;
//   * K (row-major) and V (transposed) tiles of 64 rows are staged in shared
//     memory with 16-byte loads; rows are padded by 8 elements so the
//     fragment reads are free of bank conflicts;
//   * online softmax in registers; the KV loop stops at the diagonal tile,
//     so tiles above it are never read, and only the diagonal tile is masked;
//   * query tiles are issued longest-row first to even out the causal load.
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
// Not yet: wgmma, TMA, warp specialisation, double buffering.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "seg_starts.cuh"

namespace {

constexpr int kBlockM = 64;   // query rows per block
constexpr int kBlockN = 64;   // key rows per KV tile
constexpr int kWarps = 4;     // 16 query rows per warp
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;       // bf16 elements of padding per shared-memory row
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
// finite start of the running max (the reference's DEFAULT_MASK_VALUE)
constexpr float kMaxInit = -0.7f * 3.4028234663852886e38f;

// mma_16816, pack_bf16, load_u32 and the fragment layout: mma_bf16.cuh;
// seg_start and the packed-row semantics: seg_starts.cuh (`seg` is read only
// when kSeg)
template <int D, bool kSeg>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, const int* __restrict__ seg,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int S, int H, int KVH,
                 float scale_log2) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  __shared__ __align__(16) __nv_bfloat16 k_s[kBlockN][D + kPad];    // K[key][d]
  __shared__ __align__(16) __nv_bfloat16 vt_s[D][kBlockN + kPad];   // V[key][d] transposed

  const int q_tile = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;

  const long q_stride = (long)H * D;    // elements between consecutive positions
  const long kv_stride = (long)KVH * D;
  const __nv_bfloat16* q_base = q + (long)b * S * q_stride + (long)h * D;
  const __nv_bfloat16* k_base = k + (long)b * S * kv_stride + (long)kvh * D;
  const __nv_bfloat16* v_base = v + (long)b * S * kv_stride + (long)kvh * D;
  const int wrow = warp * 16;                 // this warp's first row in the tile
  const int row_lo = q_tile * kBlockM + wrow + g;  // sequence position of c0/c1
  const int row_hi = row_lo + 8;                   // sequence position of c2/c3
  // packed rows: the segment starts of rows row_lo and row_hi, the first KV
  // tile the query tile needs, and its largest start (KV tiles that begin
  // below it are masked per element)
  int st_lo = 0, st_hi = 0, kv_first = 0, st_max = 0;
  if constexpr (kSeg) {
    const int* sb = seg + (long)b * kMaxSegs;
    st_lo = seg_start(sb, row_lo);
    st_hi = seg_start(sb, row_hi);
    kv_first = seg_start(sb, q_tile * kBlockM) / kBlockN;
    st_max = seg_start(sb, q_tile * kBlockM + kBlockM - 1);
  }

  // Q fragments for all of D, loaded once from device memory
  uint32_t qa[D / 16][4];
  {
    const __nv_bfloat16* r_lo = q_base + (long)row_lo * q_stride;
    const __nv_bfloat16* r_hi = q_base + (long)row_hi * q_stride;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk * 16 + 2 * t;
      qa[kk][0] = load_u32(r_lo + c);
      qa[kk][1] = load_u32(r_hi + c);
      qa[kk][2] = load_u32(r_lo + c + 8);
      qa[kk][3] = load_u32(r_hi + c + 8);
    }
  }

  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  }
  // running max (log2 units) and this thread's partial row sums, rows g and g+8
  float m_lo = kMaxInit, m_hi = kMaxInit;
  float l_lo = 0.f, l_hi = 0.f;

  for (int kv_tile = kv_first; kv_tile <= q_tile; ++kv_tile) {
    const int kv0 = kv_tile * kBlockN;
    __syncthreads();  // every warp is done with the previous tile
    for (int i = threadIdx.x; i < kBlockN * D / 8; i += kThreads) {
      const int r = i / (D / 8);
      const int c = (i % (D / 8)) * 8;
      const long off = (long)(kv0 + r) * kv_stride + c;
      *reinterpret_cast<uint4*>(&k_s[r][c]) = *reinterpret_cast<const uint4*>(k_base + off);
      const uint4 vv = *reinterpret_cast<const uint4*>(v_base + off);
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int j = 0; j < 8; ++j) vt_s[c + j][r] = ve[j];
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys
    float s[kBlockN / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int nt = 0; nt < kBlockN / 8; ++nt) {
        const __nv_bfloat16* kr = &k_s[nt * 8 + g][kk * 16 + 2 * t];
        mma_16816(s[nt], qa[kk], load_u32(kr), load_u32(kr + 8));
      }
    }

    // scale (log2 units), mask the diagonal tile (and, packed, every tile
    // that starts below a row's segment), row max over the 4 lanes of a row
    const bool diag = kv_tile == q_tile;
    const bool masked = kSeg ? diag || kv0 < st_max : diag;
    float mx_lo = kMaxInit, mx_hi = kMaxInit;
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * scale_log2;
        if (masked) {
          if constexpr (kSeg) {
            const int col = kv0 + nt * 8 + 2 * t + (e & 1);
            const bool hi = e >= 2;
            if (col > (hi ? row_hi : row_lo) || col < (hi ? st_hi : st_lo)) x = -INFINITY;
          } else {
            const int col = nt * 8 + 2 * t + (e & 1);
            const int row = wrow + g + (e >= 2 ? 8 : 0);
            if (col > row) x = -INFINITY;
          }
        }
        s[nt][e] = x;
      }
      mx_lo = fmaxf(mx_lo, fmaxf(s[nt][0], s[nt][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[nt][2], s[nt][3]));
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
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
      s[nt][0] = exp2f(s[nt][0] - mn_lo);
      s[nt][1] = exp2f(s[nt][1] - mn_lo);
      s[nt][2] = exp2f(s[nt][2] - mn_hi);
      s[nt][3] = exp2f(s[nt][3] - mn_hi);
      sum_lo += s[nt][0] + s[nt][1];
      sum_hi += s[nt][2] + s[nt][3];
    }
    l_lo = l_lo * corr_lo + sum_lo;
    l_hi = l_hi * corr_hi + sum_hi;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      acc[dt][0] *= corr_lo;
      acc[dt][1] *= corr_lo;
      acc[dt][2] *= corr_hi;
      acc[dt][3] *= corr_hi;
    }

    // O += P V, P re-packed from the S accumulator into A fragments
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]), pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const __nv_bfloat16* vr = &vt_s[dt * 8 + g][kk * 16 + 2 * t];
        mma_16816(acc[dt], pa, load_u32(vr), load_u32(vr + 8));
      }
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  __nv_bfloat16* o_lo = o + ((long)b * S + row_lo) * q_stride + (long)h * D;
  __nv_bfloat16* o_hi = o + ((long)b * S + row_hi) * q_stride + (long)h * D;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int c = dt * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(o_lo + c) = pack_bf16(acc[dt][0] / l_lo, acc[dt][1] / l_lo);
    *reinterpret_cast<uint32_t*>(o_hi + c) = pack_bf16(acc[dt][2] / l_hi, acc[dt][3] / l_hi);
  }
  if (t == 0) {
    float* lse_bh = lse + ((long)b * H + h) * S;
    lse_bh[row_lo] = (m_lo + log2f(l_lo)) * kLn2;
    lse_bh[row_hi] = (m_hi + log2f(l_hi)) * kLn2;
  }
}

template <bool kSeg>
int launch_fwd(const void* q, const void* k, const void* v, const void* seg, void* o, void* lse,
               int B, int S, int H, int KVH, int D, float scale, int device, void* stream) {
  if (B <= 0 || S <= 0 || S % kBlockM != 0 || KVH <= 0 || H % KVH != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(S / kBlockM, H, B);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float scale_log2 = scale * kLog2e;
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const __nv_bfloat16*>(k);
  const auto* vb = static_cast<const __nv_bfloat16*>(v);
  const auto* sb = static_cast<const int*>(seg);
  auto* ob = static_cast<__nv_bfloat16*>(o);
  auto* lb = static_cast<float*>(lse);
  if (D == 64) {
    flash_fwd_kernel<64, kSeg><<<grid, kThreads, 0, st>>>(qb, kb, vb, sb, ob, lb, S, H, KVH,
                                                          scale_log2);
  } else if (D == 128) {
    flash_fwd_kernel<128, kSeg><<<grid, kThreads, 0, st>>>(qb, kb, vb, sb, ob, lb, S, H, KVH,
                                                           scale_log2);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entries for ctypes. Pointers are device pointers of contiguous
// tensors (seg: int32 [B, kMaxSegs]); `stream` is a cudaStream_t. Each
// returns the launch's cudaError_t.
extern "C" int tst_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                       void* lse, int B, int S, int H, int KVH, int D,
                                       float scale, int device, void* stream) {
  return launch_fwd<false>(q, k, v, nullptr, o, lse, B, S, H, KVH, D, scale, device, stream);
}

extern "C" int tst_flash_attention_fwd_seg(const void* q, const void* k, const void* v,
                                           const void* seg, void* o, void* lse, int B, int S,
                                           int H, int KVH, int D, float scale, int device,
                                           void* stream) {
  if (seg == nullptr) return (int)cudaErrorInvalidValue;
  return launch_fwd<true>(q, k, v, seg, o, lse, B, S, H, KVH, D, scale, device, stream);
}
