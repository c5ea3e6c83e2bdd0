// Causal GQA flash-attention backward for Hopper (sm_90a): two kernels, one
// for dK/dV and one for dQ, bf16 in and out, f32 accumulation; plain, or
// segment-masked for packed rows.
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
// kernels (kSeg) are second instantiations of the same templates; the plain
// ones compile as before.
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
// What bounds it on an H100: at the slice's shape (q [32,512,14,64], k/v
// [32,512,2,64]) the two kernels run 7 products of 64x64x64 per visited
// (query tile, key tile) pair (dkv: S^T, dV, dP^T, dK; dq: S, dP, dQ):
// 59 GFLOP over the 36 of 64 tile pairs at or below the diagonal, 60 us at
// the dense bf16 peak. Device memory must carry at least q, do, dq (29 MB
// each), k, v, dk, dv (4 MB each), lse and di: ~107 MB, 32 us at 3.35 TB/s.
// So the backward is bound by its products, and by how fast they run.
//
// What the design does about it (simple and correct first):
//   * all products on tensor cores with mma.sync m16n8k16; a product's f32
//     accumulator is re-packed into the A fragment of the next product, so P
//     and dS never leave registers;
//   * dkv: one block per (64-row KV tile, KV head, batch) loops over the G
//     query heads of its group and the query tiles at or below the diagonal,
//     keeping dK and dV in registers: no [B,H,S,D] per-head intermediate, no
//     group-sum pass, no atomics; each dk/dv row is written once;
//   * dq: one block per (64-row query tile, head, batch) loops over the KV
//     tiles up to the diagonal, dQ in registers; longest rows first;
//   * only the diagonal tile is masked, and masked entries are set to 0
//     rather than computed as exp(-inf - lse);
//   * packed rows (kSeg): dQ visits KV tiles from floor(seg_start(p0)/64)
//     up to the diagonal, as the forward does; a dK/dV block for KV tile
//     [c0, c0+64) visits query tiles from the diagonal up to the first start
//     > c0+63 (rows from there on start their segment after the whole tile),
//     or S. A tile pair is masked per element (col <= row && col >=
//     seg_start(row)) when it is diagonal or the query tile's largest start
//     lies beyond the KV tile's first column; boundaries of ~300-token
//     samples fall inside tiles, so rows of one query tile have different
//     starts. The dK/dV block keeps each query's start in shared memory
//     beside its lse and di;
//   * a warp owns 16 rows and 64 columns of D: at D=128 two warps share the
//     rows (8 warps), recomputing S and dP, so each thread holds 32 (dq) or
//     64 (dkv) accumulator floats at any D and nothing spills;
//   * tiles are staged in (dynamic) shared memory with 16-byte loads, rows
//     padded by 8 elements; operands needed k-major are staged transposed.
// Not yet: wgmma, TMA, double buffering, bank-conflict-free transposes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "seg_starts.cuh"

namespace {

constexpr int kTile = 64;  // rows of a query tile and of a KV tile
constexpr int kPad = 8;    // bf16 elements of padding per shared-memory row
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Geometry {
  static_assert(D % 64 == 0, "head dim must be a multiple of 64");
  static constexpr int kSplit = D / 64;            // warps sharing 16 rows
  static constexpr int kThreads = 32 * 4 * kSplit;
  static constexpr int kRow = D + kPad;            // row-major [64][D] tile stride
  static constexpr int kCol = kTile + kPad;        // transposed [D][64] tile stride
  static constexpr int kRowTile = kTile * kRow;    // elements of a row-major tile
  static constexpr int kColTile = D * kCol;        // elements of a transposed tile
};

// Stage rows [0, 64) of a bf16 matrix (row stride `stride` elements, D used
// columns) into shared memory, row-major into `dst` and/or transposed into
// `dst_t` (either may be null).
template <int D>
__device__ __forceinline__ void stage_tile(const __nv_bfloat16* src, long stride,
                                           __nv_bfloat16* dst, __nv_bfloat16* dst_t) {
  using G = Geometry<D>;
  for (int i = threadIdx.x; i < kTile * D / 8; i += G::kThreads) {
    const int r = i / (D / 8);
    const int c = (i % (D / 8)) * 8;
    const uint4 val = *reinterpret_cast<const uint4*>(src + (long)r * stride + c);
    if (dst != nullptr) *reinterpret_cast<uint4*>(dst + r * G::kRow + c) = val;
    if (dst_t != nullptr) {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int j = 0; j < 8; ++j) dst_t[(c + j) * G::kCol + r] = e[j];
    }
  }
}

// c (16 x 64: eight 16x8 C tiles) = A[row0 .. row0+16, :D] · B[0 .. 64, :D]^T,
// A and B row-major [.][kRow] tiles in shared memory.
template <int D>
__device__ __forceinline__ void gemm_abt(float (&c)[8][4], const __nv_bfloat16* a_s,
                                         const __nv_bfloat16* b_s, int row0, int g, int t) {
  using G = Geometry<D>;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) c[nt][0] = c[nt][1] = c[nt][2] = c[nt][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const __nv_bfloat16* ar = a_s + (row0 + g) * G::kRow + kk * 16 + 2 * t;
    const uint32_t a[4] = {load_u32(ar), load_u32(ar + 8 * G::kRow), load_u32(ar + 8),
                           load_u32(ar + 8 * G::kRow + 8)};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const __nv_bfloat16* br = b_s + (nt * 8 + g) * G::kRow + kk * 16 + 2 * t;
      mma_16816(c[nt], a, load_u32(br), load_u32(br + 8));
    }
  }
}

// acc (16 x 64: columns d0 .. d0+64 of D) += X · B[0 .. 64, d0 .. d0+64), where
// X (16 x 64) is the f32 C fragments `x` of a gemm_abt, rounded to bf16 here,
// and B is staged transposed: bt_s[d][row], stride kCol.
template <int D>
__device__ __forceinline__ void gemm_xb(float (&acc)[8][4], const float (&x)[8][4],
                                        const __nv_bfloat16* bt_s, int d0, int g, int t) {
  using G = Geometry<D>;
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk) {
    const uint32_t xa[4] = {pack_bf16(x[2 * kk][0], x[2 * kk][1]),
                            pack_bf16(x[2 * kk][2], x[2 * kk][3]),
                            pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]),
                            pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3])};
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) {
      const __nv_bfloat16* br = bt_s + (d0 + dt * 8 + g) * G::kCol + kk * 16 + 2 * t;
      mma_16816(acc[dt], xa, load_u32(br), load_u32(br + 8));
    }
  }
}

// write this warp's 16 x 64 block of f32 accumulators as bf16 rows `row_lo`
// and `row_lo + 8` (pointers to column d0 of each row)
__device__ __forceinline__ void store_rows(const float (&acc)[8][4], __nv_bfloat16* lo,
                                           __nv_bfloat16* hi, int t) {
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) {
    const int c = dt * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(lo + c) = pack_bf16(acc[dt][0], acc[dt][1]);
    *reinterpret_cast<uint32_t*>(hi + c) = pack_bf16(acc[dt][2], acc[dt][3]);
  }
}

// dK, dV: one block per (KV tile, KV head, batch). Warp w owns KV rows
// (w % 4)·16 .. +16 of the tile and columns (w / 4)·64 .. +64 of D. `seg`
// (int32 [B, kMaxSegs]) is read only when kSeg.
template <int D, bool kSeg>
__global__ void __launch_bounds__(Geometry<D>::kThreads)
flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ di,
                     const int* __restrict__ seg, __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int S, int H, int KVH, float scale) {
  using G = Geometry<D>;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem);  // K[key][d]
  __nv_bfloat16* v_s = k_s + G::kRowTile;                        // V[key][d]
  __nv_bfloat16* q_s = v_s + G::kRowTile;                        // Q[query][d]
  __nv_bfloat16* do_s = q_s + G::kRowTile;                       // dO[query][d]
  __nv_bfloat16* qt_s = do_s + G::kRowTile;                      // Q[d][query]
  __nv_bfloat16* dot_s = qt_s + G::kColTile;                     // dO[d][query]
  float* lse_s = reinterpret_cast<float*>(dot_s + G::kColTile);  // log2 units
  float* di_s = lse_s + kTile;
  int* st_s = reinterpret_cast<int*>(di_s + kTile);  // segment starts (kSeg)

  const int kv_tile = blockIdx.x;  // tile 0 has the most query tiles: launched first
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int groups = H / KVH;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int wrow = (warp % 4) * 16;  // this warp's first KV row in the tile
  const int d0 = (warp / 4) * 64;    // this warp's first column of D
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

  const long q_stride = (long)H * D;
  const long kv_stride = (long)KVH * D;
  const long kv_off = ((long)b * S + (long)kv_tile * kTile) * kv_stride + (long)kvh * D;
  stage_tile<D>(k + kv_off, kv_stride, k_s, nullptr);
  stage_tile<D>(v + kv_off, kv_stride, v_s, nullptr);

  float acc_dk[8][4], acc_dv[8][4];
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dk[dt][e] = acc_dv[dt][e] = 0.f;
  }

  for (int hg = 0; hg < groups; ++hg) {
    const int h = kvh * groups + hg;
    for (int q_tile = kv_tile; q_tile < q_end; ++q_tile) {
      const int q0 = q_tile * kTile;
      __syncthreads();  // every warp is done with the previous query tile
      const long q_off = ((long)b * S + q0) * q_stride + (long)h * D;
      stage_tile<D>(q + q_off, q_stride, q_s, qt_s);
      stage_tile<D>(dout + q_off, q_stride, do_s, dot_s);
      for (int i = threadIdx.x; i < kTile; i += G::kThreads) {
        const long r = ((long)b * H + h) * S + q0 + i;
        lse_s[i] = lse[r] * kLog2e;
        di_s[i] = di[r];
        if constexpr (kSeg) st_s[i] = seg_start(sb, q0 + i);
      }
      __syncthreads();

      // P^T: this warp's 16 keys x the tile's 64 queries
      float p[8][4];
      gemm_abt<D>(p, k_s, q_s, wrow, g, t);
      const bool diag = q_tile == kv_tile;
      // packed: masked per element when a query's segment starts after kv0
      const bool masked = kSeg ? diag || st_s[kTile - 1] > kv0 : diag;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = nt * 8 + 2 * t + (e & 1);     // query within the tile
          const int row = wrow + g + (e >= 2 ? 8 : 0);  // key within the tile
          bool off;
          if constexpr (kSeg) {
            off = masked && (kv0 + row > q0 + col || kv0 + row < st_s[col]);
          } else {
            off = masked && col < row;
          }
          p[nt][e] = off ? 0.f : exp2f(p[nt][e] * scale_log2 - lse_s[col]);
        }
      }
      gemm_xb<D>(acc_dv, p, dot_s, d0, g, t);  // dV += P^T dO

      float dpt[8][4];
      gemm_abt<D>(dpt, v_s, do_s, wrow, g, t);  // dP^T = V dO^T
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = nt * 8 + 2 * t + (e & 1);
          p[nt][e] = p[nt][e] * (dpt[nt][e] - di_s[col]) * scale;  // scale·dS^T
        }
      }
      gemm_xb<D>(acc_dk, p, qt_s, d0, g, t);  // dK += scale·dS^T Q
    }
  }

  const long r_lo = ((long)b * S + (long)kv_tile * kTile + wrow + g) * kv_stride + kvh * D + d0;
  const long r_hi = r_lo + 8 * kv_stride;
  store_rows(acc_dk, dk + r_lo, dk + r_hi, t);
  store_rows(acc_dv, dv + r_lo, dv + r_hi, t);
}

// dQ: one block per (query tile, head, batch). Warp w owns query rows
// (w % 4)·16 .. +16 of the tile and columns (w / 4)·64 .. +64 of D. `seg`
// (int32 [B, kMaxSegs]) is read only when kSeg.
template <int D, bool kSeg>
__global__ void __launch_bounds__(Geometry<D>::kThreads)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ di,
                    const int* __restrict__ seg, __nv_bfloat16* __restrict__ dq, int S, int H,
                    int KVH, float scale) {
  using G = Geometry<D>;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem);  // Q[query][d]
  __nv_bfloat16* do_s = q_s + G::kRowTile;                       // dO[query][d]
  __nv_bfloat16* k_s = do_s + G::kRowTile;                       // K[key][d]
  __nv_bfloat16* v_s = k_s + G::kRowTile;                        // V[key][d]
  __nv_bfloat16* kt_s = v_s + G::kRowTile;                       // K[d][key]

  const int q_tile = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int wrow = (warp % 4) * 16;  // this warp's first query row in the tile
  const int d0 = (warp / 4) * 64;    // this warp's first column of D
  const float scale_log2 = scale * kLog2e;

  const long q_stride = (long)H * D;
  const long kv_stride = (long)KVH * D;
  const long q_off = ((long)b * S + (long)q_tile * kTile) * q_stride + (long)h * D;
  stage_tile<D>(q + q_off, q_stride, q_s, nullptr);
  stage_tile<D>(dout + q_off, q_stride, do_s, nullptr);
  const int row_lo = q_tile * kTile + wrow + g;  // sequence position of c0/c1
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

  float acc[8][4];
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

  for (int kv_tile = kv_first; kv_tile <= q_tile; ++kv_tile) {
    __syncthreads();  // every warp is done with the previous KV tile
    const long kv_off = ((long)b * S + (long)kv_tile * kTile) * kv_stride + (long)kvh * D;
    stage_tile<D>(k + kv_off, kv_stride, k_s, kt_s);
    stage_tile<D>(v + kv_off, kv_stride, v_s, nullptr);
    __syncthreads();

    float s[8][4], dp[8][4];
    gemm_abt<D>(s, q_s, k_s, wrow, g, t);    // S = Q K^T
    gemm_abt<D>(dp, do_s, v_s, wrow, g, t);  // dP = dO V^T
    const bool diag = kv_tile == q_tile;
    const bool masked = kSeg ? diag || kv_tile * kTile < st_max : diag;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * t + (e & 1);     // key within the tile
        const int row = wrow + g + (e >= 2 ? 8 : 0);  // query within the tile
        bool off;
        if constexpr (kSeg) {
          const int key = kv_tile * kTile + col;
          off = masked && (key > row_lo + (e >= 2 ? 8 : 0) || key < (e >= 2 ? st_hi : st_lo));
        } else {
          off = masked && col > row;
        }
        const float p =
            off ? 0.f : exp2f(s[nt][e] * scale_log2 - (e >= 2 ? lse_hi : lse_lo));
        s[nt][e] = p * (dp[nt][e] - (e >= 2 ? di_hi : di_lo)) * scale;  // scale·dS
      }
    }
    gemm_xb<D>(acc, s, kt_s, d0, g, t);  // dQ += scale·dS K
  }

  __nv_bfloat16* lo = dq + ((long)b * S + row_lo) * q_stride + (long)h * D + d0;
  store_rows(acc, lo, lo + 8 * q_stride, t);
}

template <int D, bool kSeg>
constexpr int dkv_smem_bytes() {
  return (4 * Geometry<D>::kRowTile + 2 * Geometry<D>::kColTile) * 2 + (kSeg ? 3 : 2) * kTile * 4;
}

template <int D>
constexpr int dq_smem_bytes() {
  return (4 * Geometry<D>::kRowTile + Geometry<D>::kColTile) * 2;
}

template <int D, bool kSeg>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* di, const void* seg, void* dk, void* dv,
                       int B, int S, int H, int KVH, float scale, cudaStream_t st) {
  constexpr int smem = dkv_smem_bytes<D, kSeg>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<D, kSeg>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_kernel<D, kSeg><<<dim3(S / kTile, KVH, B), Geometry<D>::kThreads, smem, st>>>(
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
  constexpr int smem = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D, kSeg>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<D, kSeg><<<dim3(S / kTile, H, B), Geometry<D>::kThreads, smem, st>>>(
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
