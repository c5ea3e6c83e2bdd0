// Packed-int4 dequant-matmul for Hopper (sm_90a): out[M, N] (f32) =
// y[M, K] (bf16) @ dequant(q[layer], scale[layer]), the layer indexed in place,
// in one launch.
//
// Replaces the TPU kernels `_kernel` / `_kernel_pipe`
// (tst/kernels/quant_matmul.py:64, :87, via `int4_matmul_stacked` :159). Layout
// (tst.models.quant): q int8 [L, K, N/2], column j in the low nibble stored
// biased +8, column j + N/2 in the high nibble, signed; scale f32
// [L, K/128, 1, N], one scale per 128-row group and column. The weight is
// dequantized as the plain version does it: nibble · scale in f32, rounded to
// bf16 (y's dtype); the product accumulates in f32.
//
// What bounds it on an H100: decode's M is small (the chunk's rows times the
// fold count, <= 64 here), so each weight byte feeds at most 2·64 products
// and the kernel is bound by reading the packed weight (0.5 byte a weight):
// a layer's seven projections of Qwen2.5-0.5B are 6.7 MB, 2 µs at 3.35 TB/s,
// 0.06-2.2 MB a call. At that size a call is a latency problem: the bytes have
// to be in flight at once, over enough SMs, in one launch. Why the stack is
// indexed in place: slicing q[layer] out of the [L, K, N/2] stack would copy
// it first (the reason for the TPU kernel's scalar prefetch, :9-18); here the
// layer is a pointer offset.
//
// What the design does about it:
//   * one launch a call. A block (CTA) owns 64 packed columns (128 output
//     columns: 64 low, 64 high), up to 64 rows of y, and a range of 128-row
//     K groups; K is split over the CTAs of a thread-block cluster (up to 8;
//     the caller's split plan aims at about one CTA an SM), so narrow leaves
//     still spread over many SMs;
//   * a cp.async ring of groups (packed bytes, y, the group's 128 scales): 2
//     stages where a CTA has at most two groups, else 4 in flight;
//   * 4 warps: two column halves x two K halves of each group; a warp's B
//     fragments come from one ldmatrix.x4.trans a k16 step (16 rows x 32
//     packed bytes: the rows 2t, 2t+1 of packed columns 2g and 2g+1 in one
//     register), unpacked with integer ops (nibble | 0x4B000000 read as a
//     float is 2^23 + nibble, exactly) into 8 output n8 tiles; A fragments by
//     ldmatrix.x4; products are mma.sync m16n8k16 (bf16 in, f32 accumulate):
//     at M <= 64 wgmma's m64 would mostly multiply padding;
//   * the reduction, in one fixed order, with no atomics, no workspace and no
//     second kernel: the two K halves are summed in shared memory; then row r
//     of the tile belongs to the CTA of split r % splits, and every CTA
//     writes its partial of that row straight into the owner's shared memory
//     (distributed shared memory), so one cluster barrier separates the
//     writes from the owner's sum, which runs over the splits in order (an
//     earlier barrier phase, arrived at on entry and waited for just before
//     the writes, makes sure every CTA of the cluster has started).
// Measured and not kept (PERF.md §6): each CTA reading the others' partials
// after a cluster barrier (two barriers, remote loads on the critical path:
// slower); 8 warps a CTA (K quarters; one CTA an SM at 228 registers,
// slower); clusters of 7 where 4 do (they pack the GPCs worse).
// Not yet: TMA bulk copies, fewer registers at M = 64 (16 bytes spill), a
// CUDA graph over the decode step's launches.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_sm90.cuh"  // cp.async; mma_bf16.cuh: mma.sync, ldmatrix

namespace cg = cooperative_groups;

namespace {

constexpr int kGroup = 128;           // K rows per scale group = per ring stage
constexpr int kBNH = 64;              // packed columns per CTA
constexpr int kBM = 64;               // rows of y per CTA (4 m16 tiles at most)
constexpr int kThreads = 128;         // 4 warps: 2 column halves x 2 K halves
constexpr int kMaxSplits = 8;         // CTAs of a cluster (the portable maximum)
constexpr int kQPitch = kBNH + 16;    // bytes per packed row: ldmatrix rows on distinct banks
constexpr int kYPitch = kGroup + 8;   // bf16 per y row
constexpr int kRedPitch = 2 * kBNH + 4;  // f32 per row of the K-half partial (128 columns)
constexpr int kMaxDevices = 32;

// shared memory of a CTA: a ring of S stages, then the inbox where the
// cluster's CTAs put their partials of the rows this CTA sums
template <int MT, int S>
struct Smem {
  static constexpr int kQBytes = kGroup * kQPitch;
  static constexpr int kYBytes = 16 * MT * kYPitch * 2;
  static constexpr int kStageBytes = kQBytes + kYBytes + 2 * kBNH * 4;  // + the scales
  static constexpr int kRing = S * kStageBytes;
  // the second K half's partial, over the ring's space after the main loop
  static_assert(16 * MT * kRedPitch * 4 <= kRing, "the K-half partial must fit in the ring");
  // [splits][ceil(16·MT / splits) rows][128] f32 for any splits <= kMaxSplits
  static constexpr int kInbox = (16 * MT + kMaxSplits) * 2 * kBNH * 4;
  static constexpr int kBytes = kRing + kInbox;
};

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the value of byte `b` (0..3) of `nibs`, each byte a biased nibble 0..15,
// minus the bias 8: 0x4B0000nn read as an f32 is exactly 2^23 + nn
__device__ __forceinline__ float unbias(uint32_t nibs, int b) {
  return __int_as_float(__byte_perm(nibs, 0x4B000000u, 0x7440u | b)) - 8388616.f;
}

// two rows of a B fragment from one register of biased nibbles: bytes `odd`
// and 2 + `odd` (rows 2t and 2t + 1 of packed column 2g + odd), each times
// its column's scale in f32, rounded to bf16 as the plain version does
__device__ __forceinline__ uint32_t dequant2(uint32_t nibs, int odd, float scale) {
  return pack_bf16(unbias(nibs, odd) * scale, unbias(nibs, 2 + odd) * scale);
}

template <int MT, int S>
__global__ void __launch_bounds__(kThreads)
int4_matmul_kernel(const __nv_bfloat16* __restrict__ y, const int8_t* __restrict__ q,
                   const float* __restrict__ scale, float* __restrict__ out, int M, int K,
                   int NH) {
  using R = Smem<MT, S>;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t ring = smem_u32(smem);
  float4* inbox = reinterpret_cast<float4*>(smem + R::kRing);
  cg::cluster_group cluster = cg::this_cluster();
  cluster_arrive_relaxed();  // this CTA has started: its inbox may be written once all have

  const int N = 2 * NH;
  const int j0 = blockIdx.x * kBNH;
  const int splits = gridDim.y;  // = the cluster's size: one cluster spans the K splits
  const int split = blockIdx.y;
  const int m0 = blockIdx.z * kBM;
  const int n_groups = K / kGroup;
  const int per_split = (n_groups + splits - 1) / splits;
  const int c_begin = split * per_split;
  const int n_mine = max(0, min(n_groups, c_begin + per_split) - c_begin);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int ch = warp % 2;  // packed columns 32·ch .. 32·ch + 31 of the CTA's 64
  const int kh = warp / 2;  // rows 64·kh .. 64·kh + 63 of every group

  // group c_begin + i into ring stage i % S: packed bytes [128][64],
  // y [16·MT rows][128] (zero past M), then the 64 low and 64 high scales
  auto load = [&](int i) {
    const int c = c_begin + i;
    const uint32_t st = ring + (i % S) * R::kStageBytes;
    for (int v = tid; v < kGroup * (kBNH / 16); v += kThreads) {
      const int r = v / (kBNH / 16), col = (v % (kBNH / 16)) * 16;
      cp_async16(st + r * kQPitch + col, q + (long)(c * kGroup + r) * NH + j0 + col);
    }
    const uint32_t ys = st + R::kQBytes;
    for (int v = tid; v < 16 * MT * (kGroup / 8); v += kThreads) {
      const int r = v / (kGroup / 8), col = (v % (kGroup / 8)) * 8;
      const bool ok = m0 + r < M;
      cp_async16_zfill(ys + (r * kYPitch + col) * 2,
                       y + (long)(ok ? m0 + r : 0) * K + c * kGroup + col, ok);
    }
    if (tid < 2 * kBNH / 4) {
      const int half = tid / (kBNH / 4), col = (tid % (kBNH / 4)) * 4;
      cp_async16(ys + R::kYBytes + (half * kBNH + col) * 4,
                 scale + (long)c * N + half * NH + j0 + col);
    }
  };

  // acc[mt][tile]: tile = 4·hb + 2·odd + hi, the n8 tile of packed columns
  // 32·ch + 16·hb + 2ν + odd (ν < 8), low (hi = 0) or high nibbles
  float acc[MT][8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[mt][i][0] = acc[mt][i][1] = acc[mt][i][2] = acc[mt][i][3] = 0.f;

#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < n_mine) load(s);
    cp_async_commit();
  }
  // this lane's ldmatrix rows: B (16 k rows x 32 packed bytes), A (16 y rows)
  const int b_row = (lane % 8) + 8 * ((lane / 8) % 2), b_col = 32 * ch + 16 * (lane / 16);
  const int a_row = lane % 16, a_col = 8 * (lane / 16);
  for (int i = 0; i < n_mine; ++i) {
    cp_async_wait<S - 2>();  // group i has landed (this thread's copies)
    __syncthreads();         // everyone's; every warp is done with group i - 1
    if (i + S - 1 < n_mine) load(i + S - 1);
    cp_async_commit();

    const uint32_t st = ring + (i % S) * R::kStageBytes;
    const uint32_t ys = st + R::kQBytes;
    const float* sc = reinterpret_cast<const float*>(smem + (i % S) * R::kStageBytes +
                                                     R::kQBytes + R::kYBytes);
    float s_lo[4], s_hi[4];  // [2·hb + odd]: packed column 32·ch + 16·hb + 2g + odd
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int col = 32 * ch + 16 * (p / 2) + 2 * g + p % 2;
      s_lo[p] = sc[col];
      s_hi[p] = sc[kBNH + col];
    }
#pragma unroll
    for (int kq = 0; kq < 4; ++kq) {
      const int kk = 4 * kh + kq;
      // r[2·hb] rows 2t, 2t+1 and r[2·hb + 1] rows 2t+8, 2t+9 of packed bytes
      // 2g, 2g+1 of byte half hb; a register holds (row 2t: byte 2g, 2g+1;
      // row 2t+1: byte 2g, 2g+1) low to high
      uint32_t r[4];
      ldmatrix_x4_trans(r, st + (16 * kk + b_row) * kQPitch + b_col);
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        ldmatrix_x4(a[mt], ys + ((16 * mt + a_row) * kYPitch + 16 * kk + a_col) * 2);
      }
#pragma unroll
      for (int hb = 0; hb < 2; ++hb) {
        const uint32_t lo[2] = {r[2 * hb] & 0x0F0F0F0Fu, r[2 * hb + 1] & 0x0F0F0F0Fu};
        const uint32_t hi[2] = {((r[2 * hb] >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u,
                                ((r[2 * hb + 1] >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u};
#pragma unroll
        for (int odd = 0; odd < 2; ++odd) {
          const int p = 2 * hb + odd;
          // B rows 2t, 2t+1 from the first register, 2t+8, 2t+9 from the second
          const uint32_t blo0 = dequant2(lo[0], odd, s_lo[p]), blo1 = dequant2(lo[1], odd, s_lo[p]);
          const uint32_t bhi0 = dequant2(hi[0], odd, s_hi[p]), bhi1 = dequant2(hi[1], odd, s_hi[p]);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_16816(acc[mt][2 * p], a[mt], blo0, blo1);
            mma_16816(acc[mt][2 * p + 1], a[mt], bhi0, bhi1);
          }
        }
      }
    }
  }

  // the K halves: warps kh = 1 leave their partials in the (now free) ring,
  // warps kh = 0 add them to their own, in that order
  cp_async_wait<0>();
  __syncthreads();
  float* half = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    if (kh == 1 - pass) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          // tile i's columns: 64·hi + 32·ch + 16·hb + 2ν + odd (i = 4·hb + 2·odd + hi)
          const int c = 64 * (i % 2) + 32 * ch + 16 * (i / 4) + 4 * t + (i / 2) % 2;
          float* p = half + (16 * mt + g) * kRedPitch + c;
          if (pass == 0) {
            p[0] = acc[mt][i][0];
            p[2] = acc[mt][i][1];
            p[8 * kRedPitch] = acc[mt][i][2];
            p[8 * kRedPitch + 2] = acc[mt][i][3];
          } else {
            acc[mt][i][0] += p[0];
            acc[mt][i][1] += p[2];
            acc[mt][i][2] += p[8 * kRedPitch];
            acc[mt][i][3] += p[8 * kRedPitch + 2];
          }
        }
      }
    }
    if (pass == 0) __syncthreads();
  }
  // row r of the tile is summed by the CTA of split r % splits: warps kh = 0
  // put their rows' partials into its inbox, slot [split][r / splits]; the
  // lane's columns 4t .. 4t + 3 of each 16-column run are (even c0, odd c0,
  // even c1, odd c1)
  const int rows = min(16 * MT, M - m0);
  const int per_owner = (16 * MT + splits - 1) / splits;  // inbox rows a slot
  cluster_wait();  // every CTA of the cluster has started
  if (kh == 0) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = 16 * mt + g + 8 * hf;
        if (row >= rows) continue;
        float4* slot = cluster.map_shared_rank(inbox, row % splits) +
                       (split * per_owner + row / splits) * (2 * kBNH / 4);
#pragma unroll
        for (int hb = 0; hb < 2; ++hb) {
#pragma unroll
          for (int hi = 0; hi < 2; ++hi) {
            const float* e = acc[mt][4 * hb + hi];      // odd = 0
            const float* o = acc[mt][4 * hb + 2 + hi];  // odd = 1
            slot[(64 * hi + 32 * ch + 16 * hb + 4 * t) / 4] =
                make_float4(e[2 * hf], o[2 * hf], e[2 * hf + 1], o[2 * hf + 1]);
          }
        }
      }
    }
  }
  cluster_arrive_release();
  cluster_wait();  // every partial of this CTA's rows is in its inbox
  for (int f = tid; f < per_owner * (2 * kBNH / 4); f += kThreads) {
    const int lr = f / (2 * kBNH / 4), c4 = f % (2 * kBNH / 4);
    const int row = lr * splits + split;
    if (row >= rows) continue;
    float4 sum = inbox[lr * (2 * kBNH / 4) + c4];  // in split order
    for (int s = 1; s < splits; ++s) {
      const float4 v = inbox[(s * per_owner + lr) * (2 * kBNH / 4) + c4];
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    const int col = c4 < kBNH / 4 ? j0 + 4 * c4 : NH + j0 + 4 * c4 - kBNH;
    *reinterpret_cast<float4*>(out + (long)(m0 + row) * N + col) = sum;
  }
}

template <int MT, int S>
cudaError_t launch(int NH, int splits, int M, cudaStream_t st, int device, const __nv_bfloat16* y,
                   const int8_t* q, const float* s, float* out, int K) {
  static unsigned smem_set = 0;
  constexpr int bytes = Smem<MT, S>::kBytes;
  if (!(smem_set & (1u << device))) {
    const cudaError_t err = cudaFuncSetAttribute(
        int4_matmul_kernel<MT, S>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    smem_set |= 1u << device;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(NH / kBNH, splits, (M + kBM - 1) / kBM);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, int4_matmul_kernel<MT, S>, y, q, s, out, M, K, NH);
}

// a ring of 2 stages where a split has at most 2 groups, else 4
template <int MT>
cudaError_t launch_ring(int NH, int splits, int M, cudaStream_t st, int device,
                        const __nv_bfloat16* y, const int8_t* q, const float* s, float* out,
                        int K) {
  const int groups = K / kGroup;
  if ((groups + splits - 1) / splits <= 2) {
    return launch<MT, 2>(NH, splits, M, st, device, y, q, s, out, K);
  }
  return launch<MT, 4>(NH, splits, M, st, device, y, q, s, out, K);
}

}  // namespace

// Plain C entry for ctypes. y: bf16 [M, K]; q: int8 [L, K, NH]; scale: f32
// [L, K/128, 1, 2·NH]; out: f32 [M, 2·NH]. All contiguous device pointers;
// `layer` indexes the stack in place. K must be a multiple of 128 and NH of
// 64; `splits` (1..8, at most K/128) is the caller's split plan: K's groups
// go to `splits` CTAs of a cluster, ceil(groups / splits) each. Returns the
// launch's cudaError_t.
extern "C" int tst_int4_matmul(const void* y, const void* q, const void* scale, void* out, int M,
                               int K, int NH, int layer, int splits, int device, void* stream) {
  if (M <= 0 || K <= 0 || K % kGroup != 0 || NH <= 0 || NH % kBNH != 0 || layer < 0 ||
      splits < 1 || splits > kMaxSplits || splits > K / kGroup || device < 0 ||
      device >= kMaxDevices) {
    return (int)cudaErrorInvalidValue;
  }
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err == cudaSuccess && cur != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* yb = static_cast<const __nv_bfloat16*>(y);
  const auto* qb = static_cast<const int8_t*>(q) + (long)layer * K * NH;
  const auto* sb = static_cast<const float*>(scale) + (long)layer * (K / kGroup) * 2 * NH;
  auto* o = static_cast<float*>(out);
  switch (M >= kBM ? 4 : (M + 15) / 16) {
    case 1: return (int)launch_ring<1>(NH, splits, M, st, device, yb, qb, sb, o, K);
    case 2: return (int)launch_ring<2>(NH, splits, M, st, device, yb, qb, sb, o, K);
    case 3: return (int)launch_ring<3>(NH, splits, M, st, device, yb, qb, sb, o, K);
    default: return (int)launch_ring<4>(NH, splits, M, st, device, yb, qb, sb, o, K);
  }
}
