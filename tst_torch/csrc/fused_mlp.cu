// SwiGLU MLP forward for Hopper (sm_90a): out = down(silu(x·Wg) ⊙ (x·Wu)),
// bf16 in and out, f32 accumulation; two warpgroup-wgmma kernels.
//
// Replaces the TPU kernel `_fused_mlp_kernel` (tst/kernels/fused_mlp.py:44, via
// `_fused_mlp_fwd_impl` :62 and `fused_swiglu_mlp` :116). Semantics are the
// reference's: g = x·Wg and u = x·Wu in f32, h = silu(g)·u rounded to x's dtype
// (bf16), out = h·Wd accumulated in f32 and rounded once to bf16. The backward
// stays the reference's plain f32 recomputation (tst_torch/kernels/fused_mlp.py).
// x [M, D], Wg/Wu [D, F], Wd [F, D], all contiguous row-major bf16.
//
// What bounds it on an H100: at the train step's shape (M = 16384, D = 896,
// F = 4864) the three products are 428 GFLOP, 0.433 ms at the dense bf16 peak
// (989 TFLOP/s), against 84 MB of inputs and output (0.025 ms at 3.35 TB/s):
// bound by the tensor cores, given enough rows to every weight tile. The TPU
// kernel kept a [bm, D] f32 output accumulator in VMEM and streamed F; on
// Hopper that accumulator is the problem ([64, 896] f32 is 224 KiB, more than
// a block's registers and shared memory), and the first port cut its rows to
// 32 to fit, re-reading the weights for every 32 rows on mma.sync.
//
// What the design does about it: the hidden h = silu(g)·u [M, F] is written to
// device memory as bf16, exactly the values the down product reads, so the
// two products become two GEMMs with 128-row tiles:
//   * swiglu_gate_up_kernel: a tile is 128 rows x 128 columns of F; Wg's and
//     Wu's columns sit side by side in one [64, 256] B tile, so one wgmma
//     m64n256k16 a k16 step gives both g and u in the same thread's registers,
//     and the epilogue computes silu(g)·u in f32 there and stores h in bf16;
//   * swiglu_down_kernel: out = h·Wd, tiles of 128 rows x 128 columns of D,
//     wgmma m64n128k16, one bf16 rounding on store;
//   * both: a producer warp and two consumer warpgroups (64 rows each) a
//     block. The producer's one thread fills a ring of 4 (gate-up) or 6 (down)
//     stages by TMA, 128-byte-swizzled tiles of [128 rows][64] of A and
//     [64][64] blocks of the weights, each stage paid to a `full` mbarrier;
//     the consumers wait on it, run the stage's four k16 products and give
//     the stage back through an `empty` mbarrier. A is read K-major and the
//     weights MN-major (the descriptor's transpose bit, gemm_sm90.cuh), so
//     nothing is staged transposed, and no block-wide barrier sits in the
//     loop. A persistent grid of one block an SM walks its tiles row-major,
//     so the producer fetches the next tile while the consumers store the
//     last, and the blocks in flight share their x rows and weights in L2;
//     TMA reads rows past M and columns past F as zeros, and they are never
//     stored.
// h costs 2·M·F·2 bytes of traffic (159 MB each way at the train shape,
// ~0.1 ms), outside the function's bound; it lives for the call only.
// Measured and not kept (PERF.md §6): the same GEMMs fed by cp.async from
// all threads with a block barrier every k-step (slower), and keeping one
// wgmma group in flight across k-steps (the compiler serializes it: slower).
// Not yet: 16-byte or TMA stores of h and out through shared memory, two
// consumer blocks sharing a weight tile by TMA multicast in a cluster, the
// fused variant that keeps h on chip (a cluster splitting the [128, D]
// accumulator over its blocks' shared memory).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_sm90.cuh"

namespace {

constexpr int kBM = 128;        // rows of a tile: one m64 slab for each consumer warpgroup
constexpr int kBK = 64;         // depth of a k-step: one 128-byte swizzle block
constexpr int kTileN = 128;     // output columns of a tile (of F for gate-up, of D for down)
constexpr int kConsumers = 256; // two consumer warpgroups
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kATileBytes = kBM * kBK * 2;  // [128][64] bf16: two stacked sw128 blocks
constexpr int kMaxDevices = 32;

// kGate: h = silu(x·Wg)·(x·Wu) (B = Wg | Wu, n256); else out = h·Wd (n128)
template <bool kGate>
struct Gemm {
  static constexpr int kN = kGate ? 2 * kTileN : kTileN;  // wgmma width
  static constexpr int kStages = kGate ? 4 : 6;
  static constexpr int kStageBytes = kATileBytes + kBK * kN * 2;
  // the ring, its full and empty barriers, aligned_smem's slack
  static constexpr int kSmem = kStages * kStageBytes + 2 * kStages * 8 + 1024;
};

// C [M, N] (row-major bf16) from A [M, K] and B [K, N] through their TMA
// maps (tb1 beside tb0 when kGate), one persistent block an SM over 128 x 128
// output tiles
template <bool kGate>
__device__ __forceinline__ void gemm_body(const CUtensorMap* ta, const CUtensorMap* tb0,
                                          const CUtensorMap* tb1, __nv_bfloat16* __restrict__ c,
                                          int M, int K, int N) {
  using G = Gemm<kGate>;
  constexpr int kN = G::kN;
  constexpr int kS = G::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = smem_u32(aligned_smem(smem_raw));
  const uint32_t full = ring + kS * G::kStageBytes;  // stage s landed: full + 8s
  const uint32_t empty = full + kS * 8;               // stage s consumed: empty + 8s
  const int tid = threadIdx.x;
  const int n_tiles = (N + kTileN - 1) / kTileN;
  const int tiles = ((M + kBM - 1) / kBM) * n_tiles;
  const int ksteps = K / kBK;
  const int total = (tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x * ksteps;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kS; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {  // the producer warp: one thread issues every copy
    if (tid == kConsumers) {
      int tile = blockIdx.x, k0 = 0;
      for (int it = 0; it < total; ++it) {
        const int s = it % kS;
        if (it >= kS) mbar_wait(empty + 8 * s, (it / kS - 1) & 1);
        const uint32_t st = ring + s * G::kStageBytes;
        mbar_expect_tx(full + 8 * s, G::kStageBytes);
        const int row0 = (tile / n_tiles) * kBM, n0 = (tile % n_tiles) * kTileN;
        tma_load(st, ta, full + 8 * s, k0, row0);  // rows past M arrive as zeros
#pragma unroll
        for (int cb = 0; cb < kN / 64; ++cb) {  // columns past N arrive as zeros
          tma_load(st + kATileBytes + cb * kSw128Block, (kGate && cb >= 2) ? tb1 : tb0,
                   full + 8 * s, n0 + (cb % 2) * 64, k0);
        }
        k0 += kBK;
        if (k0 == K) {
          k0 = 0;
          tile += gridDim.x;
        }
      }
    }
    return;
  }

  const int wg = tid / 128;  // consumer warpgroup: rows 64·wg .. 64·wg + 63 of a tile
  const int warp = (tid % 128) / 32;
  const int g = (tid % 32) / 4;
  const int t = tid % 4;
  float acc[kN / 2];
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) acc[i] = 0.f;
  int tile = blockIdx.x, kb = 0;
  for (int it = 0; it < total; ++it) {
    const int s = it % kS;
    mbar_wait(full + 8 * s, (it / kS) & 1);
    const uint32_t st = ring + s * G::kStageBytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      wgmma_ss_mn(acc, desc_k_major(st + wg * kSw128Block, kk),
                  desc_mn_wide(st + kATileBytes, kk), kb > 0 || kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    mbar_arrive(empty + 8 * s);
    if (++kb < ksteps) continue;
    fence_acc_n(acc);
    // the tile's epilogue: this thread's rows 16·warp + g and + 8 of its slab
    const int row = (tile / n_tiles) * kBM + 64 * wg + 16 * warp + g;
    const int n0 = (tile % n_tiles) * kTileN;
    kb = 0;
    tile += gridDim.x;
#pragma unroll
    for (int j = 0; j < kTileN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * t;
      if (col >= N) continue;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float v0 = acc[4 * j + 2 * hf], v1 = acc[4 * j + 2 * hf + 1];
        if constexpr (kGate) {  // u sits kTileN columns (16 n8 groups) to the right of g
          v0 = v0 / (1.f + expf(-v0)) * acc[4 * (j + kTileN / 8) + 2 * hf];
          v1 = v1 / (1.f + expf(-v1)) * acc[4 * (j + kTileN / 8) + 2 * hf + 1];
        }
        if (row + 8 * hf < M) {
          *reinterpret_cast<uint32_t*>(c + (long)(row + 8 * hf) * N + col) = pack_bf16(v0, v1);
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
swiglu_gate_up_kernel(const __grid_constant__ CUtensorMap tx,
                      const __grid_constant__ CUtensorMap twg,
                      const __grid_constant__ CUtensorMap twu, __nv_bfloat16* __restrict__ h,
                      int M, int D, int F) {
  gemm_body<true>(&tx, &twg, &twu, h, M, D, F);
}

__global__ void __launch_bounds__(kThreads, 1)
swiglu_down_kernel(const __grid_constant__ CUtensorMap th, const __grid_constant__ CUtensorMap twd,
                   __nv_bfloat16* __restrict__ out, int M, int F, int D) {
  gemm_body<false>(&th, &twd, &twd, out, M, F, D);
}

// a TMA map of a row-major [rows, cols] bf16 matrix, read in boxes of
// [box_rows][64] into 128-byte-swizzled tiles; out-of-range elements read as zero
cudaError_t tensor_map(CUtensorMap* map, const void* base, int rows, int cols, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  return encode_tensor_map(map, base, 2, dims, strides, box);
}

// the common start of both entries: the shapes checked, `device` made
// current (a no-op when it is), its SM count (read once) in `sms`, and the
// kernel's dynamic shared memory limit raised (once a device)
template <bool kGate>
cudaError_t prepare(const void* kernel, int M, int D, int F, int device, unsigned* smem_set,
                    int* sms) {
  static int cached[kMaxDevices] = {0};
  if (M <= 0 || D <= 0 || F <= 0 || D % 128 != 0 || F % 64 != 0 || device < 0 ||
      device >= kMaxDevices) {
    return cudaErrorInvalidValue;
  }
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err == cudaSuccess && cur != device) err = cudaSetDevice(device);
  if (err == cudaSuccess && cached[device] == 0) {
    err = cudaDeviceGetAttribute(&cached[device], cudaDevAttrMultiProcessorCount, device);
  }
  if (err == cudaSuccess && !(*smem_set & (1u << device))) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Gemm<kGate>::kSmem);
    if (err == cudaSuccess) *smem_set |= 1u << device;
  }
  *sms = cached[device];
  return err;
}

// one persistent block an SM, or a block a tile where there are fewer
int grid_for(int M, int N, int sms) {
  const int tiles = ((M + kBM - 1) / kBM) * ((N + kTileN - 1) / kTileN);
  return tiles < sms ? tiles : sms;
}

}  // namespace

// Plain C entries for ctypes: device pointers of contiguous bf16 tensors;
// `stream` is a cudaStream_t. D must be a multiple of 128 and F of 64; any
// M >= 1. Each returns its launch's cudaError_t.
//
// h [M, F] = silu(x [M, D] · wg [D, F]) · (x · wu [D, F])
extern "C" int tst_swiglu_gate_up(const void* x, const void* wg, const void* wu, void* h, int M,
                                  int D, int F, int device, void* stream) {
  static unsigned smem_set = 0;
  int sms = 0;
  CUtensorMap tx, twg, twu;
  cudaError_t err = prepare<true>((const void*)swiglu_gate_up_kernel, M, D, F, device, &smem_set,
                                  &sms);
  if (err == cudaSuccess) err = tensor_map(&tx, x, M, D, kBM);
  if (err == cudaSuccess) err = tensor_map(&twg, wg, D, F, kBK);
  if (err == cudaSuccess) err = tensor_map(&twu, wu, D, F, kBK);
  if (err != cudaSuccess) return (int)err;
  swiglu_gate_up_kernel<<<grid_for(M, F, sms), kThreads, Gemm<true>::kSmem,
                          static_cast<cudaStream_t>(stream)>>>(
      tx, twg, twu, static_cast<__nv_bfloat16*>(h), M, D, F);
  return (int)cudaGetLastError();
}

// out [M, D] = h [M, F] · wd [F, D]
extern "C" int tst_swiglu_down(const void* h, const void* wd, void* out, int M, int F, int D,
                               int device, void* stream) {
  static unsigned smem_set = 0;
  int sms = 0;
  CUtensorMap th, twd;
  cudaError_t err = prepare<false>((const void*)swiglu_down_kernel, M, D, F, device, &smem_set,
                                   &sms);
  if (err == cudaSuccess) err = tensor_map(&th, h, M, F, kBM);
  if (err == cudaSuccess) err = tensor_map(&twd, wd, F, D, kBK);
  if (err != cudaSuccess) return (int)err;
  swiglu_down_kernel<<<grid_for(M, D, sms), kThreads, Gemm<false>::kSmem,
                       static_cast<cudaStream_t>(stream)>>>(
      th, twd, static_cast<__nv_bfloat16*>(out), M, F, D);
  return (int)cudaGetLastError();
}
