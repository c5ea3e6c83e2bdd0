// Fused SwiGLU MLP forward for Hopper (sm_90a): out = down(silu(x·Wg) ⊙ (x·Wu)),
// bf16 in and out, f32 accumulation, the [M, F] hidden never in device memory.
//
// Replaces the TPU kernel `_fused_mlp_kernel` (tst/kernels/fused_mlp.py:44, via
// `_fused_mlp_fwd_impl` :62 and `fused_swiglu_mlp` :116). Semantics are the
// reference's: g = x·Wg and u = x·Wu in f32, h = silu(g)·u rounded to x's dtype
// (bf16), out = h·Wd accumulated in f32 and rounded once to bf16. The backward
// stays the reference's plain f32 recomputation (tst_torch/kernels/fused_mlp.py).
// x [M, D], Wg/Wu [D, F], Wd [F, D], all contiguous row-major bf16.
//
// What bounds it on an H100: at the train step's shape (M = 16384, D = 896,
// F = 4864) the three products are 428 GFLOP and the weights 26 MB, so the
// call is compute-bound on the tensor cores if the weights stay in L2 (they
// fit its 50 MB) and every block reuses a weight tile over enough rows. The
// TPU kernel kept a [bm, D] f32 output accumulator in VMEM and streamed F;
// on Hopper that accumulator is the problem: [64, 896] f32 is 224 KiB, more
// than a block's registers and than its 227 KiB of shared memory, and at
// Llama-3-8B's D = 4096 it is 4.6x that.
//
// What the design does about it (simple and correct first):
//   * a block owns 32 rows (two m16 tiles) and an output slice of DN = 128·NT
//     columns; the f32 accumulator [32, DN] is spread over 16 warps, NT n8
//     tiles each for both m tiles (2·NT·4 registers a thread, 56 at D = 896);
//   * where D is wider than 1024, the output is cut into D / DN slices, one
//     block each, and every slice recomputes h for its rows (the "output-D
//     slices, h recomputed" option): at D = 896 there is one slice and no
//     recomputation; at D = 4096, four slices of 1024;
//   * F is streamed in chunks of 64: the gate and up products of the chunk
//     (each warp one 16 x 8 tile of each) run over D in steps of 64 with x,
//     Wg and Wu tiles staged in shared memory; h = silu(g)·u goes to shared
//     memory as bf16, the chunk's Wd rows [64, DN] are staged, and every warp
//     adds h·Wd to its accumulator tiles;
//   * all products are mma.sync m16n8k16 (bf16 in, f32 accumulate); B
//     fragments come from row-major shared tiles through ldmatrix .trans,
//     rows padded by 8 elements so the reads are free of bank conflicts;
//   * rows past M are read as zero and never stored, so any M works.
// Not yet: cp.async / TMA double buffering, wgmma, larger row tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kBM = 32;        // rows per block: two m16 tiles
constexpr int kBF = 64;        // hidden columns per F chunk: eight n8 tiles
constexpr int kBK = 64;        // depth of one x / Wg / Wu tile of the gate/up products
constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;        // bf16 elements of padding per shared-memory row

__device__ __forceinline__ uint4 load16(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ void store16(__nv_bfloat16* p, uint4 v) {
  *reinterpret_cast<uint4*>(p) = v;
}

template <int NT>
__host__ __device__ constexpr int slice_cols() { return kWarps * 8 * NT; }

template <int NT>
constexpr size_t smem_bytes() {
  return sizeof(__nv_bfloat16) *
         ((size_t)kBM * (kBK + kPad)              // x tile
          + 2 * (size_t)kBK * (kBF + kPad)         // Wg, Wu tiles
          + (size_t)kBM * (kBF + kPad)             // h
          + (size_t)kBF * (slice_cols<NT>() + kPad));  // Wd rows of the chunk
}

template <int NT>
__global__ void __launch_bounds__(kThreads, 1)
fused_mlp_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wg,
                 const __nv_bfloat16* __restrict__ wu, const __nv_bfloat16* __restrict__ wd,
                 __nv_bfloat16* __restrict__ out, int M, int D, int F) {
  constexpr int DN = slice_cols<NT>();
  extern __shared__ __align__(16) unsigned char smem[];
  auto* x_s = reinterpret_cast<__nv_bfloat16(*)[kBK + kPad]>(smem);
  auto* wg_s = reinterpret_cast<__nv_bfloat16(*)[kBF + kPad]>(x_s + kBM);
  auto* wu_s = wg_s + kBK;
  auto* h_s = wu_s + kBK;
  auto* wd_s = reinterpret_cast<__nv_bfloat16(*)[DN + kPad]>(h_s + kBM);

  const int row0 = blockIdx.x * kBM;
  const int col0 = blockIdx.y * DN;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  // gate/up products: warp -> (m tile, n8 tile of the chunk)
  const int mt1 = warp / 8;
  const int nt1 = warp % 8;
  // down product: warp -> NT n8 tiles of the slice, both m tiles
  const int wcol = warp * NT * 8;
  // ldmatrix row of this lane inside a k16 tile (lanes 16-31 repeat 0-15)
  const int lrow = lane % 16;

  float acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] =
        acc[mt][nt][3] = 0.f;

  for (int f0 = 0; f0 < F; f0 += kBF) {
    float cg[4] = {0.f, 0.f, 0.f, 0.f};
    float cu[4] = {0.f, 0.f, 0.f, 0.f};
    for (int d0 = 0; d0 < D; d0 += kBK) {
      __syncthreads();  // every warp is done with the previous tiles (and with h / Wd)
      if (tid < kBM * kBK / 8) {  // x tile: 256 vectors of 8
        const int r = tid / (kBK / 8), c = (tid % (kBK / 8)) * 8;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (row0 + r < M) v = load16(x + (long)(row0 + r) * D + d0 + c);
        store16(&x_s[r][c], v);
      }
      {  // Wg and Wu tiles: 512 vectors of 8 each
        const int r = tid / (kBF / 8), c = (tid % (kBF / 8)) * 8;
        const long off = (long)(d0 + r) * F + f0 + c;
        store16(&wg_s[r][c], load16(wg + off));
        store16(&wu_s[r][c], load16(wu + off));
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const int ar = mt1 * 16 + g, ac = kk * 16 + 2 * t;
        const uint32_t a[4] = {load_u32(&x_s[ar][ac]), load_u32(&x_s[ar + 8][ac]),
                               load_u32(&x_s[ar][ac + 8]), load_u32(&x_s[ar + 8][ac + 8])};
        uint32_t b0, b1;
        ldmatrix_b_trans(b0, b1, &wg_s[kk * 16 + lrow][nt1 * 8]);
        mma_16816(cg, a, b0, b1);
        ldmatrix_b_trans(b0, b1, &wu_s[kk * 16 + lrow][nt1 * 8]);
        mma_16816(cu, a, b0, b1);
      }
    }
    // h = silu(g) * u in f32, rounded to bf16 (c0,c1: row g; c2,c3: row g + 8)
    {
      float h[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) h[i] = cg[i] / (1.f + expf(-cg[i])) * cu[i];
      const int hr = mt1 * 16 + g, hc = nt1 * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(&h_s[hr][hc]) = pack_bf16(h[0], h[1]);
      *reinterpret_cast<uint32_t*>(&h_s[hr + 8][hc]) = pack_bf16(h[2], h[3]);
    }
    // the chunk's Wd rows [64, DN] of this block's output slice
    for (int v = tid; v < kBF * DN / 8; v += kThreads) {
      const int r = v / (DN / 8), c = (v % (DN / 8)) * 8;
      store16(&wd_s[r][c], load16(wd + (long)(f0 + r) * D + col0 + c));
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBF / 16; ++kk) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int ar = mt * 16 + g, ac = kk * 16 + 2 * t;
        a[mt][0] = load_u32(&h_s[ar][ac]);
        a[mt][1] = load_u32(&h_s[ar + 8][ac]);
        a[mt][2] = load_u32(&h_s[ar][ac + 8]);
        a[mt][3] = load_u32(&h_s[ar + 8][ac + 8]);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t b0, b1;
        ldmatrix_b_trans(b0, b1, &wd_s[kk * 16 + lrow][wcol + nt * 8]);
        mma_16816(acc[0][nt], a[0], b0, b1);
        mma_16816(acc[1][nt], a[1], b0, b1);
      }
    }
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int r_lo = row0 + mt * 16 + g;
    const int r_hi = r_lo + 8;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int c = col0 + wcol + nt * 8 + 2 * t;
      if (r_lo < M)
        *reinterpret_cast<uint32_t*>(out + (long)r_lo * D + c) =
            pack_bf16(acc[mt][nt][0], acc[mt][nt][1]);
      if (r_hi < M)
        *reinterpret_cast<uint32_t*>(out + (long)r_hi * D + c) =
            pack_bf16(acc[mt][nt][2], acc[mt][nt][3]);
    }
  }
}

template <int NT>
int launch(const void* x, const void* wg, const void* wu, const void* wd, void* out, int M,
           int D, int F, cudaStream_t st) {
  const size_t smem = smem_bytes<NT>();
  cudaError_t err = cudaFuncSetAttribute(fused_mlp_kernel<NT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((M + kBM - 1) / kBM, D / slice_cols<NT>());
  fused_mlp_kernel<NT><<<grid, kThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(wg),
      static_cast<const __nv_bfloat16*>(wu), static_cast<const __nv_bfloat16*>(wd),
      static_cast<__nv_bfloat16*>(out), M, D, F);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry for ctypes: device pointers of contiguous bf16 tensors x [M, D],
// wg/wu [D, F], wd [F, D], out [M, D]; `stream` is a cudaStream_t. D must be a
// multiple of 128 and F of 64; any M >= 1. Returns the launch's cudaError_t.
extern "C" int tst_fused_mlp_fwd(const void* x, const void* wg, const void* wu, const void* wd,
                                 void* out, int M, int D, int F, int device, void* stream) {
  if (M <= 0 || D <= 0 || F <= 0 || D % 128 != 0 || F % kBF != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  // the fewest output slices whose width DN = 128·NT keeps NT <= 8
  const int n128 = D / 128;
  int slices = 1;
  while (n128 % slices != 0 || n128 / slices > 8) ++slices;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n128 / slices) {
    case 1: return launch<1>(x, wg, wu, wd, out, M, D, F, st);
    case 2: return launch<2>(x, wg, wu, wd, out, M, D, F, st);
    case 3: return launch<3>(x, wg, wu, wd, out, M, D, F, st);
    case 4: return launch<4>(x, wg, wu, wd, out, M, D, F, st);
    case 5: return launch<5>(x, wg, wu, wd, out, M, D, F, st);
    case 6: return launch<6>(x, wg, wu, wd, out, M, D, F, st);
    case 7: return launch<7>(x, wg, wu, wd, out, M, D, F, st);
    case 8: return launch<8>(x, wg, wu, wd, out, M, D, F, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
