// Packed-int4 dequant-matmul for Hopper (sm_90a): out[M, N] (f32) =
// y[M, K] (bf16) @ dequant(q[layer], scale[layer]), the layer indexed in place.
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
// a layer's seven projections of Qwen2.5-0.5B are 6.7 MB, 2 µs at 3.35 TB/s.
// The plain version writes and reads a bf16 copy of each weight (4x the
// bytes) and launches the unpack chain as separate kernels. Why the stack is
// indexed in place: slicing q[layer] out of the [L, K, N/2] stack would copy
// it first (the reason for the TPU kernel's scalar prefetch, :9-18); here the
// layer is a pointer offset.
//
// What the design does about it (simple and correct first):
//   * a block owns 64 packed columns (128 output columns: 64 low, 64 high),
//     up to 64 rows of y, and a range of 128-row K groups; 4 warps, each two
//     packed n8 tiles, i.e. four output n8 tiles, for every m16 tile;
//   * the packed bytes are read once, coalesced along the contiguous N/2
//     axis, into shared memory; each lane unpacks the four bytes of its B
//     fragments with integer ops (lo = (b & 0xF) - 8, hi = b >> 4 on the
//     signed byte), scales them by the group's f32 scale and rounds to bf16;
//     one byte feeds a low and a high fragment;
//   * products are mma.sync m16n8k16 (bf16 in, f32 accumulate);
//   * narrow leaves (N/2 = 64 for Qwen2.5-0.5B's wk, wv) give one column
//     block, so K is split across blocks: each split writes its f32 partial
//     to a workspace and a second, tiny kernel sums the partials in split
//     order (deterministic; no atomics). One split writes the output directly.
// Not yet: cp.async double buffering of the packed tiles, fusing the split
// reduction.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kGroup = 128;     // rows per scale group = K rows per staged chunk
constexpr int kBNH = 64;        // packed columns per block (8 n8 tiles)
constexpr int kBM = 64;         // rows of y per block (4 m16 tiles at most)
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kYPad = 8;        // bf16 padding per y row
constexpr int kQPad = 16;       // byte padding per packed row

template <int MT>
__global__ void __launch_bounds__(kThreads)
int4_matmul_kernel(const __nv_bfloat16* __restrict__ y, const int8_t* __restrict__ q,
                   const float* __restrict__ scale, float* __restrict__ out, int M, int K,
                   int NH, int chunks_per_split) {
  __shared__ __align__(16) __nv_bfloat16 y_s[kBM][kGroup + kYPad];
  __shared__ __align__(16) int8_t q_s[kGroup][kBNH + kQPad];

  const int N = 2 * NH;
  const int j0 = blockIdx.x * kBNH;
  const int split = blockIdx.y;
  const int m0 = blockIdx.z * kBM;
  const int n_chunks = K / kGroup;
  const int c_begin = split * chunks_per_split;
  const int c_end = min(n_chunks, c_begin + chunks_per_split);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;

  // acc[mt][i]: i = 0, 1 low tiles of packed n8 tiles 2·warp, 2·warp + 1; 2, 3 high
  float acc[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[mt][i][0] = acc[mt][i][1] = acc[mt][i][2] = acc[mt][i][3] = 0.f;

  for (int c = c_begin; c < c_end; ++c) {
    const int k0 = c * kGroup;
    __syncthreads();  // every warp is done with the previous chunk's tiles
    // y rows [m0, m0 + 16·MT) x [k0, k0 + 128): 16-byte vectors, zero past M
    for (int v = tid; v < MT * 16 * (kGroup / 8); v += kThreads) {
      const int r = v / (kGroup / 8), col = (v % (kGroup / 8)) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < M) val = *reinterpret_cast<const uint4*>(y + (long)(m0 + r) * K + k0 + col);
      *reinterpret_cast<uint4*>(&y_s[r][col]) = val;
    }
    // packed bytes [k0, k0 + 128) x [j0, j0 + 64): 512 vectors of 16 bytes
    for (int v = tid; v < kGroup * (kBNH / 16); v += kThreads) {
      const int r = v / (kBNH / 16), col = (v % (kBNH / 16)) * 16;
      *reinterpret_cast<uint4*>(&q_s[r][col]) =
          *reinterpret_cast<const uint4*>(q + (long)(k0 + r) * NH + j0 + col);
    }
    // this lane's scales: column g of each of its packed tiles, low and high
    const float* sc = scale + (long)c * N;
    float s_lo[2], s_hi[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int j = j0 + (2 * warp + i) * 8 + g;
      s_lo[i] = sc[j];
      s_hi[i] = sc[NH + j];
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kGroup / 16; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int ar = mt * 16 + g, ac = kk * 16 + 2 * t;
        a[mt][0] = load_u32(&y_s[ar][ac]);
        a[mt][1] = load_u32(&y_s[ar + 8][ac]);
        a[mt][2] = load_u32(&y_s[ar][ac + 8]);
        a[mt][3] = load_u32(&y_s[ar + 8][ac + 8]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int jj = (2 * warp + i) * 8 + g;
        const int r = kk * 16 + 2 * t;
        // B rows 2t, 2t+1 (b0) and 2t+8, 2t+9 (b1) of column jj
        const int8_t b[4] = {q_s[r][jj], q_s[r + 1][jj], q_s[r + 8][jj], q_s[r + 9][jj]};
        float lo[4], hi[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          lo[e] = (float)((b[e] & 0xF) - 8) * s_lo[i];
          hi[e] = (float)(b[e] >> 4) * s_hi[i];
        }
        const uint32_t lo0 = pack_bf16(lo[0], lo[1]), lo1 = pack_bf16(lo[2], lo[3]);
        const uint32_t hi0 = pack_bf16(hi[0], hi[1]), hi1 = pack_bf16(hi[2], hi[3]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_16816(acc[mt][i], a[mt], lo0, lo1);
          mma_16816(acc[mt][2 + i], a[mt], hi0, hi1);
        }
      }
    }
  }
  // f32 out: the output itself with one split, else this split's workspace slice
  float* dst = out + (long)split * M * N;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int r_lo = m0 + mt * 16 + g;
    const int r_hi = r_lo + 8;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = (i < 2 ? 0 : NH) + j0 + (2 * warp + (i % 2)) * 8 + 2 * t;
      if (r_lo < M)
        *reinterpret_cast<float2*>(dst + (long)r_lo * N + col) =
            make_float2(acc[mt][i][0], acc[mt][i][1]);
      if (r_hi < M)
        *reinterpret_cast<float2*>(dst + (long)r_hi * N + col) =
            make_float2(acc[mt][i][2], acc[mt][i][3]);
    }
  }
}

// out[i] = sum over splits s (in order) of ws[s][i]
__global__ void split_sum_kernel(const float* __restrict__ ws, float* __restrict__ out, long n,
                                 int splits) {
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int p = 0; p < splits; ++p) s += ws[(long)p * n + i];
    out[i] = s;
  }
}

template <int MT>
void launch(dim3 grid, cudaStream_t st, const __nv_bfloat16* y, const int8_t* q, const float* s,
            float* dst, int M, int K, int NH, int cps) {
  int4_matmul_kernel<MT><<<grid, kThreads, 0, st>>>(y, q, s, dst, M, K, NH, cps);
}

}  // namespace

// K splits int4_matmul takes for a call: about two blocks per SM of an H100,
// at most one 128-row group per split and at most 16 splits.
extern "C" int tst_int4_matmul_splits(int M, int K, int NH) {
  const int n_chunks = K / kGroup;
  const int blocks = (NH / kBNH) * ((M + kBM - 1) / kBM);
  int want = (264 + blocks - 1) / blocks;
  want = want < 1 ? 1 : (want > 16 ? 16 : want);
  want = want > n_chunks ? n_chunks : want;
  const int cps = (n_chunks + want - 1) / want;
  return (n_chunks + cps - 1) / cps;
}

// Plain C entry for ctypes. y: bf16 [M, K]; q: int8 [L, K, NH]; scale: f32
// [L, K/128, 1, 2·NH]; out: f32 [M, 2·NH]; ws: f32 [splits, M, 2·NH] when
// splits > 1 (else unused), splits from tst_int4_matmul_splits. All contiguous
// device pointers; `layer` indexes the stack in place. K must be a multiple of
// 128 and NH of 64. Returns the launches' cudaError_t.
extern "C" int tst_int4_matmul(const void* y, const void* q, const void* scale, void* out,
                               void* ws, int M, int K, int NH, int layer, int splits, int device,
                               void* stream) {
  if (M <= 0 || K <= 0 || K % kGroup != 0 || NH <= 0 || NH % kBNH != 0 || layer < 0 ||
      splits != tst_int4_matmul_splits(M, K, NH) || (splits > 1 && ws == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_chunks = K / kGroup;
  const int cps = (n_chunks + splits - 1) / splits;
  const long N = 2L * NH;
  const auto* yb = static_cast<const __nv_bfloat16*>(y);
  const auto* qb = static_cast<const int8_t*>(q) + (long)layer * K * NH;
  const auto* sb = static_cast<const float*>(scale) + (long)layer * n_chunks * N;
  float* dst = static_cast<float*>(splits > 1 ? ws : out);
  const dim3 grid(NH / kBNH, splits, (M + kBM - 1) / kBM);
  const int mt = M >= kBM ? 4 : (M + 15) / 16;
  switch (mt) {
    case 1: launch<1>(grid, st, yb, qb, sb, dst, M, K, NH, cps); break;
    case 2: launch<2>(grid, st, yb, qb, sb, dst, M, K, NH, cps); break;
    case 3: launch<3>(grid, st, yb, qb, sb, dst, M, K, NH, cps); break;
    default: launch<4>(grid, st, yb, qb, sb, dst, M, K, NH, cps); break;
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long n = (long)M * N;
  const int blocks = (int)((n + 255) / 256 < 1024 ? (n + 255) / 256 : 1024);
  split_sum_kernel<<<blocks, 256, 0, st>>>(static_cast<const float*>(ws),
                                           static_cast<float*>(out), n, splits);
  return (int)cudaGetLastError();
}
