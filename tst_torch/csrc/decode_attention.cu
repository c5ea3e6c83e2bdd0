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
// speculative decode's verify chunk), on the cache's length, or on where
// masked slots sit between the visible ones (rejected draft tokens). torch's
// batched products and softmax choose their blocking by shape, so there a
// row's sums run in another order at another T or S; here they do not, and
// speculative decode's tokens are greedy decode's bit for bit.
//
// Semantics (the plain version, tst_torch/kernels/decode_attention.py): f32
// scores q·k (bf16 operands), an f32 softmax over the visible slots whose
// probabilities are rounded to bf16, f32 sums of p·v, the output rounded to
// bf16. Masked slots weigh nothing (the plain version's exact 0).
//
// One block of 128 threads a (row, query, head). Every sum runs over the
// visible slots by their rank r (0, 1, ... in slot order), in a structure
// fixed by r and by their count n alone, so the bits follow the visible
// slots and nothing else:
//   1. rank → slot: each warp counts the visible slots of a quarter of the
//      cache (ballots), then writes the slots of its quarter at their ranks
//      (shared memory, S ints);
//   2. scores: 16 lanes a key row (each 4 or 8 dims, one 8- or 16-byte
//      load), their partial dots summed by one xor tree; 8 rows at a time,
//      8 rows' loads ahead; the masked slots are never read;
//   3. the maximum (exact in any order); p = exp(score - max); the sum of p:
//      thread i adds ranks i, i + 128, ... in order, then one xor tree in
//      each warp and the 4 warps' sums in a fixed order; each probability
//      rounded to bf16 in place;
//   4. p·v: 16 lanes a value row, lane c owning D/16 dims; group g of 16
//      lanes adds ranks g, g + 8, ... in order (8 rows' loads ahead), then
//      the 8 groups' partial sums are added in group order.
// What bounds it: the visible slots' keys and values, read once by each of
// the GQA group's queries (the group's re-reads hit L2), and at a decode
// step's small sizes the latency of those few dependent steps. It is a small
// share of a decode step, which is bound by its launches (PERF.md §5).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxDevices = 32;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kLanesPerRow = 16;                  // lanes that read one key or value row
constexpr int kGroups = kThreads / kLanesPerRow;  // rows taken at a time
constexpr int kAhead = 8;                         // rows a group loads before it uses them
constexpr unsigned kFull = 0xffffffffu;

template <int N>
struct Vec;  // N bf16, one load
template <>
struct Vec<4> {
  using T = uint2;
};
template <>
struct Vec<8> {
  using T = uint4;
};

template <int D>
__global__ void __launch_bounds__(kThreads) decode_attention_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const uint8_t* __restrict__ mask,
    __nv_bfloat16* __restrict__ out, int T, int S, int H, int KVH, float scale) {
  constexpr int kPer = D / kLanesPerRow;  // dims a lane
  using VecT = typename Vec<kPer>::T;
  extern __shared__ int slot[];                   // [S]: rank → slot
  float* p = reinterpret_cast<float*>(slot + S);  // [S]: rank → score, then probability
  __shared__ int count[kWarps];
  __shared__ float red[kWarps];
  __shared__ float part[kGroups][D];

  const int bt = blockIdx.x;  // b * T + t
  const int h = blockIdx.y;
  const int b = bt / T;
  const int kvh = h / (H / KVH);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = tid / kLanesPerRow, c = tid % kLanesPerRow;
  const long kv_stride = (long)KVH * D;  // elements between slots
  const uint8_t* mrow = mask + (long)bt * S;
  __nv_bfloat16* orow = out + ((long)bt * H + h) * D;

  // 1. rank → slot, in slot order
  const int span = ((S + kWarps - 1) / kWarps + 31) / 32 * 32;
  const int lo = warp * span, hi = min(S, lo + span);
  int mine = 0;
#pragma unroll 4
  for (int s0 = lo; s0 < hi; s0 += 32) {
    const int s = s0 + lane;
    mine += __popc(__ballot_sync(kFull, s < hi && mrow[s]));
  }
  if (lane == 0) count[warp] = mine;
  __syncthreads();
  int rank = 0, n = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    rank += w < warp ? count[w] : 0;
    n += count[w];
  }
  for (int s0 = lo; s0 < hi; s0 += 32) {
    const int s = s0 + lane;
    const bool seen = s < hi && mrow[s];
    const unsigned ballot = __ballot_sync(kFull, seen);
    if (seen) slot[rank + __popc(ballot & ((1u << lane) - 1u))] = s;
    rank += __popc(ballot);
  }
  if (n == 0) {  // nothing visible (a decode step always sees its own slot)
    for (int d = tid; d < D; d += kThreads) orow[d] = __float2bfloat16(0.f);
    return;
  }
  __syncthreads();

  // 2. scores, 16 lanes a row: lane c's dims in order, then one xor tree
  float qf[kPer];
  {
    const VecT raw = *reinterpret_cast<const VecT*>(q + ((long)bt * H + h) * D + c * kPer);
    const __nv_bfloat162* pair = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int e = 0; e < kPer / 2; ++e) {
      const float2 f = __bfloat1622float2(pair[e]);
      qf[2 * e] = f.x;
      qf[2 * e + 1] = f.y;
    }
  }
  const __nv_bfloat16* kb = k + ((long)b * S * KVH + kvh) * D + c * kPer;
  const __nv_bfloat16* vb = v + ((long)b * S * KVH + kvh) * D + c * kPer;
  float mx = -INFINITY;
  for (int r0 = 0; r0 < n; r0 += kGroups * kAhead) {  // the same trips for every lane
    VecT raw[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int r = min(r0 + u * kGroups + g, n - 1);
      raw[u] = *reinterpret_cast<const VecT*>(kb + slot[r] * kv_stride);
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const __nv_bfloat162* pair = reinterpret_cast<const __nv_bfloat162*>(&raw[u]);
      float acc = 0.f;
#pragma unroll
      for (int e = 0; e < kPer / 2; ++e) {
        const float2 f = __bfloat1622float2(pair[e]);
        acc = fmaf(qf[2 * e], f.x, acc);
        acc = fmaf(qf[2 * e + 1], f.y, acc);
      }
#pragma unroll
      for (int off = kLanesPerRow / 2; off > 0; off >>= 1)
        acc += __shfl_xor_sync(kFull, acc, off);  // a + b on both lanes: one value
      const int r = r0 + u * kGroups + g;
      if (r < n) {
        const float x = acc * scale;
        mx = fmaxf(mx, x);
        if (c == 0) p[r] = x;
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
  if (lane == 0) red[warp] = mx;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, red[w]);

  // 3. p and their sum, by rank
  float sum = 0.f;
  for (int r = tid; r < n; r += kThreads) {
    const float e = expf(p[r] - mx);
    p[r] = e;
    sum += e;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(kFull, sum, off);
  __syncthreads();  // every thread has read red's maxima
  if (lane == 0) red[warp] = sum;
  __syncthreads();
  sum = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) sum += red[w];
  for (int r = tid; r < n; r += kThreads) p[r] = __bfloat162float(__float2bfloat16(p[r] / sum));
  __syncthreads();

  // 4. p·v: group g adds ranks g, g + 8, ... in order, lane c its dims
  float acc[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) acc[j] = 0.f;
  for (int r0 = g; r0 < n; r0 += kGroups * kAhead) {
    VecT raw[kAhead];
    float pw[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int r = min(r0 + u * kGroups, n - 1);
      raw[u] = *reinterpret_cast<const VecT*>(vb + slot[r] * kv_stride);
      pw[u] = p[r];
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (r0 + u * kGroups >= n) break;
      const __nv_bfloat162* pair = reinterpret_cast<const __nv_bfloat162*>(&raw[u]);
#pragma unroll
      for (int e = 0; e < kPer / 2; ++e) {
        const float2 f = __bfloat1622float2(pair[e]);
        acc[2 * e] = fmaf(pw[u], f.x, acc[2 * e]);
        acc[2 * e + 1] = fmaf(pw[u], f.y, acc[2 * e + 1]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) part[g][c * kPer + j] = acc[j];
  __syncthreads();
  for (int d = tid; d < D; d += kThreads) {
    float o = part[0][d];
#pragma unroll
    for (int gg = 1; gg < kGroups; ++gg) o += part[gg][d];
    orow[d] = __float2bfloat16(o);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* mask, void* out,
                   int B, int T, int S, int H, int KVH, float scale, cudaStream_t st) {
  const size_t smem = (size_t)S * (sizeof(int) + sizeof(float));
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(decode_attention_kernel<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
  }
  decode_attention_kernel<D><<<dim3(B * T, H), kThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const uint8_t*>(mask),
      static_cast<__nv_bfloat16*>(out), T, S, H, KVH, scale);
  return cudaGetLastError();
}

}  // namespace

// q [B, T, H, D], k and v [B, S, KVH, D] (bf16, contiguous), mask [B, T, S]
// (bool as bytes) → out [B, T, H, D] bf16. S up to 27648 (216 KB of ranks
// and probabilities).
extern "C" int tst_decode_attention(const void* q, const void* k, const void* v,
                                    const void* mask, void* out, int B, int T, int S, int H,
                                    int KVH, int D, float scale, int device, void* stream) {
  if (B <= 0 || T <= 0 || S <= 0 || S > 27648 || H <= 0 || KVH <= 0 || H % KVH != 0 ||
      device < 0 || device >= kMaxDevices) {
    return (int)cudaErrorInvalidValue;
  }
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err == cudaSuccess && cur != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return (int)launch<64>(q, k, v, mask, out, B, T, S, H, KVH, scale, st);
    case 128: return (int)launch<128>(q, k, v, mask, out, B, T, S, H, KVH, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
