// The port's own copy of tst/native/csrc/fast_pack.cpp: the port builds
// and loads this file, never the JAX package's library.
// Native byte-tokenization + fixed-shape packing (tst_torch.native.fast_pack).
//
// The TPU host in this deployment has a single CPU core; packing thousands
// of 100k-character VideoMME transcripts through the Python loop in
// tst_torch/data/tokenize.py dominates pipeline startup. This kernel performs the
// exact same packing — BOS + UTF-8 bytes, head-truncating the prompt while
// preserving its answerable tail, loss mask over target+EOS — in one pass
// over contiguous buffers, called via ctypes (no pybind11 in this image).
//
// Semantics MUST stay byte-identical to tokenize_dataset(ByteTokenizer());
// tests/test_torch_native_pack.py asserts exact equality on every output array.

#include <cstdint>
#include <cstring>
#include <algorithm>

extern "C" {

// Returns 0 on success, -(1+i) if sample i cannot fit its target in L.
//
//  prompts / targets: concatenated UTF-8 bytes of the already-rendered
//  blind prompts and answer targets (leading target space folded into the
//  prompt by the caller, exactly like ByteTokenizer.encode_example).
//  p_off / t_off: n+1 offsets into those buffers.
//  Outputs are preallocated by the caller: tokens [n*L] int32 (prefilled is
//  NOT required), loss_mask [n*L] float32, answer_pos/lengths [n] int32.
int pack_byte_batch(
    const uint8_t* prompts, const int64_t* p_off,
    const uint8_t* targets, const int64_t* t_off,
    int64_t n, int64_t L,
    int32_t pad_id, int32_t bos_id, int32_t eos_id,
    int32_t* tokens, float* loss_mask, int32_t* answer_pos,
    int32_t* lengths) {
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t* p = prompts + p_off[i];
    int64_t p_len = p_off[i + 1] - p_off[i] + 1;  // +1: BOS
    const uint8_t* t = targets + t_off[i];
    int64_t t_len = t_off[i + 1] - t_off[i] + 1;  // +1: EOS

    int32_t* row = tokens + i * L;
    float* mrow = loss_mask + i * L;
    std::fill(row, row + L, pad_id);
    std::fill(mrow, mrow + L, 0.0f);

    int64_t drop = 0;  // head-truncation of the prompt's byte payload
    if (p_len + t_len > L) {
      int64_t keep = L - t_len;           // prompt tokens kept (incl. BOS)
      if (keep < 8) return (int)(-(1 + i));
      drop = p_len - keep;                // bytes dropped after BOS
    }
    int64_t pk = p_len - drop;            // kept prompt length incl. BOS
    row[0] = bos_id;
    for (int64_t j = 1; j < pk; ++j) row[j] = (int32_t)p[drop + j - 1];
    for (int64_t j = 0; j < t_len - 1; ++j) {
      row[pk + j] = (int32_t)t[j];
      mrow[pk + j] = 1.0f;
    }
    row[pk + t_len - 1] = eos_id;
    mrow[pk + t_len - 1] = 1.0f;
    answer_pos[i] = (int32_t)(pk - 1);
    lengths[i] = (int32_t)(pk + t_len);
  }
  return 0;
}

}  // extern "C"
