// Segment starts of packed rows, shared by the flash-attention kernels of
// this directory.
//
// A packed row holds up to kMaxSegs samples end to end; its starts are an
// int32 [B, kMaxSegs] device array, ascending, unused slots SEG_PAD = 1 << 30
// (tst/kernels/flash_attention.py:159,166). Query row i attends to column j
// iff j <= i and j >= seg_start(i): the largest start <= i, and 0 when no
// start is <= i (`_seg_start_vec` :197, `segment_mask` :1360). So an all-SEG_PAD
// row, or the [0, SEG_PAD, ...] padding rows of the packer, act as one
// segment starting at 0. seg_start(i) is nondecreasing in i for any order of
// the starts, so a tile's first row has its smallest start and its last row
// its largest.
//
// Each thread scans the kMaxSegs starts of its batch row itself (they are
// 32 bytes, read through L1) rather than reading a [B, S] per-position start
// vector: that would cost the wrapper one more device op and array per call,
// and the kernels need the start of only a few rows each.
#pragma once

namespace {

constexpr int kMaxSegs = 8;

// largest start <= pos, or 0 when none is
__device__ __forceinline__ int seg_start(const int* __restrict__ starts, int pos) {
  int st = 0;
#pragma unroll
  for (int j = 0; j < kMaxSegs; ++j) {
    const int s = starts[j];
    if (s <= pos && s > st) st = s;
  }
  return st;
}

// smallest start > pos, or S when none is: the first row that no longer sees
// column pos (nor any column before it)
__device__ __forceinline__ int seg_end(const int* __restrict__ starts, int pos, int S) {
  int end = S;
#pragma unroll
  for (int j = 0; j < kMaxSegs; ++j) {
    const int s = starts[j];
    if (s > pos && s < end) end = s;
  }
  return end;
}

}  // namespace
