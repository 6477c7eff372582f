// What the block-sparse kernels share: their arguments and the cell masks
// of a walked 64 x 64 tile (ops/kernels/block_sparse_attention.py TilePlan).
//
// block_sparse_attention.cu holds the fp32 kernels and the C entry points;
// block_sparse_attention_mma.cu holds the bf16 and fp16 forward and
// backward passes on the tensor cores.  The entry points choose by dtype.

#pragma once

#include <cuda_runtime.h>

namespace bsparse {

constexpr int kTile = 64;  // rows of a block, keys/queries of a walked tile
constexpr int kMaxMaskWords = 64;  // 1-token sub-blocks: 64 x 64 bits

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;   // backward only
  const float* lse;   // written by the forward, read by the backward
  const float* delta; // backward only
  const int* ptr;     // [layout_heads * nt + 1]
  const int* idx;     // [live]
  const unsigned long long* masks;  // [live, words]
  const int* order;   // [layout_heads * nt]: the tiles, longest list first
  void* out0;         // forward: out; dq pass: dq; dk/dv pass: dk
  void* out1;         // dk/dv pass: dv
  float* lse_out;     // forward only
  int B, S, H;
  int layout_heads;   // 1 (shared layout) or H
  int causal;
  int mask_shift;     // sub-blocks of 1 << mask_shift tokens
  float scale;
};

__device__ __forceinline__ int mask_words(int shift) {
  return kMaxMaskWords >> (2 * shift);
}

// Bits [lo, hi) of a 64-bit word (clamped to the tile).
__device__ __forceinline__ unsigned long long span_bits(int lo, int hi) {
  lo = max(lo, 0);
  hi = min(hi, kTile);
  if (hi <= lo) return 0ull;
  const unsigned long long upto = hi == kTile ? ~0ull : (1ull << hi) - 1ull;
  return upto & ~((1ull << lo) - 1ull);
}

// Bit c: the cell of (tile row r, tile column c) is live.  A row is
// (64 >> shift) consecutive bits of the mask, each for 1 << shift columns.
__device__ __forceinline__ unsigned long long row_bits(
    const unsigned long long* mask, int r, int shift) {
  if (shift == 0) return mask[r];
  const int per = kTile >> shift;
  const int first = (r >> shift) * per;
  const unsigned long long bits = mask[first >> 6] >> (first & 63);
  const unsigned long long unit = (1ull << (1 << shift)) - 1ull;
  unsigned long long out = 0ull;
  for (int j = 0; j < per; ++j)
    if ((bits >> j) & 1ull) out |= unit << (j << shift);
  return out;
}

// Bit r: the cell of (tile row r, tile column c) is live.
__device__ __forceinline__ unsigned long long col_bits(
    const unsigned long long* mask, int c, int shift) {
  const int per = kTile >> shift;
  const int col = c >> shift;
  const unsigned long long unit = (1ull << (1 << shift)) - 1ull;
  unsigned long long out = 0ull;
  for (int i = 0; i < per; ++i) {
    const int bit = i * per + col;
    if ((mask[bit >> 6] >> (bit & 63)) & 1ull) out |= unit << (i << shift);
  }
  return out;
}

// The live keys of query qpos (tile row r) in k tile kt: its cells, S and
// causality, bit c for key kt * 64 + c.
__device__ __forceinline__ unsigned long long row_keep(
    const unsigned long long* mask, int r, int qpos, int kt,
    const Args& a) {
  if (qpos >= a.S) return 0ull;
  const int k0 = kt * kTile;
  return row_bits(mask, r, a.mask_shift) &
         span_bits(0, a.causal ? min(a.S, qpos + 1) - k0 : a.S - k0);
}

// The live queries of key kpos (tile column c) in q tile qt, bit r for query
// qt * 64 + r.
__device__ __forceinline__ unsigned long long col_keep(
    const unsigned long long* mask, int c, int kpos, int qt,
    const Args& a) {
  if (kpos >= a.S) return 0ull;
  const int q0 = qt * kTile;
  return col_bits(mask, c, a.mask_shift) &
         span_bits(a.causal ? kpos - q0 : 0, a.S - q0);
}

__device__ __forceinline__ void stage_mask(const Args& a, int e,
                                           unsigned long long* mask_s) {
  const int words = mask_words(a.mask_shift);
  for (int t = threadIdx.x; t < words; t += blockDim.x)
    mask_s[t] = a.masks[(size_t)e * words + t];
}


enum Pass { kFwd = 0, kDq = 1, kDkv = 2 };

// The tensor-core kernels (block_sparse_attention_mma.cu); dtype 1 =
// bfloat16, 2 = float16.
cudaError_t launch_mma(Pass pass, const Args& a, int d, int dtype,
                       cudaStream_t stream);

}  // namespace bsparse
