// What the two families of flash-attention kernels share: their arguments,
// the live-key rule and the walk over the 64 x 64 tile lattice
// (ops/kernels/lattice.py, the JAX package's ops/pallas/lattice.py).
//
// flash_attention.cu holds the fp32 kernels (fp32 FMAs, the parity dtype)
// and the C entry points; flash_attention_mma.cu holds the bf16 and fp16
// kernels on the tensor cores.  The entry points choose by the dtype alone.

#pragma once

#include <cuda_runtime.h>

namespace flash {

constexpr int kTile = 64;  // rows of a block, keys/queries of a walked tile
constexpr float kNoKeyLse = 1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;   // backward only
  const float* lse;   // written by the forward, read by the backward
  const float* delta; // backward only
  const int* seg;     // [B, S] or null
  void* out0;         // forward: out; dq pass: dq; dk/dv pass: dk
  void* out1;         // dk/dv pass: dv
  float* lse_out;     // forward only
  int B, S, H;
  int causal;
  int window;         // <= 0: none
  float scale;
};

enum Pass { kFwd = 0, kDq = 1, kDkv = 2 };

// A key is live for a query when both lie below S, under causal q >= k,
// under a window q - k < W (and k - q < W without causal), and under
// segments equal ids.
__device__ __forceinline__ bool keep(int qpos, int kpos, const Args& a,
                                     int qseg, int kseg) {
  if (qpos >= a.S || kpos >= a.S) return false;
  if (a.causal && qpos < kpos) return false;
  if (a.window > 0) {
    const int diff = qpos - kpos;
    if (diff >= a.window) return false;
    if (!a.causal && -diff >= a.window) return false;
  }
  return a.seg == nullptr || qseg == kseg;
}

// lattice.kv_block_bounds with block_q = block_k = kTile
__device__ __forceinline__ void kv_bounds(int qi, int nk, const Args& a,
                                          int& k0, int& k1) {
  k1 = a.causal ? min(qi + 1, nk) : nk;
  k0 = 0;
  if (a.window > 0) {
    k0 = max(qi * kTile - (a.window - 1), 0) / kTile;
    if (!a.causal)
      k1 = min(k1, (qi * kTile + kTile - 1 + a.window + kTile - 1) / kTile);
  }
}

// lattice.q_block_bounds with block_q = block_k = kTile
__device__ __forceinline__ void q_bounds(int ki, int nq, const Args& a,
                                         int& q0, int& q1) {
  q0 = a.causal ? ki : 0;
  q1 = nq;
  if (a.window > 0) {
    q1 = min(nq, (ki * kTile + kTile - 1 + a.window + kTile - 1) / kTile);
    if (!a.causal) q0 = max(ki * kTile - (a.window - 1), 0) / kTile;
  }
}

// True unless every (q, k) pair of the tile is live: the diagonal and
// window-edge tiles, the tail tiles past S and every tile under segments.
__device__ __forceinline__ bool tile_needs_mask(int qt, int kt,
                                                const Args& a) {
  if (a.seg != nullptr) return true;
  const int q_lo = qt * kTile, q_hi = q_lo + kTile - 1;
  const int k_lo = kt * kTile, k_hi = k_lo + kTile - 1;
  if (q_hi >= a.S || k_hi >= a.S) return true;
  if (a.causal && k_hi > q_lo) return true;
  if (a.window > 0) {
    if (q_hi - k_lo >= a.window) return true;
    if (!a.causal && k_hi - q_lo >= a.window) return true;
  }
  return false;
}

// The tensor-core kernels (flash_attention_mma.cu); dtype 1 = bfloat16,
// 2 = float16.
cudaError_t launch_mma(Pass pass, const Args& a, int d, int dtype,
                       cudaStream_t stream);

}  // namespace flash
