// Block-sparse attention for training on Hopper (sm_90a), hand-written CUDA,
// fp32: a forward (out + lse), a dq pass and a dk/dv pass over the live
// 64 x 64 tiles of a block-sparse layout.
//
// Replaces, for fp32 inputs, the Pallas TPU kernels of deepspeed_tpu/ops/
// pallas/block_sparse_attention.py:
//   * _bs_fwd (_bs_kernel, K/V resident in VMEM) and _bs_fwd_gather
//     (_bs_gather_kernel, one live K/V block a grid step)
//     -> block_sparse_fwd_kernel.  The resident/gather split was a VMEM
//     capacity artifact: here one kernel stages one live tile at a time in
//     shared memory, at any S;
//   * _sparse_bwd_pallas, dq pass (_bs_bwd_dq_kernel, the flat live-tile
//     list row-major) -> block_sparse_bwd_dq_kernel;
//   * _sparse_bwd_pallas, dk/dv pass (_bs_bwd_dkv_kernel, the list
//     column-major) -> block_sparse_bwd_dkv_kernel.
// fp32 is the parity dtype (TF32 products would keep ~3 digits).  In bf16
// and fp16 all three run on the tensor cores (block_sparse_attention_mma.cu);
// the C entry points below choose by the dtype.  The arguments and
// cell-mask helpers both files use are in block_sparse_common.cuh.
//
// Layout: q, k, v, out, dq, dk, dv are [B, S, H, D]; lse and delta fp32
// [B, H, S].  The host plan (ops/kernels/block_sparse_attention.py TilePlan)
// gives, for layout head hh = (b * H + h) % layout_heads and tile i, the live
// list ptr[hh * nt + i] .. ptr[hh * nt + i + 1]: idx[e] is the walked tile
// (a k tile in the forward and the dq pass, a q tile in the dk/dv pass) and
// masks[e * words ..] its cell mask, a bit grid over sub-blocks of
// 1 << mask_shift tokens (bit (r >> shift) * (64 >> shift) + (c >> shift) for
// tile row r, tile column c; words = 64 >> 2 * shift).  order[hh * nt ..]
// lists each head's tiles longest list first: block y takes tile
// order[hh * nt + y].
//
// Semantics (as _keep_tile and _tile_update): a key is live for a query when
// both lie below S, the mask bit is set and, under causal, q >= k.  Scores
// are s = q . k / sqrt(D); masked probabilities are exactly 0; a row with no
// live key gets out 0 and lse 1e30, and dq 0; a key no live query reaches
// gets dk = dv = 0 (an empty list writes zeros, so no zeroing pass follows).
//
// What bounds it: the operations.  Per live (q, k) pair the forward does
// 4 D flops, the dq pass 6 D, the dk/dv pass 8 D, and every tile staged from
// device memory meets 64 rows of work.  In fp32 FMAs (this kernel) it runs
// far below the tensor cores' rate, as the flash kernels do; and the walk is
// uneven: global rows and columns of a BigBird or Fixed layout walk every
// tile while the others walk a few, so the longest block sets the time.
//
// The design, first right and simple (the 16-bit kernels on the tensor
// cores are in block_sparse_attention_mma.cu; a balanced, persistent
// schedule is later work):
//   * the flash kernels' skeleton (attention_tile.cuh): one block per
//     (b * H + h, 64-row tile), G = D / 16 lanes a row, the walked tile
//     staged in shared memory as fp32 (zero past S);
//   * the walk follows the row's (or column's) live list instead of a
//     contiguous range; the cell mask rides in shared memory beside the
//     staged tile, and each thread folds its row's (or column's) bits, S
//     and causality into one 64-bit word a tile, so any cell size (1-token
//     to 256-token cells) costs one bit test a pair, and no [S, S] mask
//     exists anywhere;
//   * the blocks start longest list first (the plan's order), so the few
//     long rows of global cells and of the causal bottom do not start last
//     and leave the card idle behind them;
//   * the backward passes are split, as in JAX, so neither needs atomics.

#include "attention_tile.cuh"
#include "block_sparse_common.cuh"

namespace {

using BsArgs = bsparse::Args;
using bsparse::col_keep;
using bsparse::kMaxMaskWords;
using bsparse::Pass;
using bsparse::row_keep;
using bsparse::stage_mask;
using bsparse::kDkv;
using bsparse::kDq;
using bsparse::kFwd;

// ---------------------------------------------------------------------------
// forward: block (b * H + h, q tile); out [B, S, H, D], lse [B, H, S]
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kTile * D / kDimsPerLane)
block_sparse_fwd_kernel(BsArgs a) {
  constexpr int G = D / kDimsPerLane;
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);
  float* v_s = k_s + kTile * D;
  unsigned long long* mask_s =
      reinterpret_cast<unsigned long long*>(v_s + kTile * D);

  const int bh = blockIdx.x, hh = bh % a.layout_heads;
  const int b = bh / a.H, h = bh % a.H;
  const int qi = a.order[hh * gridDim.y + blockIdx.y];
  const int list = hh * gridDim.y + qi;
  const int r = threadIdx.x / G, sub = threadIdx.x % G;
  const int qpos = qi * kTile + r;
  const bool row_ok = qpos < a.S;
  const size_t stride = (size_t)a.H * D;
  const size_t base = ((size_t)b * a.S * a.H + h) * D;
  const T* q = static_cast<const T*>(a.q) + base;
  const T* k = static_cast<const T*>(a.k) + base;
  const T* v = static_cast<const T*>(a.v) + base;

  float qr[kChunks][4], acc[kChunks][4];
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i) { qr[c][i] = 0.f; acc[c][i] = 0.f; }
  if (row_ok) load_row<T, G>(q + (size_t)qpos * stride, sub, qr);
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i) qr[c][i] *= a.scale;

  float m = -INFINITY, l = 0.f;
  const int e1 = a.ptr[list + 1];
  for (int e = a.ptr[list]; e < e1; ++e) {
    const int kt = a.idx[e];
    __syncthreads();  // the previous tile is no longer read
    stage_tile<T, D>(k, stride, kt * kTile, a.S, k_s);
    stage_tile<T, D>(v, stride, kt * kTile, a.S, v_s);
    stage_mask(a, e, mask_s);
    __syncthreads();
    const unsigned long long live = row_keep(mask_s, r, qpos, kt, a);
#pragma unroll
    for (int half = 0; half < kTile / kSub; ++half) {
      float s[kSub];
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        const int kk = half * kSub + j;
        float kr[kChunks][4];
        read_staged<D, G>(k_s, kk, sub, kr);
        const float dotp = group_sum<G>(dot(qr, kr));
        s[j] = (live >> kk) & 1ull ? dotp : -INFINITY;
        tmax = fmaxf(tmax, s[j]);
      }
      const float m_new = fmaxf(m, tmax);
      if (m_new == -INFINITY) continue;  // no live key for this row yet
      const float alpha = m == -INFINITY ? 0.f : expf(m - m_new);
      l *= alpha;
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[c][i] *= alpha;
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        const float p = s[j] == -INFINITY ? 0.f : expf(s[j] - m_new);
        l += p;
        float vr[kChunks][4];
        read_staged<D, G>(v_s, half * kSub + j, sub, vr);
        axpy(p, vr, acc);
      }
      m = m_new;
    }
  }
  if (row_ok) {
    T* out = static_cast<T*>(a.out0) + base + (size_t)qpos * stride;
    store_row<T, G>(out, sub, acc, l > 0.f ? 1.f / l : 0.f);
    if (sub == 0)
      a.lse_out[(size_t)bh * a.S + qpos] = l > 0.f ? m + logf(l) : kNoKeyLse;
  }
}

// ---------------------------------------------------------------------------
// dq pass: block (b * H + h, q tile); dq = scale * sum_k p (dp - delta) k
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kTile * D / kDimsPerLane)
block_sparse_bwd_dq_kernel(BsArgs a) {
  constexpr int G = D / kDimsPerLane;
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);
  float* v_s = k_s + kTile * D;
  unsigned long long* mask_s =
      reinterpret_cast<unsigned long long*>(v_s + kTile * D);

  const int bh = blockIdx.x, hh = bh % a.layout_heads;
  const int b = bh / a.H, h = bh % a.H;
  const int qi = a.order[hh * gridDim.y + blockIdx.y];
  const int list = hh * gridDim.y + qi;
  const int r = threadIdx.x / G, sub = threadIdx.x % G;
  const int qpos = qi * kTile + r;
  const bool row_ok = qpos < a.S;
  const size_t stride = (size_t)a.H * D;
  const size_t base = ((size_t)b * a.S * a.H + h) * D;
  const T* k = static_cast<const T*>(a.k) + base;
  const T* v = static_cast<const T*>(a.v) + base;

  float qr[kChunks][4], dor[kChunks][4], acc[kChunks][4];
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i) { qr[c][i] = 0.f; dor[c][i] = 0.f; acc[c][i] = 0.f; }
  float lse = 0.f, delta = 0.f;
  if (row_ok) {
    const size_t row = (size_t)qpos * stride;
    load_row<T, G>(static_cast<const T*>(a.q) + base + row, sub, qr);
    load_row<T, G>(static_cast<const T*>(a.dout) + base + row, sub, dor);
    lse = a.lse[(size_t)bh * a.S + qpos];
    delta = a.delta[(size_t)bh * a.S + qpos];
  }

  const int e1 = a.ptr[list + 1];
  for (int e = a.ptr[list]; e < e1; ++e) {
    const int kt = a.idx[e];
    __syncthreads();
    stage_tile<T, D>(k, stride, kt * kTile, a.S, k_s);
    stage_tile<T, D>(v, stride, kt * kTile, a.S, v_s);
    stage_mask(a, e, mask_s);
    __syncthreads();
    const unsigned long long live = row_keep(mask_s, r, qpos, kt, a);
#pragma unroll 2
    for (int kk = 0; kk < kTile; ++kk) {
      float kr[kChunks][4], vr[kChunks][4];
      read_staged<D, G>(k_s, kk, sub, kr);
      read_staged<D, G>(v_s, kk, sub, vr);
      const float s = group_sum<G>(dot(qr, kr));
      const float dp = group_sum<G>(dot(dor, vr));
      const float p = (live >> kk) & 1ull ? expf(s * a.scale - lse) : 0.f;
      axpy(p * (dp - delta), kr, acc);
    }
  }
  if (row_ok)  // an empty list leaves acc 0: the row's dq is written as 0
    store_row<T, G>(static_cast<T*>(a.out0) + base + (size_t)qpos * stride,
                    sub, acc, a.scale);
}

// ---------------------------------------------------------------------------
// dk/dv pass: block (b * H + h, k tile), walking the column's live q tiles;
//   dv = sum_q p do,  dk = scale * sum_q p (dp - delta) q
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kTile * D / kDimsPerLane)
block_sparse_bwd_dkv_kernel(BsArgs a) {
  constexpr int G = D / kDimsPerLane;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* do_s = q_s + kTile * D;
  float* lse_s = do_s + kTile * D;
  float* delta_s = lse_s + kTile;
  unsigned long long* mask_s =
      reinterpret_cast<unsigned long long*>(delta_s + kTile);

  const int bh = blockIdx.x, hh = bh % a.layout_heads;
  const int b = bh / a.H, h = bh % a.H;
  const int ki = a.order[hh * gridDim.y + blockIdx.y];
  const int list = hh * gridDim.y + ki;
  const int r = threadIdx.x / G, sub = threadIdx.x % G;
  const int kpos = ki * kTile + r;
  const bool row_ok = kpos < a.S;
  const size_t stride = (size_t)a.H * D;
  const size_t base = ((size_t)b * a.S * a.H + h) * D;
  const T* q = static_cast<const T*>(a.q) + base;
  const T* dout = static_cast<const T*>(a.dout) + base;

  float kr[kChunks][4], vr[kChunks][4], dk[kChunks][4], dv[kChunks][4];
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      kr[c][i] = 0.f; vr[c][i] = 0.f; dk[c][i] = 0.f; dv[c][i] = 0.f;
    }
  if (row_ok) {
    const size_t row = (size_t)kpos * stride;
    load_row<T, G>(static_cast<const T*>(a.k) + base + row, sub, kr);
    load_row<T, G>(static_cast<const T*>(a.v) + base + row, sub, vr);
  }

  const int e1 = a.ptr[list + 1];
  for (int e = a.ptr[list]; e < e1; ++e) {
    const int qt = a.idx[e];
    __syncthreads();
    stage_tile<T, D>(q, stride, qt * kTile, a.S, q_s);
    stage_tile<T, D>(dout, stride, qt * kTile, a.S, do_s);
    stage_vec<float>(a.lse + (size_t)bh * a.S, qt * kTile, a.S, lse_s);
    stage_vec<float>(a.delta + (size_t)bh * a.S, qt * kTile, a.S, delta_s);
    stage_mask(a, e, mask_s);
    __syncthreads();
    const unsigned long long live = col_keep(mask_s, r, kpos, qt, a);
#pragma unroll 1
    for (int qq = 0; qq < kTile; ++qq) {  // not unrolled: 64 live fp32 accumulators
      float qv[kChunks][4], dov[kChunks][4];
      read_staged<D, G>(q_s, qq, sub, qv);
      read_staged<D, G>(do_s, qq, sub, dov);
      const float s = group_sum<G>(dot(kr, qv));
      const float dp = group_sum<G>(dot(vr, dov));
      const float p = (live >> qq) & 1ull ? expf(s * a.scale - lse_s[qq])
                                          : 0.f;
      axpy(p, dov, dv);
      axpy(p * (dp - delta_s[qq]), qv, dk);
    }
  }
  if (row_ok) {  // an empty list leaves dk = dv = 0, written as such
    const size_t row = base + (size_t)kpos * stride;
    store_row<T, G>(static_cast<T*>(a.out0) + row, sub, dk, a.scale);
    store_row<T, G>(static_cast<T*>(a.out1) + row, sub, dv, 1.f);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <int D>
cudaError_t launch_d(Pass pass, const BsArgs& a, cudaStream_t stream) {
  const int threads = kTile * D / kDimsPerLane;
  const dim3 grid(a.B * a.H, (a.S + kTile - 1) / kTile);
  size_t smem = 2 * kTile * D * sizeof(float) +
                kMaxMaskWords * sizeof(unsigned long long);
  void (*kernel)(BsArgs) = block_sparse_fwd_kernel<float, D>;
  if (pass == kDq) {
    kernel = block_sparse_bwd_dq_kernel<float, D>;
  } else if (pass == kDkv) {
    kernel = block_sparse_bwd_dkv_kernel<float, D>;
    smem += 2 * kTile * sizeof(float);
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16, 2 = float16
cudaError_t launch(Pass pass, const BsArgs& a, int d, int dtype,
                   cudaStream_t stream) {
  if (a.B <= 0 || a.S <= 0 || a.H <= 0) return cudaGetLastError();
  if ((a.S + kTile - 1) / kTile > 65535) return cudaErrorInvalidValue;
  if (a.layout_heads != 1 && a.layout_heads != a.H) return cudaErrorInvalidValue;
  if (a.mask_shift < 0 || a.mask_shift > 3) return cudaErrorInvalidValue;
  if (dtype != 0)  // bf16, fp16: the tensor cores
    return bsparse::launch_mma(pass, a, d, dtype, stream);
  if (d == 64) return launch_d<64>(pass, a, stream);
  if (d == 128) return launch_d<128>(pass, a, stream);
  return cudaErrorInvalidValue;
}

BsArgs make_args(const void* q, const void* k, const void* v, const void* ptr,
                 const void* idx, const void* masks, const void* order, int B,
                 int S, int H, int d, int layout_heads, int causal,
                 int mask_shift) {
  BsArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.ptr = static_cast<const int*>(ptr);
  a.idx = static_cast<const int*>(idx);
  a.masks = static_cast<const unsigned long long*>(masks);
  a.order = static_cast<const int*>(order);
  a.B = B;
  a.S = S;
  a.H = H;
  a.layout_heads = layout_heads;
  a.causal = causal;
  a.mask_shift = mask_shift;
  a.scale = 1.0f / sqrtf(static_cast<float>(d));
  return a;
}

}  // namespace

extern "C" int ds_block_sparse_fwd(const void* q, const void* k,
                                   const void* v, const void* ptr,
                                   const void* idx, const void* masks,
                                   const void* order, void* out, void* lse,
                                   int B, int S, int H,
                                   int d, int layout_heads, int causal,
                                   int mask_shift, int dtype, void* stream) {
  BsArgs a = make_args(q, k, v, ptr, idx, masks, order, B, S, H, d,
                       layout_heads, causal, mask_shift);
  a.out0 = out;
  a.lse_out = static_cast<float*>(lse);
  return static_cast<int>(
      launch(kFwd, a, d, dtype, static_cast<cudaStream_t>(stream)));
}

extern "C" int ds_block_sparse_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      const void* ptr, const void* idx,
                                      const void* masks, const void* order,
                                      void* dq, int B,
                                      int S, int H, int d, int layout_heads,
                                      int causal, int mask_shift, int dtype,
                                      void* stream) {
  BsArgs a = make_args(q, k, v, ptr, idx, masks, order, B, S, H, d,
                       layout_heads, causal, mask_shift);
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.out0 = dq;
  return static_cast<int>(
      launch(kDq, a, d, dtype, static_cast<cudaStream_t>(stream)));
}

extern "C" int ds_block_sparse_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       const void* ptr, const void* idx,
                                       const void* masks, const void* order,
                                       void* dk, void* dv,
                                       int B, int S, int H, int d,
                                       int layout_heads, int causal,
                                       int mask_shift, int dtype,
                                       void* stream) {
  BsArgs a = make_args(q, k, v, ptr, idx, masks, order, B, S, H, d,
                       layout_heads, causal, mask_shift);
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.out0 = dk;
  a.out1 = dv;
  return static_cast<int>(
      launch(kDkv, a, d, dtype, static_cast<cudaStream_t>(stream)));
}
