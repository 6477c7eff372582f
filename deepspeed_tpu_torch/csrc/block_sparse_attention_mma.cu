// Block-sparse attention for Hopper (sm_90a), bf16 and fp16, on the tensor
// cores: a forward (out + lse), a dq pass and a dk/dv pass over the live
// 64 x 64 tiles of a block-sparse layout.
//
// Replaces, for 16-bit inputs, the Pallas TPU kernels of
// deepspeed_tpu/ops/pallas/block_sparse_attention.py:
//   * _bs_fwd_gather (_bs_gather_kernel, :335) and _bs_fwd (_bs_kernel,
//     :523) -> block_sparse_fwd_mma_kernel, one kernel for every S (the
//     resident/gather split was a VMEM capacity artifact);
//   * _sparse_bwd_pallas, its dq pass (_bs_bwd_dq_kernel, the flat
//     live-tile list row-major) -> block_sparse_bwd_dq_mma_kernel;
//   * its dk/dv pass (_bs_bwd_dkv_kernel, the list column-major)
//     -> block_sparse_bwd_dkv_mma_kernel.
// fp32 inputs stay on the fp32-FMA kernels of block_sparse_attention.cu,
// whose C entry points choose by the dtype.  Layout, plan, masks and
// semantics are those kernels' (block_sparse_common.cuh): masked
// probabilities are exactly 0, a row with no live key gets out 0, lse 1e30
// and dq 0, a key that no live query reaches gets dk = dv = 0, an empty
// list writes zeros.
//
// What bounds it: the forward, the bytes at the training shape (B 2, S 4096,
// h 16, d 64, BigBird cells of 128, causal): it reads each live K/V tile
// once per q tile, and 4 D flops a live pair over 989 TFLOP/s come to less
// than q, k, v, out and lse over 3.35 TB/s (chip_smoke.py attention_bounds);
// the backward, the operations: per live (q, k) pair the dq pass does 6 D
// flops and the dk/dv pass 8 D (each recomputes the scores; the split dS
// adds 2 D to each), and every tile staged from device memory meets 64 rows
// of work, so only the tensor cores come near the bound.
//
// The design: the flash kernels' tile (flash_attention_mma.cu), walking a
// live list instead of a causal range:
//   * one block of 4 warps per (b * H + h, 64-row tile); each warp owns 16
//     query rows (forward, dq pass) or 16 keys (dk/dv pass).  The block
//     walks its tile's live list (the plan's ptr / idx: k tiles row-major
//     for the forward and dq, q tiles column-major for dk/dv); blocks start
//     longest list first (the plan's order), so the long lists of global
//     rows and columns do not start last.  The passes are split, as in JAX:
//     no atomics;
//   * operands stay 16-bit in shared memory (rows padded by 8 elements for
//     conflict-free ldmatrix); the next live tile, its lse and delta (dk/dv)
//     and its cell mask are staged by cp.async one list entry ahead,
//     double-buffered, rows past S zero-filled by the src-size operand, so
//     no K/V tile is read twice by a block and the loads of entry e + 1
//     overlap the products of entry e;
//   * every product is mma.sync m16n8k16 with fp32 accumulators.  Forward:
//     S = Q.K^T, the online softmax on the accumulator fragment (exp2 with
//     the scale folded in, row max and sum across the quad), p rounded to
//     16 bits in registers as the A fragment of O += P.V (the plain
//     version's rounding); a row whose walked tiles so far hold no live key
//     keeps its running max at -inf and takes no exp(-inf - -inf).  dq pass:
//     S = Q.K^T, P = exp(S * scale - lse), dP = dO.V^T, dS = P (dP -
//     delta), dQ += dS.K.  dk/dv pass: S^T = K.Q^T and dP^T = V.dO^T, so
//     P^T and dS^T are A fragments, dV += P^T.dO, dK += dS^T.Q, lse and
//     delta read per column.  P is rounded to 16 bits as an operand; dS
//     goes in as hi = round(dS) and lo = round(dS - hi), both on the same B
//     fragments (mma::acc_to_a_split), as JAX keeps ds in fp32;
//   * masks on the fragment, only on tiles that are not wholly live (a
//     cell mask with a clear bit, the causal diagonal, the S tail): a row's
//     (key's) cell bits, S and causality fold into one 64-bit word a tile
//     (row_keep / col_keep), and one bit is tested an element.  The forward
//     and the dq pass keep their rows' two words in registers; the dk/dv
//     pass folds the block's 64 key words into shared memory once a tile
//     and reads them where it tests them;
//   * registers: at d 128 the backward passes re-read the block's resident
//     operands from shared memory for each tile and the dk/dv pass takes 16
//     queries a step, its four steps rolled, as in flash, so no pass spills
//     (chip_smoke.py's build phase fails on a spill).
// Not done here (later work): the list imbalance.  The longest row list is
// 7.9x the mean at S 4096 and 61x at S 32768, and one block walks it alone;
// splitting long lists over blocks needs a merge of partial rows.

#include "block_sparse_common.cuh"
#include "flash_common.cuh"
#include "mma_tile.cuh"

#include <math.h>

#include <type_traits>

namespace {

using bsparse::Args;
using bsparse::kMaxMaskWords;
using mma::Op;
using mma::stage_rows;
using mma::stage_vec;
using mma::store_rows;

constexpr int kTile = flash::kTile;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kTile == bsparse::kTile && kTile == mma::kTileRows &&
                  kThreads == mma::kBlockThreads,
              "one tile and block for the families and the helpers");

// List entry e's cell mask (words 64-bit words) into a shared stage, as
// 4-byte cp.async copies.
__device__ __forceinline__ void stage_mask_async(unsigned long long* dst,
                                                 const Args& a, int e,
                                                 int words) {
  const unsigned* src =
      reinterpret_cast<const unsigned*>(a.masks + (size_t)e * words);
  unsigned* d32 = reinterpret_cast<unsigned*>(dst);
  for (int t = threadIdx.x; t < 2 * words; t += kThreads)
    mma::cp_async4(d32 + t, src + t, true);
}

// Every (q, k) pair of tile (qt, kt) is live: all cell bits set, both tiles
// inside S and, under causal, the tile wholly below the diagonal.
__device__ __forceinline__ bool tile_full(const unsigned long long* mask,
                                          int words, int qt, int kt,
                                          const Args& a) {
  if ((qt + 1) * kTile > a.S || (kt + 1) * kTile > a.S) return false;
  if (a.causal && kt >= qt) return false;
  for (int w = 0; w < words; ++w)
    if (mask[w] != ~0ull) return false;
  return true;
}

// ---------------------------------------------------------------------------
// forward: block (b * H + h, q tile from the plan's order), walking the
// row's live k tiles; out [B, S, H, D], lse [B, H, S]
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
block_sparse_fwd_mma_kernel(Args a) {
  constexpr int LD = D + 8, KC = D / 16, NT = kTile / 8, DT = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);
  T* k_s = q_s + kTile * LD;          // [2][kTile][LD]
  T* v_s = k_s + 2 * kTile * LD;      // [2][kTile][LD]
  unsigned long long* mask_s =        // [2][kMaxMaskWords]
      reinterpret_cast<unsigned long long*>(v_s + 2 * kTile * LD);

  const int bh = blockIdx.x, hh = bh % a.layout_heads;
  const int b = bh / a.H, h = bh % a.H;
  const int qi = a.order[hh * gridDim.y + blockIdx.y];
  const int list = hh * gridDim.y + qi;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const size_t stride = (size_t)a.H * D;
  const size_t base = ((size_t)b * a.S * a.H + h) * D;
  const T* k = static_cast<const T*>(a.k) + base;
  const T* v = static_cast<const T*>(a.v) + base;
  const int words = bsparse::mask_words(a.mask_shift);
  const int row0 = qi * kTile + warp * 16;  // this warp's first query

  const int e0 = a.ptr[list], e1 = a.ptr[list + 1];
  stage_rows<T, D>(q_s, static_cast<const T*>(a.q) + base, stride,
                   qi * kTile, a.S);
  if (e0 < e1) {
    const int kt = a.idx[e0];
    stage_rows<T, D>(k_s, k, stride, kt * kTile, a.S);
    stage_rows<T, D>(v_s, v, stride, kt * kTile, a.S);
    stage_mask_async(mask_s, a, e0, words);
  }
  mma::cp_async_commit();

  const float sl2 = a.scale * kLog2e;
  float o[DT][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[n][i] = 0.f;
  uint32_t qf[KC][4];

  for (int e = e0; e < e1; ++e) {
    const int st = (e - e0) & 1;
    const int kt = a.idx[e];
    if (e + 1 < e1) {  // the next live tile loads while this one computes
      const int nx = a.idx[e + 1] * kTile;
      stage_rows<T, D>(k_s + (st ^ 1) * kTile * LD, k, stride, nx, a.S);
      stage_rows<T, D>(v_s + (st ^ 1) * kTile * LD, v, stride, nx, a.S);
      stage_mask_async(mask_s + (st ^ 1) * kMaxMaskWords, a, e + 1, words);
      mma::cp_async_commit();
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    __syncthreads();
    if (e == e0) {
#pragma unroll
      for (int c = 0; c < KC; ++c)
        mma::load_a(qf[c], q_s, LD, warp * 16, c * 16, lane);
    }
    const T* ks = k_s + st * kTile * LD;
    const T* vs = v_s + st * kTile * LD;
    const unsigned long long* ms = mask_s + st * kMaxMaskWords;

    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
#pragma unroll
    for (int c = 0; c < KC; ++c)
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        uint32_t bf[4];
        mma::load_b_nk(bf, ks, LD, n * 8, c * 16, lane);
        Op<T>::mma(s[n], qf[c], bf[0], bf[1]);
        Op<T>::mma(s[n + 1], qf[c], bf[2], bf[3]);
      }

    // on a tile that is not wholly live, bit kc of the row's keep word
    // decides; a masked score is -inf, so its probability is exactly 0
    if (!tile_full(ms, words, qi, kt, a)) {
      unsigned long long keep[2];
#pragma unroll
      for (int r = 0; r < 2; ++r)
        keep[r] = bsparse::row_keep(ms, warp * 16 + g + 8 * r,
                                    row0 + g + 8 * r, kt, a);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (!((keep[i >> 1] >> (n * 8 + 2 * t4 + (i & 1))) & 1ull))
            s[n][i] = -INFINITY;
    }

    // online softmax on the fragment: rows g (i = 0, 1) and g + 8 (2, 3)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int n = 0; n < NT; ++n)
        mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // no live key for this row yet: keep everything at 0, no -inf - -inf
      const float m_use = mx == -INFINITY ? 0.f : mx;
      const float alpha = exp2f((m[r] - m_use) * sl2);
      const float off = m_use * sl2;
      m[r] = mx;
      float rs = 0.f;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float p = exp2f(fmaf(s[n][2 * r + j], sl2, -off));
          s[n][2 * r + j] = p;
          rs += p;
        }
      l[r] = l[r] * alpha + rs;  // this lane's part; the quad sums at the end
#pragma unroll
      for (int n = 0; n < DT; ++n) {
        o[n][2 * r] *= alpha;
        o[n][2 * r + 1] *= alpha;
      }
    }

    // O += P.V, p rounded to 16 bits in registers
#pragma unroll
    for (int c = 0; c < NT / 2; ++c) {
      uint32_t pa[4];
      mma::acc_to_a<T>(pa, s, c);
#pragma unroll
      for (int n = 0; n < DT; n += 2) {
        uint32_t bf[4];
        mma::load_b_kn(bf, vs, LD, n * 8, c * 16, lane);
        Op<T>::mma(o[n], pa, bf[0], bf[1]);
        Op<T>::mma(o[n + 1], pa, bf[2], bf[3]);
      }
    }
    __syncthreads();  // this stage is free for the load after next
  }
  mma::cp_async_wait<0>();  // an empty list staged Q all the same

  // an empty list, or a row with no live key, leaves l 0: out 0, lse 1e30
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = l[r] > 0.f ? 1.f / l[r] : 0.f;
    const int row = row0 + g + 8 * r;
    if (t4 == 0 && row < a.S)
      a.lse_out[(size_t)bh * a.S + row] =
          l[r] > 0.f ? m[r] * a.scale + logf(l[r]) : flash::kNoKeyLse;
  }
  store_rows<T, D>(static_cast<T*>(a.out0) + base, stride, row0, a.S, o,
                   inv[0], inv[1], lane);
}

// ---------------------------------------------------------------------------
// dq pass: block (b * H + h, q tile from the plan's order), walking the
// row's live k tiles; dq = scale * sum_k p (dp - delta) k
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
block_sparse_bwd_dq_mma_kernel(Args a) {
  constexpr int LD = D + 8, KC = D / 16, NT = kTile / 8, DT = D / 8;
  constexpr bool kHoldFrags = D <= 64;  // Q and dO fragments in registers
  extern __shared__ __align__(16) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);
  T* do_s = q_s + kTile * LD;
  T* k_s = do_s + kTile * LD;         // [2][kTile][LD]
  T* v_s = k_s + 2 * kTile * LD;      // [2][kTile][LD]
  unsigned long long* mask_s =        // [2][kMaxMaskWords]
      reinterpret_cast<unsigned long long*>(v_s + 2 * kTile * LD);

  const int bh = blockIdx.x, hh = bh % a.layout_heads;
  const int b = bh / a.H, h = bh % a.H;
  const int qi = a.order[hh * gridDim.y + blockIdx.y];
  const int list = hh * gridDim.y + qi;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const size_t stride = (size_t)a.H * D;
  const size_t base = ((size_t)b * a.S * a.H + h) * D;
  const T* k = static_cast<const T*>(a.k) + base;
  const T* v = static_cast<const T*>(a.v) + base;
  const int words = bsparse::mask_words(a.mask_shift);
  const int row0 = qi * kTile + warp * 16;  // this warp's first query
  float lse_l2[2] = {0.f, 0.f}, delta[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row < a.S) {
      lse_l2[r] = a.lse[(size_t)bh * a.S + row] * kLog2e;
      delta[r] = a.delta[(size_t)bh * a.S + row];
    }
  }

  const int e0 = a.ptr[list], e1 = a.ptr[list + 1];
  stage_rows<T, D>(q_s, static_cast<const T*>(a.q) + base, stride,
                   qi * kTile, a.S);
  stage_rows<T, D>(do_s, static_cast<const T*>(a.dout) + base, stride,
                   qi * kTile, a.S);
  if (e0 < e1) {
    const int kt = a.idx[e0];
    stage_rows<T, D>(k_s, k, stride, kt * kTile, a.S);
    stage_rows<T, D>(v_s, v, stride, kt * kTile, a.S);
    stage_mask_async(mask_s, a, e0, words);
  }
  mma::cp_async_commit();

  const float sl2 = a.scale * kLog2e;
  float dq[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dq[n][i] = 0.f;
  uint32_t qf[kHoldFrags ? KC : 1][4], dof[kHoldFrags ? KC : 1][4];

  for (int e = e0; e < e1; ++e) {
    const int st = (e - e0) & 1;
    const int kt = a.idx[e];
    if (e + 1 < e1) {  // the next live tile loads while this one computes
      const int nx = a.idx[e + 1] * kTile;
      stage_rows<T, D>(k_s + (st ^ 1) * kTile * LD, k, stride, nx, a.S);
      stage_rows<T, D>(v_s + (st ^ 1) * kTile * LD, v, stride, nx, a.S);
      stage_mask_async(mask_s + (st ^ 1) * kMaxMaskWords, a, e + 1, words);
      mma::cp_async_commit();
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (kHoldFrags) {
      if (e == e0) {
#pragma unroll
        for (int c = 0; c < KC; ++c) {
          mma::load_a(qf[c], q_s, LD, warp * 16, c * 16, lane);
          mma::load_a(dof[c], do_s, LD, warp * 16, c * 16, lane);
        }
      }
    }
    const T* ks = k_s + st * kTile * LD;
    const T* vs = v_s + st * kTile * LD;
    const unsigned long long* ms = mask_s + st * kMaxMaskWords;

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) { s[n][i] = 0.f; dp[n][i] = 0.f; }
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      uint32_t af[4], bf[4];
      if constexpr (kHoldFrags) {
#pragma unroll
        for (int i = 0; i < 4; ++i) af[i] = qf[c][i];
      } else {
        mma::load_a(af, q_s, LD, warp * 16, c * 16, lane);
      }
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        mma::load_b_nk(bf, ks, LD, n * 8, c * 16, lane);
        Op<T>::mma(s[n], af, bf[0], bf[1]);
        Op<T>::mma(s[n + 1], af, bf[2], bf[3]);
      }
      if constexpr (kHoldFrags) {
#pragma unroll
        for (int i = 0; i < 4; ++i) af[i] = dof[c][i];
      } else {
        mma::load_a(af, do_s, LD, warp * 16, c * 16, lane);
      }
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        mma::load_b_nk(bf, vs, LD, n * 8, c * 16, lane);
        Op<T>::mma(dp[n], af, bf[0], bf[1]);
        Op<T>::mma(dp[n + 1], af, bf[2], bf[3]);
      }
    }

    // P = exp(s * scale - lse), dS = P (dP - delta), kept in s; on a tile
    // that is not wholly live, bit kc of the row's keep word decides
    if (!tile_full(ms, words, qi, kt, a)) {
      unsigned long long keep[2];
#pragma unroll
      for (int r = 0; r < 2; ++r)
        keep[r] = bsparse::row_keep(ms, warp * 16 + g + 8 * r,
                                    row0 + g + 8 * r, kt, a);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = i >> 1, kc = n * 8 + 2 * t4 + (i & 1);
          const float p = (keep[r] >> kc) & 1ull
                              ? exp2f(fmaf(s[n][i], sl2, -lse_l2[r]))
                              : 0.f;
          s[n][i] = p * (dp[n][i] - delta[r]);
        }
    } else {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = i >> 1;
          s[n][i] = exp2f(fmaf(s[n][i], sl2, -lse_l2[r])) *
                    (dp[n][i] - delta[r]);
        }
    }

    // dQ += dS.K, dS as two 16-bit parts (hi.K + lo.K on the same K
    // fragments): dS keeps fp32's precision through the product
#pragma unroll
    for (int c = 0; c < NT / 2; ++c) {
      uint32_t sh[4], sl[4];
      mma::acc_to_a_split<T>(sh, sl, s, c);
#pragma unroll
      for (int n = 0; n < DT; n += 2) {
        uint32_t bf[4];
        mma::load_b_kn(bf, ks, LD, n * 8, c * 16, lane);
        Op<T>::mma(dq[n], sh, bf[0], bf[1]);
        Op<T>::mma(dq[n + 1], sh, bf[2], bf[3]);
        Op<T>::mma(dq[n], sl, bf[0], bf[1]);
        Op<T>::mma(dq[n + 1], sl, bf[2], bf[3]);
      }
    }
    __syncthreads();  // this stage is free for the load after next
  }
  mma::cp_async_wait<0>();  // an empty list staged Q and dO all the same
  // an empty list leaves dq 0: the row's dq is written as 0
  store_rows<T, D>(static_cast<T*>(a.out0) + base, stride, row0, a.S, dq,
                   a.scale, a.scale, lane);
}

// ---------------------------------------------------------------------------
// dk/dv pass: block (b * H + h, k tile from the plan's order), walking the
// column's live q tiles; dv = sum_q p do, dk = scale * sum_q p (dp - delta) q
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
block_sparse_bwd_dkv_mma_kernel(Args a) {
  constexpr int LD = D + 8, KC = D / 16, DT = D / 8;
  constexpr bool kHoldFrags = D <= 64;   // K and V fragments in registers
  constexpr int NQ = D <= 64 ? 64 : 16;  // queries a step
  constexpr int NQT = NQ / 8;
  // NQ bits of a key's keep word: 32 at d 128 saves the registers
  using Keep = std::conditional_t<(NQ <= 32), unsigned, unsigned long long>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* k_s = reinterpret_cast<T*>(smem);
  T* v_s = k_s + kTile * LD;
  T* q_s = v_s + kTile * LD;          // [2][kTile][LD]
  T* do_s = q_s + 2 * kTile * LD;     // [2][kTile][LD]
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * kTile * LD);  // [2][kTile]
  float* delta_s = lse_s + 2 * kTile;                                // [2][kTile]
  unsigned long long* mask_s =                               // [2][kMaxMaskWords]
      reinterpret_cast<unsigned long long*>(delta_s + 2 * kTile);
  // the walked tile's keep word of each of the block's keys: read from
  // shared memory where tested, so it holds no registers across the
  // products (4 of them spilled at d 128)
  volatile unsigned long long* keep_s = mask_s + 2 * kMaxMaskWords;  // [kTile]

  const int bh = blockIdx.x, hh = bh % a.layout_heads;
  const int b = bh / a.H, h = bh % a.H;
  const int ki = a.order[hh * gridDim.y + blockIdx.y];
  const int list = hh * gridDim.y + ki;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const size_t stride = (size_t)a.H * D;
  const size_t base = ((size_t)b * a.S * a.H + h) * D;
  const T* q = static_cast<const T*>(a.q) + base;
  const T* dout = static_cast<const T*>(a.dout) + base;
  const float* lse = a.lse + (size_t)bh * a.S;
  const float* dlt = a.delta + (size_t)bh * a.S;
  const int words = bsparse::mask_words(a.mask_shift);
  const int row0 = ki * kTile + warp * 16;  // this warp's first key

  const int e0 = a.ptr[list], e1 = a.ptr[list + 1];
  stage_rows<T, D>(k_s, static_cast<const T*>(a.k) + base, stride,
                   ki * kTile, a.S);
  stage_rows<T, D>(v_s, static_cast<const T*>(a.v) + base, stride,
                   ki * kTile, a.S);
  if (e0 < e1) {
    const int qt = a.idx[e0];
    stage_rows<T, D>(q_s, q, stride, qt * kTile, a.S);
    stage_rows<T, D>(do_s, dout, stride, qt * kTile, a.S);
    stage_vec<float>(lse_s, lse, qt * kTile, a.S);
    stage_vec<float>(delta_s, dlt, qt * kTile, a.S);
    stage_mask_async(mask_s, a, e0, words);
  }
  mma::cp_async_commit();

  const float sl2 = a.scale * kLog2e;
  float dk[DT][4], dv[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) { dk[n][i] = 0.f; dv[n][i] = 0.f; }
  uint32_t kf[kHoldFrags ? KC : 1][4], vf[kHoldFrags ? KC : 1][4];

  for (int e = e0; e < e1; ++e) {
    const int st = (e - e0) & 1;
    const int qt = a.idx[e];
    if (e + 1 < e1) {
      const int nx = a.idx[e + 1] * kTile, ns = st ^ 1;
      stage_rows<T, D>(q_s + ns * kTile * LD, q, stride, nx, a.S);
      stage_rows<T, D>(do_s + ns * kTile * LD, dout, stride, nx, a.S);
      stage_vec<float>(lse_s + ns * kTile, lse, nx, a.S);
      stage_vec<float>(delta_s + ns * kTile, dlt, nx, a.S);
      stage_mask_async(mask_s + ns * kMaxMaskWords, a, e + 1, words);
      mma::cp_async_commit();
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (kHoldFrags) {
      if (e == e0) {
#pragma unroll
        for (int c = 0; c < KC; ++c) {
          mma::load_a(kf[c], k_s, LD, warp * 16, c * 16, lane);
          mma::load_a(vf[c], v_s, LD, warp * 16, c * 16, lane);
        }
      }
    }
    const T* qs = q_s + st * kTile * LD;
    const T* dos = do_s + st * kTile * LD;
    const float* ls = lse_s + st * kTile;
    const float* ds = delta_s + st * kTile;
    const unsigned long long* ms = mask_s + st * kMaxMaskWords;
    const bool masked = !tile_full(ms, words, qt, ki, a);
    if (masked) {  // uniform over the block
      if (threadIdx.x < kTile)
        keep_s[threadIdx.x] = bsparse::col_keep(
            ms, threadIdx.x, ki * kTile + threadIdx.x, qt, a);
      __syncthreads();
    }

    // not unrolled: at d 128 (four steps of 16 queries) the unrolled steps
    // spilled once dS went in as two parts; one step at d 64
#pragma unroll 1
    for (int qc = 0; qc < kTile; qc += NQ) {
      // S^T = K.Q^T and dP^T = V.dO^T over queries qc .. qc + NQ
      float s[NQT][4], dp[NQT][4];
#pragma unroll
      for (int n = 0; n < NQT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) { s[n][i] = 0.f; dp[n][i] = 0.f; }
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        uint32_t af[4], bf[4];
        if constexpr (kHoldFrags) {
#pragma unroll
          for (int i = 0; i < 4; ++i) af[i] = kf[c][i];
        } else {
          mma::load_a(af, k_s, LD, warp * 16, c * 16, lane);
        }
#pragma unroll
        for (int n = 0; n < NQT; n += 2) {
          mma::load_b_nk(bf, qs, LD, qc + n * 8, c * 16, lane);
          Op<T>::mma(s[n], af, bf[0], bf[1]);
          Op<T>::mma(s[n + 1], af, bf[2], bf[3]);
        }
        if constexpr (kHoldFrags) {
#pragma unroll
          for (int i = 0; i < 4; ++i) af[i] = vf[c][i];
        } else {
          mma::load_a(af, v_s, LD, warp * 16, c * 16, lane);
        }
#pragma unroll
        for (int n = 0; n < NQT; n += 2) {
          mma::load_b_nk(bf, dos, LD, qc + n * 8, c * 16, lane);
          Op<T>::mma(dp[n], af, bf[0], bf[1]);
          Op<T>::mma(dp[n + 1], af, bf[2], bf[3]);
        }
      }

      // P^T in s, dS^T = P^T (dP^T - delta) in dp; column j is query
      // qc + j, and bit qq of the key's keep word decides on a tile that
      // is not wholly live
      if (masked) {
        Keep keep[2];  // bits qc .. qc + NQ of the keys' words
#pragma unroll
        for (int r = 0; r < 2; ++r)
          keep[r] = static_cast<Keep>(keep_s[warp * 16 + g + 8 * r] >> qc);
#pragma unroll
        for (int n = 0; n < NQT; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = i >> 1, qq = qc + n * 8 + 2 * t4 + (i & 1);
            const float p =
                (keep[r] >> (qq - qc)) & 1
                    ? exp2f(fmaf(s[n][i], sl2, -ls[qq] * kLog2e))
                    : 0.f;
            s[n][i] = p;
            dp[n][i] = p * (dp[n][i] - ds[qq]);
          }
      } else {
#pragma unroll
        for (int n = 0; n < NQT; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int qq = qc + n * 8 + 2 * t4 + (i & 1);
            const float p = exp2f(fmaf(s[n][i], sl2, -ls[qq] * kLog2e));
            s[n][i] = p;
            dp[n][i] = p * (dp[n][i] - ds[qq]);
          }
      }

      // dV += P^T.dO, dK += dS^T.Q over these queries
#pragma unroll
      for (int c = 0; c < NQ / 16; ++c) {
        uint32_t pa[4], sh[4], sl[4];  // dS^T as hi + lo, as in the dq pass
        mma::acc_to_a<T>(pa, s, c);
        mma::acc_to_a_split<T>(sh, sl, dp, c);
#pragma unroll
        for (int n = 0; n < DT; n += 2) {
          uint32_t bf[4];
          mma::load_b_kn(bf, dos, LD, n * 8, qc + c * 16, lane);
          Op<T>::mma(dv[n], pa, bf[0], bf[1]);
          Op<T>::mma(dv[n + 1], pa, bf[2], bf[3]);
          mma::load_b_kn(bf, qs, LD, n * 8, qc + c * 16, lane);
          Op<T>::mma(dk[n], sh, bf[0], bf[1]);
          Op<T>::mma(dk[n + 1], sh, bf[2], bf[3]);
          Op<T>::mma(dk[n], sl, bf[0], bf[1]);
          Op<T>::mma(dk[n + 1], sl, bf[2], bf[3]);
        }
      }
    }
    __syncthreads();
  }
  mma::cp_async_wait<0>();  // an empty list staged K and V all the same
  // an empty list leaves dk = dv = 0, written as such
  store_rows<T, D>(static_cast<T*>(a.out0) + base, stride, row0, a.S, dk,
                   a.scale, a.scale, lane);
  store_rows<T, D>(static_cast<T*>(a.out1) + base, stride, row0, a.S, dv,
                   1.f, 1.f, lane);
}

template <typename T, int D>
cudaError_t launch_td(bsparse::Pass pass, const Args& a,
                      cudaStream_t stream) {
  const size_t tile = (size_t)kTile * (D + 8) * sizeof(T);
  const size_t masks = 2 * kMaxMaskWords * sizeof(unsigned long long);
  const dim3 grid(a.B * a.H, (a.S + kTile - 1) / kTile);
  size_t smem;
  void (*kernel)(Args);
  if (pass == bsparse::kFwd) {
    kernel = block_sparse_fwd_mma_kernel<T, D>;
    smem = 5 * tile + masks;
  } else if (pass == bsparse::kDq) {
    kernel = block_sparse_bwd_dq_mma_kernel<T, D>;
    smem = 6 * tile + masks;
  } else if (pass == bsparse::kDkv) {
    kernel = block_sparse_bwd_dkv_mma_kernel<T, D>;
    smem = 6 * tile + 2 * 2 * kTile * sizeof(float) + masks +
           kTile * sizeof(unsigned long long);
  } else {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

namespace bsparse {

cudaError_t launch_mma(Pass pass, const Args& a, int d, int dtype,
                       cudaStream_t stream) {
  if (dtype == 1 && d == 64)
    return launch_td<__nv_bfloat16, 64>(pass, a, stream);
  if (dtype == 1 && d == 128)
    return launch_td<__nv_bfloat16, 128>(pass, a, stream);
  if (dtype == 2 && d == 64) return launch_td<__half, 64>(pass, a, stream);
  if (dtype == 2 && d == 128) return launch_td<__half, 128>(pass, a, stream);
  return cudaErrorInvalidValue;
}

}  // namespace bsparse
