// Flash attention for training on Hopper (sm_90a), bf16 and fp16, on the
// tensor cores: a forward (out + lse), a dq pass and a dk/dv pass.
//
// Replaces, for 16-bit inputs, the Pallas TPU kernels of
// deepspeed_tpu/ops/pallas/flash_attention.py:
//   * _flash_call (_fa_kernel) and _flash_fwd_stream (_fa_stream_kernel)
//     -> flash_fwd_mma_kernel;
//   * _flash_bwd_pallas and _flash_bwd_stream, dq pass
//     (_fa_bwd_dq_kernel, _fa_bwd_dq_stream_kernel) -> flash_bwd_dq_mma_kernel;
//   * the same two, dk/dv pass (_fa_bwd_dkv_kernel,
//     _fa_bwd_dkv_stream_kernel) -> flash_bwd_dkv_mma_kernel.
// fp32 inputs go to the fp32-FMA kernels of flash_attention.cu (the parity
// dtype: TF32 products would keep ~3 digits); the C entry points there
// choose by the dtype alone.  Layout, masks, the 64 x 64 tile walk and the
// outputs are those kernels' (flash_common.cuh): a row with no live key
// gets out 0 and lse 1e30; masked probabilities are exactly 0.
//
// What bounds it: the operations (chip_smoke.py attention_bounds).  Per
// live (q, k) pair the forward does 4 d flops, the dq pass 6 d and the
// dk/dv pass 8 d (each pass recomputes the scores; the split dS adds 2 d
// tensor-core flops to each backward pass, the split P 2 d more to the
// dk/dv pass); at the training shapes
// each byte read meets hundreds of flops, so only the tensor cores' 989
// TFLOP/s (bf16, fp16) come near the bound.
//
// The design (FA2's shape on mma.sync; wgmma with TMA is later work):
//   * one block of 4 warps per (b * H + h, 64-row tile); each warp owns 16
//     query rows (forward, dq pass) or 16 keys (dk/dv pass) and walks the
//     live tiles of the lattice (kv_bounds / q_bounds).  The forward and
//     the dq pass take the q tiles in reverse, the heaviest causal rows
//     first; the two backward passes are split, as in JAX: no atomics,
//     deterministic;
//   * operands stay 16-bit in shared memory, rows padded by 8 elements so
//     ldmatrix is free of bank conflicts; the walked tiles are staged by
//     16-byte cp.async.cg copies, double-buffered (tile j + 1 loads while
//     tile j computes), rows past S zero-filled by the src-size operand;
//   * every product is mma.sync m16n8k16 with fp32 accumulators, fragments
//     by ldmatrix (V, K in dQ = dS·K, and Q, dO in the dk/dv products by
//     the transposing load);
//   * forward: S = Q·Kᵀ, the online softmax in fp32 on the accumulator
//     fragment (row max and sum across the quad by two shuffles, exp2 with
//     the scale folded in), p rounded to 16 bits in registers and reused as
//     the A fragment of P·V (the rounding of _reference_fwd_with_lse, JAX
//     :81; the TPU kernel kept p in fp32);
//   * dq pass: S = Q·Kᵀ, P = exp(S·scale − lse), dP = dO·Vᵀ,
//     dS = P∘(dP − delta), dQ += dS·K; dk/dv pass: Sᵀ = K·Qᵀ and
//     dPᵀ = V·dOᵀ directly, so Pᵀ and dSᵀ come out as A fragments,
//     dV += Pᵀ·dO, dK += dSᵀ·Q.  dS goes in as two 16-bit parts, hi =
//     round(dS) and lo = round(dS − hi), each multiplied on the same B
//     fragments (mma::acc_to_a_split): JAX keeps ds in fp32 (:363-366),
//     and where delta is far from dP one rounding of dS put dq and dk past
//     2e-2 of the fp32 backward (PERF.md); so does Pᵀ in dV += Pᵀ·dO
//     (JAX keeps p in fp32 there too, :406): on a saved lse below the
//     row's scores P exceeds 1, and one rounding of it put dv past 2e-2
//     at BERT-large's shape (ROADMAP Queue 3); delta = rowsum(dO∘O) stays
//     outside (JAX :443);
//   * masks (causal, window, segments, the S tail) are applied on the
//     accumulator fragment, only on tiles that need one
//     (tile_needs_mask); segment ids, lse and delta of the walked tile are
//     staged with it;
//   * registers: at d 128 the fragments of the block's resident operands
//     (Q, dO in the dq pass; K, V in the dk/dv pass) are re-read from shared
//     memory for each tile, and the dk/dv pass takes its 64 queries 16 at a
//     time, so dK and dV (64 fp32 each) fit beside Sᵀ and dPᵀ without a
//     spill (32 at a time spilled 24 bytes at the same speed: PERF.md);
//     with dSᵀ in two parts the four 16-query steps stay rolled (unrolled
//     they spilled 24-32 bytes).

#include "flash_common.cuh"
#include "mma_tile.cuh"

#include <math.h>

namespace {

using flash::Args;
using flash::kTile;
using mma::Op;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kLog2e = 1.4426950408889634f;

static_assert(kTile == mma::kTileRows && kThreads == mma::kBlockThreads,
              "the staging helpers' tile and block");
using mma::stage_rows;
using mma::stage_vec;
using mma::store_rows;

// ---------------------------------------------------------------------------
// forward: block (b * H + h, q tile); out [B, S, H, D], lse [B, H, S]
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_mma_kernel(Args a) {
  constexpr int LD = D + 8, KC = D / 16, NT = kTile / 8, DT = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);
  T* k_s = q_s + kTile * LD;          // [2][kTile][LD]
  T* v_s = k_s + 2 * kTile * LD;      // [2][kTile][LD]
  int* seg_s = reinterpret_cast<int*>(v_s + 2 * kTile * LD);  // [2][kTile]

  const int bh = blockIdx.x, qi = gridDim.y - 1 - blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const size_t stride = (size_t)a.H * D;
  const size_t base = ((size_t)b * a.S * a.H + h) * D;
  const T* k = static_cast<const T*>(a.k) + base;
  const T* v = static_cast<const T*>(a.v) + base;
  const int* seg = a.seg != nullptr ? a.seg + (size_t)b * a.S : nullptr;
  const int row0 = qi * kTile + warp * 16;  // this warp's first query
  int qseg[2] = {0, 0};
#pragma unroll
  for (int r = 0; r < 2; ++r)
    if (seg != nullptr && row0 + g + 8 * r < a.S) qseg[r] = seg[row0 + g + 8 * r];

  const int nk = (a.S + kTile - 1) / kTile;
  int k0, k1;
  flash::kv_bounds(qi, nk, a, k0, k1);

  stage_rows<T, D>(q_s, static_cast<const T*>(a.q) + base, stride,
                   qi * kTile, a.S);
  if (k0 < k1) {
    stage_rows<T, D>(k_s, k, stride, k0 * kTile, a.S);
    stage_rows<T, D>(v_s, v, stride, k0 * kTile, a.S);
    if (seg != nullptr) stage_vec<int>(seg_s, seg, k0 * kTile, a.S);
  }
  mma::cp_async_commit();

  const float sl2 = a.scale * kLog2e;
  float o[DT][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[n][i] = 0.f;
  uint32_t qf[KC][4];

  for (int kt = k0; kt < k1; ++kt) {
    const int st = (kt - k0) & 1;
    if (kt + 1 < k1) {  // the next tile loads while this one computes
      const int nx = (kt + 1) * kTile;
      stage_rows<T, D>(k_s + (st ^ 1) * kTile * LD, k, stride, nx, a.S);
      stage_rows<T, D>(v_s + (st ^ 1) * kTile * LD, v, stride, nx, a.S);
      if (seg != nullptr) stage_vec<int>(seg_s + (st ^ 1) * kTile, seg, nx, a.S);
      mma::cp_async_commit();
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    __syncthreads();
    if (kt == k0) {
#pragma unroll
      for (int c = 0; c < KC; ++c)
        mma::load_a(qf[c], q_s, LD, warp * 16, c * 16, lane);
    }
    const T* ks = k_s + st * kTile * LD;
    const T* vs = v_s + st * kTile * LD;

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

    if (flash::tile_needs_mask(qi, kt, a)) {
      const int* ksg = seg_s + st * kTile;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kc = n * 8 + 2 * t4 + (i & 1);
          if (!flash::keep(row0 + g + 8 * (i >> 1), kt * kTile + kc, a,
                           qseg[i >> 1], seg != nullptr ? ksg[kc] : 0))
            s[n][i] = -INFINITY;
        }
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

    // O += P·V, p rounded to 16 bits in registers
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
// dq pass: block (b * H + h, q tile); dq = scale * sum_k p (dp - delta) k
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_mma_kernel(Args a) {
  constexpr int LD = D + 8, KC = D / 16, NT = kTile / 8, DT = D / 8;
  constexpr bool kHoldFrags = D <= 64;  // Q and dO fragments in registers
  extern __shared__ __align__(16) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);
  T* do_s = q_s + kTile * LD;
  T* k_s = do_s + kTile * LD;         // [2][kTile][LD]
  T* v_s = k_s + 2 * kTile * LD;      // [2][kTile][LD]
  int* seg_s = reinterpret_cast<int*>(v_s + 2 * kTile * LD);  // [2][kTile]

  const int bh = blockIdx.x, qi = gridDim.y - 1 - blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const size_t stride = (size_t)a.H * D;
  const size_t base = ((size_t)b * a.S * a.H + h) * D;
  const T* k = static_cast<const T*>(a.k) + base;
  const T* v = static_cast<const T*>(a.v) + base;
  const int* seg = a.seg != nullptr ? a.seg + (size_t)b * a.S : nullptr;
  const int row0 = qi * kTile + warp * 16;
  int qseg[2] = {0, 0};
  float lse_l2[2] = {0.f, 0.f}, delta[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row < a.S) {
      lse_l2[r] = a.lse[(size_t)bh * a.S + row] * kLog2e;
      delta[r] = a.delta[(size_t)bh * a.S + row];
      if (seg != nullptr) qseg[r] = seg[row];
    }
  }

  const int nk = (a.S + kTile - 1) / kTile;
  int k0, k1;
  flash::kv_bounds(qi, nk, a, k0, k1);

  stage_rows<T, D>(q_s, static_cast<const T*>(a.q) + base, stride,
                   qi * kTile, a.S);
  stage_rows<T, D>(do_s, static_cast<const T*>(a.dout) + base, stride,
                   qi * kTile, a.S);
  if (k0 < k1) {
    stage_rows<T, D>(k_s, k, stride, k0 * kTile, a.S);
    stage_rows<T, D>(v_s, v, stride, k0 * kTile, a.S);
    if (seg != nullptr) stage_vec<int>(seg_s, seg, k0 * kTile, a.S);
  }
  mma::cp_async_commit();

  const float sl2 = a.scale * kLog2e;
  float dq[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dq[n][i] = 0.f;
  uint32_t qf[kHoldFrags ? KC : 1][4], dof[kHoldFrags ? KC : 1][4];

  for (int kt = k0; kt < k1; ++kt) {
    const int st = (kt - k0) & 1;
    if (kt + 1 < k1) {
      const int nx = (kt + 1) * kTile;
      stage_rows<T, D>(k_s + (st ^ 1) * kTile * LD, k, stride, nx, a.S);
      stage_rows<T, D>(v_s + (st ^ 1) * kTile * LD, v, stride, nx, a.S);
      if (seg != nullptr) stage_vec<int>(seg_s + (st ^ 1) * kTile, seg, nx, a.S);
      mma::cp_async_commit();
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (kHoldFrags) {
      if (kt == k0) {
#pragma unroll
        for (int c = 0; c < KC; ++c) {
          mma::load_a(qf[c], q_s, LD, warp * 16, c * 16, lane);
          mma::load_a(dof[c], do_s, LD, warp * 16, c * 16, lane);
        }
      }
    }
    const T* ks = k_s + st * kTile * LD;
    const T* vs = v_s + st * kTile * LD;

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

    // P = exp(s * scale - lse), dS = P (dP - delta), kept in s
    const bool masked = flash::tile_needs_mask(qi, kt, a);
    const int* ksg = seg_s + st * kTile;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1, kc = n * 8 + 2 * t4 + (i & 1);
        float p = exp2f(fmaf(s[n][i], sl2, -lse_l2[r]));
        if (masked && !flash::keep(row0 + g + 8 * r, kt * kTile + kc, a,
                                   qseg[r], seg != nullptr ? ksg[kc] : 0))
          p = 0.f;
        s[n][i] = p * (dp[n][i] - delta[r]);
      }

    // dQ += dS·K, dS as two 16-bit parts (hi·K + lo·K on the same K
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
    __syncthreads();
  }
  store_rows<T, D>(static_cast<T*>(a.out0) + base, stride, row0, a.S, dq,
                   a.scale, a.scale, lane);
}

// ---------------------------------------------------------------------------
// dk/dv pass: block (b * H + h, k tile);
//   dv = sum_q p do,  dk = scale * sum_q p (dp - delta) q
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_mma_kernel(Args a) {
  constexpr int LD = D + 8, KC = D / 16, DT = D / 8;
  constexpr bool kHoldFrags = D <= 64;  // K and V fragments in registers
  constexpr int NQ = D <= 64 ? 64 : 16;  // queries a step
  constexpr int NQT = NQ / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* k_s = reinterpret_cast<T*>(smem);
  T* v_s = k_s + kTile * LD;
  T* q_s = v_s + kTile * LD;          // [2][kTile][LD]
  T* do_s = q_s + 2 * kTile * LD;     // [2][kTile][LD]
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * kTile * LD);  // [2][kTile]
  float* delta_s = lse_s + 2 * kTile;                                // [2][kTile]
  int* seg_s = reinterpret_cast<int*>(delta_s + 2 * kTile);         // [2][kTile]

  const int bh = blockIdx.x, ki = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const size_t stride = (size_t)a.H * D;
  const size_t base = ((size_t)b * a.S * a.H + h) * D;
  const T* q = static_cast<const T*>(a.q) + base;
  const T* dout = static_cast<const T*>(a.dout) + base;
  const float* lse = a.lse + (size_t)bh * a.S;
  const float* dlt = a.delta + (size_t)bh * a.S;
  const int* seg = a.seg != nullptr ? a.seg + (size_t)b * a.S : nullptr;
  const int row0 = ki * kTile + warp * 16;  // this warp's first key
  int kseg[2] = {0, 0};
#pragma unroll
  for (int r = 0; r < 2; ++r)
    if (seg != nullptr && row0 + g + 8 * r < a.S) kseg[r] = seg[row0 + g + 8 * r];

  const int nq = (a.S + kTile - 1) / kTile;
  int q0, q1;
  flash::q_bounds(ki, nq, a, q0, q1);

  stage_rows<T, D>(k_s, static_cast<const T*>(a.k) + base, stride,
                   ki * kTile, a.S);
  stage_rows<T, D>(v_s, static_cast<const T*>(a.v) + base, stride,
                   ki * kTile, a.S);
  if (q0 < q1) {
    stage_rows<T, D>(q_s, q, stride, q0 * kTile, a.S);
    stage_rows<T, D>(do_s, dout, stride, q0 * kTile, a.S);
    stage_vec<float>(lse_s, lse, q0 * kTile, a.S);
    stage_vec<float>(delta_s, dlt, q0 * kTile, a.S);
    if (seg != nullptr) stage_vec<int>(seg_s, seg, q0 * kTile, a.S);
  }
  mma::cp_async_commit();

  const float sl2 = a.scale * kLog2e;
  float dk[DT][4], dv[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) { dk[n][i] = 0.f; dv[n][i] = 0.f; }
  uint32_t kf[kHoldFrags ? KC : 1][4], vf[kHoldFrags ? KC : 1][4];

  for (int qt = q0; qt < q1; ++qt) {
    const int st = (qt - q0) & 1;
    if (qt + 1 < q1) {
      const int nx = (qt + 1) * kTile, ns = st ^ 1;
      stage_rows<T, D>(q_s + ns * kTile * LD, q, stride, nx, a.S);
      stage_rows<T, D>(do_s + ns * kTile * LD, dout, stride, nx, a.S);
      stage_vec<float>(lse_s + ns * kTile, lse, nx, a.S);
      stage_vec<float>(delta_s + ns * kTile, dlt, nx, a.S);
      if (seg != nullptr) stage_vec<int>(seg_s + ns * kTile, seg, nx, a.S);
      mma::cp_async_commit();
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (kHoldFrags) {
      if (qt == q0) {
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
    const int* qsg = seg_s + st * kTile;
    const bool masked = flash::tile_needs_mask(qt, ki, a);

    // not unrolled: at d 128 (four steps of 16 queries) the unrolled steps
    // spilled once dS went in as two parts; one step at d 64
#pragma unroll 1
    for (int qc = 0; qc < kTile; qc += NQ) {
      // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ over queries qc .. qc + NQ
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

      // Pᵀ in s, dSᵀ = Pᵀ (dPᵀ - delta) in dp; column j is query qc + j
#pragma unroll
      for (int n = 0; n < NQT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = i >> 1, qq = qc + n * 8 + 2 * t4 + (i & 1);
          float p = exp2f(fmaf(s[n][i], sl2, -ls[qq] * kLog2e));
          if (masked && !flash::keep(qt * kTile + qq, row0 + g + 8 * r, a,
                                     seg != nullptr ? qsg[qq] : 0, kseg[r]))
            p = 0.f;
          s[n][i] = p;
          dp[n][i] = p * (dp[n][i] - ds[qq]);
        }

      // dV += Pᵀ·dO, then dK += dSᵀ·Q over these queries; Pᵀ and dSᵀ
      // each go in as hi + lo 16-bit parts (the JAX kernel keeps both in
      // fp32), one pair live at a time
#pragma unroll
      for (int c = 0; c < NQ / 16; ++c) {
        uint32_t hi[4], lo[4];
        mma::acc_to_a_split<T>(hi, lo, s, c);
#pragma unroll
        for (int n = 0; n < DT; n += 2) {
          uint32_t bf[4];
          mma::load_b_kn(bf, dos, LD, n * 8, qc + c * 16, lane);
          Op<T>::mma(dv[n], hi, bf[0], bf[1]);
          Op<T>::mma(dv[n + 1], hi, bf[2], bf[3]);
          Op<T>::mma(dv[n], lo, bf[0], bf[1]);
          Op<T>::mma(dv[n + 1], lo, bf[2], bf[3]);
        }
        mma::acc_to_a_split<T>(hi, lo, dp, c);
#pragma unroll
        for (int n = 0; n < DT; n += 2) {
          uint32_t bf[4];
          mma::load_b_kn(bf, qs, LD, n * 8, qc + c * 16, lane);
          Op<T>::mma(dk[n], hi, bf[0], bf[1]);
          Op<T>::mma(dk[n + 1], hi, bf[2], bf[3]);
          Op<T>::mma(dk[n], lo, bf[0], bf[1]);
          Op<T>::mma(dk[n + 1], lo, bf[2], bf[3]);
        }
      }
    }
    __syncthreads();
  }
  store_rows<T, D>(static_cast<T*>(a.out0) + base, stride, row0, a.S, dk,
                   a.scale, a.scale, lane);
  store_rows<T, D>(static_cast<T*>(a.out1) + base, stride, row0, a.S, dv,
                   1.f, 1.f, lane);
}

template <typename T, int D>
cudaError_t launch_td(flash::Pass pass, const Args& a, cudaStream_t stream) {
  const size_t tile = (size_t)kTile * (D + 8) * sizeof(T);
  const dim3 grid(a.B * a.H, (a.S + kTile - 1) / kTile);
  size_t smem;
  void (*kernel)(Args);
  if (pass == flash::kFwd) {
    kernel = flash_fwd_mma_kernel<T, D>;
    smem = 5 * tile + 2 * kTile * sizeof(int);
  } else if (pass == flash::kDq) {
    kernel = flash_bwd_dq_mma_kernel<T, D>;
    smem = 6 * tile + 2 * kTile * sizeof(int);
  } else {
    kernel = flash_bwd_dkv_mma_kernel<T, D>;
    smem = 6 * tile + 2 * kTile * (2 * sizeof(float) + sizeof(int));
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

namespace flash {

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

}  // namespace flash
