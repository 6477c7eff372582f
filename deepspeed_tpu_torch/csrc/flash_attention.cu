// Flash attention for training on Hopper (sm_90a), hand-written CUDA, fp32
// inputs: a forward (out + lse), a dq pass and a dk/dv pass; and the C entry
// points of both flash families.
//
// Replaces, for fp32 inputs, the Pallas TPU kernels of
// deepspeed_tpu/ops/pallas/flash_attention.py:
//   * _flash_call (_fa_kernel) and _flash_fwd_stream (_fa_stream_kernel)
//     -> flash_fwd_kernel;
//   * _flash_bwd_pallas and _flash_bwd_stream, dq pass
//     (_fa_bwd_dq_kernel, _fa_bwd_dq_stream_kernel) -> flash_bwd_dq_kernel;
//   * the same two, dk/dv pass (_fa_bwd_dkv_kernel,
//     _fa_bwd_dkv_stream_kernel) -> flash_bwd_dkv_kernel.
// bf16 and fp16 inputs go to the tensor-core kernels of
// flash_attention_mma.cu; the entry points below choose by the dtype alone.
// fp32 is the parity dtype (five fp32 training steps on the card match the
// CPU's to 1e-4), which TF32 tensor-core products (~3 digits) would not
// keep, so these kernels compute in fp32 FMAs.
// The TPU split between a resident kernel (K/V whole in VMEM) and a streamed
// one (S * d past the VMEM budget) does not carry over: every kernel here
// stages one 64-row tile at a time in shared memory, at any S.
//
// Layout: q, k, v, out, dq, dk, dv are [B, S, H, D] (row (b, s, h) at
// ((b * S + s) * H + h) * D); lse and delta are fp32 [B, H, S]; segment ids
// int32 [B, S] or null.  K/V carry the query heads (GQA is repeated before
// the call, as the JAX model does).
//
// Semantics (flash_common.cuh keep; ops/pallas/lattice.py tile_keep,
// flash_attention.py _fa_kernel): scores are s = q . k / sqrt(D).  Masked
// probabilities are exactly 0; a row with no live key gets out 0 and lse
// 1e30.  p stays fp32 before p . V.
//
// What bounds it: the operations.  Per live (q, k) pair the forward does
// 4 D flops, the backward 10 D (it recomputes s); at S 2048 each byte read
// from device memory meets hundreds of flops.  In fp32 the card has no
// tensor-core path that keeps the parity, so the bound is 67 TFLOP/s.
//
// The design, first right and simple (cp.async pipelining and a persistent
// schedule are later work):
//   * one block per (b * H + h, 64-row tile): the forward and the dq pass
//     own 64 query rows and walk the live key tiles [k0, k1) of the lattice
//     (kv_bounds); the dk/dv pass owns 64 keys and walks the live query
//     tiles [q0, q1) (q_bounds).  The two backward passes are split, as in
//     JAX, so no pass needs atomics;
//   * the walked tile (K and V, or q, do, lse, delta) is staged in shared
//     memory as fp32, zero past S (the tail tile is masked, not refused);
//   * G = D / 16 lanes share one row, each holding 16 of its dims (four
//     float4 chunks, interleaved so a warp's reads of one staged row hit
//     distinct banks); a dot product is 16 FMAs per lane and a butterfly of
//     log2(G) shuffles, which leaves the full sum in every lane of the group;
//   * fp32 FMA arithmetic; the forward's online softmax rescales once per 32
//     keys.

#include "attention_tile.cuh"
#include "flash_common.cuh"

namespace {

using flash::Args;
using flash::keep;
using flash::kv_bounds;
using flash::q_bounds;
using flash::Pass;
using flash::kFwd;
using flash::kDq;
using flash::kDkv;

// ---------------------------------------------------------------------------
// forward: block (b * H + h, q tile); out [B, S, H, D], lse [B, H, S]
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kTile * D / kDimsPerLane)
flash_fwd_kernel(Args a) {
  constexpr int G = D / kDimsPerLane;
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);
  float* v_s = k_s + kTile * D;
  int* kseg_s = reinterpret_cast<int*>(v_s + kTile * D);

  const int bh = blockIdx.x, qi = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
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
  const int qseg = (a.seg != nullptr && row_ok) ? a.seg[(size_t)b * a.S + qpos] : 0;

  float m = -INFINITY, l = 0.f;
  const int nk = (a.S + kTile - 1) / kTile;
  int k0, k1;
  kv_bounds(qi, nk, a, k0, k1);
  for (int kt = k0; kt < k1; ++kt) {
    __syncthreads();  // the previous tile is no longer read
    stage_tile<T, D>(k, stride, kt * kTile, a.S, k_s);
    stage_tile<T, D>(v, stride, kt * kTile, a.S, v_s);
    if (a.seg != nullptr)
      stage_vec<int>(a.seg + (size_t)b * a.S, kt * kTile, a.S, kseg_s);
    __syncthreads();
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
        const bool ok = keep(qpos, kt * kTile + kk, a, qseg,
                             a.seg != nullptr ? kseg_s[kk] : 0);
        s[j] = ok ? dotp : -INFINITY;
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
flash_bwd_dq_kernel(Args a) {
  constexpr int G = D / kDimsPerLane;
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);
  float* v_s = k_s + kTile * D;
  int* kseg_s = reinterpret_cast<int*>(v_s + kTile * D);

  const int bh = blockIdx.x, qi = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
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
  int qseg = 0;
  if (row_ok) {
    const size_t row = (size_t)qpos * stride;
    load_row<T, G>(static_cast<const T*>(a.q) + base + row, sub, qr);
    load_row<T, G>(static_cast<const T*>(a.dout) + base + row, sub, dor);
    lse = a.lse[(size_t)bh * a.S + qpos];
    delta = a.delta[(size_t)bh * a.S + qpos];
    if (a.seg != nullptr) qseg = a.seg[(size_t)b * a.S + qpos];
  }

  const int nk = (a.S + kTile - 1) / kTile;
  int k0, k1;
  kv_bounds(qi, nk, a, k0, k1);
  for (int kt = k0; kt < k1; ++kt) {
    __syncthreads();
    stage_tile<T, D>(k, stride, kt * kTile, a.S, k_s);
    stage_tile<T, D>(v, stride, kt * kTile, a.S, v_s);
    if (a.seg != nullptr)
      stage_vec<int>(a.seg + (size_t)b * a.S, kt * kTile, a.S, kseg_s);
    __syncthreads();
#pragma unroll 2
    for (int kk = 0; kk < kTile; ++kk) {
      float kr[kChunks][4], vr[kChunks][4];
      read_staged<D, G>(k_s, kk, sub, kr);
      read_staged<D, G>(v_s, kk, sub, vr);
      const float s = group_sum<G>(dot(qr, kr));
      const float dp = group_sum<G>(dot(dor, vr));
      const bool ok = keep(qpos, kt * kTile + kk, a, qseg,
                           a.seg != nullptr ? kseg_s[kk] : 0);
      const float p = ok ? expf(s * a.scale - lse) : 0.f;
      axpy(p * (dp - delta), kr, acc);
    }
  }
  if (row_ok)
    store_row<T, G>(static_cast<T*>(a.out0) + base + (size_t)qpos * stride,
                    sub, acc, a.scale);
}

// ---------------------------------------------------------------------------
// dk/dv pass: block (b * H + h, k tile);
//   dv = sum_q p do,  dk = scale * sum_q p (dp - delta) q
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kTile * D / kDimsPerLane)
flash_bwd_dkv_kernel(Args a) {
  constexpr int G = D / kDimsPerLane;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* do_s = q_s + kTile * D;
  float* lse_s = do_s + kTile * D;
  float* delta_s = lse_s + kTile;
  int* qseg_s = reinterpret_cast<int*>(delta_s + kTile);

  const int bh = blockIdx.x, ki = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
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
  int kseg = 0;
  if (row_ok) {
    const size_t row = (size_t)kpos * stride;
    load_row<T, G>(static_cast<const T*>(a.k) + base + row, sub, kr);
    load_row<T, G>(static_cast<const T*>(a.v) + base + row, sub, vr);
    if (a.seg != nullptr) kseg = a.seg[(size_t)b * a.S + kpos];
  }

  const int nq = (a.S + kTile - 1) / kTile;
  int q0, q1;
  q_bounds(ki, nq, a, q0, q1);
  for (int qt = q0; qt < q1; ++qt) {
    __syncthreads();
    stage_tile<T, D>(q, stride, qt * kTile, a.S, q_s);
    stage_tile<T, D>(dout, stride, qt * kTile, a.S, do_s);
    stage_vec<float>(a.lse + (size_t)bh * a.S, qt * kTile, a.S, lse_s);
    stage_vec<float>(a.delta + (size_t)bh * a.S, qt * kTile, a.S, delta_s);
    if (a.seg != nullptr)
      stage_vec<int>(a.seg + (size_t)b * a.S, qt * kTile, a.S, qseg_s);
    __syncthreads();
#pragma unroll 1
    for (int qq = 0; qq < kTile; ++qq) {  // not unrolled: 64 live fp32 accumulators
      float qv[kChunks][4], dov[kChunks][4];
      read_staged<D, G>(q_s, qq, sub, qv);
      read_staged<D, G>(do_s, qq, sub, dov);
      const float s = group_sum<G>(dot(kr, qv));
      const float dp = group_sum<G>(dot(vr, dov));
      const bool ok = keep(qt * kTile + qq, kpos, a,
                           a.seg != nullptr ? qseg_s[qq] : 0, kseg);
      const float p = ok ? expf(s * a.scale - lse_s[qq]) : 0.f;
      axpy(p, dov, dv);
      axpy(p * (dp - delta_s[qq]), qv, dk);
    }
  }
  if (row_ok) {
    const size_t row = base + (size_t)kpos * stride;
    store_row<T, G>(static_cast<T*>(a.out0) + row, sub, dk, a.scale);
    store_row<T, G>(static_cast<T*>(a.out1) + row, sub, dv, 1.f);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename T, int D>
cudaError_t launch_td(Pass pass, const Args& a, cudaStream_t stream) {
  const int threads = kTile * D / kDimsPerLane;
  const dim3 grid(a.B * a.H, (a.S + kTile - 1) / kTile);
  size_t smem = 2 * kTile * D * sizeof(float);
  void (*kernel)(Args);
  if (pass == kFwd) {
    kernel = flash_fwd_kernel<T, D>;
    smem += kTile * sizeof(int);
  } else if (pass == kDq) {
    kernel = flash_bwd_dq_kernel<T, D>;
    smem += kTile * sizeof(int);
  } else {
    kernel = flash_bwd_dkv_kernel<T, D>;
    smem += 2 * kTile * sizeof(float) + kTile * sizeof(int);
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

// dtype: 0 = float32 (the kernels above), 1 = bfloat16 and 2 = float16
// (the tensor-core kernels of flash_attention_mma.cu)
cudaError_t launch(Pass pass, const Args& a, int d, int dtype,
                   cudaStream_t stream) {
  if (a.B <= 0 || a.S <= 0 || a.H <= 0) return cudaGetLastError();
  if ((a.S + kTile - 1) / kTile > 65535) return cudaErrorInvalidValue;
  if (dtype == 0 && d == 64) return launch_td<float, 64>(pass, a, stream);
  if (dtype == 0 && d == 128) return launch_td<float, 128>(pass, a, stream);
  if (dtype == 1 || dtype == 2) return flash::launch_mma(pass, a, d, dtype, stream);
  return cudaErrorInvalidValue;
}

Args make_args(const void* q, const void* k, const void* v, const void* seg,
               int B, int S, int H, int d, int causal, int window) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.seg = static_cast<const int*>(seg);
  a.B = B;
  a.S = S;
  a.H = H;
  a.causal = causal;
  a.window = window;
  a.scale = 1.0f / sqrtf(static_cast<float>(d));
  return a;
}

}  // namespace

extern "C" int ds_flash_fwd(const void* q, const void* k, const void* v,
                            const void* seg, void* out, void* lse, int B,
                            int S, int H, int d, int causal, int window,
                            int dtype, void* stream) {
  Args a = make_args(q, k, v, seg, B, S, H, d, causal, window);
  a.out0 = out;
  a.lse_out = static_cast<float*>(lse);
  return static_cast<int>(
      launch(kFwd, a, d, dtype, static_cast<cudaStream_t>(stream)));
}

extern "C" int ds_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, const void* seg, void* dq,
                               int B, int S, int H, int d, int causal,
                               int window, int dtype, void* stream) {
  Args a = make_args(q, k, v, seg, B, S, H, d, causal, window);
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.out0 = dq;
  return static_cast<int>(
      launch(kDq, a, d, dtype, static_cast<cudaStream_t>(stream)));
}

extern "C" int ds_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, const void* seg, void* dk,
                                void* dv, int B, int S, int H, int d,
                                int causal, int window, int dtype,
                                void* stream) {
  Args a = make_args(q, k, v, seg, B, S, H, d, causal, window);
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.out0 = dk;
  a.out1 = dv;
  return static_cast<int>(
      launch(kDkv, a, d, dtype, static_cast<cudaStream_t>(stream)));
}
