// One-token GQA decode attention for Hopper (sm_90a), hand-written CUDA.
//
// Replaces two Pallas TPU kernels of the JAX package:
//   * deepspeed_tpu/ops/pallas/decode_attention.py  decode_attention
//     (_decode_kernel): keys in a padded cache [B, Smax, kv_h, d];
//   * deepspeed_tpu/ops/pallas/paged_attention.py   paged_decode_attention
//     (_paged_kernel): keys in a shared page pool [N, bs, kv_h, d] addressed
//     by a block table [B, max_blocks].
// Both compute, for each sequence b and query head i,
//     out[b, i] = softmax_k(q[b, i] . K[b, k, i / n_rep] / sqrt(d)) . V
// over the live keys k in [max(len - window, 0), len).
//
// What bounds it: the bytes of K and V.  One decode step reads every live
// key and value once and does 4*d flops per (query head, key), about
// 2*n_rep flops per byte read -- far under the card's ~295 flops per byte,
// so the time is the K/V bytes over the memory rate.
//
// What the design does about it:
//   * one thread block per (sequence b, kv head g, group of R query heads),
//     R the largest of 8, 4, 2, 1 that divides n_rep: every K/V byte is
//     read once per kv head, not once per query head (the TPU kernel
//     expanded the GQA groups in VMEM instead);
//   * the R query rows are loaded once, pre-scaled by 1/sqrt(d) in fp32;
//   * a key is read by a group of D/VEC lanes, each with one 16-byte
//     vector load of K and one of V; scores are reduced with warp shuffles;
//   * each lane group keeps an online softmax (m, l, acc) per query head in
//     fp32 and walks its share of the keys, starting at the window's first
//     key (pages before the window are never touched); the partial states
//     are merged with shuffles inside a warp and in shared memory across
//     warps, and the [R, d] result is written in q's dtype.
// Not yet done (later work): split-K over the sequence for small B * kv_h,
// and cp.async/TMA pipelining of the K/V stream.
//
// Plain C interface (bound with ctypes); each entry point returns
// cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 4;  // keys in flight per lane group

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;  // 16 bytes
  __device__ __forceinline__ static void load(const float* p, float (&o)[N]) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    o[0] = x.x; o[1] = x.y; o[2] = x.z; o[3] = x.w;
  }
  __device__ __forceinline__ static void store(float* p, float x) { *p = x; }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;  // 16 bytes
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float (&o)[N]) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h2[i]);
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16(x);
  }
};

template <>
struct Vec<__half> {
  static constexpr int N = 8;  // 16 bytes
  __device__ __forceinline__ static void load(const __half* p,
                                              float (&o)[N]) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __half2* h2 = reinterpret_cast<const __half2*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __half22float2(h2[i]);
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static void store(__half* p, float x) {
    *p = __float2half_rn(x);
  }
};

// exp(a - b) with exp(-inf - anything) = 0 and no NaN when both are -inf.
__device__ __forceinline__ float rescale(float a, float b) {
  return a == -INFINITY ? 0.f : expf(a - b);
}

struct Problem {
  const void* q;        // [B, h, D]
  const void* k;        // padded [B, seq_cap, kv_h, D] or pool [N, bs, kv_h, D]
  const void* v;
  const int* tables;    // [B, max_blocks] page ids, or nullptr (padded cache)
  const int* lengths;   // [B] keys to attend, counting the one just written
  void* out;            // [B, h, D]
  int h, kv_h, n_rep;
  int seq_cap;          // Smax, or max_blocks * bs
  int block_size, max_blocks, num_pages;
  int window;           // <= 0: no window
  float scale;
};

template <typename T, int D, int R>
__global__ void __launch_bounds__(kThreads) gqa_decode_kernel(Problem p) {
  constexpr int VEC = Vec<T>::N;
  constexpr int LPK = D / VEC;            // lanes per key
  constexpr int KPW = 32 / LPK;           // keys per warp per pass
  constexpr int GROUPS = kWarps * KPW;    // keys per block per pass
  static_assert(D % VEC == 0 && 32 % LPK == 0, "unsupported head dim");

  const T* __restrict__ q = static_cast<const T*>(p.q);
  const T* __restrict__ k = static_cast<const T*>(p.k);
  const T* __restrict__ v = static_cast<const T*>(p.v);
  T* __restrict__ out = static_cast<T*>(p.out);

  const int g = blockIdx.x;               // kv head
  const int b = blockIdx.y;               // sequence
  const int head0 = g * p.n_rep + blockIdx.z * R;  // first query head
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int sub = lane / LPK;             // key slot inside the warp
  const int dl = lane % LPK;              // this lane's slice of the dims
  const int group = warp * KPW + sub;

  const int len = p.lengths[b];
  const int start = p.window > 0 ? max(len - p.window, 0) : 0;
  const int end = min(len, p.seq_cap);

  float qr[R][VEC];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    Vec<T>::load(q + ((size_t)b * p.h + head0 + r) * D + dl * VEC, qr[r]);
#pragma unroll
    for (int i = 0; i < VEC; ++i) qr[r][i] *= p.scale;
  }

  float m[R], l[R], acc[R][VEC];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[r][i] = 0.f;
  }

  // the loop bounds are uniform over the block, so every lane reaches the
  // shuffles below
  for (int base = start; base < end; base += GROUPS * kUnroll) {
    float kf[kUnroll][VEC], vf[kUnroll][VEC];
    bool live[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int pos = base + u * GROUPS + group;
      live[u] = pos < end;
      if (live[u]) {
        size_t row;
        if (p.tables != nullptr) {
          int page = p.tables[(size_t)b * p.max_blocks + pos / p.block_size];
          page = min(max(page, 0), p.num_pages - 1);
          row = (size_t)page * p.block_size + pos % p.block_size;
        } else {
          row = (size_t)b * p.seq_cap + pos;
        }
        const size_t off = (row * p.kv_h + g) * D + dl * VEC;
        Vec<T>::load(k + off, kf[u]);
        Vec<T>::load(v + off, vf[u]);
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) kf[u][i] = vf[u][i] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float s[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < VEC; ++i) part = fmaf(qr[r][i], kf[u][i], part);
#pragma unroll
        for (int off = LPK / 2; off > 0; off >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, off);
        s[r] = part;
      }
      if (live[u]) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float mn = fmaxf(m[r], s[r]);
          const float alpha = rescale(m[r], mn);
          const float pr = expf(s[r] - mn);
          l[r] = l[r] * alpha + pr;
#pragma unroll
          for (int i = 0; i < VEC; ++i)
            acc[r][i] = fmaf(pr, vf[u][i], acc[r][i] * alpha);
          m[r] = mn;
        }
      }
    }
  }

  // merge the KPW lane groups of each warp (lanes dl, dl+LPK, ... hold the
  // same dims of different keys)
#pragma unroll
  for (int off = LPK; off < 32; off <<= 1) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[r], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[r], off);
      const float mn = fmaxf(m[r], mo);
      const float a = rescale(m[r], mn);
      const float c = rescale(mo, mn);
      l[r] = l[r] * a + lo * c;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[r][i], off);
        acc[r][i] = acc[r][i] * a + ao * c;
      }
      m[r] = mn;
    }
  }

  // merge the warps in shared memory and write [R, D]
  __shared__ float s_m[kWarps][R];
  __shared__ float s_l[kWarps][R];
  __shared__ float s_acc[kWarps][R][D];
  if (sub == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) s_acc[warp][r][dl * VEC + i] = acc[r][i];
      if (dl == 0) {
        s_m[warp][r] = m[r];
        s_l[warp][r] = l[r];
      }
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < R * D; t += kThreads) {
    const int r = t / D;
    const int dim = t % D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, s_m[w][r]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = rescale(s_m[w][r], mx);
      den += s_l[w][r] * c;
      num += s_acc[w][r][dim] * c;
    }
    // no live key (length <= 0): 0, as the TPU kernel gives
    const float o = mx == -INFINITY ? 0.f : num / fmaxf(den, 1e-9f);
    Vec<T>::store(out + ((size_t)b * p.h + head0 + r) * D + dim, o);
  }
}

template <typename T, int D>
cudaError_t launch_d(const Problem& p, int batch, cudaStream_t stream) {
  int R = 1;
  if (p.n_rep % 8 == 0) R = 8;
  else if (p.n_rep % 4 == 0) R = 4;
  else if (p.n_rep % 2 == 0) R = 2;
  const dim3 grid(p.kv_h, batch, p.n_rep / R);
  switch (R) {
    case 8: gqa_decode_kernel<T, D, 8><<<grid, kThreads, 0, stream>>>(p); break;
    case 4: gqa_decode_kernel<T, D, 4><<<grid, kThreads, 0, stream>>>(p); break;
    case 2: gqa_decode_kernel<T, D, 2><<<grid, kThreads, 0, stream>>>(p); break;
    default: gqa_decode_kernel<T, D, 1><<<grid, kThreads, 0, stream>>>(p); break;
  }
  return cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16, 2 = float16
cudaError_t launch(const Problem& p, int batch, int d, int dtype,
                   cudaStream_t stream) {
  if (batch <= 0 || p.kv_h <= 0 || p.n_rep <= 0) return cudaGetLastError();
  if (dtype == 0 && d == 64) return launch_d<float, 64>(p, batch, stream);
  if (dtype == 0 && d == 128) return launch_d<float, 128>(p, batch, stream);
  if (dtype == 1 && d == 64) return launch_d<__nv_bfloat16, 64>(p, batch, stream);
  if (dtype == 1 && d == 128) return launch_d<__nv_bfloat16, 128>(p, batch, stream);
  if (dtype == 2 && d == 64) return launch_d<__half, 64>(p, batch, stream);
  if (dtype == 2 && d == 128) return launch_d<__half, 128>(p, batch, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int ds_decode_attention(const void* q, const void* k_cache,
                                   const void* v_cache, const void* lengths,
                                   void* out, int batch, int h, int kv_h,
                                   int d, int smax, int window, int dtype,
                                   void* stream) {
  Problem p{q, k_cache, v_cache, nullptr, static_cast<const int*>(lengths),
            out, h, kv_h, h / kv_h, smax, 0, 0, 0, window,
            1.0f / sqrtf(static_cast<float>(d))};
  return static_cast<int>(
      launch(p, batch, d, dtype, static_cast<cudaStream_t>(stream)));
}

extern "C" int ds_paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* block_tables, const void* lengths, void* out, int batch,
    int h, int kv_h, int d, int num_pages, int block_size, int max_blocks,
    int window, int dtype, void* stream) {
  Problem p{q, k_pool, v_pool, static_cast<const int*>(block_tables),
            static_cast<const int*>(lengths), out, h, kv_h, h / kv_h,
            max_blocks * block_size, block_size, max_blocks, num_pages,
            window, 1.0f / sqrtf(static_cast<float>(d))};
  return static_cast<int>(
      launch(p, batch, d, dtype, static_cast<cudaStream_t>(stream)));
}
