// MoE token dispatch and combine for Hopper (sm_90a), hand-written CUDA.
//
// Replaces two Pallas TPU kernels of the JAX package
// (deepspeed_tpu/ops/pallas/moe_dispatch.py):
//   * _pallas_dispatch_fwd (_dispatch_kernel): tokens [T, H] and
//     src_idx [E, C] -> expert buffers [E, C, H], out[e, c] = tokens[src],
//     zero where src is EMPTY_SLOT (-1);
//   * _pallas_combine_fwd (_combine_kernel): expert_out [E, C, H],
//     flat_idx [T, K] and fp32 gates [T, K] -> y [T, H],
//     y[t] = sum_k gates[t, k] * expert_out.flat[flat_idx[t, k]], where an
//     index E*C (a dropped assignment) contributes nothing.
//
// What bounds them: the bytes.  Dispatch reads each routed token's row and
// writes every slot's row once (an empty slot's as zeros); combine reads K
// rows per token and writes one.  Neither does more than K multiply-adds
// per element.
//
// What the design does about it:
//   * dispatch runs one 128-thread block per slot row (grid-stride loops
//     past 2^31 - 1 rows): the hardware's block scheduler balances the mix
//     of copied and empty rows.  Each thread issues all its loads of a row
//     (U 16-byte vectors, unrolled, U * 128 vectors a pass; U = 4 for a
//     bf16 row of 4096) before any store, so a row's bytes are in flight
//     together instead of one vector a thread; an empty slot's row is
//     written with no read;
//   * its stores are streaming (st.global.cs, evict-first in L2): the
//     [E, C, H] buffers are written once here.  The two changes, measured
//     one at a time, each shortened the kernel at the train shape; a
//     persistent grid of contiguous row ranges (132 x 8 or 16 blocks, the
//     range's indices staged at once) and bulk copies through shared memory
//     (cp.async.bulk with an mbarrier ring) were both slower than this grid
//     (tools/dispatch_bench.cu; the numbers are in PERF.md);
//   * combine runs one thread block per token, with a grid-stride loop past
//     2^31 - 1 tokens; the threads of a block walk the row in 16-byte
//     vectors, so every load and store is a full 128-bit access;
//   * dispatch copies raw bytes: one kernel serves every dtype, and the
//     copy is exact;
//   * combine accumulates in fp32 in the order k = 0, 1, ..., as the TPU
//     kernel's acc + g * row did, with __fmul_rn / __fadd_rn so that nvcc
//     cannot contract the two into an FMA: in fp32 the result equals the
//     plain PyTorch version's bit for bit for K <= 2.  The dropped
//     assignment is masked in the kernel: no padded copy of the expert
//     output with a zero row is made (the TPU wrapper built one);
//   * no atomics: every output row belongs to one block.
// Not yet done (later work): fusing the dispatch copy into the experts'
// first GEMM (a gathered-row TMA load) and the combine into the last.
//
// Plain C interface (bound with ctypes); each entry point returns
// cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxGrid = 1 << 20;

// out[r] = tokens[min(src_idx[r], T - 1)], zero where src_idx[r] < 0; U
// vectors a thread a pass over a row.
template <int U>
__global__ void __launch_bounds__(kThreads)
dispatch_kernel(const uint4* __restrict__ tokens,
                const int* __restrict__ src_idx, uint4* __restrict__ out,
                int num_tokens, int64_t rows, int vecs_per_row) {
  for (int64_t r = blockIdx.x; r < rows; r += gridDim.x) {
    const int src = __ldg(src_idx + r);
    uint4* dst = out + r * vecs_per_row;
    if (src < 0) {  // an empty slot: zeros, nothing read
      for (int i = threadIdx.x; i < vecs_per_row; i += kThreads)
        __stcs(dst + i, make_uint4(0u, 0u, 0u, 0u));
      continue;
    }
    // an index past the tokens clamps, as the plain version's gather does
    const int row = src < num_tokens ? src : num_tokens - 1;
    const uint4* from = tokens + static_cast<int64_t>(row) * vecs_per_row;
    for (int c0 = threadIdx.x; c0 < vecs_per_row; c0 += U * kThreads) {
      uint4 buf[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (c0 + u * kThreads < vecs_per_row)
          buf[u] = __ldg(from + c0 + u * kThreads);
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (c0 + u * kThreads < vecs_per_row)
          __stcs(dst + c0 + u * kThreads, buf[u]);
    }
  }
}

// One 16-byte vector of T as fp32 values, and back.
template <typename T>
struct Pack;

template <>
struct Pack<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const uint4& u, float (&f)[N]) {
    f[0] = __uint_as_float(u.x); f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z); f[3] = __uint_as_float(u.w);
  }
  __device__ __forceinline__ static uint4 store(const float (&f)[N]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const uint4& u, float (&f)[N]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(h[i]);
      f[2 * i] = x.x;
      f[2 * i + 1] = x.y;
    }
  }
  __device__ __forceinline__ static uint4 store(const float (&f)[N]) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    }
    return u;
  }
};

template <>
struct Pack<__half> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const uint4& u, float (&f)[N]) {
    const __half2* h = reinterpret_cast<const __half2*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __half22float2(h[i]);
      f[2 * i] = x.x;
      f[2 * i + 1] = x.y;
    }
  }
  __device__ __forceinline__ static uint4 store(const float (&f)[N]) {
    uint4 u;
    __half2* h = reinterpret_cast<__half2*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      h[i] = __floats2half2_rn(f[2 * i], f[2 * i + 1]);
    }
    return u;
  }
};

template <typename T>
__global__ void combine_kernel(const uint4* __restrict__ expert_out,
                               const int* __restrict__ flat_idx,
                               const float* __restrict__ gates,
                               uint4* __restrict__ y, int num_tokens, int k,
                               int64_t slots, int vecs_per_row) {
  constexpr int N = Pack<T>::N;
  for (int64_t t = blockIdx.x; t < num_tokens; t += gridDim.x) {
    for (int i = threadIdx.x; i < vecs_per_row; i += blockDim.x) {
      float acc[N];
#pragma unroll
      for (int j = 0; j < N; ++j) acc[j] = 0.0f;
      for (int c = 0; c < k; ++c) {
        const int idx = flat_idx[t * k + c];
        if (idx < 0 || idx >= slots) continue;  // dropped assignment
        const float g = gates[t * k + c];
        float row[N];
        Pack<T>::load(__ldg(expert_out + int64_t(idx) * vecs_per_row + i),
                      row);
#pragma unroll
        for (int j = 0; j < N; ++j) {
          acc[j] = __fadd_rn(acc[j], __fmul_rn(g, row[j]));
        }
      }
      y[t * vecs_per_row + i] = Pack<T>::store(acc);
    }
  }
}

inline int grid_for(int64_t rows) {
  return static_cast<int>(rows < kMaxGrid ? (rows > 0 ? rows : 1) : kMaxGrid);
}

}  // namespace

// tokens [T, row_bytes], src_idx int32 [rows], out [rows, row_bytes];
// row_bytes a multiple of 16.
extern "C" int ds_moe_dispatch(const void* tokens, const void* src_idx,
                               void* out, int num_tokens, int rows,
                               int row_bytes, void* stream) {
  if (rows <= 0 || row_bytes <= 0) return 0;
  const uint4* t = static_cast<const uint4*>(tokens);
  const int* idx = static_cast<const int*>(src_idx);
  uint4* o = static_cast<uint4*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vecs = row_bytes / 16;
  // U: a row's vectors a thread, up to 4 (a bf16 row of 4096 in one pass)
  const int per_thread = (vecs + kThreads - 1) / kThreads;
  const int grid = grid_for(rows);
  if (per_thread <= 1)
    dispatch_kernel<1><<<grid, kThreads, 0, s>>>(t, idx, o, num_tokens, rows,
                                                 vecs);
  else if (per_thread <= 2)
    dispatch_kernel<2><<<grid, kThreads, 0, s>>>(t, idx, o, num_tokens, rows,
                                                 vecs);
  else
    dispatch_kernel<4><<<grid, kThreads, 0, s>>>(t, idx, o, num_tokens, rows,
                                                 vecs);
  return static_cast<int>(cudaGetLastError());
}

// expert_out [slots, H], flat_idx int32 [T, K], gates fp32 [T, K],
// y [T, H]; dtype 0 fp32, 1 bf16, 2 fp16; H * element size a multiple of 16.
extern "C" int ds_moe_combine(const void* expert_out, const void* flat_idx,
                              const void* gates, void* y, int num_tokens,
                              int k, int slots, int hidden, int dtype,
                              void* stream) {
  if (num_tokens <= 0 || hidden <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint4* eo = static_cast<const uint4*>(expert_out);
  const int* idx = static_cast<const int*>(flat_idx);
  const float* g = static_cast<const float*>(gates);
  uint4* out = static_cast<uint4*>(y);
  const int grid = grid_for(num_tokens);
  switch (dtype) {
    case 0:
      combine_kernel<float><<<grid, kThreads, 0, s>>>(
          eo, idx, g, out, num_tokens, k, slots, hidden / 4);
      break;
    case 1:
      combine_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
          eo, idx, g, out, num_tokens, k, slots, hidden / 8);
      break;
    case 2:
      combine_kernel<__half><<<grid, kThreads, 0, s>>>(
          eo, idx, g, out, num_tokens, k, slots, hidden / 8);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
