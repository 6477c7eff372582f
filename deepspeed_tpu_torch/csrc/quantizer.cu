// Symmetric per-row int8 quantization for Hopper (sm_90a), hand-written
// CUDA.
//
// Replaces the Pallas TPU kernel quantize_int8 (_quant_kernel) of
// deepspeed_tpu/ops/pallas/quantizer.py: x [R, C] (fp32, bf16 or fp16) ->
// q int8 [R, C] and fp32 scales [R], with, per row,
//   amax = max |x| over the fp32 values,
//   scale = amax * (1/127), or 1 when amax is 0 (XLA compiles the TPU
//     kernel's amax / 127.0 into a product with the fp32 reciprocal),
//   q = clamp(round_half_even(x / scale), -127, 127).
//
// What bounds it: the bytes.  It reads each element once from device
// memory and writes one byte per element and four per row, for a compare,
// a division and a rounding per element.
//
// What the design does about it:
//   * one thread block per row (grid-stride past 2^20 rows); its threads
//     walk the row in 16-byte vectors (4 fp32 or 8 bf16/fp16 values), and
//     store the codes 4 or 8 bytes at a time; a row whose bytes are not a
//     multiple of 16 takes a scalar walk instead;
//   * two passes over the row: a warp-shuffle max of |x| and one
//     shared-memory step across the block's warps, then the codes; the
//     second read of the row hits L1/L2, not device memory, for the
//     widths the port quantizes (a 4096-wide bf16 row is 8 KB);
//   * the arithmetic is the TPU kernel's, so the codes and scales equal
//     the plain PyTorch version's bit for bit: amax of the fp32 values (not
//     of bf16), amax times the fp32 reciprocal of 127 (__fmul_rn), x /
//     scale as an IEEE division (__fdiv_rn, never x * (1 / scale)), and
//     __float2int_rn, which rounds half to even as jnp.round and
//     torch.round do (never roundf).
// Not yet done (later work): fusing the quantizer into the collective it
// compresses, and several rows a block for narrow rows.
//
// Plain C interface (bound with ctypes); the entry point returns
// cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGrid = 1 << 20;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

// One 16-byte vector of T as N fp32 values.
template <typename T>
struct Vec {
  static constexpr int N = 16 / sizeof(T);
  __device__ __forceinline__ static void load(const uint4& u, float (&f)[N]) {
    const T* x = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int i = 0; i < N; ++i) f[i] = to_float(x[i]);
  }
};

__device__ __forceinline__ int8_t code(float x, float scale) {
  const int c = __float2int_rn(__fdiv_rn(x, scale));
  return static_cast<int8_t>(max(-127, min(127, c)));
}

// max over the block; every thread gets the result
__device__ __forceinline__ float block_max(float x, float* warp_max) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, s));
  }
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = x;
  __syncthreads();
  float m = warp_max[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) m = fmaxf(m, warp_max[w]);
  return m;
}

template <typename T, bool kVector>
__global__ void __launch_bounds__(kThreads)
    quantize_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                    float* __restrict__ scales, int64_t rows, int cols) {
  using V = Vec<T>;
  constexpr int N = V::N;
  __shared__ float warp_max[kWarps];
  for (int64_t r = blockIdx.x; r < rows; r += gridDim.x) {
    const T* xr = x + r * cols;
    int8_t* qr = q + r * cols;
    float amax = 0.0f;
    if (kVector) {
      const uint4* xv = reinterpret_cast<const uint4*>(xr);
      for (int i = threadIdx.x; i < cols / N; i += kThreads) {
        float f[N];
        V::load(xv[i], f);
#pragma unroll
        for (int j = 0; j < N; ++j) amax = fmaxf(amax, fabsf(f[j]));
      }
    } else {
      for (int i = threadIdx.x; i < cols; i += kThreads) {
        amax = fmaxf(amax, fabsf(to_float(xr[i])));
      }
    }
    amax = block_max(amax, warp_max);
    const float scale = amax > 0.0f ? __fmul_rn(amax, 1.0f / 127.0f) : 1.0f;
    if (threadIdx.x == 0) scales[r] = scale;
    if (kVector) {
      const uint4* xv = reinterpret_cast<const uint4*>(xr);
      for (int i = threadIdx.x; i < cols / N; i += kThreads) {
        float f[N];
        V::load(xv[i], f);
        alignas(8) int8_t c[N];
#pragma unroll
        for (int j = 0; j < N; ++j) c[j] = code(f[j], scale);
        if constexpr (N == 4) {
          reinterpret_cast<uint32_t*>(qr)[i] =
              *reinterpret_cast<const uint32_t*>(c);
        } else {
          reinterpret_cast<uint2*>(qr)[i] = *reinterpret_cast<const uint2*>(c);
        }
      }
    } else {
      for (int i = threadIdx.x; i < cols; i += kThreads) {
        qr[i] = code(to_float(xr[i]), scale);
      }
    }
    __syncthreads();  // warp_max is rewritten by the next row
  }
}

template <typename T>
cudaError_t launch_t(const void* x, void* q, void* scales, int64_t rows,
                     int cols, bool vector, cudaStream_t stream) {
  const int grid = static_cast<int>(rows < kMaxGrid ? rows : kMaxGrid);
  const T* xt = static_cast<const T*>(x);
  int8_t* qt = static_cast<int8_t*>(q);
  float* st = static_cast<float*>(scales);
  if (vector) {
    quantize_kernel<T, true><<<grid, kThreads, 0, stream>>>(xt, qt, st, rows,
                                                            cols);
  } else {
    quantize_kernel<T, false><<<grid, kThreads, 0, stream>>>(xt, qt, st,
                                                             rows, cols);
  }
  return cudaGetLastError();
}

}  // namespace

// x [rows, cols] -> q int8 [rows, cols], scales fp32 [rows].  dtype: 0
// fp32, 1 bf16, 2 fp16.  vector: rows are 16-byte aligned and a whole
// number of 16-byte vectors (the wrapper checks).
extern "C" int ds_quantize_int8(const void* x, void* q, void* scales,
                                int64_t rows, int cols, int dtype, int vector,
                                void* stream) {
  if (rows <= 0 || cols <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) err = launch_t<float>(x, q, scales, rows, cols, vector, s);
  if (dtype == 1) {
    err = launch_t<__nv_bfloat16>(x, q, scales, rows, cols, vector, s);
  }
  if (dtype == 2) err = launch_t<__half>(x, q, scales, rows, cols, vector, s);
  return static_cast<int>(err);
}
