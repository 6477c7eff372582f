// Multi-tensor gradient norm and fused Adam for Hopper (sm_90a),
// hand-written CUDA.
//
// Replaces two Pallas TPU kernels of the JAX package
// (deepspeed_tpu/ops/pallas/fused_optimizer.py):
//   * leaf_sqsum (_sqsum_kernel): sum of g^2 over fp32 gradients, per
//     leaf; here one launch covers the whole gradient list;
//   * fused_adam_leaf (_adam_kernel): one pass of Adam / AdamW over fp32
//     p, g, m, v, updating p, m and v in place; here one launch covers the
//     whole parameter list.
//
// What bounds them: the bytes.  The norm reads 4 bytes an element; Adam
// reads p, g, m, v and writes p, m, v, 28 bytes an element, for ~20 flops.
//
// What the design does about it:
//   * a chunk table: every tensor is cut into chunks of kChunk elements,
//     and the table row of a chunk holds (tensor index, 64-bit start,
//     length); one thread block walks one chunk with 16-byte vector loads
//     (the scalar tail of a tensor whose length is not a multiple of 4 is
//     done by the chunk that holds it).  The tensors' addresses are a
//     separate int64 array, so the table is built once for a parameter
//     list while the gradients' addresses change every step;
//   * the norm reduces in two deterministic stages and no float atomics:
//     per-chunk partials from a fixed shared-memory tree, then one block
//     that sums the partials in a fixed order.  The result repeats bit for
//     bit from run to run; a NaN or Inf anywhere reaches it;
//   * Adam keeps the TPU kernel's operation order (its lines 139-153, the
//     order of optax.scale_by_adam) with __fmul_rn / __fadd_rn / __fdiv_rn
//     / __fsqrt_rn, so that nvcc cannot contract a multiply and an add into
//     one FMA: the kernel rounds exactly where the plain PyTorch version
//     rounds;
//   * the step's scalars [lr, mult, bc1, bc2] are read from device memory
//     (the TPU kernel read them from SMEM): mult comes from the on-device
//     norm, and the host never reads the norm to take a step.
// Not yet done (later work): fusing the norm's read into the backward's
// last gradient write, and bf16 moments.
//
// Plain C interface (bound with ctypes); each entry point returns
// cudaGetLastError() after its launches.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kReduceThreads = 1024;

struct Chunk {
  int64_t tensor;
  int64_t start;
  int64_t len;
};

// chunks is int64 [3, num_chunks]: tensor index, start, length
__device__ __forceinline__ Chunk chunk_at(const int64_t* chunks,
                                          int64_t num_chunks, int64_t c) {
  return Chunk{chunks[c], chunks[num_chunks + c], chunks[2 * num_chunks + c]};
}

template <int Threads>
__device__ __forceinline__ float block_sum(float x, float* shared) {
  shared[threadIdx.x] = x;
  __syncthreads();
#pragma unroll
  for (int s = Threads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) shared[threadIdx.x] += shared[threadIdx.x + s];
    __syncthreads();
  }
  return shared[0];
}

__global__ void sqsum_partial_kernel(const int64_t* __restrict__ ptrs,
                                     const int64_t* __restrict__ chunks,
                                     int64_t num_chunks,
                                     float* __restrict__ partials) {
  __shared__ float shared[kThreads];
  const Chunk ch = chunk_at(chunks, num_chunks, blockIdx.x);
  const float* g = reinterpret_cast<const float*>(ptrs[ch.tensor]) + ch.start;
  const int64_t vecs = ch.len / 4;
  const float4* g4 = reinterpret_cast<const float4*>(g);
  float acc = 0.0f;
  for (int64_t i = threadIdx.x; i < vecs; i += kThreads) {
    const float4 x = __ldg(g4 + i);
    acc += x.x * x.x;
    acc += x.y * x.y;
    acc += x.z * x.z;
    acc += x.w * x.w;
  }
  for (int64_t i = vecs * 4 + threadIdx.x; i < ch.len; i += kThreads) {
    acc += g[i] * g[i];
  }
  const float total = block_sum<kThreads>(acc, shared);
  if (threadIdx.x == 0) partials[blockIdx.x] = total;
}

__global__ void sqsum_final_kernel(const float* __restrict__ partials,
                                   int64_t n, float* __restrict__ out) {
  __shared__ float shared[kReduceThreads];
  float acc = 0.0f;
  for (int64_t i = threadIdx.x; i < n; i += kReduceThreads) {
    acc += partials[i];
  }
  const float total = block_sum<kReduceThreads>(acc, shared);
  if (threadIdx.x == 0) out[0] = total;
}

struct AdamConsts {
  float b1, b2, one_minus_b1, one_minus_b2, eps, wd;
  int decoupled;
};

__device__ __forceinline__ void adam_element(float& p, float g_raw, float& m,
                                             float& v, float lr, float mult,
                                             float bc1, float bc2,
                                             const AdamConsts& k) {
  float g = __fmul_rn(g_raw, mult);
  if (k.wd != 0.0f && !k.decoupled) g = __fadd_rn(g, __fmul_rn(k.wd, p));
  const float m_new = __fadd_rn(__fmul_rn(k.one_minus_b1, g),
                                __fmul_rn(k.b1, m));
  const float v_new = __fadd_rn(__fmul_rn(k.one_minus_b2, __fmul_rn(g, g)),
                                __fmul_rn(k.b2, v));
  const float mu_hat = __fdiv_rn(m_new, bc1);
  const float nu_hat = __fdiv_rn(v_new, bc2);
  float direction = __fdiv_rn(mu_hat, __fadd_rn(__fsqrt_rn(nu_hat), k.eps));
  if (k.wd != 0.0f && k.decoupled) {
    direction = __fadd_rn(direction, __fmul_rn(k.wd, p));
  }
  p = __fadd_rn(p, __fmul_rn(-lr, direction));
  m = m_new;
  v = v_new;
}

// ptrs is int64 [4, num_tensors]: the rows hold p, g, m, v addresses
__global__ void adam_kernel(const int64_t* __restrict__ ptrs,
                            int64_t num_tensors,
                            const int64_t* __restrict__ chunks,
                            int64_t num_chunks,
                            const float* __restrict__ scalars,
                            AdamConsts k) {
  const Chunk ch = chunk_at(chunks, num_chunks, blockIdx.x);
  float* p = reinterpret_cast<float*>(ptrs[ch.tensor]) + ch.start;
  const float* g =
      reinterpret_cast<const float*>(ptrs[num_tensors + ch.tensor]) +
      ch.start;
  float* m = reinterpret_cast<float*>(ptrs[2 * num_tensors + ch.tensor]) +
             ch.start;
  float* v = reinterpret_cast<float*>(ptrs[3 * num_tensors + ch.tensor]) +
             ch.start;
  const float lr = scalars[0], mult = scalars[1];
  const float bc1 = scalars[2], bc2 = scalars[3];
  const int64_t vecs = ch.len / 4;
  for (int64_t i = threadIdx.x; i < vecs; i += kThreads) {
    float4 pp = reinterpret_cast<float4*>(p)[i];
    const float4 gg = __ldg(reinterpret_cast<const float4*>(g) + i);
    float4 mm = reinterpret_cast<float4*>(m)[i];
    float4 vv = reinterpret_cast<float4*>(v)[i];
    adam_element(pp.x, gg.x, mm.x, vv.x, lr, mult, bc1, bc2, k);
    adam_element(pp.y, gg.y, mm.y, vv.y, lr, mult, bc1, bc2, k);
    adam_element(pp.z, gg.z, mm.z, vv.z, lr, mult, bc1, bc2, k);
    adam_element(pp.w, gg.w, mm.w, vv.w, lr, mult, bc1, bc2, k);
    reinterpret_cast<float4*>(p)[i] = pp;
    reinterpret_cast<float4*>(m)[i] = mm;
    reinterpret_cast<float4*>(v)[i] = vv;
  }
  for (int64_t i = vecs * 4 + threadIdx.x; i < ch.len; i += kThreads) {
    adam_element(p[i], g[i], m[i], v[i], lr, mult, bc1, bc2, k);
  }
}

}  // namespace

// Sum of squares of the fp32 tensors at ptrs (int64 [num_tensors]) over
// the chunk table (int64 [3, num_chunks]); partials is fp32 scratch of
// num_chunks; the result is written to out[0].  Two kernel launches.
extern "C" int ds_multi_tensor_sqsum(const void* ptrs, const void* chunks,
                                     int num_chunks, void* partials,
                                     void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partials);
  if (num_chunks > 0) {
    sqsum_partial_kernel<<<num_chunks, kThreads, 0, s>>>(
        static_cast<const int64_t*>(ptrs),
        static_cast<const int64_t*>(chunks), num_chunks, part);
  }
  sqsum_final_kernel<<<1, kReduceThreads, 0, s>>>(part, num_chunks,
                                                  static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// One Adam step, in place, over the fp32 tensors whose addresses are the
// rows of ptrs (int64 [4, num_tensors]: p, g, m, v), walked by the chunk
// table (int64 [3, num_chunks]); scalars is fp32 [4] on the device:
// lr, mult, bc1, bc2.
extern "C" int ds_fused_adam(const void* ptrs, int num_tensors,
                             const void* chunks, int num_chunks,
                             const void* scalars, float b1, float b2,
                             float one_minus_b1, float one_minus_b2,
                             float eps, float weight_decay, int decoupled,
                             void* stream) {
  if (num_chunks <= 0) return 0;
  AdamConsts k{b1, b2, one_minus_b1, one_minus_b2, eps, weight_decay,
               decoupled};
  adam_kernel<<<num_chunks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(ptrs), num_tensors,
      static_cast<const int64_t*>(chunks), num_chunks,
      static_cast<const float*>(scalars), k);
  return static_cast<int>(cudaGetLastError());
}
