// Tile helpers shared by the attention kernels of flash_attention.cu and
// block_sparse_attention.cu: 64-row tiles of [*, S, H, D] operands staged in
// shared memory as fp32, rows held by groups of G = D / 16 lanes (16 dims a
// lane, as four float4 chunks interleaved over the lanes so that a warp's
// reads of one staged row hit distinct banks), dot products finished by a
// butterfly of shuffles.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;         // rows per block, keys/queries per walked tile
constexpr int kDimsPerLane = 16;  // head dims one lane holds
constexpr int kChunks = kDimsPerLane / 4;
constexpr int kSub = 32;          // forward: keys per online-softmax rescale
constexpr float kNoKeyLse = 1e30f;

template <typename T>
struct Io;

template <>
struct Io<float> {
  static constexpr int kVec = 4;  // elements per 16-byte load
  __device__ __forceinline__ static void load_vec(const float* p, float* o) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    o[0] = x.x; o[1] = x.y; o[2] = x.z; o[3] = x.w;
  }
  __device__ __forceinline__ static void load4(const float* p, float* o) {
    load_vec(p, o);
  }
  __device__ __forceinline__ static void store4(float* p, const float* x) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  }
};

template <>
struct Io<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ __forceinline__ static void load_vec(const __nv_bfloat16* p,
                                                  float* o) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h2[i]);
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static void load4(const __nv_bfloat16* p,
                                               float* o) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float2 a = __bfloat1622float2(h2[0]);
    const float2 b = __bfloat1622float2(h2[1]);
    o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
  }
  __device__ __forceinline__ static void store4(__nv_bfloat16* p,
                                                const float* x) {
    uint2 raw;
    __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&raw);
    h2[0] = __floats2bfloat162_rn(x[0], x[1]);
    h2[1] = __floats2bfloat162_rn(x[2], x[3]);
    *reinterpret_cast<uint2*>(p) = raw;
  }
};

template <>
struct Io<__half> {
  static constexpr int kVec = 8;
  __device__ __forceinline__ static void load_vec(const __half* p, float* o) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __half2* h2 = reinterpret_cast<const __half2*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __half22float2(h2[i]);
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static void load4(const __half* p, float* o) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const __half2* h2 = reinterpret_cast<const __half2*>(&raw);
    const float2 a = __half22float2(h2[0]);
    const float2 b = __half22float2(h2[1]);
    o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
  }
  __device__ __forceinline__ static void store4(__half* p, const float* x) {
    uint2 raw;
    __half2* h2 = reinterpret_cast<__half2*>(&raw);
    h2[0] = __halves2half2(__float2half_rn(x[0]), __float2half_rn(x[1]));
    h2[1] = __halves2half2(__float2half_rn(x[2]), __float2half_rn(x[3]));
    *reinterpret_cast<uint2*>(p) = raw;
  }
};

// first dim of this lane's chunk c of a row (chunks interleaved over lanes)
template <int G>
__device__ __forceinline__ int chunk_dim(int c, int sub) {
  return (c * G + sub) * 4;
}

template <int G>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// This lane's 16 dims of one global row, as fp32.
template <typename T, int G>
__device__ __forceinline__ void load_row(const T* row, int sub,
                                         float (&r)[kChunks][4]) {
#pragma unroll
  for (int c = 0; c < kChunks; ++c) Io<T>::load4(row + chunk_dim<G>(c, sub), r[c]);
}

template <typename T, int G>
__device__ __forceinline__ void store_row(T* row, int sub,
                                          const float (&r)[kChunks][4],
                                          float mult) {
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const float x[4] = {r[c][0] * mult, r[c][1] * mult, r[c][2] * mult,
                        r[c][3] * mult};
    Io<T>::store4(row + chunk_dim<G>(c, sub), x);
  }
}

// This lane's 16 dims of staged row `row` of a [kTile][D] fp32 tile.
template <int D, int G>
__device__ __forceinline__ void read_staged(const float* tile, int row,
                                            int sub, float (&r)[kChunks][4]) {
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const float4 x = *reinterpret_cast<const float4*>(
        tile + row * D + chunk_dim<G>(c, sub));
    r[c][0] = x.x; r[c][1] = x.y; r[c][2] = x.z; r[c][3] = x.w;
  }
}

__device__ __forceinline__ float dot(const float (&a)[kChunks][4],
                                     const float (&b)[kChunks][4]) {
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i) s = fmaf(a[c][i], b[c][i], s);
  return s;
}

__device__ __forceinline__ void axpy(float alpha, const float (&x)[kChunks][4],
                                     float (&y)[kChunks][4]) {
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i) y[c][i] = fmaf(alpha, x[c][i], y[c][i]);
}

// Stage rows [row0, row0 + kTile) of a [*, S, H, D] operand (base already at
// (b, 0, h)) into a [kTile][D] fp32 tile; rows at or past S become 0.
template <typename T, int D>
__device__ __forceinline__ void stage_tile(const T* __restrict__ base,
                                           size_t row_stride, int row0, int S,
                                           float* __restrict__ tile) {
  constexpr int kVec = Io<T>::kVec;
  constexpr int kPerRow = D / kVec;
  for (int t = threadIdx.x; t < kTile * kPerRow; t += blockDim.x) {
    const int r = t / kPerRow;
    const int c = t % kPerRow;
    float x[kVec];
    if (row0 + r < S) {
      Io<T>::load_vec(base + (size_t)(row0 + r) * row_stride + c * kVec, x);
    } else {
#pragma unroll
      for (int i = 0; i < kVec; ++i) x[i] = 0.f;
    }
    float4* dst = reinterpret_cast<float4*>(tile + r * D + c * kVec);
#pragma unroll
    for (int i = 0; i < kVec / 4; ++i)
      dst[i] = make_float4(x[4 * i], x[4 * i + 1], x[4 * i + 2], x[4 * i + 3]);
  }
}

// Stage a [kTile] slice of a per-position array (lse/delta [B*H, S] rows or
// segment ids [B, S] rows); 0 past S.
template <typename U>
__device__ __forceinline__ void stage_vec(const U* __restrict__ row, int pos0,
                                          int S, U* __restrict__ dst) {
  for (int t = threadIdx.x; t < kTile; t += blockDim.x)
    dst[t] = pos0 + t < S ? row[pos0 + t] : U(0);
}

}  // namespace
