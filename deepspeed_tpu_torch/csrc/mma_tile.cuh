// Tensor-core building blocks of the attention kernels of
// flash_attention_mma.cu, block_sparse_attention_mma.cu and
// decode_attention.cu: 16-bit tiles staged in shared memory by cp.async,
// fragments loaded by ldmatrix, products by mma.sync m16n8k16 with fp32
// accumulators.
//
// Shared tiles are [rows][D + 8] 16-bit elements: the 8-element pad makes a
// row 16 bytes longer than a multiple of 128, so the 8 rows that one
// ldmatrix 8 x 8 matrix reads start on 8 distinct groups of 4 banks.
//
// Fragment layouts (PTX ISA, mma.m16n8k16, 16-bit A/B, fp32 C); lane l, g =
// l / 4, t = l % 4:
//   A 16 x 16 (4 regs): a0 (row g, cols 2t, 2t+1), a1 (row g+8), a2 (row g,
//     cols 2t+8, 2t+9), a3 (row g+8, cols 2t+8, 2t+9);
//   B 16 x 8 (2 regs): b0 (k 2t, 2t+1; n g), b1 (k 2t+8, 2t+9; n g);
//   C 16 x 8 (4 fp32): c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mma {

template <typename T>
struct Op;

template <>
struct Op<__nv_bfloat16> {
  // two fp32 values as one register of two bf16, lo in the low half
  __device__ __forceinline__ static uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  // the two values of a register made by pack, as fp32
  __device__ __forceinline__ static float2 unpack(uint32_t u) {
    return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
  }
  __device__ __forceinline__ static void mma(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

template <>
struct Op<__half> {
  __device__ __forceinline__ static uint32_t pack(float lo, float hi) {
    __half2 v = __halves2half2(__float2half_rn(lo), __float2half_rn(hi));
    return *reinterpret_cast<uint32_t*>(&v);
  }
  __device__ __forceinline__ static float2 unpack(uint32_t u) {
    return __half22float2(*reinterpret_cast<__half2*>(&u));
  }
  __device__ __forceinline__ static void mma(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; nothing is read and 16 zero bytes are written
// when !ok (the src-size operand, not a branch)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 16 : 0));
}

// 4 bytes global -> shared, zero when !ok
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// four 8 x 8 16-bit matrices; lanes 8i..8i+7 give the row addresses of
// matrix i, which lands in r[i]
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// the same, each matrix transposed
__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// The A fragment of the 16 x 16 block at (row0, col0) of a row-major tile
// with row stride ld.
template <typename T>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const T* tile,
                                       int ld, int row0, int col0,
                                       int lane) {
  ldsm4(a, tile + (row0 + (lane & 15)) * ld + col0 + (lane >> 4) * 8);
}

// B fragments of two n8 tiles (n0, n0 + 8) over k16 (k0) from a tile laid
// out [n][k] (keys by dims for Q·Kᵀ): r[0], r[1] are b0, b1 of the first
// n8 tile, r[2], r[3] of the second.
template <typename T>
__device__ __forceinline__ void load_b_nk(uint32_t (&r)[4], const T* tile,
                                          int ld, int n0, int k0, int lane) {
  ldsm4(r, tile + (n0 + (lane & 7) + (lane >> 4) * 8) * ld + k0 +
               ((lane >> 3) & 1) * 8);
}

// The same from a tile laid out [k][n] (keys by dims for P·V), through the
// transposing load.
template <typename T>
__device__ __forceinline__ void load_b_kn(uint32_t (&r)[4], const T* tile,
                                          int ld, int n0, int k0, int lane) {
  ldsm4_t(r, tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0 +
                 (lane >> 4) * 8);
}

// The A fragment of k16 chunk kc of a 16-row fp32 accumulator row block
// (n8 tiles 2kc, 2kc + 1), rounded to 16 bits in registers.
template <typename T, int N>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4],
                                         const float (&c)[N][4], int kc) {
  a[0] = Op<T>::pack(c[2 * kc][0], c[2 * kc][1]);
  a[1] = Op<T>::pack(c[2 * kc][2], c[2 * kc][3]);
  a[2] = Op<T>::pack(c[2 * kc + 1][0], c[2 * kc + 1][1]);
  a[3] = Op<T>::pack(c[2 * kc + 1][2], c[2 * kc + 1][3]);
}

// The same chunk as two 16-bit parts, hi = round(c) and lo = round(c - hi):
// hi + lo holds c to about 2^-16 relative in bf16 (2^-22 in fp16), so
// hi·B + lo·B on the tensor cores is the product of the fp32 operand to
// within the fp32 accumulation.  The backward passes multiply dS so: JAX
// keeps ds in fp32 there, and dS = P (dP - delta) can be large where dP
// and delta do not cancel, so one 16-bit rounding of it shows in dq and dk.
template <typename T, int N>
__device__ __forceinline__ void acc_to_a_split(uint32_t (&hi)[4],
                                               uint32_t (&lo)[4],
                                               const float (&c)[N][4],
                                               int kc) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float x0 = c[2 * kc + (i >> 1)][2 * (i & 1)];
    const float x1 = c[2 * kc + (i >> 1)][2 * (i & 1) + 1];
    hi[i] = Op<T>::pack(x0, x1);
    const float2 h = Op<T>::unpack(hi[i]);
    lo[i] = Op<T>::pack(x0 - h.x, x1 - h.y);
  }
}

// The staging and storing of [*, S, H, D] operands that the tensor-core
// attention kernels share (flash_attention_mma.cu,
// block_sparse_attention_mma.cu): blocks of kBlockThreads threads, tiles
// of kTileRows rows.
constexpr int kTileRows = 64;
constexpr int kBlockThreads = 128;

// Rows [row0, row0 + kTileRows) of a [*, S, H, D] operand (base at (b, 0,
// h), row stride `stride` elements) into a [kTileRows][D + 8] shared tile;
// rows at or past S are zero.
template <typename T, int D>
__device__ __forceinline__ void stage_rows(T* dst, const T* src,
                                           size_t stride, int row0, int S) {
  constexpr int kChunks = D / 8;  // 16-byte chunks a row
#pragma unroll
  for (int i = 0; i < kTileRows * kChunks / kBlockThreads; ++i) {
    const int t = i * kBlockThreads + threadIdx.x;
    const int r = t / kChunks, c = t % kChunks;
    const bool ok = row0 + r < S;
    cp_async16(dst + r * (D + 8) + c * 8,
               src + (size_t)(ok ? row0 + r : 0) * stride + c * 8, ok);
  }
}

// kTileRows 4-byte values row[pos0 ..] (lse, delta or segment ids), 0 past
// S.
template <typename U>
__device__ __forceinline__ void stage_vec(U* dst, const U* row, int pos0,
                                          int S) {
  const int t = threadIdx.x;
  if (t < kTileRows) {
    const bool ok = pos0 + t < S;
    cp_async4(dst + t, row + (ok ? pos0 + t : 0), ok);
  }
}

// Store a warp's 16 x D fp32 accumulator block times `mult` to rows
// row0 .. row0 + 15 of a [*, S, H, D] output; rows past S are skipped.
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* dst, size_t stride, int row0,
                                           int S, const float (&c)[D / 8][4],
                                           float mult0, float mult1,
                                           int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + g + half * 8;
    if (row >= S) continue;
    const float mult = half ? mult1 : mult0;
    T* out = dst + (size_t)row * stride + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(out + n * 8) = Op<T>::pack(
          c[n][2 * half] * mult, c[n][2 * half + 1] * mult);
  }
}

}  // namespace mma
