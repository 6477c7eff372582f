// One-token GQA decode attention for Hopper (sm_90a), hand-written CUDA.
//
// Replaces two Pallas TPU kernels of the JAX package:
//   * deepspeed_tpu/ops/pallas/decode_attention.py  decode_attention
//     (_decode_kernel): keys in a padded cache [B, Smax, kv_h, d];
//   * deepspeed_tpu/ops/pallas/paged_attention.py   paged_decode_attention
//     (_paged_kernel): keys in a shared page pool [N, bs, kv_h, d] addressed
//     by a block table [B, max_blocks]; paged_decode_attention_tp runs the
//     same kernel on one rank's heads.
// Both compute, for each sequence b and query head i,
//     out[b, i] = softmax_k(q[b, i] . K[b, k, i / n_rep] / sqrt(d)) . V
// over the live keys k in [max(len - window, 0), min(len, cap)); a sequence
// with no live key (length <= 0) gets 0.
//
// What bounds it: the bytes of K and V.  One decode step reads every live
// key and value once and does 4*d flops per (query head, key), about
// 2*n_rep flops per byte read -- far under the card's ~295 flops per byte,
// so the time is the K/V bytes over the memory rate.  The card reaches that
// rate only with every SM busy and megabytes of loads in flight.
//
// The design:
//   * split-K over the sequence.  The grid is (split, kv head x query-head
//     group, sequence); block `split` walks keys [split * C, split * C + C)
//     of its sequence, C = `chunk` (256: PERF.md), cut to the live
//     range.  Chunks sit at absolute positions, so the partition depends on
//     the sequence's length and window and on C alone -- never on B, h,
//     kv_h or the SM count.  A rank of the head-sharded #2b therefore splits
//     exactly as the unsharded call does, and its heads come out bit-equal;
//     the padded (v1) and paged (v2) paths split alike too.  A block whose
//     chunk holds no live key returns at once;
//   * one block per (kv head, group of query heads): every K/V byte of the
//     chunk is read once per kv head, not once per query head;
//   * the merge runs in the same launch.  A sequence's live splits each
//     write (m, l, acc[rows][D]) in fp32 to a workspace; the last of them,
//     found by an atomic counter per (sequence, group) that it then resets
//     to 0, merges the partials in split order (never arrival order, so the
//     result does not depend on scheduling) and writes `out` in q's dtype.
//     A sequence with one live split writes `out` directly with the same
//     arithmetic.  The wrapper sizes the workspace (split_layout in
//     ops/kernels/decode_attention.py) and zeroes the counters once, when it
//     allocates them;
//   * bf16 and fp16 (gqa_decode_mma_kernel): the chunk's K and V pass
//     through shared memory in 64-key tiles staged by 16-byte cp.async
//     copies, double-buffered (tile j + 1 loads while tile j computes); for
//     the paged pool the chunk's page ids are read once a page into shared
//     memory first, so no K/V load waits on a table read.  Scores come from
//     mma.sync m16n8k16 (mma_tile.cuh): the group's query heads are the rows
//     of a 16-row A tile (rows past the group are zero; the kernel is
//     byte-bound, so idle rows cost nothing), each warp takes 16 keys of a
//     tile, S = Q.K^T and O += P.V on the tensor cores, the online softmax
//     on the accumulator fragment (no per-key shuffle chain), P rounded to
//     the inputs' 16-bit type as the plain version rounds it.  The four
//     warps' states merge in shared memory at the end;
//   * fp32 (gqa_decode_kernel) keeps its CUDA-core walk, split-K too: it is
//     the parity dtype of the v1 == v2 greedy agreement, and TF32 products
//     would keep ~3 digits.  A key is read by D/4 lanes with 16-byte loads
//     and scored by a shuffle reduction; 16 keys a pass are in flight per
//     block.
//
// Plain C interface (bound with ctypes); each entry point returns
// cudaGetLastError() after its launch.

#include "mma_tile.cuh"

#include <math.h>

namespace {

using mma::Op;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 4;   // fp32: keys in flight per lane group
constexpr int kKeys = 64;    // 16-bit: keys a staged tile holds
constexpr int kRows = 16;    // 16-bit: query heads an A tile holds
constexpr float kLog2e = 1.4426950408889634f;

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
  __device__ __forceinline__ static void store(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16(x);
  }
};

template <>
struct Vec<__half> {
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
  float* partial;       // [B * h, splits, D + 4]: acc[D], m, l of a split
  int* counters;        // [B * h]: 0 between launches
  int h, kv_h, n_rep;
  int seq_cap;          // Smax, or max_blocks * bs
  int block_size, max_blocks, num_pages;
  int window;           // <= 0: no window
  int chunk;            // C: keys a split walks, a multiple of kKeys
  int splits;           // ceil(seq_cap / C)
  int groups;           // query-head groups a kv head splits into
  float scale;
};

// The live splits of a sequence of `len` keys: [first, first + count);
// count 0 when it has no live key.  Depends on len, the window and C only.
struct Span {
  int start, end, first, count;
};

__device__ __forceinline__ Span live_splits(const Problem& p, int len) {
  Span s;
  s.start = p.window > 0 ? max(len - p.window, 0) : 0;
  s.end = min(len, p.seq_cap);
  if (s.end <= s.start) {
    s.first = 0;
    s.count = 0;
  } else {
    s.first = s.start / p.chunk;
    s.count = (s.end - 1) / p.chunk - s.first + 1;
  }
  return s;
}

template <typename T, int D>
__device__ __forceinline__ void write_out(const Problem& p, size_t head_row,
                                          int d, float m, float l,
                                          float acc) {
  const float o = m == -INFINITY ? 0.f : acc / fmaxf(l, 1e-9f);
  Vec<T>::store(static_cast<T*>(p.out) + head_row * D + d, o);
}

// A sequence without a live key: zeros for the block's rows.
template <typename T, int D>
__device__ void write_zeros(const Problem& p, int b, int head0, int rows) {
  for (int t = threadIdx.x; t < rows * D; t += kThreads)
    Vec<T>::store(static_cast<T*>(p.out) +
                      ((size_t)b * p.h + head0 + t / D) * D + t % D,
                  0.f);
}

// The block's state for `rows` query heads head0.. of sequence b
// over its split: m (in units of scaled scores), l and the unnormalised
// acc[r * D + d], in shared memory.  One live split writes out; otherwise
// the split writes its partial and the last split to arrive merges them in
// split order.
template <typename T, int D>
__device__ void finish(const Problem& p, int b, int head0, int rows,
                       int split, const Span& sp, const float* bm,
                       const float* bl, const float* bacc) {
  const size_t row0 = (size_t)b * p.h + head0;
  if (sp.count == 1) {
    for (int t = threadIdx.x; t < rows * D; t += kThreads) {
      const int r = t / D;
      write_out<T, D>(p, row0 + r, t % D, bm[r], bl[r], bacc[t]);
    }
    return;
  }
  constexpr int W = D + 4;  // a partial: acc[D], m, l, 2 pad (16 bytes)
  for (int t = threadIdx.x; t < rows * D; t += kThreads) {
    const int r = t / D;
    p.partial[((row0 + r) * p.splits + split) * W + t % D] = bacc[t];
  }
  if ((int)threadIdx.x < rows) {
    float* pm = p.partial + ((row0 + threadIdx.x) * p.splits + split) * W + D;
    pm[0] = bm[threadIdx.x];
    pm[1] = bl[threadIdx.x];
  }
  __threadfence();
  __syncthreads();
  __shared__ int last;
  int* counter = p.counters + row0;
  if (threadIdx.x == 0) last = atomicAdd(counter, 1) == sp.count - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // a thread merges four consecutive dims of one row: the row's max over
  // the splits, then the sums, acc read as float4
  for (int t = 4 * threadIdx.x; t < rows * D; t += 4 * kThreads) {
    const int r = t / D, d = t % D;
    const float* part = p.partial + (row0 + r) * p.splits * W;
    float mx = -INFINITY;
    for (int s = sp.first; s < sp.first + sp.count; ++s)
      mx = fmaxf(mx, __ldcg(part + s * W + D));
    float den = 0.f, num[4] = {0.f, 0.f, 0.f, 0.f};
    for (int s = sp.first; s < sp.first + sp.count; ++s) {
      const float c = rescale(__ldcg(part + s * W + D), mx);
      den += __ldcg(part + s * W + D + 1) * c;
      const float4 a =
          __ldcg(reinterpret_cast<const float4*>(part + s * W + d));
      num[0] += a.x * c;
      num[1] += a.y * c;
      num[2] += a.z * c;
      num[3] += a.w * c;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      write_out<T, D>(p, row0 + r, d + i, mx, den, num[i]);
  }
  if (threadIdx.x == 0) *counter = 0;  // ready for the next launch
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores; block (split, kv head x group of R query heads, b)
// ---------------------------------------------------------------------------

template <int D, int R>
__global__ void __launch_bounds__(kThreads) gqa_decode_kernel(Problem p) {
  constexpr int VEC = Vec<float>::N;
  constexpr int LPK = D / VEC;            // lanes per key
  constexpr int KPW = 32 / LPK;           // keys per warp per pass
  constexpr int GROUPS = kWarps * KPW;    // keys per block per pass
  static_assert(D % VEC == 0 && 32 % LPK == 0, "unsupported head dim");

  const float* __restrict__ q = static_cast<const float*>(p.q);
  const float* __restrict__ k = static_cast<const float*>(p.k);
  const float* __restrict__ v = static_cast<const float*>(p.v);

  const int split = blockIdx.x;
  const int g = blockIdx.y / p.groups;    // kv head
  const int b = blockIdx.z;               // sequence
  const int head0 = g * p.n_rep + (blockIdx.y % p.groups) * R;
  const Span sp = live_splits(p, p.lengths[b]);
  if (sp.count == 0) {
    if (split == 0) write_zeros<float, D>(p, b, head0, R);
    return;
  }
  if (split < sp.first || split >= sp.first + sp.count) return;
  const int lo = max(sp.start, split * p.chunk);
  const int hi = min(sp.end, split * p.chunk + p.chunk);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int sub = lane / LPK;             // key slot inside the warp
  const int dl = lane % LPK;              // this lane's slice of the dims
  const int group = warp * KPW + sub;

  float qr[R][VEC];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    Vec<float>::load(q + ((size_t)b * p.h + head0 + r) * D + dl * VEC, qr[r]);
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
  for (int base = lo; base < hi; base += GROUPS * kUnroll) {
    float kf[kUnroll][VEC], vf[kUnroll][VEC];
    bool live[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int pos = base + u * GROUPS + group;
      live[u] = pos < hi;
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
        Vec<float>::load(k + off, kf[u]);
        Vec<float>::load(v + off, vf[u]);
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
      const float lo_ = __shfl_xor_sync(0xffffffffu, l[r], off);
      const float mn = fmaxf(m[r], mo);
      const float a = rescale(m[r], mn);
      const float c = rescale(mo, mn);
      l[r] = l[r] * a + lo_ * c;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[r][i], off);
        acc[r][i] = acc[r][i] * a + ao * c;
      }
      m[r] = mn;
    }
  }

  // merge the warps in shared memory (in warp order) into the block's
  // state, kept in s_acc[0], s_bm, s_bl
  __shared__ float s_m[kWarps][R];
  __shared__ float s_l[kWarps][R];
  __shared__ float s_acc[kWarps][R][D];
  __shared__ float s_bm[R], s_bl[R];
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
    s_acc[0][r][dim] = num;  // only this thread reads this element
    if (dim == 0) {
      s_bm[r] = mx;
      s_bl[r] = den;
    }
  }
  __syncthreads();
  finish<float, D>(p, b, head0, R, split, sp, s_bm, s_bl, &s_acc[0][0][0]);
}

// ---------------------------------------------------------------------------
// bf16, fp16: tensor cores; block (split, kv head x group of 16 query
// heads, b)
// ---------------------------------------------------------------------------

// three blocks an SM (the shared memory allows three): at most 168
// registers
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 3)
gqa_decode_mma_kernel(Problem p) {
  constexpr int LD = D + 8, KC = D / 16, DT = D / 8, CH = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);       // [kRows][LD]
  T* k_s = q_s + kRows * LD;                 // [2][kKeys][LD]
  T* v_s = k_s + 2 * kKeys * LD;             // [2][kKeys][LD]
  int* page_s = reinterpret_cast<int*>(v_s + 2 * kKeys * LD);  // [chunk + 1]

  const int split = blockIdx.x;
  const int g = blockIdx.y / p.groups;       // kv head
  const int grp = blockIdx.y % p.groups;
  const int b = blockIdx.z;
  const int head0 = g * p.n_rep + grp * kRows;
  const int rows = min(kRows, p.n_rep - grp * kRows);
  const int len = p.lengths[b];  // in flight while the page ids and q load
  const int c0 = split * p.chunk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g4 = lane >> 2, t4 = lane & 3;
  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);

  // the chunk's page ids, once a page, and the group's query rows (zero
  // past the group): neither waits on the length
  int first_page = 0;
  if (p.tables != nullptr) {
    first_page = c0 / p.block_size;
    const int n = (min(c0 + p.chunk, p.seq_cap) - 1) / p.block_size -
                  first_page + 1;
    for (int t = threadIdx.x; t < n; t += kThreads)
      page_s[t] = min(max(p.tables[(size_t)b * p.max_blocks + first_page + t],
                          0),
                      p.num_pages - 1);
  }
  for (int t = threadIdx.x; t < kRows * CH; t += kThreads) {
    const int r = t / CH, c = t % CH;
    const bool ok = r < rows;
    mma::cp_async16(q_s + r * LD + c * 8,
                    q + ((size_t)b * p.h + head0 + (ok ? r : 0)) * D + c * 8,
                    ok);
  }

  const Span sp = live_splits(p, len);
  if (sp.count == 0 || split < sp.first || split >= sp.first + sp.count) {
    mma::cp_async_commit();
    mma::cp_async_wait<0>();  // the copies land before the block exits
    if (sp.count == 0 && split == 0) write_zeros<T, D>(p, b, head0, rows);
    return;
  }
  if (p.tables != nullptr) __syncthreads();  // page_s is read below
  const int lo = max(sp.start, c0), hi = min(sp.end, c0 + p.chunk);
  const int t0 = (lo - c0) / kKeys, t1 = (hi - c0 + kKeys - 1) / kKeys;

  // keys [c0 + tile * kKeys, + kKeys) into stage st; keys outside [lo, hi)
  // are zero (never read, so no stale or NaN value reaches P.V)
  auto stage = [&](int tile, int st) {
    const int base = c0 + tile * kKeys;
#pragma unroll
    for (int i = 0; i < kKeys * CH / kThreads; ++i) {
      const int t = i * kThreads + threadIdx.x;
      const int r = t / CH, c = t % CH;
      const int pos = base + r;
      const bool ok = pos >= lo && pos < hi;
      size_t row = 0;
      if (ok)
        row = p.tables != nullptr
                  ? (size_t)page_s[pos / p.block_size - first_page] *
                            p.block_size + pos % p.block_size
                  : (size_t)b * p.seq_cap + pos;
      const size_t off = (row * p.kv_h + g) * D + c * 8;
      const int dst = (st * kKeys + r) * LD + c * 8;
      mma::cp_async16(k_s + dst, k + off, ok);
      mma::cp_async16(v_s + dst, v + off, ok);
    }
  };
  stage(t0, 0);
  mma::cp_async_commit();

  const float sl2 = p.scale * kLog2e;
  float o[DT][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[n][i] = 0.f;
  uint32_t qf[KC][4];

  for (int t = t0; t < t1; ++t) {
    const int st = (t - t0) & 1;
    if (t + 1 < t1) {  // the next tile loads while this one computes
      stage(t + 1, st ^ 1);
      mma::cp_async_commit();
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    __syncthreads();
    if (t == t0) {
#pragma unroll
      for (int c = 0; c < KC; ++c) mma::load_a(qf[c], q_s, LD, 0, c * 16, lane);
    }
    const T* ks = k_s + st * kKeys * LD;
    const T* vs = v_s + st * kKeys * LD;

    // S = Q.K^T over this warp's 16 keys (two n8 tiles)
    float s[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      uint32_t bf[4];
      mma::load_b_nk(bf, ks, LD, warp * 16, c * 16, lane);
      Op<T>::mma(s[0], qf[c], bf[0], bf[1]);
      Op<T>::mma(s[1], qf[c], bf[2], bf[3]);
    }
    const int kpos = c0 + t * kKeys + warp * 16;  // this warp's first key
    if (kpos < lo || kpos + 16 > hi) {
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int pos = kpos + n * 8 + 2 * t4 + (i & 1);
          if (pos < lo || pos >= hi) s[n][i] = -INFINITY;
        }
    }

    // online softmax on the fragment: rows g4 (i = 0, 1) and g4 + 8 (2, 3)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = fmaxf(m[r], fmaxf(fmaxf(s[0][2 * r], s[0][2 * r + 1]),
                                   fmaxf(s[1][2 * r], s[1][2 * r + 1])));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_use = mx == -INFINITY ? 0.f : mx;
      const float alpha = exp2f((m[r] - m_use) * sl2);
      const float off = m_use * sl2;
      m[r] = mx;
      float rs = 0.f;
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float pr = exp2f(fmaf(s[n][2 * r + j], sl2, -off));
          s[n][2 * r + j] = pr;
          rs += pr;
        }
      l[r] = l[r] * alpha + rs;  // this lane's part; the quad sums at the end
#pragma unroll
      for (int n = 0; n < DT; ++n) {
        o[n][2 * r] *= alpha;
        o[n][2 * r + 1] *= alpha;
      }
    }

    // O += P.V, P rounded to 16 bits in registers
    uint32_t pa[4];
    mma::acc_to_a<T>(pa, s, 0);
#pragma unroll
    for (int n = 0; n < DT; n += 2) {
      uint32_t bf[4];
      mma::load_b_kn(bf, vs, LD, n * 8, warp * 16, lane);
      Op<T>::mma(o[n], pa, bf[0], bf[1]);
      Op<T>::mma(o[n + 1], pa, bf[2], bf[3]);
    }
    __syncthreads();  // this stage is free for the load after next
  }

  // the four warps' states into shared memory (over the K/V stages, free
  // after the loop's last barrier), then merged in warp order
  float* w_m = reinterpret_cast<float*>(k_s);   // [kWarps][kRows]
  float* w_l = w_m + kWarps * kRows;            // [kWarps][kRows]
  float* w_acc = w_l + kWarps * kRows;          // [kWarps][kRows][D]
  float* b_m = w_acc + kWarps * kRows * D;      // [kRows]
  float* b_l = b_m + kRows;                     // [kRows]
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = g4 + 8 * r;
    if (t4 == 0) {
      w_m[warp * kRows + row] = m[r] == -INFINITY ? -INFINITY : m[r] * p.scale;
      w_l[warp * kRows + row] = l[r];
    }
#pragma unroll
    for (int n = 0; n < DT; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        w_acc[(warp * kRows + row) * D + n * 8 + 2 * t4 + j] = o[n][2 * r + j];
  }
  __syncthreads();
  for (int t = threadIdx.x; t < rows * D; t += kThreads) {
    const int r = t / D, d = t % D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, w_m[w * kRows + r]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = rescale(w_m[w * kRows + r], mx);
      den += w_l[w * kRows + r] * c;
      num += w_acc[(w * kRows + r) * D + d] * c;
    }
    w_acc[r * D + d] = num;  // warp 0's slot: only this thread reads it
    if (d == 0) {
      b_m[r] = mx;
      b_l[r] = den;
    }
  }
  __syncthreads();
  finish<T, D>(p, b, head0, rows, split, sp, b_m, b_l, w_acc);
}

template <int D>
cudaError_t launch_fp32(Problem p, int batch, cudaStream_t stream) {
  int R = 1;
  if (p.n_rep % 8 == 0) R = 8;
  else if (p.n_rep % 4 == 0) R = 4;
  else if (p.n_rep % 2 == 0) R = 2;
  p.groups = p.n_rep / R;
  const dim3 grid(p.splits, p.kv_h * p.groups, batch);
  switch (R) {
    case 8: gqa_decode_kernel<D, 8><<<grid, kThreads, 0, stream>>>(p); break;
    case 4: gqa_decode_kernel<D, 4><<<grid, kThreads, 0, stream>>>(p); break;
    case 2: gqa_decode_kernel<D, 2><<<grid, kThreads, 0, stream>>>(p); break;
    default: gqa_decode_kernel<D, 1><<<grid, kThreads, 0, stream>>>(p); break;
  }
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_mma(Problem p, int batch, cudaStream_t stream) {
  p.groups = (p.n_rep + kRows - 1) / kRows;
  const size_t tiles = (size_t)(kRows + 4 * kKeys) * (D + 8) * sizeof(T);
  const size_t smem = tiles + (p.chunk + 1) * sizeof(int);
  static_assert((size_t)4 * kKeys * (D + 8) * sizeof(T) >=
                    (size_t)kWarps * kRows * (D + 2) * sizeof(float) +
                        2 * kRows * sizeof(float),
                "the warps' merge must fit over the K/V stages");
  cudaError_t err = cudaFuncSetAttribute(
      gqa_decode_mma_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.splits, p.kv_h * p.groups, batch);
  gqa_decode_mma_kernel<T, D><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16, 2 = float16
cudaError_t launch(Problem p, int batch, int d, int dtype,
                   cudaStream_t stream) {
  if (batch <= 0 || p.kv_h <= 0 || p.n_rep <= 0) return cudaGetLastError();
  if (p.chunk <= 0 || p.chunk % kKeys || p.seq_cap <= 0 ||
      p.splits != (p.seq_cap + p.chunk - 1) / p.chunk || batch > 65535 ||
      p.block_size <= 0)
    return cudaErrorInvalidValue;
  if (dtype == 0 && d == 64) return launch_fp32<64>(p, batch, stream);
  if (dtype == 0 && d == 128) return launch_fp32<128>(p, batch, stream);
  if (dtype == 1 && d == 64) return launch_mma<__nv_bfloat16, 64>(p, batch, stream);
  if (dtype == 1 && d == 128) return launch_mma<__nv_bfloat16, 128>(p, batch, stream);
  if (dtype == 2 && d == 64) return launch_mma<__half, 64>(p, batch, stream);
  if (dtype == 2 && d == 128) return launch_mma<__half, 128>(p, batch, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int ds_decode_attention(const void* q, const void* k_cache,
                                   const void* v_cache, const void* lengths,
                                   void* out, void* partial, void* counters,
                                   int batch, int h, int kv_h, int d,
                                   int smax, int window, int chunk,
                                   int splits, int dtype, void* stream) {
  Problem p{q, k_cache, v_cache, nullptr, static_cast<const int*>(lengths),
            out, static_cast<float*>(partial), static_cast<int*>(counters),
            h, kv_h, h / kv_h, smax, 1, 0, 0, window, chunk, splits, 1,
            1.0f / sqrtf(static_cast<float>(d))};
  return static_cast<int>(
      launch(p, batch, d, dtype, static_cast<cudaStream_t>(stream)));
}

extern "C" int ds_paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* block_tables, const void* lengths, void* out, void* partial,
    void* counters, int batch, int h, int kv_h, int d, int num_pages,
    int block_size, int max_blocks, int window, int chunk, int splits,
    int dtype, void* stream) {
  Problem p{q, k_pool, v_pool, static_cast<const int*>(block_tables),
            static_cast<const int*>(lengths), out,
            static_cast<float*>(partial), static_cast<int*>(counters), h,
            kv_h, h / kv_h, max_blocks * block_size, block_size, max_blocks,
            num_pages, window, chunk, splits, 1,
            1.0f / sqrtf(static_cast<float>(d))};
  return static_cast<int>(
      launch(p, batch, d, dtype, static_cast<cudaStream_t>(stream)));
}
