// Shared pieces of the streaming-score kernels (topk_z.cu; ivf_score.cu
// uses the row loads, and the gathered-row kernels of gather_stream.cuh the
// top-k list and merge_partials).
//
// Rows and queries are bf16 or f32 (the template parameter T of the loaders;
// each kernel is instantiated for both). An f32 row is read as two 16-byte
// loads per 8 elements instead of one; accumulation is f32 either way.
//
// topk_z streams rows of an output embedding past a small tile of decode
// queries held in shared memory, and folds each row's scores into a
// per-query online logsumexp and a running top-k. The TPU kernels ran that
// fold as one sequential grid per query tile; here the rows are split over
// every warp of every CTA, each warp keeps its own partial (m, s, top-k),
// the CTA folds its warps' partials into one, and `merge_partials` reduces
// the CTAs' partials of one query in a second, small kernel. The top-k
// order is total -- score descending, then id ascending -- so the result
// does not depend on which warp saw which row, and it keeps the TPU
// kernels' rule that the lowest id wins among equal scores.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace streaming {

// Tile sizes chosen by a sweep on an H100 (R in {2, 4, 8}, the row loop
// unrolled 1, 2 or 4 times, 1 or 2 CTAs per SM): R = 4, no unrolling and
// 2 CTAs per SM streamed the qwen1.5-4b head fastest.
constexpr int QT = 8;        // queries per CTA (one lane of a warp each)
constexpr int R = 4;         // rows a warp scores per step
constexpr int WARPS = 8;     // warps per CTA
constexpr int THREADS = WARPS * 32;
constexpr int GROUP = WARPS * R;   // rows a CTA scores per step
constexpr float NEG = -1e30f;
constexpr int MERGE_THREADS = 128;

__device__ __forceinline__ bool better(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

// Running top-KMAX list, sorted by `better`; starts at the filler (NEG, 0).
template <int KMAX>
struct TopK {
  float v[KMAX];
  int i[KMAX];
  __device__ __forceinline__ void init() {
#pragma unroll
    for (int j = 0; j < KMAX; ++j) { v[j] = NEG; i[j] = 0; }
  }
  __device__ __forceinline__ void insert(float x, int id) {
    if (!better(x, id, v[KMAX - 1], i[KMAX - 1])) return;
    v[KMAX - 1] = x;
    i[KMAX - 1] = id;
#pragma unroll
    for (int j = KMAX - 1; j > 0; --j) {
      if (better(v[j], i[j], v[j - 1], i[j - 1])) {
        float tv = v[j]; v[j] = v[j - 1]; v[j - 1] = tv;
        int ti = i[j]; i[j] = i[j - 1]; i[j - 1] = ti;
      }
    }
  }
};

// Online logsumexp: (m, s) with lse = m + log(s); s == 0 means empty.
__device__ __forceinline__ void online_add(float& m, float& s, float x) {
  float mn = fmaxf(m, x);
  s = s * expf(m - mn) + expf(x - mn);
  m = mn;
}

__device__ __forceinline__ void bf16x8(const uint4& u, float* f) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float2 t = __bfloat1622float2(p[j]);
    f[2 * j] = t.x;
    f[2 * j + 1] = t.y;
  }
}

// Elements [8 c, 8 c + 8) of a row as f32: one 16-byte load of bf16, two
// of f32.
__device__ __forceinline__ void load8(const __nv_bfloat16* row, int c,
                                      float* f) {
  bf16x8(__ldg(reinterpret_cast<const uint4*>(row) + c), f);
}

__device__ __forceinline__ void load8(const float* row, int c, float* f) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(row) + 2 * c);
  const float4 b = __ldg(reinterpret_cast<const float4*>(row) + 2 * c + 1);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

// Copies queries [q0, q0 + QT) of h (Q, d) into shared memory as f32, zero
// rows past Q; 16-byte loads (d % 8 == 0).
template <class T>
__device__ __forceinline__ void load_query_tile(const T* h, int Q, int d,
                                                int q0, float* hs) {
  const int nvec = d / 8;
  for (int idx = threadIdx.x; idx < QT * nvec; idx += blockDim.x) {
    const int q = idx / nvec, c = idx - q * nvec;
    float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (q0 + q < Q) load8(h + (size_t)(q0 + q) * d, c, f);
    float4* dst = reinterpret_cast<float4*>(hs + q * d + c * 8);
    dst[0] = make_float4(f[0], f[1], f[2], f[3]);
    dst[1] = make_float4(f[4], f[5], f[6], f[7]);
  }
  __syncthreads();
}

// Dot products of R rows (null = absent, scores 0) with the QT queries in
// shared memory, accumulated in f32. Every lane returns all R x QT sums.
template <class T>
__device__ __forceinline__ void score_rows(const T* const* rows,
                                           const float* hs, int d, int lane,
                                           float (&acc)[R][QT]) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int q = 0; q < QT; ++q) acc[r][q] = 0.f;
  const int nvec = d / 8;
#pragma unroll 1
  for (int j = lane; j < nvec; j += 32) {
    float wv[R][8];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (rows[r] != nullptr) {
        load8(rows[r], j, wv[r]);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) wv[r][e] = 0.f;
      }
    }
#pragma unroll
    for (int q = 0; q < QT; ++q) {
      const float4* hp = reinterpret_cast<const float4*>(hs + q * d + j * 8);
      float4 a = hp[0], b = hp[1];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        acc[r][q] += wv[r][0] * a.x + wv[r][1] * a.y + wv[r][2] * a.z +
                     wv[r][3] * a.w + wv[r][4] * b.x + wv[r][5] * b.y +
                     wv[r][6] * b.z + wv[r][7] * b.w;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int q = 0; q < QT; ++q)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[r][q] += __shfl_xor_sync(0xffffffffu, acc[r][q], off);
}

// acc[r][lane] without dynamic register indexing.
__device__ __forceinline__ float pick(const float (&a)[QT], int lane) {
  float x = 0.f;
#pragma unroll
  for (int q = 0; q < QT; ++q) x = (q == lane) ? a[q] : x;
  return x;
}

// Inserts a sorted list into `t`, stopping at the first entry that does
// not enter (the rest cannot either).
template <int KMAX>
__device__ __forceinline__ void insert_sorted(TopK<KMAX>& t, const float* v,
                                              const int* i, int n) {
  for (int j = 0; j < n; ++j) {
    if (!better(v[j], i[j], t.v[KMAX - 1], t.i[KMAX - 1])) break;
    t.insert(v[j], i[j]);
  }
}

// Folds the per-warp (m, s) of each query into one per CTA; the result is
// valid in lanes < QT of warp 0. `sm`/`ss` are shared [WARPS][QT].
__device__ __forceinline__ void cta_lse(float& m, float& s, int warp,
                                        int lane, float (*sm)[QT],
                                        float (*ss)[QT]) {
  if (lane < QT) { sm[warp][lane] = m; ss[warp][lane] = s; }
  __syncthreads();
  if (warp == 0 && lane < QT) {
    float mx = NEG, sum = 0.f;
    for (int w = 0; w < WARPS; ++w)
      if (ss[w][lane] > 0.f) mx = fmaxf(mx, sm[w][lane]);
    for (int w = 0; w < WARPS; ++w)
      if (ss[w][lane] > 0.f) sum += ss[w][lane] * expf(sm[w][lane] - mx);
    m = mx;
    s = sum;
  }
}

// Folds the per-warp top-k lists of each query into one per CTA (valid in
// lanes < QT of warp 0). `sv`/`si` are shared [WARPS][QT][KMAX].
template <int KMAX>
__device__ __forceinline__ void cta_topk(TopK<KMAX>& t, int warp, int lane,
                                         float (*sv)[QT][KMAX],
                                         int (*si)[QT][KMAX]) {
  if (lane < QT) {
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      sv[warp][lane][j] = t.v[j];
      si[warp][lane][j] = t.i[j];
    }
  }
  __syncthreads();
  if (warp == 0 && lane < QT) {
    for (int w = 1; w < WARPS; ++w)
      insert_sorted(t, sv[w][lane], si[w][lane], KMAX);
  }
}

// Partial layout: index (query, part) with part = blockIdx.x; top-k
// partials are (query, part, k).
template <int KMAX>
__device__ __forceinline__ void write_topk(const TopK<KMAX>& t, int k,
                                           float* pv, int* pi, size_t base) {
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    if (j < k) { pv[base + j] = t.v[j]; pi[base + j] = t.i[j]; }
  }
}

__device__ __forceinline__ float block_max(float x, float* red) {
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();
  if (lane == 0) red[w] = x;
  __syncthreads();
  x = red[0];
  for (int i = 1; i < MERGE_THREADS / 32; ++i) x = fmaxf(x, red[i]);
  return x;
}

__device__ __forceinline__ float block_sum(float x, float* red) {
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();
  if (lane == 0) red[w] = x;
  __syncthreads();
  x = 0.f;
  for (int i = 0; i < MERGE_THREADS / 32; ++i) x += red[i];
  return x;
}

// LSE of one query's P partials (m, s): m + log(sum s exp(m_p - m)), with
// -inf when every partial is empty.
__device__ __forceinline__ float merge_lse(const float* pm, const float* ps,
                                           int P, float* red) {
  float mx = NEG;
  for (int p = threadIdx.x; p < P; p += MERGE_THREADS)
    if (ps[p] > 0.f) mx = fmaxf(mx, pm[p]);
  mx = block_max(mx, red);
  float s = 0.f;
  for (int p = threadIdx.x; p < P; p += MERGE_THREADS)
    if (ps[p] > 0.f) s += ps[p] * expf(pm[p] - mx);
  s = block_sum(s, red);
  return s > 0.f ? mx + logf(s) : -INFINITY;
}

// One CTA per query: head LSE, optional tail LSE, and the top-k of all
// partial lists (tree merge of per-thread lists in shared memory).
template <int KMAX>
__global__ void __launch_bounds__(MERGE_THREADS)
merge_partials(int P, int k, const float* __restrict__ hm,
               const float* __restrict__ hs, const float* __restrict__ pv,
               const int* __restrict__ pi, const float* __restrict__ tm,
               const float* __restrict__ ts, float* __restrict__ lse,
               float* __restrict__ tail_lse, float* __restrict__ topv,
               int* __restrict__ topi) {
  __shared__ float red[MERGE_THREADS / 32];
  __shared__ float sv[MERGE_THREADS * KMAX];
  __shared__ int si[MERGE_THREADS * KMAX];
  // launched as a programmatic dependent (ivf_decode.cu), the partials
  // are complete and visible past this; otherwise it returns at once
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int q = blockIdx.x, t = threadIdx.x;
  const size_t row = (size_t)q * P;
  float l = merge_lse(hm + row, hs + row, P, red);
  if (t == 0) lse[q] = l;
  if (tm != nullptr) {
    float tl = merge_lse(tm + row, ts + row, P, red);
    if (t == 0) tail_lse[q] = tl;
  }
  TopK<KMAX> mine;
  mine.init();
  for (int p = t; p < P; p += MERGE_THREADS)
    insert_sorted(mine, pv + (row + p) * k, pi + (row + p) * k, k);
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    sv[t * KMAX + j] = mine.v[j];
    si[t * KMAX + j] = mine.i[j];
  }
  for (int stride = MERGE_THREADS / 2; stride > 0; stride >>= 1) {
    __syncthreads();
    if (t < stride) {
      const float* av = sv + t * KMAX;
      const int* ai = si + t * KMAX;
      const float* bv = sv + (t + stride) * KMAX;
      const int* bi = si + (t + stride) * KMAX;
      float ov[KMAX];
      int oi[KMAX];
      int ia = 0, ib = 0;
#pragma unroll
      for (int j = 0; j < KMAX; ++j) {
        if (better(av[ia], ai[ia], bv[ib], bi[ib])) {
          ov[j] = av[ia]; oi[j] = ai[ia]; ++ia;
        } else {
          ov[j] = bv[ib]; oi[j] = bi[ib]; ++ib;
        }
      }
#pragma unroll
      for (int j = 0; j < KMAX; ++j) {
        sv[t * KMAX + j] = ov[j];
        si[t * KMAX + j] = oi[j];
      }
    }
  }
  __syncthreads();
  if (t < k) {
    topv[(size_t)q * k + t] = sv[t];
    topi[(size_t)q * k + t] = si[t];
  }
}

}  // namespace streaming
