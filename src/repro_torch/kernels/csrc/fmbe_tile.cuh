// The feature tile of fmbe_z.cu: Kar-Karnick features phi_j(x) = coef_j *
// prod_{m < degree_j} (omega_{j,m} . x) of a tile of QT queries for FP
// consecutive features.
//
// The TPU kernels (src/repro/kernels/fmbe.py::_phi_tile) built a feature
// tile as max_degree full (block_q, d) x (d, block_p) matmuls and
// multiplied by 1 where m >= degree_j. Degrees follow a truncated
// geometric law (mean about 0.98 at p = 2), so most of that work is thrown
// away. Here a CTA lists the projection rows (j, m) with m < degree_j of
// its FP features -- about one per feature -- and its warps share the list:
// each warp dots UR rows of omega (f32, +-1) at a time with the QT queries
// staged in shared memory as f32 (from bf16 or f32 queries,
// streaming::load_query_tile), lanes splitting d in 16-byte loads, and
// leaves the projections in shared memory. Degree-0 features read nothing.
// The products are then taken per (query, feature) in the TPU kernel's
// factor order (m ascending, then coef), so a run is bit-reproducible.
#pragma once

#include "streaming.cuh"

namespace fmbe {

using streaming::QT;
using streaming::THREADS;
using streaming::WARPS;

constexpr int MMAX = 8;      // largest max_degree the kernels take
constexpr int UR = 2;        // projection rows a warp dots at a time

template <int FP>
struct Tile {
  float proj[QT][FP][MMAX];  // projections of the tile's live rows
  int unit[FP * MMAX];       // live rows, f * MMAX + m
  int deg[FP];
  float coef[FP];
  int n_units;
};

// UR rows of omega (null = absent) against the QT staged queries: every
// lane returns all UR x QT dot products, accumulated in f32.
__device__ __forceinline__ void dot_rows(const float* const* rows,
                                         const float* hs, int d, int lane,
                                         float (&acc)[UR][QT]) {
#pragma unroll
  for (int u = 0; u < UR; ++u)
#pragma unroll
    for (int q = 0; q < QT; ++q) acc[u][q] = 0.f;
  const int n4 = d / 4;
#pragma unroll 2
  for (int c = lane; c < n4; c += 32) {
    float4 w[UR];
#pragma unroll
    for (int u = 0; u < UR; ++u)
      w[u] = rows[u] != nullptr
                 ? __ldg(reinterpret_cast<const float4*>(rows[u]) + c)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int q = 0; q < QT; ++q) {
      const float4 x = reinterpret_cast<const float4*>(hs + q * d)[c];
#pragma unroll
      for (int u = 0; u < UR; ++u)
        acc[u][q] += w[u].x * x.x + w[u].y * x.y + w[u].z * x.z +
                     w[u].w * x.w;
    }
  }
#pragma unroll
  for (int u = 0; u < UR; ++u)
#pragma unroll
    for (int q = 0; q < QT; ++q)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[u][q] += __shfl_xor_sync(0xffffffffu, acc[u][q], off);
}

// Fills t.proj for features [j0, j0 + FP) of omega (P, M, d) and queries
// staged in hs. Ends with the CTA synchronised.
template <int FP>
__device__ __forceinline__ void project(const float* __restrict__ omega,
                                        const int* __restrict__ degree,
                                        const float* __restrict__ coef,
                                        int P, int M, int d, int j0,
                                        const float* hs, Tile<FP>& t) {
  for (int f = threadIdx.x; f < FP; f += blockDim.x) {
    const bool in = j0 + f < P;
    t.deg[f] = in ? min(degree[j0 + f], M) : 0;
    t.coef[f] = in ? coef[j0 + f] : 0.f;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int n = 0;
    for (int f = 0; f < FP; ++f)
      for (int m = 0; m < t.deg[f]; ++m) t.unit[n++] = f * MMAX + m;
    t.n_units = n;
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n = t.n_units;
  for (int e0 = warp * UR; e0 < n; e0 += WARPS * UR) {
    const float* rows[UR];
    int code[UR];
#pragma unroll
    for (int u = 0; u < UR; ++u) {
      code[u] = e0 + u < n ? t.unit[e0 + u] : -1;
      rows[u] = code[u] < 0 ? nullptr
                            : omega + ((size_t)(j0 + code[u] / MMAX) * M +
                                       code[u] % MMAX) * d;
    }
    float acc[UR][QT];
    dot_rows(rows, hs, d, lane, acc);
#pragma unroll
    for (int u = 0; u < UR; ++u) {
      if (code[u] < 0 || lane >= QT) continue;
      t.proj[lane][code[u] / MMAX][code[u] % MMAX] =
          streaming::pick(acc[u], lane);
    }
  }
  __syncthreads();
}

// phi of (query q, feature f) from the tile: the projections multiplied
// in m order, then coef.
template <int FP>
__device__ __forceinline__ float feature(const Tile<FP>& t, int q, int f) {
  float prod = 1.f;
  for (int m = 0; m < t.deg[f]; ++m) prod *= t.proj[q][f][m];
  return prod * t.coef[f];
}

}  // namespace fmbe
