// Streaming softmax cross-entropy at f32, forward, on the CUDA cores: per
// token the LSE over the vocabulary and the label's score, without writing
// the (T, V) logits.
//
// Replaces the TPU kernel src/repro/kernels/fused_ce.py::fused_ce_fwd
// (_fwd_kernel) for f32 h and W; bf16 runs on the tensor cores
// (fused_ce_fwd.cu). The f32 backward runs on the tensor cores too, on
// exact bf16 planes of its operands (fused_ce_bwd.cu).
//
// Bound on this card: operations, at the f32 rate outside the tensor
// cores. qwen1.5-4b at T = 1024: 2 T V d = 0.80 TFLOP, about 12 ms at 67
// TFLOP/s.
//
// Design: one register-tiled FFMA product, gemm_tile: BIG x BIG (128 x
// 128) output tiles of 256 threads (16 x 16), an 8 x 8 micro-tile each, in
// two halves 64 rows (columns) apart so that a thread reads its rows and
// columns of a step as float4s without bank conflicts. Slices of 8 along
// K are staged in shared memory with m (or n) contiguous; each thread
// loads one float4 of each operand a slice (K-major: K contiguous in
// memory), the next slice's into registers while the current one is
// multiplied. CTAs (vocab split, token tile) walk their split's vocab
// tiles in order with an online (m, s, label score) per token; the 16
// threads of a row share its max by shuffles. Each CTA writes one partial
// per token, merged over the splits in a fixed order, so two calls are
// bit-equal.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BIG = 128;      // output tile
constexpr int TK = 1024 / BIG;  // depth of a slice: one float4 a thread
constexpr int MT = BIG / 16;    // outputs a thread, each way
constexpr int PAD = 4;        // keeps float4 alignment, spreads banks
constexpr int THREADS = 256;  // 16 x 16 threads
constexpr float NEG = -1e30f;

using Slice = float[TK][BIG + PAD];

// X(r, k) = X[r * ld + k] of a K-major operand with `rows` rows and depth
// K. Rows and depths past the edge read as 0.
struct Operand {
  const float* p;
  int rows, K, ld;
};

// This thread's float4 of the slice rows [r0, r0 + BIG) x depths
// [k0, k0 + TK) of op: 4 depths of one row.
__device__ __forceinline__ float4 fetch(const Operand& op, int r0, int k0) {
  const int t = threadIdx.x;
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  const int gr = r0 + t / (TK / 4), gk = k0 + (t % (TK / 4)) * 4;
  if (gr < op.rows) {
    const float* src = op.p + (size_t)gr * op.ld + gk;
    if (gk + 3 < op.K) {
      v = __ldg(reinterpret_cast<const float4*>(src));
    } else {
      v.x = gk < op.K ? src[0] : 0.f;
      v.y = gk + 1 < op.K ? src[1] : 0.f;
      v.z = gk + 2 < op.K ? src[2] : 0.f;
    }
  }
  return v;
}

// Stores this thread's float4 of fetch into the slice, s[k][r].
__device__ __forceinline__ void put(float4 v, Slice& s) {
  const int t = threadIdx.x;
  const int r = t / (TK / 4), k = (t % (TK / 4)) * 4;
  s[k][r] = v.x;
  s[k + 1][r] = v.y;
  s[k + 2][r] = v.z;
  s[k + 3][r] = v.w;
}

// The tile row (or column) of this thread's i-th output along one way, for
// the thread coordinate c (ty for rows, tx for columns).
__device__ __forceinline__ int at(int i, int c) {
  return (i & 3) + 4 * c + 64 * (i >> 2);
}

// acc[i][j] = sum_k A(m0 + at(i, ty), k) B(n0 + at(j, tx), k), k ascending,
// with ty = threadIdx.x / 16, tx = threadIdx.x % 16.
__device__ __forceinline__ void gemm_tile(const Operand& A, const Operand& B,
                                          int m0, int n0,
                                          float (&acc)[MT][MT], Slice& sa,
                                          Slice& sb) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < MT; ++j) acc[i][j] = 0.f;
  float4 ra = fetch(A, m0, 0), rb = fetch(B, n0, 0);
  for (int k0 = 0; k0 < A.K; k0 += TK) {
    put(ra, sa);
    put(rb, sb);
    __syncthreads();
    if (k0 + TK < A.K) {               // the next slice, during this one
      ra = fetch(A, m0, k0 + TK);
      rb = fetch(B, n0, k0 + TK);
    }
#pragma unroll
    for (int k = 0; k < TK; ++k) {
      float av[MT], bv[MT];
#pragma unroll
      for (int h = 0; h < MT / 4; ++h) {
        const float4 a = *reinterpret_cast<const float4*>(
            &sa[k][4 * ty + 64 * h]);
        const float4 b = *reinterpret_cast<const float4*>(
            &sb[k][4 * tx + 64 * h]);
        av[4 * h] = a.x; av[4 * h + 1] = a.y;
        av[4 * h + 2] = a.z; av[4 * h + 3] = a.w;
        bv[4 * h] = b.x; bv[4 * h + 1] = b.y;
        bv[4 * h + 2] = b.z; bv[4 * h + 3] = b.w;
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < MT; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// Reductions over the 16 threads of a tile row (16 consecutive lanes).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 1; off < 16; off <<= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 1; off < 16; off <<= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// ---- forward ------------------------------------------------------------------

// grid (n_split, token tiles of BIG). part_* are (n_split, T).
__global__ void __launch_bounds__(THREADS)
ce_f32_fwd_partial(const float* __restrict__ h, const float* __restrict__ w,
                   const int* __restrict__ labels, int T, int V, int d,
                   int per, float* __restrict__ part_m,
                   float* __restrict__ part_s, float* __restrict__ part_p) {
  __shared__ __align__(16) Slice sa;
  __shared__ __align__(16) Slice sb;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int m0 = blockIdx.y * BIG;
  const Operand A{h, T, d, d}, B{w, V, d, d};
  int lab[MT];
  float m[MT], s[MT], p[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int row = m0 + at(i, ty);
    lab[i] = row < T ? labels[row] : -1;
    m[i] = NEG;
    s[i] = 0.f;
    p[i] = NEG;
  }
  const int n_vt = (V + BIG - 1) / BIG;
  const int vt1 = min(n_vt, (int)(blockIdx.x + 1) * per);
  for (int vt = blockIdx.x * per; vt < vt1; ++vt) {
    float acc[MT][MT];
    gemm_tile(A, B, m0, vt * BIG, acc, sa, sb);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < MT; ++j) {
        const int col = vt * BIG + at(j, tx);
        if (col >= V) acc[i][j] = -INFINITY;
        mx = fmaxf(mx, acc[i][j]);
        if (col == lab[i]) p[i] = acc[i][j];
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < MT; ++j) sum += expf(acc[i][j] - m_new);
      s[i] = s[i] * expf(m[i] - m_new) + sum;
      m[i] = m_new;
    }
  }
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const float si = row_sum(s[i]), pi = row_max(p[i]);
    const int row = m0 + at(i, ty);
    if (tx == 0 && row < T) {
      const size_t idx = (size_t)blockIdx.x * T + row;
      part_m[idx] = m[i];
      part_s[idx] = si;
      part_p[idx] = pi;
    }
  }
}

// One thread per token: lse = m + log(sum_p s_p exp(m_p - m)) over the
// splits in order, nll = lse - the label's score.
__global__ void ce_f32_fwd_merge(int T, int n_split,
                                 const float* __restrict__ part_m,
                                 const float* __restrict__ part_s,
                                 const float* __restrict__ part_p,
                                 float* __restrict__ nll,
                                 float* __restrict__ lse) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T) return;
  float mx = NEG, p = NEG;
  for (int k = 0; k < n_split; ++k) {
    const size_t i = (size_t)k * T + t;
    if (part_s[i] > 0.f) mx = fmaxf(mx, part_m[i]);
    p = fmaxf(p, part_p[i]);
  }
  float sum = 0.f;
  for (int k = 0; k < n_split; ++k) {
    const size_t i = (size_t)k * T + t;
    if (part_s[i] > 0.f) sum += part_s[i] * expf(part_m[i] - mx);
  }
  const float l = mx + logf(sum);
  lse[t] = l;
  nll[t] = l - p;
}

}  // namespace

// part_m / part_s / part_p: (n_split, T) f32 each; per: vocab tiles of 128
// columns a split.
extern "C" int fused_ce_f32_fwd_launch(const void* h, const void* w,
                                       const void* labels, int T, int V,
                                       int d, int n_split, int per,
                                       void* part_m, void* part_s,
                                       void* part_p, void* nll, void* lse,
                                       void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  dim3 grid(n_split, (T + BIG - 1) / BIG);
  ce_f32_fwd_partial<<<grid, THREADS, 0, st>>>(
      static_cast<const float*>(h), static_cast<const float*>(w),
      static_cast<const int*>(labels), T, V, d, per,
      static_cast<float*>(part_m), static_cast<float*>(part_s),
      static_cast<float*>(part_p));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ce_f32_fwd_merge<<<(T + 255) / 256, 256, 0, st>>>(
      T, n_split, static_cast<const float*>(part_m),
      static_cast<const float*>(part_s), static_cast<const float*>(part_p),
      static_cast<float*>(nll), static_cast<float*>(lse));
  return (int)cudaGetLastError();
}
