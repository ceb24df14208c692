// Streaming softmax cross-entropy, forward: per token the LSE over the
// vocabulary and the label's score, without writing the (T, V) logits.
//
// Replaces the TPU kernel src/repro/kernels/fused_ce.py::fused_ce_fwd
// (_fwd_kernel): an online (m, s) and the label's score carried across a
// sequential vocab grid per token tile.
//
// Bound on this card: operations. 2*T*V*d multiply-adds (qwen1.5-4b at
// T = 1024: 8.0e11, about 0.81 ms at the bf16 tensor-core rate) against 778
// MB of W read once (0.23 ms).
//
// Design: CUDA blocks run in no order, so nothing is carried across CTAs.
// A CTA owns a tile of BX tokens and one split of the vocabulary; it scores
// BY-row sub-tiles of W on the tensor cores (fused_ce_tile.cuh) and folds
// each into the per-token online (m, s) and label score in shared memory,
// one warp per 8 tokens. It writes one partial (m, s, p) per token and
// split; a second kernel merges the splits of each token in a fixed order.
// Splits give every SM work at T = 1024 (16 token tiles), and the CTAs of one
// split are adjacent in launch order, so they share W's sub-tiles in L2.
#include "fused_ce_tile.cuh"

using namespace fused_ce;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__global__ void __launch_bounds__(THREADS)
fused_ce_fwd_partial(const bf16* __restrict__ h, const bf16* __restrict__ w,
                     const int* __restrict__ labels, int T, int V, int d,
                     int v_per_split, float* __restrict__ part_m,
                     float* __restrict__ part_s, float* __restrict__ part_p) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* stage = reinterpret_cast<bf16*>(smem);
  float* s = reinterpret_cast<float*>(smem + STAGES_BYTES);
  __shared__ float rm[BX], rs[BX], rp[BX];
  __shared__ int rl[BX];
  const int t0 = blockIdx.x * BX;
  const int v_begin = blockIdx.y * v_per_split;
  const int v_end = min(V, v_begin + v_per_split);
  for (int r = threadIdx.x; r < BX; r += THREADS) {
    rm[r] = NEG;
    rs[r] = 0.f;
    rp[r] = NEG;
    rl[r] = t0 + r < T ? labels[t0 + r] : -1;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  constexpr int ROWS = BX / WARPS;                 // tokens per warp
  constexpr int PER_LANE = BY / 32;                // columns per lane
  for (int v0 = v_begin; v0 < v_end; v0 += BY) {
    score_tile(h, T, t0, w, V, v0, d, stage, s);   // ends with a barrier
#pragma unroll 1
    for (int rr = 0; rr < ROWS; ++rr) {
      const int r = warp * ROWS + rr;
      float x[PER_LANE];
      float mx = NEG, pick = NEG;
#pragma unroll
      for (int c = 0; c < PER_LANE; ++c) {
        const int col = v0 + lane + 32 * c;
        const bool ok = col < v_end;
        x[c] = ok ? s[r * SLD + lane + 32 * c] : NEG;
        mx = fmaxf(mx, x[c]);
        if (ok && col == rl[r]) pick = x[c];
      }
      mx = warp_max(mx);
      pick = warp_max(pick);
      const float m_old = rm[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < PER_LANE; ++c)
        if (v0 + lane + 32 * c < v_end) sum += expf(x[c] - m_new);
      sum = warp_sum(sum);
      if (lane == 0) {
        rs[r] = rs[r] * expf(m_old - m_new) + sum;
        rm[r] = m_new;
        rp[r] = fmaxf(rp[r], pick);
      }
      __syncwarp();
    }
  }
  __syncthreads();
  for (int r = threadIdx.x; r < BX; r += THREADS) {
    if (t0 + r >= T) continue;
    const size_t idx = (size_t)blockIdx.y * T + t0 + r;
    part_m[idx] = rm[r];
    part_s[idx] = rs[r];
    part_p[idx] = rp[r];
  }
}

// One thread per token: lse = m + log(sum_p s_p exp(m_p - m)) over the
// splits in order, nll = lse - the label's score.
__global__ void fused_ce_fwd_merge(int T, int n_split,
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

extern "C" int fused_ce_fwd_launch(const void* h, const void* w,
                                   const void* labels, int T, int V, int d,
                                   int n_split, int v_per_split, void* part_m,
                                   void* part_s, void* part_p, void* nll,
                                   void* lse, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      fused_ce_fwd_partial, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SCORE_SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + BX - 1) / BX, n_split);
  fused_ce_fwd_partial<<<grid, THREADS, SCORE_SMEM, st>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(w),
      static_cast<const int*>(labels), T, V, d, v_per_split,
      static_cast<float*>(part_m), static_cast<float*>(part_s),
      static_cast<float*>(part_p));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fused_ce_fwd_merge<<<(T + 255) / 256, 256, 0, st>>>(
      T, n_split, static_cast<const float*>(part_m),
      static_cast<const float*>(part_s), static_cast<const float*>(part_p),
      static_cast<float*>(nll), static_cast<float*>(lse));
  return (int)cudaGetLastError();
}
