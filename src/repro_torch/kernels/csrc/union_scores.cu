// Scores of a deduplicated block union for a whole decode batch.
//
// Replaces the TPU kernel src/repro/kernels/ivf_score.py::union_scores
// (_union_kernel): for a query batch h (Q, d) and a sorted union table
// head_ids (U_cap,) of which the first head_live slots are real, write
// out[q, s, r] = h[q] . w_blocks[head_ids[s], r] in f32 for live slots and
// exactly 0 for pad slots (s >= head_live). It is the head of the MINCE,
// FMBE and top-k decodes, which mask the scores themselves.
//
// Bound on this card: bytes. The kernel reads head_live blocks of br x d
// rows once and writes the (Q, U_cap, br) f32 output (qwen1.5-4b in bf16 at
// Q = 8: about 23 blocks of 512 x 2560 plus a 2 MB output, about 62 MB,
// about 19 us at 3.35 TB/s; about twice that in f32) and does 2*Q flops per
// element read. Rows and queries are both bf16 or both f32.
//
// Design: as ivf_decode.cu. The TPU grid walked the union slots in order
// for one query tile with scalar-prefetched block ids; here every 32-row
// group of every union slot is one unit of work, spread over every warp of
// 2 CTAs per SM. Each CTA stages its 8-query tile in shared memory as f32
// and reads head_live and the block id of its slot from device memory
// itself, so the host never synchronises on the plan. A group of a pad slot
// loads nothing and writes zeros, so the output needs no separate fill.
// There is no reduction across CTAs: every output element is written by
// exactly one warp.
#include "streaming.cuh"

using namespace streaming;

template <class T>
__global__ void __launch_bounds__(THREADS, 2)
union_scores_kernel(const T* __restrict__ wb, const T* __restrict__ h,
                    const int* __restrict__ head_ids,
                    const int* __restrict__ head_live, int Q, int U, int br,
                    int d, float* __restrict__ out) {
  extern __shared__ __align__(16) float hs[];
  const int q0 = blockIdx.y * QT;
  load_query_tile(h, Q, d, q0, hs);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int qg = q0 + lane;
  const bool owner = lane < QT && qg < Q;
  const int live = *head_live;
  const int per_slot = (br + GROUP - 1) / GROUP;
  const int n_groups = U * per_slot;
  for (int g = blockIdx.x; g < n_groups; g += gridDim.x) {
    const int slot = g / per_slot;
    const int row0 = (g - slot * per_slot) * GROUP + warp * R;
    float* dst = out + ((size_t)qg * U + slot) * br;
    if (slot >= live) {                        // pad slot: zeros, no load
      if (owner) {
#pragma unroll
        for (int r = 0; r < R; ++r)
          if (row0 + r < br) dst[row0 + r] = 0.f;
      }
      continue;
    }
    const int blk = head_ids[slot];
    const T* rows[R];
#pragma unroll
    for (int r = 0; r < R; ++r)
      rows[r] = (row0 + r < br) ? wb + ((size_t)blk * br + row0 + r) * d
                                : nullptr;
    float acc[R][QT];
    score_rows(rows, hs, d, lane, acc);
    if (owner) {
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (rows[r] != nullptr) dst[row0 + r] = pick(acc[r], lane);
    }
  }
}

template <class T>
static cudaError_t launch(const void* w_blocks, const void* h,
                          const void* head_ids, const void* head_live, int Q,
                          int U, int br, int d, int grid_x, void* out,
                          cudaStream_t stream) {
  const size_t smem = (size_t)QT * d * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      union_scores_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(grid_x, (Q + QT - 1) / QT);
  union_scores_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(w_blocks), static_cast<const T*>(h),
      static_cast<const int*>(head_ids), static_cast<const int*>(head_live),
      Q, U, br, d, static_cast<float*>(out));
  return cudaGetLastError();
}

// f32: 1 if the rows and queries are f32, 0 if bf16.
extern "C" int union_scores_launch(const void* w_blocks, const void* h,
                                   const void* head_ids,
                                   const void* head_live, int Q, int U,
                                   int br, int d, int grid_x, void* out,
                                   int f32, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (f32)
    return (int)launch<float>(w_blocks, h, head_ids, head_live, Q, U, br, d,
                              grid_x, out, st);
  return (int)launch<__nv_bfloat16>(w_blocks, h, head_ids, head_live, Q, U,
                                    br, d, grid_x, out, st);
}
