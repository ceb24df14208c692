// Per-query gather-score of probed IVF blocks.
//
// Replaces the TPU kernel src/repro/kernels/ivf_score.py::ivf_score
// (_ivf_kernel): for queries h (Q, d) and per-query probed block ids
// block_ids (Q, P), write out[q, p, r] = h[q] . w_blocks[block_ids[q, p], r]
// in f32 for every row r of the block. It is the kernel behind
// ops.ivf_block_scores; the serving decodes use ivf_decode and
// union_scores, which never write this tensor.
//
// Bound on this card: bytes. A (query, block) pair reads one br x d block
// (bf16 or f32, as the queries) and writes br floats (qwen1.5-4b in bf16,
// Q 8 x P 16 blocks of 512 x 2560: 335 MB of block reads without
// deduplication, about 0.1 ms at 3.35 TB/s;
// queries that probe the same block read it again, from L2 when it is
// still there), and does 2 flops per element read.
//
// Design: the TPU grid walked (query, probe) pairs in order with the block
// id scalar-prefetched into the BlockSpec. Here a CTA takes 64 rows of one
// (query, probe) pair, reads the block id itself, stages the query row in
// shared memory as f32, and each of its 8 warps dots 4 rows at a time with
// 16-byte loads (f32 accumulation), so a qwen1.5-4b call launches 1024 CTAs
// and fills the card. An id outside [0, nb) writes NaN instead of reading
// out of bounds.
#include "streaming.cuh"

using namespace streaming;

constexpr int ROWS_PER_CTA = 64;

template <class T>
__global__ void __launch_bounds__(THREADS)
ivf_score_kernel(const T* __restrict__ wb, const T* __restrict__ h,
                 const int* __restrict__ block_ids, int P, int nb, int br,
                 int d, float* __restrict__ out) {
  extern __shared__ __align__(16) float hq[];
  const int qp = blockIdx.x, q = qp / P;
  const int blk = block_ids[qp];
  const int nvec = d / 8;
  for (int c = threadIdx.x; c < nvec; c += blockDim.x) {
    float f[8];
    load8(h + (size_t)q * d, c, f);
    float4* dst = reinterpret_cast<float4*>(hq + c * 8);
    dst[0] = make_float4(f[0], f[1], f[2], f[3]);
    dst[1] = make_float4(f[4], f[5], f[6], f[7]);
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int first = (int)blockIdx.y * ROWS_PER_CTA;
  const int end = min(br, first + ROWS_PER_CTA);
  float* dst = out + (size_t)qp * br;
  for (int r0 = first + warp * R; r0 < end;
       r0 += WARPS * R) {
    if (blk < 0 || blk >= nb) {
      if (lane < R && r0 + lane < end) dst[r0 + lane] = nanf("");
      continue;
    }
    const T* rows[R];
#pragma unroll
    for (int r = 0; r < R; ++r)
      rows[r] = r0 + r < end ? wb + ((size_t)blk * br + r0 + r) * d
                             : nullptr;
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.f;
#pragma unroll 1
    for (int j = lane; j < nvec; j += 32) {
      const float4* hp = reinterpret_cast<const float4*>(hq + j * 8);
      const float4 a = hp[0], b = hp[1];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (rows[r] == nullptr) continue;
        float f[8];
        load8(rows[r], j, f);
        acc[r] += f[0] * a.x + f[1] * a.y + f[2] * a.z + f[3] * a.w +
                  f[4] * b.x + f[5] * b.y + f[6] * b.z + f[7] * b.w;
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);
      if (lane == 0 && rows[r] != nullptr) dst[r0 + r] = acc[r];
    }
  }
}

template <class T>
static cudaError_t launch(const void* w_blocks, const void* h,
                          const void* block_ids, int Q, int P, int nb, int br,
                          int d, void* out, cudaStream_t stream) {
  const size_t smem = (size_t)d * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ivf_score_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(Q * P, (br + ROWS_PER_CTA - 1) / ROWS_PER_CTA);
  ivf_score_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(w_blocks), static_cast<const T*>(h),
      static_cast<const int*>(block_ids), P, nb, br, d,
      static_cast<float*>(out));
  return cudaGetLastError();
}

// f32: 1 if the rows and queries are f32, 0 if bf16.
extern "C" int ivf_score_launch(const void* w_blocks, const void* h,
                                const void* block_ids, int Q, int P, int nb,
                                int br, int d, void* out, int f32,
                                void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (f32)
    return (int)launch<float>(w_blocks, h, block_ids, Q, P, nb, br, d, out,
                              st);
  return (int)launch<__nv_bfloat16>(w_blocks, h, block_ids, Q, P, nb, br, d,
                                    out, st);
}
