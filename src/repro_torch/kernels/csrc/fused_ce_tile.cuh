// Shared pieces of the fused cross-entropy kernels (fused_ce_fwd.cu,
// fused_ce_bwd.cu): a BX x BY tile of scores X[x] . Y[y] on the tensor cores.
//
// Both kernels stream bf16 rows of h (T, d) and of the output embedding
// w (V, d) and never write the (T, V) logits to device memory. A CTA owns BX
// rows of X (h, or w for dW) and walks over sub-tiles of BY rows of Y; each
// sub-tile's scores come from a K loop over d in slices of BK columns, staged
// in shared memory by cp.async (two stages, so the next slice loads while the
// tensor cores work on this one) and multiplied with WMMA bf16 fragments
// (mma.sync, f32 accumulation). The 8 warps split the 64 x 128 tile as
// 2 x 4 warp tiles of 32 x 32. The f32 scores land in shared memory, where
// the caller folds them.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace fused_ce {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int BX = 64;            // rows of X a CTA owns
constexpr int BY = 128;           // rows of Y in one score sub-tile
constexpr int BK = 32;            // columns of d in one staged slice
constexpr int SK = BK + 8;        // padded row of a staged slice (bf16)
constexpr int SLD = BY + 4;       // padded row of the f32 score tile
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr float NEG = -1e30f;

constexpr int STAGE_ELEMS = (BX + BY) * SK;      // bf16 per pipeline stage
constexpr size_t STAGES_BYTES = 2 * STAGE_ELEMS * sizeof(bf16);
// the two stages followed by the score tile
constexpr size_t SCORE_SMEM = STAGES_BYTES + BX * SLD * sizeof(float);

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;                     // 0: fill with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits until at most one committed group is still in flight.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Row `r` of a (n, d) bf16 matrix, columns [k0, k0 + 8), or zeros past n.
__device__ __forceinline__ void stage_piece(bf16* dst, const bf16* m, int n,
                                            int r, int d, int k0) {
  const bool ok = r < n;
  cp_async16(dst, m + (size_t)(ok ? r : 0) * d + k0, ok);
}

// Stages columns [k0, k0 + BK) of rows x0.. of X and y0.. of Y.
__device__ __forceinline__ void stage_xy(const bf16* X, int nx, int x0,
                                         const bf16* Y, int ny, int y0, int d,
                                         int k0, bf16* st) {
  constexpr int PER_ROW = BK / 8;                  // 16-byte pieces per row
  for (int p = threadIdx.x; p < (BX + BY) * PER_ROW; p += THREADS) {
    const int r = p / PER_ROW, c = p % PER_ROW;
    if (r < BX)
      stage_piece(st + r * SK + c * 8, X, nx, x0 + r, d, k0 + c * 8);
    else
      stage_piece(st + r * SK + c * 8, Y, ny, y0 + r - BX, d, k0 + c * 8);
  }
}

// s[x][y] = X[x0 + x] . Y[y0 + y] for x < BX, y < BY (f32, row stride SLD);
// rows past nx or ny score 0. `stage` holds 2 * STAGE_ELEMS bf16. Ends with
// a barrier, so every thread may read `s` on return. d % BK == 0.
__device__ __forceinline__ void score_tile(const bf16* X, int nx, int x0,
                                           const bf16* Y, int ny, int y0,
                                           int d, bf16* stage, float* s) {
  const int warp = threadIdx.x / 32;
  const int wx = warp / 4, wy = warp % 4;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  const int nk = d / BK;
  stage_xy(X, nx, x0, Y, ny, y0, d, 0, stage);
  cp_async_commit();
  for (int kk = 0; kk < nk; ++kk) {
    if (kk + 1 < nk)
      stage_xy(X, nx, x0, Y, ny, y0, d, (kk + 1) * BK,
               stage + ((kk + 1) & 1) * STAGE_ELEMS);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const bf16* xs = stage + (kk & 1) * STAGE_ELEMS;
    const bf16* ys = xs + BX * SK;
#pragma unroll
    for (int k16 = 0; k16 < BK; k16 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], xs + (wx * 32 + i * 16) * SK + k16, SK);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], ys + (wy * 32 + j * 16) * SK + k16, SK);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(s + (wx * 32 + i * 16) * SLD + wy * 32 + j * 16,
                              acc[i][j], SLD, wmma::mem_row_major);
  __syncthreads();
}

}  // namespace fused_ce
