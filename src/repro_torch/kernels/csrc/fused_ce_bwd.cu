// Streaming softmax cross-entropy, backward: dh (T, d) and dW (V, d) of
// g_nll . nll + g_lse . lse, recomputing the scores instead of reading
// (T, V) logits.
//
// Replaces the TPU kernel src/repro/kernels/fused_ce.py::fused_ce_bwd
// (_bwd_kernel): one sequential (token tile, vocab tile) grid that
// accumulates dh in VMEM and dW through an aliased HBM buffer.
//
// With p = exp(s - lse) and coef = (g_nll + g_lse) p - g_nll onehot(label):
//   dh = coef W,   dW = coef^T h.
// coef is rounded to bf16 before both products, as the TPU kernel does; the
// products accumulate in f32.
//
// Bound on this card: operations. Three products of 2*T*V*d each (qwen1.5-4b
// at T = 1024: 2.4e12, about 2.4 ms at the bf16 tensor-core rate).
//
// Design: CUDA blocks run in no order, so each output has one owner and no
// float atomics are used (two calls are bit-equal):
//  * ce_grad<true> (dh): a CTA owns BX tokens and one split of the vocab.
//    For each CHUNK of its vocab it scores the chunk in BY-row sub-tiles
//    (fused_ce_tile.cuh), keeps the BX x CHUNK bf16 coef in shared memory,
//    then multiplies it by the chunk's rows of W, DC columns of d at a time,
//    adding into its own partial dh in device memory. sum_splits adds the
//    splits' partials in a fixed order.
//  * ce_grad<false> (dW): the same with the roles of h and W swapped: a CTA
//    owns BX vocab rows, keeps coef^T for CHUNK tokens and multiplies it by
//    those rows of h. At T <= CHUNK each dW row is written once.
// The scores are computed twice (once per pass), so the kernels do 4 of the
// 3 products' worth of tensor-core work.
#include "fused_ce_tile.cuh"

using namespace fused_ce;

constexpr int CHUNK = 1024;           // coef columns kept in shared memory
constexpr int CLD = CHUNK + 8;        // padded row of the coef block (bf16)
constexpr int DC = 128;               // columns of d per output pass
constexpr int DLD = DC + 8;           // padded row of a staged Y slice (bf16)
constexpr size_t COEF_BYTES = (size_t)BX * CLD * sizeof(bf16);
constexpr size_t GRAD_SMEM = COEF_BYTES + SCORE_SMEM;
static_assert(2 * BK * DLD * sizeof(bf16) <= SCORE_SMEM,
              "the output-pass stages reuse the score-tile space");
static_assert(CHUNK % BY == 0, "chunks hold whole score sub-tiles");

// Stages rows [y0, y0 + BK) of Y, columns [c0, c0 + DC); zeros past ny or d.
__device__ __forceinline__ void stage_y(const bf16* Y, int ny, int y0, int d,
                                        int c0, bf16* st) {
  constexpr int PER_ROW = DC / 8;
  for (int p = threadIdx.x; p < BK * PER_ROW; p += THREADS) {
    const int r = p / PER_ROW, c = p % PER_ROW;
    const int y = y0 + r, col = c0 + c * 8;
    const bool ok = y < ny && col < d;
    cp_async16(st + r * DLD + c * 8,
               Y + (size_t)(ok ? y : 0) * d + (ok ? col : 0), ok);
  }
}

template <bool X_IS_TOKENS>
__global__ void __launch_bounds__(THREADS, 1)
ce_grad(const bf16* __restrict__ h, const bf16* __restrict__ w,
        const int* __restrict__ labels, const float* __restrict__ lse,
        const float* __restrict__ gn, const float* __restrict__ go, int T,
        int V, int d, int y_per_split, float* __restrict__ out,
        size_t split_stride) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* coef = reinterpret_cast<bf16*>(smem);                  // [BX][CLD]
  bf16* stage = reinterpret_cast<bf16*>(smem + COEF_BYTES);
  float* s = reinterpret_cast<float*>(smem + COEF_BYTES + STAGES_BYTES);
  const bf16* X = X_IS_TOKENS ? h : w;
  const bf16* Y = X_IS_TOKENS ? w : h;
  const int nx = X_IS_TOKENS ? T : V;
  const int ny = X_IS_TOKENS ? V : T;
  const int x0 = blockIdx.x * BX;
  const int y_begin = blockIdx.y * y_per_split;
  const int y_end = min(ny, y_begin + y_per_split);
  float* o = out + blockIdx.y * split_stride;
  const int warp = threadIdx.x / 32;
  const int wx = warp / 4, wy = warp % 4;
  for (int c0 = y_begin; c0 < y_end; c0 += CHUNK) {
    const int clen = min(CHUNK, y_end - c0);
    // coef[x][y - c0] for the chunk, in BY-column sub-tiles
    for (int y0 = c0; y0 < c0 + clen; y0 += BY) {
      score_tile(X, nx, x0, Y, ny, y0, d, stage, s);
      for (int e = threadIdx.x; e < BX * BY; e += THREADS) {
        const int x = e / BY, yl = e % BY;
        const int xi = x0 + x, yi = y0 + yl;
        float c = 0.f;
        if (xi < nx && yi < y_end) {
          const int t = X_IS_TOKENS ? xi : yi;
          const int v = X_IS_TOKENS ? yi : xi;
          c = gn[t] * expf(s[x * SLD + yl] - lse[t]);
          if (v == labels[t]) c -= go[t];
        }
        coef[x * CLD + (y0 - c0) + yl] = __float2bfloat16(c);
      }
    }
    __syncthreads();
    // out[x0 + x][:] (+)= coef[x][:clen] . Y[c0 : c0 + clen][:]
    const int nk = (clen + BK - 1) / BK;      // coef past clen is 0
    for (int d0 = 0; d0 < d; d0 += DC) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
      stage_y(Y, ny, c0, d, d0, stage);
      cp_async_commit();
      for (int kk = 0; kk < nk; ++kk) {
        if (kk + 1 < nk)
          stage_y(Y, ny, c0 + (kk + 1) * BK, d, d0,
                  stage + ((kk + 1) & 1) * BK * DLD);
        cp_async_commit();
        cp_async_wait_one();
        __syncthreads();
        const bf16* ys = stage + (kk & 1) * BK * DLD;
#pragma unroll
        for (int k16 = 0; k16 < BK; k16 += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
              a[2];
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
              b[2];
#pragma unroll
          for (int i = 0; i < 2; ++i)
            wmma::load_matrix_sync(
                a[i], coef + (wx * 32 + i * 16) * CLD + kk * BK + k16, CLD);
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::load_matrix_sync(b[j], ys + k16 * DLD + wy * 32 + j * 16,
                                   DLD);
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j)
              wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
        }
        __syncthreads();
      }
      if (d0 + wy * 32 < d) {              // d % 32 == 0: whole warp tiles
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            float* dst = o + (size_t)(x0 + wx * 32 + i * 16) * d + d0 +
                         wy * 32 + j * 16;
            if (c0 != y_begin) {           // later chunks add to the first
              wmma::fragment<wmma::accumulator, 16, 16, 16, float> prev;
              wmma::load_matrix_sync(prev, dst, d, wmma::mem_row_major);
#pragma unroll
              for (int e = 0; e < prev.num_elements; ++e)
                acc[i][j].x[e] += prev.x[e];
            }
            wmma::store_matrix_sync(dst, acc[i][j], d, wmma::mem_row_major);
          }
      }
    }
    __syncthreads();                       // coef is rewritten next chunk
  }
}

// out[i] = sum over splits k (in order) of part[k * stride + i], i < n.
__global__ void sum_splits(const float* __restrict__ part, int n_split,
                           size_t stride, size_t n, float* __restrict__ out) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float acc = 0.f;
    for (int k = 0; k < n_split; ++k) acc += part[k * stride + i];
    out[i] = acc;
  }
}

extern "C" int fused_ce_bwd_launch(const void* h, const void* w,
                                   const void* labels, const void* lse,
                                   const void* gn, const void* go, int T,
                                   int V, int d, int n_split, int v_per_split,
                                   int t_per_split, void* part, void* dh,
                                   void* dw, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto hb = static_cast<const bf16*>(h);
  auto wb = static_cast<const bf16*>(w);
  auto lab = static_cast<const int*>(labels);
  auto l = static_cast<const float*>(lse);
  auto gnp = static_cast<const float*>(gn);
  auto gop = static_cast<const float*>(go);
  cudaError_t err = cudaFuncSetAttribute(
      ce_grad<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)GRAD_SMEM);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(ce_grad<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)GRAD_SMEM);
  if (err != cudaSuccess) return (int)err;
  const int t_tiles = (T + BX - 1) / BX, v_tiles = (V + BX - 1) / BX;
  const size_t t_stride = (size_t)t_tiles * BX * d;
  ce_grad<true><<<dim3(t_tiles, n_split), THREADS, GRAD_SMEM, st>>>(
      hb, wb, lab, l, gnp, gop, T, V, d, v_per_split,
      static_cast<float*>(part), t_stride);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_splits<<<264, 256, 0, st>>>(static_cast<const float*>(part), n_split,
                                  t_stride, (size_t)T * d,
                                  static_cast<float*>(dh));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ce_grad<false><<<dim3(v_tiles, 1), THREADS, GRAD_SMEM, st>>>(
      hb, wb, lab, l, gnp, gop, T, V, d, t_per_split,
      static_cast<float*>(dw), (size_t)v_tiles * BX * d);
  return (int)cudaGetLastError();
}
