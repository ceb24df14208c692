// FMBE decode estimate z(x) = phi(x) . lambda, (Q,) signed f32, without a
// (Q, P) feature matrix in device memory.
//
// Replaces the TPU kernel src/repro/kernels/fmbe.py::fmbe_z (_fmbe_z_kernel).
// lambda is (P,), one shared sketch sum, or (Q, P), a per-query lambda (the
// block-partitioned complement the serving decode uses).
//
// Bound on this card: bytes. At Q = 8 and P = 4096 features of qwen1.5-4b
// (d 2560, mean degree 0.98; x bf16 or f32) the omega rows it needs are
// about 41 MB of f32 (all 8 rows of every feature would be 335 MB), about
// 12 us at 3.35 TB/s;
// the 2*Q flops per omega element read are far below the compute bound.
//
// Design: grid (features / FP, queries / QT), FP = 16 features per CTA so
// that P = 4096 gives 256 CTAs. Each CTA stages its 8 queries in shared
// memory as f32 once, dots only the live rows (j, m < degree_j) of its
// features (fmbe_tile.cuh), multiplies each feature by coef_j * lambda and
// sums its features per query in feature order. The CTAs' partial sums are
// added by a second kernel, one CTA per query, in a fixed order -- no float
// atomics, so a run is bit-reproducible.
#include "fmbe_tile.cuh"

namespace {

constexpr int FP = 16;

template <class T>
__global__ void __launch_bounds__(fmbe::THREADS, 2)
fmbe_z_partial(const float* __restrict__ omega,
               const int* __restrict__ degree,
               const float* __restrict__ coef,
               const float* __restrict__ lam, int lam_stride,
               const T* __restrict__ x, int Q, int P, int M, int d,
               float* __restrict__ part) {
  extern __shared__ __align__(16) float hs[];
  __shared__ fmbe::Tile<FP> tile;
  __shared__ float val[fmbe::QT][FP];
  const int j0 = blockIdx.x * FP, q0 = blockIdx.y * fmbe::QT;
  streaming::load_query_tile(x, Q, d, q0, hs);
  fmbe::project<FP>(omega, degree, coef, P, M, d, j0, hs, tile);
  for (int t = threadIdx.x; t < fmbe::QT * FP; t += blockDim.x) {
    const int q = t / FP, f = t % FP;
    const bool in = q0 + q < Q && j0 + f < P;
    val[q][f] = in ? fmbe::feature(tile, q, f) *
                         lam[(size_t)(q0 + q) * lam_stride + j0 + f]
                   : 0.f;
  }
  __syncthreads();
  if (threadIdx.x < fmbe::QT && q0 + threadIdx.x < Q) {
    float s = 0.f;
    for (int f = 0; f < FP; ++f) s += val[threadIdx.x][f];
    part[(size_t)(q0 + threadIdx.x) * gridDim.x + blockIdx.x] = s;
  }
}

__global__ void __launch_bounds__(streaming::MERGE_THREADS)
fmbe_z_merge(int n_part, const float* __restrict__ part,
             float* __restrict__ z) {
  __shared__ float red[streaming::MERGE_THREADS / 32];
  const float* row = part + (size_t)blockIdx.x * n_part;
  float s = 0.f;
  for (int p = threadIdx.x; p < n_part; p += streaming::MERGE_THREADS)
    s += row[p];
  s = streaming::block_sum(s, red);
  if (threadIdx.x == 0) z[blockIdx.x] = s;
}

template <class T>
cudaError_t launch(const void* omega, const void* degree, const void* coef,
                   const void* lam, int lam_stride, const void* x, int Q,
                   int P, int M, int d, int n_part, void* part, void* z,
                   cudaStream_t st) {
  const size_t smem = (size_t)fmbe::QT * d * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fmbe_z_partial<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(n_part, (Q + fmbe::QT - 1) / fmbe::QT);
  fmbe_z_partial<T><<<grid, fmbe::THREADS, smem, st>>>(
      static_cast<const float*>(omega), static_cast<const int*>(degree),
      static_cast<const float*>(coef), static_cast<const float*>(lam),
      lam_stride, static_cast<const T*>(x), Q, P, M, d,
      static_cast<float*>(part));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fmbe_z_merge<<<Q, streaming::MERGE_THREADS, 0, st>>>(
      n_part, static_cast<const float*>(part), static_cast<float*>(z));
  return cudaGetLastError();
}

}  // namespace

// f32: 1 if x is f32, 0 if bf16.
extern "C" int fmbe_z_launch(const void* omega, const void* degree,
                             const void* coef, const void* lam,
                             int lam_stride, const void* x, int Q, int P,
                             int M, int d, int n_part, void* part, void* z,
                             int f32, void* stream) {
  if (n_part != (P + FP - 1) / FP || M < 1 || M > fmbe::MMAX)
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (f32)
    return (int)launch<float>(omega, degree, coef, lam, lam_stride, x, Q, P,
                              M, d, n_part, part, z, st);
  return (int)launch<__nv_bfloat16>(omega, degree, coef, lam, lam_stride, x,
                                    Q, P, M, d, n_part, part, z, st);
}
