// Kar-Karnick feature matrix phi(x) (Q, P) without the (Q, P, max_degree)
// projection tensor.
//
// Replaces the TPU kernel src/repro/kernels/fmbe.py::fmbe_phi
// (_fmbe_phi_kernel). It is the build-time kernel of FMBE: the serving
// build feeds the output embedding through it in chunks of blocks to form
// the per-block sketch sums lambda_blocks.
//
// Bound on this card: operations. At a chunk of 8192 vocabulary rows and
// P = 4096 features (mean degree 0.98) it does about 8.4e10 multiply-adds
// on 83 MB of inputs and writes a 134 MB output: about 2.5 ms at the f32
// rate outside the tensor cores (f32 x), about 0.17 ms at the bf16
// tensor-core rate (bf16 x, fmbe_phi_wgmma.cu).
//
// Design: grid (features / FP, queries / QT). Each CTA stages QT = 8 rows
// of f32 x in shared memory, lists the live projection rows of its FP = 64
// features, dots them on CUDA cores (fmbe_tile.cuh) and writes the QT x FP
// tile of phi, consecutive threads on consecutive features. The omega rows
// are read once per query tile, from L2 after the first: about 42 GB of L2
// reads at the chunk above. It serves f32 x, for which the tensor cores'
// bf16 products would round x; bf16 x runs on them (fmbe_phi_wgmma.cu).
#include "fmbe_tile.cuh"

namespace {

constexpr int FP = 64;

__global__ void __launch_bounds__(fmbe::THREADS, 2)
fmbe_phi_kernel(const float* __restrict__ omega,
                const int* __restrict__ degree,
                const float* __restrict__ coef, const float* __restrict__ x,
                int Q, int P, int M, int d, float* __restrict__ out) {
  extern __shared__ __align__(16) float hs[];
  __shared__ fmbe::Tile<FP> tile;
  const int j0 = blockIdx.x * FP, q0 = blockIdx.y * fmbe::QT;
  streaming::load_query_tile(x, Q, d, q0, hs);
  fmbe::project<FP>(omega, degree, coef, P, M, d, j0, hs, tile);
  for (int t = threadIdx.x; t < fmbe::QT * FP; t += blockDim.x) {
    const int q = t / FP, f = t % FP;
    if (q0 + q < Q && j0 + f < P)
      out[(size_t)(q0 + q) * P + j0 + f] = fmbe::feature(tile, q, f);
  }
}

}  // namespace

// x (Q, d) f32.
extern "C" int fmbe_phi_launch(const void* omega, const void* degree,
                               const void* coef, const void* x, int Q, int P,
                               int M, int d, void* out, void* stream) {
  if (M < 1 || M > fmbe::MMAX) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)fmbe::QT * d * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fmbe_phi_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((P + FP - 1) / FP, (Q + fmbe::QT - 1) / fmbe::QT);
  fmbe_phi_kernel<<<grid, fmbe::THREADS, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(omega), static_cast<const int*>(degree),
      static_cast<const float*>(coef), static_cast<const float*>(x), Q, P, M,
      d, static_cast<float*>(out));
  return (int)cudaGetLastError();
}
