// Item-order and epilogue microbenchmark of the tensor-core fmbe_phi
// (src/repro_torch/kernels/csrc/fmbe_phi_wgmma.cu). It runs that kernel's
// own Job with two things varied at compile time:
//  - G, the row tiles in a group of items (walked row tile fastest within
//    a group; G = 1 walks the column tile fastest); the kernel uses 8;
//  - EPI, whether the epilogue runs: without it the kernel is its
//    mainloop alone and leaves phi unwritten.
// G = 8 with the epilogue is the kernel itself.
#include "../src/repro_torch/kernels/csrc/fmbe_phi_wgmma.cu"

namespace {

template <int G, bool EPI>
struct OrderJob : PhiJob<1> {
  __device__ PhiItem item(int u) const {
    const int per_group = G * a.n_nt;
    const int g = u / per_group, r = u - g * per_group;
    const int rows = min(G, a.n_mt - g * G);
    PhiItem it;
    it.nks = it.nk = (a.d + BK - 1) / BK;
    it.m0 = (g * G + r % rows) * BM;
    it.nt = r / rows;
    return it;
  }
  __device__ void epilogue(const PhiItem& it, float (&acc)[2][64],
                           NoState& st) const {
    if (EPI) PhiJob<1>::epilogue(it, acc, st);
  }
};

template <int G, bool EPI>
__global__ void __launch_bounds__(THREADS, 1)
order_kernel(const __grid_constant__ CUtensorMap mx,
             const __grid_constant__ CUtensorMap mp, PhiArgs a) {
  run(OrderJob<G, EPI>{{&mx, &mp, a}});
}

template <int G, bool EPI>
int launch_variant(const CUtensorMap& mx, const CUtensorMap& mp,
                   const PhiArgs& a, int grid, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      order_kernel<G, EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)PHI_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  order_kernel<G, EPI><<<grid, THREADS, PHI_SMEM_BYTES, stream>>>(mx, mp, a);
  return (int)cudaGetLastError();
}

}  // namespace

// The arguments of fmbe_phi_wgmma_launch, then group_m (1, 4, 8 or 16) and
// epilogue (0 or 1; without it only group_m 1 and 8).
extern "C" int fmbe_phi_order_launch(const void* x, const void* pack,
                                     const void* start, const void* tile_j0,
                                     const void* degree, const void* coef,
                                     int Q, int P, int d, int n_tiles,
                                     int grid, void* out, void* stream,
                                     int group_m, int epilogue) {
  CUtensorMap mx, mp;
  if (make_map(&mx, x, d, Q, false) ||
      make_map(&mp, pack, d, (uint64_t)n_tiles * BN, false))
    return ERR_TENSOR_MAP;
  PhiArgs a;
  a.start = static_cast<const int*>(start);
  a.tile_j0 = static_cast<const int*>(tile_j0);
  a.degree = static_cast<const int*>(degree);
  a.coef = static_cast<const float*>(coef);
  a.out = static_cast<float*>(out);
  a.Q = Q;
  a.P = P;
  a.d = d;
  a.n_mt = (Q + BM - 1) / BM;
  a.n_nt = n_tiles;
  auto st = static_cast<cudaStream_t>(stream);
  if (epilogue) {
    switch (group_m) {
      case 1: return launch_variant<1, true>(mx, mp, a, grid, st);
      case 4: return launch_variant<4, true>(mx, mp, a, grid, st);
      case 8: return launch_variant<8, true>(mx, mp, a, grid, st);
      case 16: return launch_variant<16, true>(mx, mp, a, grid, st);
    }
  } else {
    switch (group_m) {
      case 1: return launch_variant<1, false>(mx, mp, a, grid, st);
      case 8: return launch_variant<8, false>(mx, mp, a, grid, st);
    }
  }
  return (int)cudaErrorInvalidValue;
}
