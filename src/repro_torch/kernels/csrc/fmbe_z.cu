// FMBE decode estimate z(x) = phi(x) . lambda, (Q,) signed f32, without a
// (Q, P) feature matrix in device memory, on the tensor cores.
//
// Replaces the TPU kernel src/repro/kernels/fmbe.py::fmbe_z (_fmbe_z_kernel).
// phi_j(x) = coef_j * prod_{m < degree_j} (omega_{j,m} . x); lambda is (P,),
// one shared sketch sum, or (Q, P), a per-query lambda (the
// block-partitioned complement the serving decode uses).
//
// Bound on this card: bytes. The kernel reads the feature map's pack
// (kernels/fmbe.py fmbe_pack: the live +-1 rows of omega as bf16, exact,
// laid out so that no feature crosses a 128-column tile and zero-padded to
// whole tiles), once: at Q = 8 and P = 4096 features of qwen1.5-4b (d 2560,
// mean degree about 0.98) 34 tiles of 128 rows, about 22 MB, about 7 us at
// 3.35 TB/s, half the f32 omega rows the CUDA-core kernel read before. Its
// 2*Q flops per element read are far below the compute bound.
//
// Design: two launches on the caller's stream.
// (1) The projections of every pack row against the query tile, a Job of
//     the gathered-row pipeline gather_stream.cuh: each CTA of a
//     persistent grid takes an equal, contiguous range of the pack's rows;
//     its producer warp bulk-copies them into the ring and its consumer
//     warps score them on the tensor cores (mma.sync m16n8k16, the pack
//     rows as A, the 8 queries as N = 8), with f32 sums. bf16 x is the
//     query tile as it is. f32 x is first split by ce_split (ce_planes.cuh)
//     into three exact bf16 planes (x = x0 + x1 + x2), all three in the
//     query tile, and each plane's sums are added smallest first, so the f32
//     route reads the same pack bytes as bf16 and every product is exact.
//     Each (query, pack column) projection goes to a (Q, n_cols) f32 buffer
//     (139 KB at the main path's shape, in L2).
// (2) The feature products, launched as a programmatic dependent of (1)
//     (its launch overlaps (1); it waits for (1)'s projections before its
//     first read): one CTA a query, a warp a column tile. A lane takes the
//     tile's features j0 + lane + 32 i, multiplies each feature's columns
//     in m order, then coef_j -- the TPU kernel's factor order -- then
//     lambda, and adds its features in i order; a butterfly over the lanes
//     gives the tile's partial, and the partials are added in tile order.
// No float atomics: every sum runs in a fixed order, so two calls are
// bit-equal.
#include "ce_planes.cuh"
#include "gather_stream.cuh"

namespace {

using gstream::FULL;
using gstream::Layout;
using gstream::layout;
using gstream::QT;
using gstream::score;
using gstream::Stage;
using gstream::Tile;

constexpr int MMAX = 8;                // largest degree the pack holds
constexpr int PACK_TILE = 128;         // columns of a pack tile
constexpr int FEAT_WARPS = 16;         // warps of the feature kernel

// The projections of the pack's rows: the rows of this CTA's equal share
// of n_cols, each scored against the query tile (NP planes) and written to
// proj (Q, n_cols).
struct ProjJob {
  const bf16* pack;
  int n_cols, d;
  float* proj;
  int side_bytes = 0, extra_bytes = 0;
  uint8_t* own = nullptr;              // unused: no shared memory of its own
  int lo = 0;                          // the CTA's first row

  struct Src {
    int row;
  };

  __device__ int rows() {
    const long long b = blockIdx.x, g = gridDim.x;
    lo = (int)(n_cols * b / g);
    return (int)(n_cols * (b + 1) / g) - lo;
  }
  __device__ Src src(int i) const { return {lo + i}; }
  __device__ const bf16* ptr(const Src& s) const {
    return pack + (size_t)s.row * d;
  }
  __device__ void side(const Src&, int, uint32_t) const {}
  __device__ void start(int, int, int) const {}
  __device__ void pre(const Stage&, int, int, int) const {}
  // one (query, row) projection a thread, rows of a query on adjacent
  // threads
  __device__ void post(const Stage& st, int t, int q0, int nq) const {
    constexpr int ROWS = Tile<bf16>::ROWS;
    for (int p = t; p < ROWS * QT; p += Tile<bf16>::WARPS * 32) {
      const int r = p % ROWS, q = p / ROWS;
      if (r >= st.n || q >= nq) continue;
      proj[(size_t)(q0 + q) * n_cols + lo + st.j0 + r] =
          score<bf16>(st, r, q);
    }
  }
  __device__ void finish(int, int, int) const {}
};

template <int NP>
__global__ void __launch_bounds__((Tile<bf16>::WARPS + 1) * 32, GS_CTAS)
fmbe_z_proj(ProjJob job, const bf16* __restrict__ x, int Q, size_t plane) {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  gstream::run<bf16, ProjJob, NP>(job, x, Q, job.d, plane);
}

// z[q] from the projections: a warp a column tile, its partial in shared
// memory, the partials added in tile order.
__global__ void __launch_bounds__(FEAT_WARPS * 32)
fmbe_z_features(const float* __restrict__ proj, int n_cols,
                const int* __restrict__ tile_j0, int n_tiles,
                const int* __restrict__ start,
                const int* __restrict__ degree,
                const float* __restrict__ coef,
                const float* __restrict__ lam, int lam_stride,
                float* __restrict__ z) {
  extern __shared__ float part[];      // [n_tiles]
  const int q = blockIdx.x, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* pq = proj + (size_t)q * n_cols;
  const float* lq = lam + (size_t)q * lam_stride;
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  for (int t = warp; t < n_tiles; t += FEAT_WARPS) {
    const int j0 = tile_j0[t], width = tile_j0[t + 1] - j0;
    float v = 0.f;
#pragma unroll
    for (int i = 0; i < PACK_TILE / 32; ++i) {
      const int j = j0 + lane + 32 * i;
      if (lane + 32 * i >= width) break;
      const int g = degree[j], c0 = start[j];
      // all of a feature's (predicated) loads first, then its product in
      // m order; a factor past the degree is 1, which multiplies exactly
      float f[MMAX];
#pragma unroll
      for (int m = 0; m < MMAX; ++m) f[m] = m < g ? pq[c0 + m] : 1.f;
      float prod = 1.f;
#pragma unroll
      for (int m = 0; m < MMAX; ++m) prod *= f[m];
      v += prod * coef[j] * lq[j];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
    if (lane == 0) part[t] = v;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int t = 0; t < n_tiles; ++t) s += part[t];
    z[q] = s;
  }
}

template <int NP>
int launch(const bf16* x, const void* pack, const int* tile_j0,
           const int* start, const int* degree, const float* coef,
           const float* lam, int lam_stride, int Q, int d, int n_tiles,
           int grid_x, float* proj, float* z, cudaStream_t st) {
  const int n_cols = n_tiles * PACK_TILE;
  ProjJob job{static_cast<const bf16*>(pack), n_cols, d, proj};
  const Layout m = layout<bf16, NP>(d, job.side_bytes, job.extra_bytes);
  if (m.nst < 1) return (int)cudaErrorInvalidValue;   // d too wide
  cudaError_t err = cudaFuncSetAttribute(
      fmbe_z_proj<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      m.total);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(grid_x, (Q + QT - 1) / QT);
  fmbe_z_proj<NP><<<grid, gstream::threads<bf16>(), m.total, st>>>(
      job, x, Q, (size_t)Q * d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(Q);
  cfg.blockDim = dim3(FEAT_WARPS * 32);
  cfg.dynamicSmemBytes = n_tiles * sizeof(float);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, fmbe_z_features,
                                 static_cast<const float*>(proj), n_cols,
                                 tile_j0, n_tiles, start, degree, coef, lam,
                                 lam_stride, z);
}

}  // namespace

// x (Q, d) bf16, or f32 with f32 != 0 and x_planes a (3, Q, d) bf16
// buffer; pack (n_tiles * 128, d) bf16 with its tile_j0 (n_tiles + 1),
// start, degree and coef (P); lam (P,) with lam_stride 0 or (Q, P) with
// lam_stride P; proj a (Q, n_tiles * 128) f32 buffer; z (Q,).
extern "C" int fmbe_z_launch(const void* x, const void* pack,
                             const void* tile_j0, const void* start,
                             const void* degree, const void* coef,
                             const void* lam, int lam_stride, int Q, int d,
                             int n_tiles, int grid_x, void* proj, void* z,
                             void* x_planes, int f32, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto ti = static_cast<const int*>(tile_j0);
  auto sj = static_cast<const int*>(start);
  auto dg = static_cast<const int*>(degree);
  auto cf = static_cast<const float*>(coef);
  auto lm = static_cast<const float*>(lam);
  auto pj = static_cast<float*>(proj);
  auto zz = static_cast<float*>(z);
  if (!f32)
    return launch<1>(static_cast<const bf16*>(x), pack, ti, sj, dg, cf, lm,
                     lam_stride, Q, d, n_tiles, grid_x, pj, zz, st);
  auto planes = static_cast<bf16*>(x_planes);
  const int e = split_launch(static_cast<const float*>(x), Q, d, Q, d,
                             planes, st);
  if (e) return e;
  return launch<3>(planes, pack, ti, sj, dg, cf, lm, lam_stride, Q, d,
                   n_tiles, grid_x, pj, zz, st);
}
