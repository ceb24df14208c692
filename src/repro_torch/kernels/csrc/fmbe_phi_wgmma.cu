// Kar-Karnick feature matrix phi(x) (Q, P) of bf16 or f32 queries on the
// tensor cores:  phi_j(x) = coef_j * prod_{m < degree_j} (omega_{j,m} . x).
//
// Replaces the TPU kernel src/repro/kernels/fmbe.py::fmbe_phi
// (_fmbe_phi_kernel). It is the build-time kernel of FMBE: the serving
// build feeds the output embedding through it in chunks of 16 IVF blocks
// (8192 rows) to form the per-block sketch sums.
//
// bf16 x (one plane) is A as it is. f32 x (three planes): ce_split first
// splits x into (3, Q, dp) exact bf16 planes (ce_planes.cuh; dp = d
// rounded up to 64, zeros past d), and an item runs the passes (x2, omega),
// (x1, omega), (x0, omega), smallest first. The omega rows are +-1, exact
// in bf16, so every product is exact (x0 + x1 + x2 == x): the only error
// is the tensor cores' f32 sums over d, as in the bf16 kernel.
// FMBE_PHI3_PROMOTE > 0 adds the (x0, omega) pass to an f32 sum in shared
// memory every that many stages, on a ring of PROMOTE_STAGES (4) beside the
// 64 KB sums (ce_planes.cuh). tools/fmbe_phi_promote.py measures it: on the
// f32 build's chunk and on that chunk x8, phi without it stays 10x closer
// to float64 than the plain f32 version, and it costs half a millisecond a
// chunk, so the kernel does not promote (0).
//
// Bound on this card: operations. At a chunk of 8192 rows, P = 4096
// features of mean degree 0.98 and d 2560 the live projections are 84.3 G
// multiply-adds, about 0.17 ms at the bf16 tensor-core rate (three times
// that at f32, 0.51 ms); the 134 MB of phi written and the 65 MB read (f32
// x: 84 MB, and the planes 126 MB written and read) take about 0.06 ms.
//
// Design: the projections are one GEMM. The live rows (j, m < degree_j) of
// omega are +-1, so exact in bf16, and the wrapper gathers them once per
// feature map into a bf16 matrix B (n_cols, d) (kernels/fmbe.py
// fmbe_pack): feature j's rows at columns start_j + m, in feature order,
// zero-padded so that no feature crosses a 128-column tile and no tile
// holds more than 128 features. x (Q, d) is A. Both are K-major, as h and
// W are for the scores of fused_ce_fwd.cu, and run on the same mainloop
// (hopper_gemm.cuh: TMA into a 6-stage ring, wgmma m64n128k16 with f32
// accumulators, 128 x 128 tiles, two consumer warpgroups in ping-pong,
// persistent CTAs over (row tile, column tile) items, walked in groups of
// GROUP_M row tiles, row tile fastest, so that CTAs running at once share
// tiles of both operands in L2). Products of bf16
// values are exact in f32 and summed in f32, as the CUDA-core kernel sums
// them.
//
// The epilogue unit is a warp's 8 rows of a column tile. In wgmma's layout
// a warp holds rows acc_row(h, e) of the tile, one per quad of lanes, each
// across all 128 columns; a tile writes the at most 128 consecutive
// features [tile_j0[t], tile_j0[t + 1]) of each row, degree-0 ones among
// them (phi = coef_j). For each of its 4 row sets the warp writes the raw
// projections into 4 KB of shared memory beside the ring (the ring takes
// 193 KB, which leaves no room to stage two 64 KB f32 tiles), then lane l
// takes the features j0 + l + 32 i of each row: it multiplies the feature's
// columns start_j .. start_j + degree_j - 1 in m order, then coef_j -- the
// TPU kernel's factor order -- and stores phi with consecutive lanes on
// consecutive features, so phi leaves in whole 128-byte lines. A lane
// issues all of a feature's (predicated) shared-memory loads before its
// products: one epilogue warp per scheduler has no other warp to hide
// their latency behind. A first design took each product from the
// registers (quad shuffles over 8-column groups, one 4-byte store per
// feature and row) was about twice as slow. tools/fmbe_phi_order.cu times
// this kernel beside its product alone and other item orders. Every output
// element has one writer and the sums a fixed order, so two calls are
// bit-equal.
#include "ce_planes.cuh"

using namespace hgemm;

namespace {

#ifndef FMBE_PHI3_PROMOTE
#define FMBE_PHI3_PROMOTE 0
#endif
constexpr int PHI3_PROMOTE = FMBE_PHI3_PROMOTE;
constexpr int PROMOTE_STAGES = 4;      // the ring beside the sums
// the ring of P planes of x: the mainloop's, or a shallower one beside the
// sums, which end where the 6-stage ring would (the staging stays put)
template <int P>
__host__ __device__ constexpr int phi_stages() {
  return P == 3 && PHI3_PROMOTE > 0 ? PROMOTE_STAGES : STAGES;
}
static_assert(PROMOTE_STAGES * STAGE_BYTES + SUMS_BYTES ==
                  STAGES * STAGE_BYTES,
              "the sums take the place of two stages");

// staging: the raw projections of 8 rows of BN columns a consumer warp,
// each row padded by 4 floats so that the quads' rows fall in other banks
constexpr int STAGE_ROW = BN + 4;
constexpr int STAGE_FLOATS = 8 * STAGE_ROW;
constexpr size_t PHI_SMEM_BYTES =
    SMEM_BYTES + (size_t)CONSUMERS * 4 * STAGE_FLOATS * sizeof(float);
constexpr int SLOTS = BN / 32;         // features of a tile a lane takes
constexpr int GROUP_M = 8;             // row tiles of a group of items

struct PhiArgs {
  const int* start;      // (P): first pack column of feature j, -1 if none
  const int* tile_j0;    // (n_tiles + 1): features of each column tile,
                         // at most BN
  const int* degree;     // (P), at most max_degree
  const float* coef;     // (P)
  float* out;            // (Q, P)
  int Q, P, d;
  int n_mt, n_nt;        // row tiles, column tiles
};

struct PhiItem {
  int nk;            // stages: planes x nks
  int nks;           // K slices
  int m0, nt;
};

struct NoState {};

template <int P>
struct PhiJob {
  const CUtensorMap* mx;     // x, or its planes, K-major boxes
  const CUtensorMap* mp;     // the pack, K-major boxes
  PhiArgs a;
  using State = NoState;

  __device__ int begin() const { return (int)blockIdx.x; }
  __device__ bool valid(int u) const { return u < a.n_mt * a.n_nt; }
  __device__ void advance(int& u) const { u += gridDim.x; }
  __device__ PhiItem item(int u) const {
    const int per_group = GROUP_M * a.n_nt;
    const int g = u / per_group, r = u - g * per_group;
    const int rows = min(GROUP_M, a.n_mt - g * GROUP_M);
    PhiItem it;
    it.nks = (a.d + BK - 1) / BK;
    it.nk = P * it.nks;
    it.m0 = (g * GROUP_M + r % rows) * BM;
    it.nt = r / rows;
    return it;
  }
  // stage k: slice k % nks of plane P - 1 - k / nks (smallest first)
  __device__ void load(const PhiItem& it, int k, uint32_t sa, uint32_t sb,
                       uint64_t* bar) const {
    const int q = k / it.nks, ks = k - q * it.nks;
    load_slice(mx + (P - 1 - q), false, sa, bar, it.m0, ks * BK);
    load_slice(mp, false, sb, bar, it.nt * BN, ks * BK);
  }
  __device__ void mma(const PhiItem&, float (&acc)[2][64], uint32_t sa,
                      uint32_t sb) const {
    mma_stage<false, false>(acc, sa, sb);
  }
  // P = 3: the (x0, omega) pass, the last, promoted every PHI3_PROMOTE
  // stages
  __device__ void after_stage(const PhiItem& it, int k,
                              float (&acc)[2][64]) const {
    promote_stage<P == 3 ? PHI3_PROMOTE : 0>(
        k, it.nk, it.nks, acc, PROMOTE_STAGES * STAGE_BYTES);
  }
  __device__ void init(NoState&) const {}
  __device__ void after(const PhiItem&, NoState&, int) const {}

  __device__ void epilogue(const PhiItem& it, float (&acc)[2][64],
                           NoState&) const {
    extern __shared__ uint8_t smem_raw[];
    const int lane = threadIdx.x & 31, q = lane & 3, quad = lane >> 2;
    float* stage = reinterpret_cast<float*>(smem_raw + SMEM_BYTES) +
                   (threadIdx.x >> 5) * STAGE_FLOATS;
    const int j0 = a.tile_j0[it.nt], width = a.tile_j0[it.nt + 1] - j0;
    // this lane's features of the tile: first column in the tile, degree
    // (0 past the range) and coef
    int col[SLOTS], deg[SLOTS];
    float cf[SLOTS];
#pragma unroll
    for (int i = 0; i < SLOTS; ++i) {
      const int j = lane + 32 * i;
      const bool in = j < width;
      col[i] = in ? __ldg(a.start + j0 + j) - it.nt * BN : 0;
      deg[i] = in ? __ldg(a.degree + j0 + j) : 0;
      cf[i] = in ? __ldg(a.coef + j0 + j) : 0.f;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        // the raw projections of the warp's 8 rows (quad = row)
#pragma unroll
        for (int g = 0; g < 16; ++g)
          *reinterpret_cast<float2*>(stage + quad * STAGE_ROW + 8 * g +
                                     2 * q) =
              make_float2(acc[h][4 * g + 2 * e], acc[h][4 * g + 2 * e + 1]);
        __syncwarp();
        const int row0 = it.m0 + acc_row(h, e) - quad;
        for (int r = 0; r < 8 && row0 + r < a.Q; ++r) {
          const float* raw = stage + r * STAGE_ROW;
          float* dst = a.out + (size_t)(row0 + r) * a.P + j0;
#pragma unroll
          for (int i = 0; i < SLOTS; ++i) {
            // all of a feature's loads first (predicated, a factor past the
            // degree is 1, which multiplies exactly), then its product in m
            // order: one epilogue warp per scheduler hides no latency
            float f[8];
#pragma unroll
            for (int m = 0; m < 8; ++m)
              f[m] = m < deg[i] ? raw[col[i] + m] : 1.f;
            float prod = 1.f;
#pragma unroll
            for (int m = 0; m < 8; ++m) prod *= f[m];
            if (lane + 32 * i < width) dst[lane + 32 * i] = prod * cf[i];
          }
        }
        __syncwarp();
      }
  }
};

template <int P>
struct PhiMaps {
  CUtensorMap x[P];
  CUtensorMap pack;
};

template <int P>
__global__ void __launch_bounds__(THREADS, 1)
fmbe_phi_wgmma_kernel(const __grid_constant__ PhiMaps<P> m, PhiArgs a) {
  run<PhiJob<P>, phi_stages<P>()>(PhiJob<P>{m.x, &m.pack, a});
}

template <int P>
int launch(const void* x, const void* pack, int n_tiles, const PhiArgs& a,
           int grid, void* x_planes, cudaStream_t st) {
  // P = 1 reads x in place; P = 3 its planes, dp columns wide
  const int dp = P == 1 ? a.d : planes_width(a.d);
  if (P == 3) {
    const int e = split_launch(static_cast<const float*>(x), a.Q, a.d, a.Q,
                               dp, static_cast<bf16*>(x_planes), st);
    if (e) return e;
  }
  PhiMaps<P> m;
  if (plane_maps<P>(m.x, P == 1 ? x : x_planes, dp, a.Q, false) ||
      make_map(&m.pack, pack, a.d, (uint64_t)n_tiles * BN, false))
    return ERR_TENSOR_MAP;
  cudaError_t err = cudaFuncSetAttribute(
      fmbe_phi_wgmma_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)PHI_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  fmbe_phi_wgmma_kernel<P><<<grid, THREADS, PHI_SMEM_BYTES, st>>>(m, a);
  return (int)cudaGetLastError();
}

}  // namespace

// x (Q, d) bf16, or f32 with f32 != 0 and x_planes a (3, Q, dp) bf16
// buffer, dp = d rounded up to 64; pack (n_tiles * 128, d) bf16; grid:
// persistent CTAs.
extern "C" int fmbe_phi_wgmma_launch(const void* x, const void* pack,
                                     const void* start,
                                     const void* tile_j0, const void* degree,
                                     const void* coef, int Q, int P, int d,
                                     int n_tiles, int grid, void* out,
                                     void* x_planes, int f32, void* stream) {
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
  return f32 ? launch<3>(x, pack, n_tiles, a, grid, x_planes, st)
             : launch<1>(x, pack, n_tiles, a, grid, x_planes, st);
}
