// Kar-Karnick feature matrix phi(x) (Q, P) of bf16 queries on the tensor
// cores:  phi_j(x) = coef_j * prod_{m < degree_j} (omega_{j,m} . x).
//
// Replaces the TPU kernel src/repro/kernels/fmbe.py::fmbe_phi
// (_fmbe_phi_kernel) for bf16 x; f32 x runs fmbe_phi.cu. It is the
// build-time kernel of FMBE: the serving build feeds the output embedding
// through it in chunks of 16 IVF blocks (8192 rows) to form the per-block
// sketch sums.
//
// Bound on this card: operations. At a chunk of 8192 rows, P = 4096
// features of mean degree 0.98 and d 2560 the live projections are 84.3 G
// multiply-adds, about 0.17 ms at the bf16 tensor-core rate; the 134 MB of
// phi written and the 65 MB read take about 0.06 ms.
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
#include "hopper_gemm.cuh"

using namespace hgemm;

namespace {

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
  int nk;
  int m0, nt;
};

struct NoState {};

struct PhiJob {
  const CUtensorMap* mx;
  const CUtensorMap* mp;
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
    it.nk = (a.d + BK - 1) / BK;
    it.m0 = (g * GROUP_M + r % rows) * BM;
    it.nt = r / rows;
    return it;
  }
  __device__ void load(const PhiItem& it, int k, uint32_t sa, uint32_t sb,
                       uint64_t* bar) const {
    load_slice(mx, false, sa, bar, it.m0, k * BK);
    load_slice(mp, false, sb, bar, it.nt * BN, k * BK);
  }
  __device__ void mma(const PhiItem&, float (&acc)[2][64], uint32_t sa,
                      uint32_t sb) const {
    mma_stage<false, false>(acc, sa, sb);
  }
  __device__ void after_stage(const PhiItem&, int, float (&)[2][64]) const {}
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

__global__ void __launch_bounds__(THREADS, 1)
fmbe_phi_wgmma_kernel(const __grid_constant__ CUtensorMap mx,
                      const __grid_constant__ CUtensorMap mp, PhiArgs a) {
  run(PhiJob{&mx, &mp, a});
}

}  // namespace

// x (Q, d) bf16; pack (n_tiles * 128, d) bf16; grid: persistent CTAs.
extern "C" int fmbe_phi_wgmma_launch(const void* x, const void* pack,
                                     const void* start,
                                     const void* tile_j0, const void* degree,
                                     const void* coef, int Q, int P, int d,
                                     int n_tiles, int grid, void* out,
                                     void* stream) {
  CUtensorMap mx, mp;
  if (make_map(&mx, x, d, Q, false) ||
      make_map(&mp, pack, d, (uint64_t)n_tiles * BN, false))
    return ERR_TENSOR_MAP;
  cudaError_t err = cudaFuncSetAttribute(
      fmbe_phi_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)PHI_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
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
  fmbe_phi_wgmma_kernel<<<grid, THREADS, PHI_SMEM_BYTES,
                          static_cast<cudaStream_t>(stream)>>>(mx, mp, a);
  return (int)cudaGetLastError();
}
