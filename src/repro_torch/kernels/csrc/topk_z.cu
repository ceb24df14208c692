// Exact log Z plus top-k over the whole vocabulary, for a decode batch.
//
// Replaces the TPU kernel src/repro/kernels/topk_z.py::topk_z
// (_topk_z_kernel, _select_topk): h (Q, d) . W (V, d)^T with an online
// logsumexp and a running top-k (score, vocab id), never writing the
// (Q, V) logits to device memory.
//
// Bound on this card: bytes. At decode Q <= 16 the kernel does 2*Q flops per
// weight element and must read all of W once (qwen1.5-4b: 151936 x 2560 bf16
// = 778 MB, about 0.23 ms at 3.35 TB/s; 1556 MB and 0.46 ms in f32), far
// below the tensor-core line. h and W are both bf16 or both f32.
//
// Design: the TPU grid ran one query tile's vocab sweep in order on one core.
// Here the vocabulary is split over every warp of 2 CTAs per SM, so all SMs
// stream W at once: a warp loads R rows with 16-byte loads, scores them
// against the QT queries kept in shared memory in the input's dtype (each
// read converted exactly to f32; f32 FMAs), and folds them
// into its own partial (m, s, top-k); the CTA folds its warps' partials and
// merge_partials (streaming.cuh) reduces the CTAs' partials of each query.
// Each query tile of QT queries is one grid row, so W is streamed once per
// tile.
//
// Wide rows: the tile takes QT * d * sizeof(T) bytes of dynamic shared
// memory beside the static per-warp lists (16,896 bytes at KMAX 32), and a
// block takes at most 232,448 on an H100. So at KMAX 32 a bf16 tile fits
// up to d 13,472 (llama-3.2-vision-90b's d 8192 takes 131,072 bytes) and
// an f32 one up to d 6,736; topk_z_tile_limit gives the wrapper the bytes
// a tile may take, and the wrapper refuses a wider one before any launch.
//
// The gate: with `rows` (Q,) given, only the queries whose entry is nonzero
// are scored (the health guard passes its flags). A CTA whose QT queries
// are all unflagged returns before it loads them, and the merge writes the
// filler -- lse -inf, top-k (NEG, 0) -- for every unflagged query, so a
// healthy batch costs two launches that exit at once. A flagged query's
// partials and merge are the ungated kernel's, bit for bit. rows ==
// nullptr scores every query.
#include "streaming.cuh"

using namespace streaming;

template <class T, int KMAX>
__global__ void __launch_bounds__(THREADS, KMAX <= 8 ? 2 : 1)
topk_z_partial(const T* __restrict__ h, const T* __restrict__ w, int Q,
               int V, int d,
               int k, float* __restrict__ part_m, float* __restrict__ part_s,
               float* __restrict__ part_v, int* __restrict__ part_i,
               const int* __restrict__ rows) {
  extern __shared__ __align__(16) unsigned char tile[];
  T* hs = reinterpret_cast<T*>(tile);
  const int q0 = blockIdx.y * QT;
  if (rows != nullptr) {
    bool any = false;
    for (int j = 0; j < QT && q0 + j < Q; ++j) any |= rows[q0 + j] != 0;
    if (!any) return;                    // the whole CTA: no sync reached
  }
  load_query_tile(h, Q, d, q0, hs);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool owner = lane < QT && q0 + lane < Q;
  float m = NEG, s = 0.f;
  TopK<KMAX> top;
  top.init();
  const int n_groups = (V + GROUP - 1) / GROUP;
  for (int g = blockIdx.x; g < n_groups; g += gridDim.x) {
    const int row0 = g * GROUP + warp * R;
    const T* rows[R];
#pragma unroll
    for (int r = 0; r < R; ++r)
      rows[r] = (row0 + r < V) ? w + (size_t)(row0 + r) * d : nullptr;
    float acc[R][QT];
    score_rows(rows, hs, d, lane, acc);
    if (owner) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (rows[r] == nullptr) continue;
        float x = pick(acc[r], lane);
        online_add(m, s, x);
        top.insert(x, row0 + r);
      }
    }
  }
  __shared__ float sm[WARPS][QT], ss[WARPS][QT];
  __shared__ float sv[WARPS][QT][KMAX];
  __shared__ int si[WARPS][QT][KMAX];
  cta_lse(m, s, warp, lane, sm, ss);
  cta_topk(top, warp, lane, sv, si);
  if (warp == 0 && owner) {
    const size_t idx = (size_t)(q0 + lane) * gridDim.x + blockIdx.x;
    part_m[idx] = m;
    part_s[idx] = s;
    write_topk(top, k, part_v, part_i, idx * k);
  }
}

template <class T, int KMAX>
static cudaError_t launch(const T* h, const T* w, int Q, int V, int d, int k,
                          int grid_x,
                          float* part_m, float* part_s, float* part_v,
                          int* part_i, float* lse, float* topv, int* topi,
                          const int* rows, cudaStream_t stream) {
  const size_t smem = (size_t)QT * d * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      topk_z_partial<T, KMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(grid_x, (Q + QT - 1) / QT);
  topk_z_partial<T, KMAX><<<grid, THREADS, smem, stream>>>(
      h, w, Q, V, d, k, part_m, part_s, part_v, part_i, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  merge_partials<KMAX><<<Q, MERGE_THREADS, 0, stream>>>(
      grid_x, k, part_m, part_s, part_v, part_i, nullptr, nullptr,
      lse, nullptr, topv, topi, rows);
  return cudaGetLastError();
}

template <class T>
static cudaError_t dispatch(const void* h, const void* w, int Q, int V, int d,
                            int k, int grid_x, void* part_m, void* part_s,
                            void* part_v, void* part_i, void* lse, void* topv,
                            void* topi, const void* rows, cudaStream_t st) {
  auto hb = static_cast<const T*>(h);
  auto wb = static_cast<const T*>(w);
  auto pm = static_cast<float*>(part_m);
  auto ps = static_cast<float*>(part_s);
  auto pv = static_cast<float*>(part_v);
  auto pi = static_cast<int*>(part_i);
  auto l = static_cast<float*>(lse);
  auto tv = static_cast<float*>(topv);
  auto ti = static_cast<int*>(topi);
  auto r = static_cast<const int*>(rows);
  if (k <= 8)
    return launch<T, 8>(hb, wb, Q, V, d, k, grid_x, pm, ps, pv, pi, l, tv,
                        ti, r, st);
  return launch<T, 32>(hb, wb, Q, V, d, k, grid_x, pm, ps, pv, pi, l, tv, ti,
                       r, st);
}

// rows: the gate (Q,) int32, or nullptr for every query. f32: 1 if h and w
// are f32, 0 if bf16.
extern "C" int topk_z_launch(const void* h, const void* w, int Q, int V,
                             int d, int k, int grid_x, void* part_m,
                             void* part_s, void* part_v, void* part_i,
                             void* lse, void* topv, void* topi,
                             const void* rows, int f32, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (f32)
    return (int)dispatch<float>(h, w, Q, V, d, k, grid_x, part_m, part_s,
                                part_v, part_i, lse, topv, topi, rows, st);
  return (int)dispatch<__nv_bfloat16>(h, w, Q, V, d, k, grid_x, part_m,
                                      part_s, part_v, part_i, lse, topv,
                                      topi, rows, st);
}

template <class T, int KMAX>
static cudaError_t tile_limit(int* bytes) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, topk_z_partial<T, KMAX>);
  if (err != cudaSuccess) return err;
  int dev = 0, optin = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  *bytes = optin - (int)attr.sharedSizeBytes;
  return cudaSuccess;
}

// The dynamic shared memory a query tile may take on the current device at
// top-k k and the dtype f32 (1) or bf16 (0): the block's opt-in limit less
// the kernel's static shared memory.
extern "C" int topk_z_tile_limit(int k, int f32, int* bytes) {
  if (f32)
    return (int)(k <= 8 ? tile_limit<float, 8>(bytes)
                        : tile_limit<float, 32>(bytes));
  return (int)(k <= 8 ? tile_limit<__nv_bfloat16, 8>(bytes)
                      : tile_limit<__nv_bfloat16, 32>(bytes));
}
