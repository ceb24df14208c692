// Exact log Z plus top-k over the whole vocabulary, for a decode batch.
//
// Replaces the TPU kernel src/repro/kernels/topk_z.py::topk_z
// (_topk_z_kernel, _select_topk): h (Q, d) . W (V, d)^T with an online
// logsumexp and a running top-k (score, vocab id), never writing the
// (Q, V) logits to device memory.
//
// Bound on this card: bytes. At decode Q <= 16 the kernel does 2*Q flops per
// weight element and must read all of W once (qwen1.5-4b: 151936 x 2560 bf16
// = 778 MB, about 0.23 ms at 3.35 TB/s; the VLM's 128256 x 8192, 2.1 GB and
// 0.63 ms; 1556 MB and 0.46 ms for qwen1.5-4b in f32), far below the
// tensor-core line. h and W are both bf16 or both f32. So the design's one
// aim is to keep enough of W in flight on every SM for the whole sweep, and
// to spend nothing else on the way: no shared-memory traffic beyond W's own
// bytes, no second read of W for a second group of queries.
//
// bf16 (topk_z_tc, the main path). The first port kept an 8-query tile
// resident in shared memory and scored W on the CUDA cores: every 16 B of
// W read 128 B of the tile from shared memory, so shared memory carried
// about 8x HBM's bytes; the tile (131 KB at d 8192) left one CTA an SM with
// some 16 KB of loads in flight; and a 16-lane batch streamed W twice. Now:
//   - A persistent grid of one CTA an SM (at most one per 128-row box) gives
//     each CTA a fixed, contiguous range of whole boxes of 128 rows of W
//     (sizes differ by at most one box), so the merge order, and the bits,
//     do not depend on timing.
//   - One producer thread streams the CTA's boxes 64 columns deep through a
//     ring of STAGES stages by TMA (2-D tensor maps, 128-byte swizzle): a
//     stage is W's 128 x 64 slice (16 KB) and the queries' N x 64 slice
//     beside it (1-2 KB, read again from L2 for every box). The ring takes
//     the shared memory to itself: 176-192 KB of W in flight an SM at any
//     d. TMA fills rows past V and Q, and columns past d, with zeros.
//   - One consumer warpgroup scores each stage on the tensor cores: wgmma
//     m64nNk16 with W's rows as A and the queries as B, N = 8 for Q <= 8
//     and 16 up to 16, f32 accumulators in registers (N / 2 a thread per
//     64-row half). Each stage's 64-deep partial starts from zero and is
//     added to the box's f32 sums once its wgmma group retires (two
//     accumulator sets in turn, so the next stage's wgmma runs meanwhile):
//     the tensor cores' running sum rounds toward zero, which over d 6144
//     at scores near 40 cost 1e-3 against the plain version. Every row's
//     score is the same sums in the same order wherever the row sits in a
//     box, so exact ties stay ties and go to the lowest id. Q > 16 takes
//     one grid row per 16 queries. No query tile is resident, so bf16
//     takes any d % 8 == 0.
//   - At the end of a box the warpgroup folds its 128 x N scores from the
//     registers: each thread keeps an online (m, s) for each of its N / 4
//     query columns; a score at or above its query's current k-th best
//     (`thr`, shared) is appended to that query's candidate list in shared
//     memory, and each warp then merges the candidates of its N / 4 queries
//     into a 32-entry list held one entry a lane, best first, until the best
//     left cannot enter. A NaN score fails the filter and never enters the
//     top-k, but poisons s, so the query's LSE is NaN.
//   - The CTA writes one partial (m, s, top-k) a query; merge_partials
//     (streaming.cuh) reduces the CTAs' partials in a fixed order.
//
// f32 (topk_z_partial, unchanged): the vocabulary is split over every warp
// of up to 2 CTAs per SM; a warp loads R rows with 16-byte loads, scores
// them against the QT queries kept in shared memory (f32 FMAs), and folds
// them into its own partial (m, s, top-k); the CTA folds its warps'
// partials, and merge_partials reduces the CTAs'. Its tile takes QT * d * 4
// bytes of dynamic shared memory beside the static per-warp lists (16,896
// bytes at KMAX 32), and a block takes at most 232,448 on an H100, so it
// fits up to d 6,736; topk_z_tile_limit gives the wrapper the bytes a tile
// may take, and the wrapper refuses a wider one before any launch.
//
// The gate: with `rows` (Q,) given, only the queries whose entry is nonzero
// are scored (the health guard passes its flags). A CTA whose queries are
// all unflagged returns before it loads anything, and the merge writes the
// filler -- lse -inf, top-k (NEG, 0) -- for every unflagged query, so a
// healthy batch costs two launches that exit at once. A flagged query's
// partials and merge are the ungated kernel's, bit for bit. rows ==
// nullptr scores every query.
//
// Both tensor maps are kernel parameters (__grid_constant__), encoded on
// the host at each call, and the kernel allocates nothing: a launch can be
// captured in a CUDA graph with no host read or synchronisation.
#include "hopper_gemm.cuh"
#include "streaming.cuh"

using streaming::better;
using streaming::merge_partials;
using streaming::MERGE_THREADS;
using streaming::NEG;
using streaming::online_add;

// ---- bf16: W through a TMA ring into wgmma --------------------------------

namespace tc {

constexpr int BOX_ROWS = 128;                   // rows of W a box
constexpr int BOX_COLS = 64;                    // depth of a stage
constexpr int W_BYTES = BOX_ROWS * BOX_COLS * 2;
constexpr int HALF_BYTES = W_BYTES / 2;         // one m64 half of a box
constexpr int CONSUMERS = 128;                  // one warpgroup
constexpr int THREADS = CONSUMERS + 32;         // and one producer warp
constexpr int PER_LANE = BOX_ROWS / 32;         // candidates a lane merges
constexpr int QTILE = 16;                       // the widest query tile

template <int N>
struct Ring {
  static constexpr int H_BYTES = N * BOX_COLS * 2;
  static constexpr int STAGE = W_BYTES + H_BYTES;       // multiple of 1024
  // as many stages as fit beside the static candidate lists
  static constexpr int STAGES = N == 8 ? 12 : 11;
  static constexpr size_t SMEM = (size_t)STAGES * STAGE + 1024;
};

// d (64 x N, f32) += A (64 x 16, K-major) B (16 x N, K-major).
__device__ __forceinline__ void wgmma_n8(float (&d)[4], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n16(float (&d)[8], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(1));
}

// acc[h] += the stage's rows [64 h, 64 h + 64) times its N queries: four
// 16-deep steps, each one wgmma per half, committed as one group.
template <int N>
__device__ __forceinline__ void mma_stage(float (&acc)[2][N / 2],
                                          uint32_t sa, uint32_t sb) {
  hgemm::wg_fence();
#pragma unroll
  for (int kk = 0; kk < BOX_COLS / 16; ++kk) {
    const uint64_t db = hgemm::make_desc(sb + kk * 32, 16, 1024);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint64_t da =
          hgemm::make_desc(sa + h * HALF_BYTES + kk * 32, 16, 1024);
      if constexpr (N == 8)
        wgmma_n8(acc[h], da, db);
      else
        wgmma_n16(acc[h], da, db);
    }
  }
  hgemm::wg_commit();
}

template <int N>
__device__ __forceinline__ void fence_acc(float (&acc)[2][N / 2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < N / 2; ++i)
      asm volatile("" : "+f"(acc[h][i])::"memory");
}

// Adds a stage's retired partial to the box's sums, in f32 with rounding
// to nearest, and hands the stage's ring slot back (lane 0 of each warp).
template <int N>
__device__ __forceinline__ void promote(float (&part)[2][N / 2],
                                        float (&sum)[2][N / 2],
                                        uint64_t* slot, int lane) {
  fence_acc<N>(part);
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) sum[h][i] += part[h][i];
  __syncwarp();
  if (lane == 0) hgemm::bar_arrive(slot);
}

// One stage into acc[B], from zero, on the tensor cores; once the stage
// before it (acc[B ^ 1]) has retired, its partial is promoted and its slot
// `prev` handed back (none before a box's first stage). A sum from zero
// over a stage's 64 products drifts only at its own, far smaller
// magnitude.
template <int N, int B>
__device__ __forceinline__ void stage_step(float (&acc)[2][2][N / 2],
                                           float (&sum)[2][N / 2],
                                           uint32_t sa, uint64_t* prev,
                                           int lane) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[B][h][i] = 0.f;
  mma_stage<N>(acc[B], sa, sa + W_BYTES);
  hgemm::wg_wait<1>();
  if (prev != nullptr) promote<N>(acc[B ^ 1], sum, prev, lane);
}

// The box's last stage (in acc[B]): waits for it and promotes it.
template <int N, int B>
__device__ __forceinline__ void stage_done(float (&acc)[2][2][N / 2],
                                           float (&sum)[2][N / 2],
                                           uint64_t* slot, int lane) {
  hgemm::wg_wait<0>();
  promote<N>(acc[B], sum, slot, lane);
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
}

// (m, s) += (m2, s2) as logsumexps; an empty side (s == 0) adds nothing and
// a NaN on either side gives NaN.
__device__ __forceinline__ void lse_fold(float& m, float& s, float m2,
                                         float s2) {
  if (isnan(s) || isnan(s2)) {
    s = NAN;
    return;
  }
  if (!(s2 > 0.f)) return;
  if (!(s > 0.f)) {
    m = m2;
    s = s2;
    return;
  }
  const float mx = fmaxf(m, m2);
  s = s * expf(m - mx) + s2 * expf(m2 - mx);
  m = mx;
}

// An order-preserving key of a float (NaN excluded): a > b iff key(a) >
// key(b), with -0 and +0 one key.
__device__ __forceinline__ unsigned key_of(float x) {
  const unsigned u = __float_as_uint(__fadd_rn(x, 0.f));
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float float_of(unsigned key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

// Merges one query's candidates (PER_LANE a lane; (-inf, INT_MAX) empty)
// into its list (lane j holds entry j; 32 entries, best first by `better`):
// the best candidate left goes in while it beats entry k - 1, so at most k
// enter and the list's first k are the top k of the list and candidates.
__device__ __forceinline__ void merge_candidates(float& lv, int& li,
                                                 float (&cv)[PER_LANE],
                                                 int (&ci)[PER_LANE], int k,
                                                 int lane) {
  while (true) {
    float bv = cv[0];
    int bi = ci[0];
#pragma unroll
    for (int j = 1; j < PER_LANE; ++j)
      if (better(cv[j], ci[j], bv, bi)) { bv = cv[j]; bi = ci[j]; }
    const unsigned wk = __reduce_max_sync(0xffffffffu, key_of(bv));
    const int wi = (int)__reduce_min_sync(
        0xffffffffu, key_of(bv) == wk ? (unsigned)bi : 0x7fffffffu);
    const float wv = float_of(wk);
    const float tv = __shfl_sync(0xffffffffu, lv, k - 1);
    const int ti = __shfl_sync(0xffffffffu, li, k - 1);
    if (!better(wv, wi, tv, ti)) return;              // warp-uniform
    const int p = __popc(__ballot_sync(0xffffffffu, better(lv, li, wv, wi)));
    const float uv = __shfl_up_sync(0xffffffffu, lv, 1);
    const int ui = __shfl_up_sync(0xffffffffu, li, 1);
    if (lane == p) { lv = wv; li = wi; }
    else if (lane > p) { lv = uv; li = ui; }
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j)
      if (ci[j] == wi) { cv[j] = -INFINITY; ci[j] = 0x7fffffff; }
  }
}

template <int N>
__global__ void __launch_bounds__(THREADS, 1)
topk_z_tc(const __grid_constant__ CUtensorMap wmap,
          const __grid_constant__ CUtensorMap hmap, int Q, int V, int d,
          int k, int n_boxes, float* __restrict__ part_m,
          float* __restrict__ part_s, float* __restrict__ part_v,
          int* __restrict__ part_i, const int* __restrict__ rows) {
  using R = Ring<N>;
  constexpr int A = N / 4;               // query columns a thread holds
  const int q0 = blockIdx.y * N;
  if (rows != nullptr) {
    bool any = false;
    for (int j = 0; j < N && q0 + j < Q; ++j) any |= rows[q0 + j] != 0;
    if (!any) return;                    // the whole CTA: no sync reached
  }
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[R::STAGES];
  __shared__ __align__(8) uint64_t empty[R::STAGES];
  __shared__ float cand_v[N][BOX_ROWS];
  __shared__ int cand_i[N][BOX_ROWS];
  __shared__ int cnt[N];
  __shared__ float thr[N];
  __shared__ float fold_m[CONSUMERS / 32][N], fold_s[CONSUMERS / 32][N];
  const uint32_t base = (hgemm::smem_u32(smem_raw) + 1023u) & ~1023u;
  const int b0 = (int)((long long)blockIdx.x * n_boxes / gridDim.x);
  const int b1 = (int)((long long)(blockIdx.x + 1) * n_boxes / gridDim.x);
  const int nk = (d + BOX_COLS - 1) / BOX_COLS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < R::STAGES; ++s) {
      hgemm::bar_init(&full[s], 1);
      hgemm::bar_init(&empty[s], CONSUMERS / 32);   // lane 0 of each warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (threadIdx.x < N) {
    cnt[threadIdx.x] = 0;
    thr[threadIdx.x] = NEG;
  }
  __syncthreads();

  if (warp == CONSUMERS / 32) {          // the producer
    if (lane == 0) {
      uint32_t it = 0;
      for (int b = b0; b < b1; ++b)
        for (int kc = 0; kc < nk; ++kc, ++it) {
          const int s = it % R::STAGES;
          hgemm::bar_wait(&empty[s], ((it / R::STAGES) & 1) ^ 1);
          hgemm::bar_expect_tx(&full[s], R::STAGE);
          const uint32_t dst = base + s * R::STAGE;
          hgemm::tma_load(&wmap, dst, &full[s], kc * BOX_COLS,
                          b * BOX_ROWS);
          hgemm::tma_load(&hmap, dst + W_BYTES, &full[s], kc * BOX_COLS, q0);
        }
    }
    return;
  }

  // the consumer warpgroup
  float m[A], s[A];
#pragma unroll
  for (int a = 0; a < A; ++a) { m[a] = NEG; s[a] = 0.f; }
  float lv[A];                           // query warp + 4 a's list, entry
  int li[A];                             // `lane`
#pragma unroll
  for (int a = 0; a < A; ++a) { lv[a] = NEG; li[a] = 0; }
  float acc[2][2][N / 2];                // two stages' partials, in turn
  float sum[2][N / 2];                   // the box's scores
  uint32_t it = 0;                       // stages consumed before the box
  for (int b = b0; b < b1; ++b) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < N / 2; ++i) sum[h][i] = 0.f;
    for (int kc = 0; kc < nk; kc += 2) {
      uint32_t u = it + kc;
      hgemm::bar_wait(&full[u % R::STAGES], (u / R::STAGES) & 1);
      stage_step<N, 0>(acc, sum, base + (u % R::STAGES) * R::STAGE,
                       kc > 0 ? &empty[(u - 1) % R::STAGES] : nullptr, lane);
      if (kc + 1 < nk) {
        ++u;
        hgemm::bar_wait(&full[u % R::STAGES], (u / R::STAGES) & 1);
        stage_step<N, 1>(acc, sum, base + (u % R::STAGES) * R::STAGE,
                         &empty[(u - 1) % R::STAGES], lane);
      }
    }
    it += nk;
    uint64_t* last = &empty[(it - 1) % R::STAGES];
    if ((nk - 1) & 1)
      stage_done<N, 1>(acc, sum, last, lane);
    else
      stage_done<N, 0>(acc, sum, last, lane);

    // sum[h][4 j + 2 e + c] is row 64 h + 16 warp + lane / 4 + 8 e of the
    // box, query column 8 j + 2 (lane % 4) + c; this thread's column a is
    // (j, c) = (a / 2, a % 2)
    const int row0 = b * BOX_ROWS;
#pragma unroll
    for (int a = 0; a < A; ++a) {
      const int col = 8 * (a / 2) + 2 * (lane & 3) + (a & 1);
      if (q0 + col >= Q) continue;
      const float t = thr[col];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = row0 + 64 * h + 16 * warp + (lane >> 2) + 8 * e;
          if (row >= V) continue;
          const float x = sum[h][4 * (a / 2) + 2 * e + (a & 1)];
          online_add(m[a], s[a], x);
          if (x >= t) {                  // false for NaN
            const int slot = atomicAdd(&cnt[col], 1);
            cand_v[col][slot] = __fadd_rn(x, 0.f);   // -0 as +0
            cand_i[col][slot] = row;
          }
        }
    }
    consumer_sync();
#pragma unroll
    for (int a = 0; a < A; ++a) {
      const int col = warp + 4 * a;
      const int n = cnt[col];
      if (n == 0) continue;              // warp-uniform
      float cv[PER_LANE];
      int ci[PER_LANE];
#pragma unroll
      for (int j = 0; j < PER_LANE; ++j) {
        const int slot = lane + 32 * j;
        cv[j] = slot < n ? cand_v[col][slot] : -INFINITY;
        ci[j] = slot < n ? cand_i[col][slot] : 0x7fffffff;
      }
      merge_candidates(lv[a], li[a], cv, ci, k, lane);
      if (lane == k - 1) thr[col] = lv[a];
      __syncwarp();
      if (lane == 0) cnt[col] = 0;
    }
    consumer_sync();
  }

  // the CTA's partials: (m, s) folded over the 8 lanes of a column in a
  // warp, then over the 4 warps in order; each warp writes its lists
#pragma unroll
  for (int a = 0; a < A; ++a) {
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m[a], off);
      const float s2 = __shfl_xor_sync(0xffffffffu, s[a], off);
      lse_fold(m[a], s[a], m2, s2);
    }
    if (lane < 4) {
      const int col = 8 * (a / 2) + 2 * lane + (a & 1);
      fold_m[warp][col] = m[a];
      fold_s[warp][col] = s[a];
    }
  }
  const size_t parts = gridDim.x;
#pragma unroll
  for (int a = 0; a < A; ++a) {
    const int q = q0 + warp + 4 * a;
    if (q < Q && lane < k) {
      const size_t idx = ((size_t)q * parts + blockIdx.x) * k + lane;
      part_v[idx] = lv[a];
      part_i[idx] = li[a];
    }
  }
  consumer_sync();
  if (threadIdx.x < N && q0 + threadIdx.x < Q) {
    float mq = fold_m[0][threadIdx.x], sq = fold_s[0][threadIdx.x];
    for (int w = 1; w < CONSUMERS / 32; ++w)
      lse_fold(mq, sq, fold_m[w][threadIdx.x], fold_s[w][threadIdx.x]);
    const size_t idx = (size_t)(q0 + threadIdx.x) * parts + blockIdx.x;
    part_m[idx] = mq;
    part_s[idx] = sq;
  }
}

template <int N>
static int launch(const void* h, const void* w, int Q, int V, int d, int k,
                  int grid_x, float* part_m, float* part_s, float* part_v,
                  int* part_i, float* lse, float* topv, int* topi,
                  const int* rows, cudaStream_t stream) {
  CUtensorMap wmap, hmap;
  if (hgemm::make_map_rows(&wmap, w, d, V, BOX_ROWS) ||
      hgemm::make_map_rows(&hmap, h, d, Q, N))
    return hgemm::ERR_TENSOR_MAP;
  cudaError_t err = cudaFuncSetAttribute(
      topk_z_tc<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Ring<N>::SMEM);
  if (err != cudaSuccess) return (int)err;
  const int n_boxes = (V + BOX_ROWS - 1) / BOX_ROWS;
  dim3 grid(grid_x, (Q + N - 1) / N);
  topk_z_tc<N><<<grid, THREADS, Ring<N>::SMEM, stream>>>(
      wmap, hmap, Q, V, d, k, n_boxes, part_m, part_s, part_v, part_i, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (k <= 8)
    merge_partials<8><<<Q, MERGE_THREADS, 0, stream>>>(
        grid_x, k, part_m, part_s, part_v, part_i, nullptr, nullptr, lse,
        nullptr, topv, topi, rows);
  else
    merge_partials<32><<<Q, MERGE_THREADS, 0, stream>>>(
        grid_x, k, part_m, part_s, part_v, part_i, nullptr, nullptr, lse,
        nullptr, topv, topi, rows);
  return (int)cudaGetLastError();
}

}  // namespace tc

// ---- f32: the query tile in shared memory, the CUDA cores -----------------

namespace cc {

using namespace streaming;

template <int KMAX>
__global__ void __launch_bounds__(THREADS, KMAX <= 8 ? 2 : 1)
topk_z_partial(const float* __restrict__ h, const float* __restrict__ w,
               int Q, int V, int d, int k, float* __restrict__ part_m,
               float* __restrict__ part_s, float* __restrict__ part_v,
               int* __restrict__ part_i, const int* __restrict__ rows) {
  extern __shared__ __align__(16) unsigned char tile[];
  float* hs = reinterpret_cast<float*>(tile);
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
    const float* rows[R];
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

template <int KMAX>
static int launch(const float* h, const float* w, int Q, int V, int d, int k,
                  int grid_x, float* part_m, float* part_s, float* part_v,
                  int* part_i, float* lse, float* topv, int* topi,
                  const int* rows, cudaStream_t stream) {
  const size_t smem = (size_t)QT * d * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      topk_z_partial<KMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(grid_x, (Q + QT - 1) / QT);
  topk_z_partial<KMAX><<<grid, THREADS, smem, stream>>>(
      h, w, Q, V, d, k, part_m, part_s, part_v, part_i, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  merge_partials<KMAX><<<Q, MERGE_THREADS, 0, stream>>>(
      grid_x, k, part_m, part_s, part_v, part_i, nullptr, nullptr,
      lse, nullptr, topv, topi, rows);
  return (int)cudaGetLastError();
}

template <int KMAX>
static cudaError_t tile_limit(int* bytes) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, topk_z_partial<KMAX>);
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

}  // namespace cc

// rows: the gate (Q,) int32, or nullptr for every query. f32: 1 if h and w
// are f32 (the CUDA-core kernel, grid_x CTAs a query tile of 8), 0 if bf16
// (the tensor-core kernel, grid_x CTAs a query tile of 8 for Q <= 8 and of
// 16 otherwise, grid_x <= the 128-row boxes of W). part_m / part_s
// (Q, grid_x), part_v / part_i (Q, grid_x, k).
extern "C" int topk_z_launch(const void* h, const void* w, int Q, int V,
                             int d, int k, int grid_x, void* part_m,
                             void* part_s, void* part_v, void* part_i,
                             void* lse, void* topv, void* topi,
                             const void* rows, int f32, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto pm = static_cast<float*>(part_m);
  auto ps = static_cast<float*>(part_s);
  auto pv = static_cast<float*>(part_v);
  auto pi = static_cast<int*>(part_i);
  auto l = static_cast<float*>(lse);
  auto tv = static_cast<float*>(topv);
  auto ti = static_cast<int*>(topi);
  auto r = static_cast<const int*>(rows);
  if (f32) {
    auto hf = static_cast<const float*>(h);
    auto wf = static_cast<const float*>(w);
    return k <= 8 ? cc::launch<8>(hf, wf, Q, V, d, k, grid_x, pm, ps, pv, pi,
                                  l, tv, ti, r, st)
                  : cc::launch<32>(hf, wf, Q, V, d, k, grid_x, pm, ps, pv,
                                   pi, l, tv, ti, r, st);
  }
  return Q <= 8 ? tc::launch<8>(h, w, Q, V, d, k, grid_x, pm, ps, pv, pi, l,
                                tv, ti, r, st)
                : tc::launch<16>(h, w, Q, V, d, k, grid_x, pm, ps, pv, pi, l,
                                 tv, ti, r, st);
}

// The dynamic shared memory an f32 query tile may take on the current
// device at top-k k: the block's opt-in limit less the kernel's static
// shared memory.
extern "C" int topk_z_tile_limit(int k, int* bytes) {
  return (int)(k <= 8 ? cc::tile_limit<8>(bytes) : cc::tile_limit<32>(bytes));
}

// The bf16 kernel's ring at query tile n (8 or 16): its stages, the bytes
// of a stage (W's box slice and the queries' slice) and the dynamic shared
// memory it asks for (kernels/topk_z.py::geometry mirrors them).
extern "C" int topk_z_ring(int n, int* stages, int* stage_bytes, int* smem) {
  if (n != 8 && n != tc::QTILE) return (int)cudaErrorInvalidValue;
  *stages = n == 8 ? tc::Ring<8>::STAGES : tc::Ring<16>::STAGES;
  *stage_bytes = n == 8 ? tc::Ring<8>::STAGE : tc::Ring<16>::STAGE;
  *smem = (int)(n == 8 ? tc::Ring<8>::SMEM : tc::Ring<16>::SMEM);
  return 0;
}
