// Per-query scores of each query's probed IVF blocks, each block read once
// per query tile.
//
// Replaces the TPU kernel src/repro/kernels/ivf_score.py::ivf_score
// (_ivf_kernel): for queries h (Q, d) and per-query probed block ids
// block_ids (Q, P), write out[q, p, r] = h[q] . w_blocks[block_ids[q, p], r]
// in f32 for every row r of the block; an id outside [0, nb) gives a NaN
// row. It is the kernel behind ops.ivf_block_scores; the serving decodes use
// ivf_decode and union_scores, which never write this tensor.
//
// Bound on this card: bytes. Queries of a tile that probe the same block
// need it read once, so the kernel reads each 8-query tile's distinct valid
// blocks of br x d rows (bf16 or f32, as the queries) once and writes the
// (Q, P, br) f32 output (qwen1.5-4b in bf16 on the mimps plan's Q 8 x P 16
// probes: 23 distinct blocks of 512 x 2560 and a 0.26 MB output, 60.6 MB,
// 18 us at 3.35 TB/s, where a read per (query, probe) pair would be
// 335 MB), and does 2 flops per element read and query.
//
// Design: two launches on the caller's stream.
// (1) The prologue, one CTA per 8-query tile (gather_stream.cuh's QT),
//     marks the tile's valid ids in a bitmap of the nb blocks in shared
//     memory; the bitmap's popcount prefix gives each id its slot in the
//     tile's sorted union, with no sort. It writes the union (pad slots
//     repeat the last id, as union_scores.cu reads a union), its live
//     count, and for each slot and query of the tile a mask of the probe
//     slots p that name the block (ceil(P / 32) words, so a query may name
//     a block more than once and P has no cap), and NaN over the rows of
//     the (q, p) pairs whose id is out of range.
// (2) The scores, gather_stream.cuh's UnionJob (the Job union_scores.cu
//     runs), launched as a programmatic dependent of (1): its launch and
//     set-up overlap (1), and it waits for (1)'s union before its first
//     read. Query tile y's CTAs (the grid's y axis) take equal contiguous
//     shares of its union's live x br rows and score them against the
//     tile, bf16 on mma.sync m16n8k16 and f32 on FMAs. After a stage's
//     partials meet, each (query, row) score goes to every probe slot in
//     that query's mask for the row's union slot; four rows of a slot that
//     start at a multiple of 4 go as one 16-byte store by the first one's
//     thread. Every output element is written by exactly one thread and
//     every sum runs in a fixed order, so two calls are bit-equal, and a
//     score equals union_scores' for that block and query tile bit for bit.
#include "gather_stream.cuh"

namespace {

using gstream::FULL;
using gstream::Layout;
using gstream::layout;
using gstream::QT;
using gstream::score;
using gstream::Stage;
using gstream::Tile;
using gstream::UnionJob;

constexpr int PRO_THREADS = 256;       // threads of a prologue CTA
constexpr int PRO_WARPS = PRO_THREADS / 32;

// The prologue of query tile blockIdx.x: its union (U slots), live count
// and probe masks (U, QT, W); NaN over the rows of out-of-range ids.
__global__ void __launch_bounds__(PRO_THREADS)
ivf_score_unions(const int* __restrict__ block_ids, int Q, int P, int nb,
                 int U, int W, int br, int* __restrict__ union_ids,
                 int* __restrict__ union_live, uint32_t* __restrict__ masks,
                 float* __restrict__ out) {
  // the bitmap of the tile's valid ids [nw], then each word's exclusive
  // prefix of popcounts [nw]
  extern __shared__ uint32_t bits[];
  __shared__ int warp_sum[PRO_WARPS];
  __shared__ int last;                 // the union's last id, 0 if empty
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int nw = (nb + 31) / 32;
  int* pre = reinterpret_cast<int*>(bits + nw);
  const int tile = blockIdx.x, q0 = tile * QT;
  const int nq = Q - q0 < QT ? Q - q0 : QT, n = nq * P;
  const int* ids = block_ids + (size_t)q0 * P;
  int* uid = union_ids + (size_t)tile * U;
  uint32_t* mk = masks + (size_t)tile * U * QT * W;

  for (int i = t; i < nw; i += PRO_THREADS) bits[i] = 0u;
  if (t == 0) last = 0;
  __syncthreads();
  for (int i = t; i < n; i += PRO_THREADS) {
    const int id = ids[i];
    if (id >= 0 && id < nb) atomicOr(&bits[id >> 5], 1u << (id & 31));
  }
  __syncthreads();
  // the prefix: a run of words a thread, then a scan over the threads
  const int per = (nw + PRO_THREADS - 1) / PRO_THREADS;
  const int w0 = t * per < nw ? t * per : nw;
  const int w1 = w0 + per < nw ? w0 + per : nw;
  int own = 0;
  for (int w = w0; w < w1; ++w) own += __popc(bits[w]);
  int incl = own;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  int base = incl - own, live = 0;
  for (int k = 0; k < PRO_WARPS; ++k) {
    if (k < warp) base += warp_sum[k];
    live += warp_sum[k];
  }
  // the union in id order, from this thread's words
  for (int w = w0; w < w1; ++w) {
    pre[w] = base;
    for (uint32_t b = bits[w]; b; b &= b - 1) {
      const int id = w * 32 + __ffs(b) - 1;
      uid[base++] = id;
      if (base == live) last = id;
    }
  }
  for (int i = t; i < U * QT * W; i += PRO_THREADS) mk[i] = 0u;
  __syncthreads();
  for (int i = live + t; i < U; i += PRO_THREADS) uid[i] = last;
  // each valid (q, p) into its mask; a warp writes NaN over the rows of
  // its out-of-range ids, a row at a time
  for (int i0 = warp * 32; i0 < n; i0 += PRO_THREADS) {   // whole warps
    const int i = i0 + lane, id = i < n ? ids[i] : 0;
    const bool valid = id >= 0 && id < nb;
    if (i < n && valid) {
      const int w = id >> 5, q = i / P, p = i - q * P;
      const int slot = pre[w] + __popc(bits[w] & ((1u << (id & 31)) - 1u));
      atomicOr(&mk[((size_t)slot * QT + q) * W + p / 32], 1u << (p % 32));
    }
    for (uint32_t bad = __ballot_sync(FULL, i < n && !valid); bad;
         bad &= bad - 1) {
      float* row = out + ((size_t)q0 * P + i0 + __ffs(bad) - 1) * br;
      for (int r = lane; r < br; r += 32) row[r] = nanf("");
    }
  }
  if (t == 0) union_live[tile] = live;
}

// ivf_score's epilogue: each (query, row) score to every probe slot in the
// query's mask for the row's union slot.
struct ProbeScatter {
  static constexpr bool PER_TILE = true;     // a union a query tile
  const uint32_t* masks;                     // (tiles, U, QT, W)
  float* out;                                // (Q, P, br)
  int P, W;

  template <class Job>
  __device__ void start(const Job&, int, int, int) const {}

  // one (query, row) score a thread, rows of a query on adjacent lanes
  template <class Job>
  __device__ void post(const Job& j, const Stage& st, int t, int q0,
                       int nq) const {
    using T = typename Job::Elem;
    constexpr int ROWS = Tile<T>::ROWS, CT = Tile<T>::WARPS * 32;
    const int lane = t % 32;
    const uint32_t* mt = masks + (size_t)blockIdx.y * j.U * QT * W;
    for (int p0 = t - lane; p0 < ROWS * QT; p0 += CT) {   // whole warps
      const int p = p0 + lane, r = p % ROWS, q = p / ROWS;
      const bool in = p < ROWS * QT && r < st.n && q < nq;
      const float x = in ? score<T>(st, r, q) : 0.f;
      const float x1 = __shfl_down_sync(FULL, x, 1);
      const float x2 = __shfl_down_sync(FULL, x, 2);
      const float x3 = __shfl_down_sync(FULL, x, 3);
      if (!in) continue;
      const int jr = j.lo + st.j0 + r, slot = jr / j.br;
      const int row = jr - slot * j.br;
      // rows row - g .. row - g + 3 of the slot, all in this stage, query
      // and warp, 16-byte aligned in out where br % 4 == 0: one store by
      // the lane of the first
      const int g = row % 4, r0 = r - g;
      const bool run4 = j.br % 4 == 0 && r0 >= 0 && r0 + 3 < st.n &&
                        r0 + 3 < ROWS && lane >= g && lane - g + 3 < 32;
      if (run4 && g != 0) continue;
      const uint32_t* mq = mt + ((size_t)slot * QT + q) * W;
      for (int w = 0; w < W; ++w) {
        for (uint32_t m = mq[w]; m; m &= m - 1) {
          const int pp = w * 32 + __ffs(m) - 1;
          float* dst = out + ((size_t)(q0 + q) * P + pp) * j.br + row;
          if (run4)
            *reinterpret_cast<float4*>(dst) = make_float4(x, x1, x2, x3);
          else
            *dst = x;
        }
      }
    }
  }
};

template <class T>
__global__ void __launch_bounds__((Tile<T>::WARPS + 1) * 32, GS_CTAS)
ivf_score_rows(UnionJob<T, ProbeScatter> job, const T* __restrict__ h,
               int Q) {
  gstream::run<T>(job, h, Q, job.d);
}

template <class T>
cudaError_t launch(const T* wb, const T* h, const int* block_ids, int Q,
                   int P, int nb, int br, int d, int U, int W, int grid_x,
                   int* union_ids, int* union_live, uint32_t* masks,
                   float* out, cudaStream_t st) {
  using Job = UnionJob<T, ProbeScatter>;
  Job job{wb, union_ids, union_live, U, br, d,
          ProbeScatter{masks, out, P, W}};
  const Layout m = layout<T>(d, job.side_bytes, job.extra_bytes);
  if (m.nst < 1) return cudaErrorInvalidValue;    // d too wide for the ring
  const int tiles = (Q + QT - 1) / QT;
  const int pro_smem = 2 * ((nb + 31) / 32) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      ivf_score_unions, cudaFuncAttributeMaxDynamicSharedMemorySize,
      pro_smem);
  if (err != cudaSuccess) return err;
  ivf_score_unions<<<tiles, PRO_THREADS, pro_smem, st>>>(
      block_ids, Q, P, nb, U, W, br, union_ids, union_live, masks, out);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ivf_score_rows<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             m.total);
  if (err != cudaSuccess) return err;
  // the scores as a programmatic dependent of the prologue
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid_x, tiles);
  cfg.blockDim = dim3(gstream::threads<T>());
  cfg.dynamicSmemBytes = m.total;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, ivf_score_rows<T>, job, h, Q);
}

}  // namespace

// w_blocks (nb, br, d) and h (Q, d), both bf16 (f32 == 0) or both f32;
// block_ids (Q, P) int32; the prologue's buffers union_ids (tiles, U) and
// union_live (tiles,) int32 and masks (tiles, U, QT, W) uint32, tiles =
// ceil(Q / QT), U = min(QT * P, nb), W = ceil(P / 32); out (Q, P, br) f32;
// grid_x CTAs a query tile.
extern "C" int ivf_score_launch(const void* w_blocks, const void* h,
                                const void* block_ids, int Q, int P, int nb,
                                int br, int d, int U, int W, int grid_x,
                                void* union_ids, void* union_live,
                                void* masks, void* out, int f32,
                                void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto ids = static_cast<const int*>(block_ids);
  auto uid = static_cast<int*>(union_ids);
  auto ul = static_cast<int*>(union_live);
  auto mk = static_cast<uint32_t*>(masks);
  auto o = static_cast<float*>(out);
  if (f32)
    return (int)launch<float>(static_cast<const float*>(w_blocks),
                              static_cast<const float*>(h), ids, Q, P, nb,
                              br, d, U, W, grid_x, uid, ul, mk, o, st);
  return (int)launch<gstream::bf16>(
      static_cast<const gstream::bf16*>(w_blocks),
      static_cast<const gstream::bf16*>(h), ids, Q, P, nb, br, d, U, W,
      grid_x, uid, ul, mk, o, st);
}
