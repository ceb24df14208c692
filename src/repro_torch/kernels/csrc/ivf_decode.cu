// Fused batched MIMPS decode (the paper's Eq. 5 at decode time).
//
// Replaces the TPU kernel src/repro/kernels/ivf_score.py::ivf_decode
// (_decode_kernel): for a query batch h (Q, d) and a deduplicated probe plan,
// score the rows of the union's blocks (head) and the staged tail sample
// rows (tail), and return per query the head LSE over member, non-pad rows,
// the top-k over global slot ids block*br + row, and the tail LSE over
// accepted samples (-inf when none survives).
//
// Bound on this card: bytes. The kernel reads head_live live blocks of
// br x d rows plus l tail rows once (qwen1.5-4b in bf16 on the main path's
// plan: 23 blocks of 512 x 2560 plus 1000 rows, about 65 MB, about 20 us at
// 3.35 TB/s; twice that in f32) and does 2*Q flops per element read. Rows,
// queries and tail rows are all bf16 or all f32.
//
// Design: two launches on the caller's stream. (1) The partial kernel, a Job
// of the gathered-row pipeline gather_stream.cuh, the one union_scores.cu
// and lsh_probe.cu run on: each CTA of a persistent grid takes an equal
// share of the l tail rows and then of the live head rows (head_live x br,
// read from the device, so the host never synchronises on the plan and pad
// slots load nothing); its producer warp bulk-copies each row (a head row
// from w_blocks by its block id, a tail row from the staged tail_rows) into
// the ring, with the head row's row_logw beside it as a 4-byte side word.
// The CTA stages its query tile's head membership, the union's block ids
// and its tail samples' acceptance in shared memory before the first stage.
// After the warps' partial scores of a stage meet, each consumer warp folds
// the stage's rows into its queries' per-lane head and tail (m, s) and
// hands the rows that enter a query's top-k to the lane that holds it
// (gather_stream.cuh's LaneFold, as lsh_probe.cu does). A head row counts
// where the query is a member of its slot and its score plus row_logw is
// not at or below NEG/2 (cluster-pad rows carry NEG; a NaN score counts, so
// the LSE is NaN, as the reference's); a tail row where its sample is
// accepted. (2) merge_partials (streaming.cuh) combines the CTAs' partials
// in a fixed order; it is launched as a programmatic dependent of (1), so
// its launch overlaps (1). Every sum runs in a fixed order, so two calls
// are bit-equal.
#include "gather_stream.cuh"

using gstream::copy_word;
using gstream::FULL;
using gstream::LaneFold;
using gstream::Layout;
using gstream::layout;
using gstream::QT;
using gstream::run;
using gstream::score;
using gstream::Stage;
using gstream::threads;
using gstream::Tile;
using streaming::merge_partials;
using streaming::MERGE_THREADS;
using streaming::NEG;

template <class T, int KMAX>
struct DecodeJob {
  const T* wb;
  const int* head_ids;
  const int* head_live;
  const bool* member;
  const float* row_logw;
  const T* tail;
  const bool* accept;
  int U, br, d, L, k;
  float *part_hm, *part_hs, *part_v, *part_tm, *part_ts;
  int* part_i;
  int side_bytes, extra_bytes;
  uint8_t* own = nullptr;              // its shared memory (run sets it)
  // live slots; this CTA's tail rows [tl, tl + nt) (its rows 0 .. nt - 1)
  // and head rows [hl, ...) of the live slots' head_live x br (its rows
  // from nt on)
  int live = 0, tl = 0, nt = 0, hl = 0;

  static constexpr int ROWS = Tile<T>::ROWS, CW = Tile<T>::WARPS;
  using Fold = LaneFold<T, KMAX>;
  Fold fold;                           // query warp + CW u, lane a row

  struct Src {
    int row;                           // tail row, or block * br + row
    bool tail;
  };

  // this Job's shared memory: the union's block ids [U], per partial
  // buffer a row_logw a row, then the query tile's membership [QT][U] and
  // its tail acceptance [QT][per] (bytes), per = the most tail rows a CTA
  // takes
  __host__ __device__ static int per_cta(int L, int grid) {
    return (L + grid - 1) / grid;
  }
  __host__ __device__ static int extra(int U, int L, int grid) {
    return U * 4 + 2 * ROWS * 4 + QT * U + QT * per_cta(L, grid);
  }
  __device__ int* ids() const { return reinterpret_cast<int*>(own); }
  __device__ float* logw(int buf) const {
    return reinterpret_cast<float*>(own) + U + buf * ROWS;
  }
  __device__ const uint8_t* mem() const { return own + U * 4 + 2 * ROWS * 4; }
  __device__ const uint8_t* acc() const { return mem() + QT * U; }

  // an equal share of the tail rows, then of the live head rows
  __device__ int rows() {
    const int n = *head_live;
    live = n < 0 ? 0 : (n < U ? n : U);
    const long long b = blockIdx.x, g = gridDim.x;
    const long long all = (long long)live * br;
    tl = (int)(L * b / g);
    nt = (int)(L * (b + 1) / g) - tl;
    hl = (int)(all * b / g);
    return nt + (int)(all * (b + 1) / g) - hl;
  }
  __device__ Src src(int i) const {
    if (i < nt) return {tl + i, true};
    const int j = hl + i - nt, slot = j / br;
    return {head_ids[slot] * br + (j - slot * br), false};
  }
  __device__ const T* ptr(const Src& s) const {
    return (s.tail ? tail : wb) + (size_t)s.row * d;
  }
  // a head row's row_logw; nothing beside a tail row
  __device__ void side(const Src& s, int, uint32_t dst) const {
    if (!s.tail) copy_word(dst, row_logw + s.row);
  }

  __device__ void start(int t, int q0, int nq) {
    constexpr int CT = CW * 32;
    int* is = ids();
    for (int i = t; i < live; i += CT) is[i] = head_ids[i];
    uint8_t* ms = own + U * 4 + 2 * ROWS * 4;
    for (int i = t; i < QT * U; i += CT) {
      const int q = i / U;
      ms[i] = q < nq && member[(size_t)(q0 + q) * U + i % U] ? 1 : 0;
    }
    uint8_t* as = ms + QT * U;
    const int per = per_cta(L, gridDim.x);
    for (int i = t; i < QT * nt; i += CT) {
      const int q = i / nt, r = i % nt;
      as[q * per + r] = q < nq && accept[(size_t)(q0 + q) * L + tl + r] ? 1
                                                                         : 0;
    }
    fold.init();
  }

  // the stage's head rows' row_logw, out of the ring before its release
  __device__ void pre(const Stage& st, int t, int, int) const {
    if (t < st.n && st.j0 + t >= nt)
      logw(st.buf)[t] =
          *reinterpret_cast<const float*>(st.side + t * side_bytes);
  }

  // query q = warp + CW u is folded by consumer warp q % CW, a lane a row
  // (LaneFold)
  __device__ void post(const Stage& st, int t, int q0, int nq) {
    static_assert(ROWS <= 32, "a lane a row");
    const int warp = t / 32, lane = t % 32;
    const int i = st.j0 + lane;        // the lane's row of the CTA's
    const bool mine = lane < st.n;
    const bool tail = i < nt;
    const int j = hl + i - nt, slot = tail ? 0 : j / br;
    const int id = mine && !tail ? ids()[slot] * br + (j - slot * br) : 0;
    const float lw = mine && !tail ? logw(st.buf)[lane] : 0.f;
    const int per = per_cta(L, gridDim.x);
#pragma unroll
    for (int u = 0; u < Fold::UQ; ++u) {
      const int q = warp + CW * u;
      if (q >= nq) break;
      bool in = mine && (tail ? acc()[q * per + i] : mem()[q * U + slot]);
      if (!__any_sync(FULL, in)) continue;
      float x = in ? score<T>(st, lane, q) : NEG;
      if (!tail) {
        x += lw;
        in = in && !(x <= NEG * 0.5f);   // a NaN row counts: NaN LSE
      }
      fold.row(u, lane, in, tail, x, id);
    }
  }

  __device__ void finish(int t, int q0, int nq) {
    fold.finish(t, q0, nq, k, part_hm, part_hs, part_tm, part_ts, part_v,
                part_i);
  }
};

template <class T, int KMAX>
__global__ void __launch_bounds__((Tile<T>::WARPS + 1) * 32, GS_CTAS)
ivf_decode_partial(DecodeJob<T, KMAX> job, const T* __restrict__ h, int Q) {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  run<T>(job, h, Q, job.d);
}

template <class T, int KMAX>
static cudaError_t launch(
    const T* wb, const T* h, const int* head_ids, const int* head_live,
    const bool* member, const float* row_logw, const T* tail,
    const bool* accept, int Q, int U, int br, int d, int L, int k,
    int grid_x, float* phm, float* phs, float* pv, int* pi, float* ptm,
    float* pts, float* head_lse, float* tail_lse, float* topv, int* topi,
    cudaStream_t stream) {
  using Job = DecodeJob<T, KMAX>;
  Job job{wb, head_ids, head_live, member, row_logw, tail, accept, U, br, d,
          L, k, phm, phs, pv, ptm, pts, pi, 4, Job::extra(U, L, grid_x)};
  const Layout m = layout<T>(d, job.side_bytes, job.extra_bytes);
  if (m.nst < 1) return cudaErrorInvalidValue;    // d too wide for the ring
  cudaError_t err = cudaFuncSetAttribute(
      ivf_decode_partial<T, KMAX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, m.total);
  if (err != cudaSuccess) return err;
  dim3 grid(grid_x, (Q + QT - 1) / QT);
  ivf_decode_partial<T, KMAX><<<grid, threads<T>(), m.total, stream>>>(
      job, h, Q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // the merge as a programmatic dependent: its launch overlaps the partial
  // kernel, and it waits for the partials before its first read
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(Q);
  cfg.blockDim = dim3(MERGE_THREADS);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, merge_partials<KMAX>, grid_x, k,
                            static_cast<const float*>(phm),
                            static_cast<const float*>(phs),
                            static_cast<const float*>(pv),
                            static_cast<const int*>(pi),
                            static_cast<const float*>(ptm),
                            static_cast<const float*>(pts), head_lse,
                            tail_lse, topv, topi,
                            static_cast<const int*>(nullptr));
}

template <class T>
static cudaError_t dispatch(
    const void* w_blocks, const void* h, const void* head_ids,
    const void* head_live, const void* head_member, const void* row_logw,
    const void* tail_rows, const void* tail_accept, int Q, int U, int br,
    int d, int L, int k, int grid_x, void* part_hm, void* part_hs,
    void* part_v, void* part_i, void* part_tm, void* part_ts, void* head_lse,
    void* tail_lse, void* topv, void* topi, cudaStream_t st) {
  auto wb = static_cast<const T*>(w_blocks);
  auto hb = static_cast<const T*>(h);
  auto ids = static_cast<const int*>(head_ids);
  auto lv = static_cast<const int*>(head_live);
  auto mem = static_cast<const bool*>(head_member);
  auto lw = static_cast<const float*>(row_logw);
  auto tr = static_cast<const T*>(tail_rows);
  auto acc = static_cast<const bool*>(tail_accept);
  auto phm = static_cast<float*>(part_hm);
  auto phs = static_cast<float*>(part_hs);
  auto pv = static_cast<float*>(part_v);
  auto pi = static_cast<int*>(part_i);
  auto ptm = static_cast<float*>(part_tm);
  auto pts = static_cast<float*>(part_ts);
  auto hl = static_cast<float*>(head_lse);
  auto tl = static_cast<float*>(tail_lse);
  auto tv = static_cast<float*>(topv);
  auto ti = static_cast<int*>(topi);
  if (k <= 8)
    return launch<T, 8>(wb, hb, ids, lv, mem, lw, tr, acc, Q, U, br, d, L, k,
                        grid_x, phm, phs, pv, pi, ptm, pts, hl, tl, tv, ti,
                        st);
  return launch<T, 32>(wb, hb, ids, lv, mem, lw, tr, acc, Q, U, br, d, L, k,
                       grid_x, phm, phs, pv, pi, ptm, pts, hl, tl, tv, ti,
                       st);
}

// f32: 1 if the rows, queries and tail rows are f32, 0 if bf16.
extern "C" int ivf_decode_launch(
    const void* w_blocks, const void* h, const void* head_ids,
    const void* head_live, const void* head_member, const void* row_logw,
    const void* tail_rows, const void* tail_accept, int Q, int U, int br,
    int d, int L, int k, int grid_x, void* part_hm, void* part_hs,
    void* part_v, void* part_i, void* part_tm, void* part_ts, void* head_lse,
    void* tail_lse, void* topv, void* topi, int f32, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (f32)
    return (int)dispatch<float>(
        w_blocks, h, head_ids, head_live, head_member, row_logw, tail_rows,
        tail_accept, Q, U, br, d, L, k, grid_x, part_hm, part_hs, part_v,
        part_i, part_tm, part_ts, head_lse, tail_lse, topv, topi, st);
  return (int)dispatch<__nv_bfloat16>(
      w_blocks, h, head_ids, head_live, head_member, row_logw, tail_rows,
      tail_accept, Q, U, br, d, L, k, grid_x, part_hm, part_hs, part_v,
      part_i, part_tm, part_ts, head_lse, tail_lse, topv, topi, st);
}

// The ring geometry `layout` picks for a launch at these shapes (U union
// slots, L tail rows, d, grid_x CTAs): out = {rows a stage, stages, row
// pitch in bytes, dynamic shared memory in bytes}. Nothing is launched.
extern "C" int ivf_decode_geometry(int U, int L, int d, int grid_x, int f32,
                                   int* out) {
  const Layout m =
      f32 ? layout<float>(d, 4, DecodeJob<float, 8>::extra(U, L, grid_x))
          : layout<__nv_bfloat16>(
                d, 4, DecodeJob<__nv_bfloat16, 8>::extra(U, L, grid_x));
  out[0] = m.rows;
  out[1] = m.nst;
  out[2] = m.pitch;
  out[3] = m.total;
  return 0;
}
