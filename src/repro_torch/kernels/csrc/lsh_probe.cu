// Fused Hamming-probe decode of the LSH backend.
//
// Replaces the TPU kernel src/repro/kernels/lsh_probe.py::lsh_probe
// (_probe_kernel): for a query batch h (Q, d) and a candidate set given by
// row ids, make the queries' SimHash codes from h and the hyperplanes,
// count per candidate the tables where it collides with each query and is
// routed, and return per query the head LSE and top-k over members
// (count > 0) and the tail LSE over the accepted tail samples, each sample's
// importance bias added to its score. The per-candidate counts (Q, C) are
// written out; the top-k ids are original row ids.
//
// Bound on this card: bytes. The kernel reads each live candidate's row of w
// once, by id (bf16 or f32, as the queries), plus l tail rows, the
// candidates' codes and slots and writes the (Q, C) counts (qwen1.5-4b,
// trimmed union: up to 38016 rows of 2560, about 195 MB plus 5.1 MB of tail
// rows, about 0.06 ms at 3.35 TB/s; the dense fallback reads all 151936
// rows, about 0.24 ms), and does 2*Q flops per element read.
//
// Design: three launches on the caller's stream. (1) lsh_codes: one CTA per
// (query, table), one warp per hyperplane: an f32 dot product over d on the
// CUDA cores (h, bf16 or f32, is exact in f32; no tensor cores, so no
// TF32), the sign bits packed with integer shifts. The TPU kernel made the
// codes in every query tile's first grid step with two matmuls; here every
// probe CTA would redo 64 dot products of length d, so they are made once.
// (2) The probe, on the gathered-row pipeline of gather_stream.cuh: each
// CTA of a persistent grid takes an equal share of the l tail samples and
// then of the live candidates (min(cand_live, C), read from the device),
// so the tail's acceptance flags and biases of its first stage are read
// while that stage's rows are in flight. Beside each candidate's row the
// producer copies its id and its L codes and L slots. Before a stage is
// released, the consumer threads count collisions, one (row, query) pair a
// thread, from those words and the query codes in shared memory, and
// write the counts. After the warps' partial scores meet, each consumer
// warp adds the stage's rows (a lane a row) to its queries' per-lane
// (m, s) of the head and of the tail, and hands the rows that enter a
// query's top-k to the lane that holds it; at the end the lanes' (m, s)
// fold, in a fixed tree, into the CTA's partial. Columns at or past
// cand_live load nothing and get count 0 (16-byte stores spread over
// every CTA), so the host never synchronises on the plan. (3)
// merge_partials (streaming.cuh) combines the CTAs' partials in a fixed
// order. The tail bias is added per sample instead of the TPU kernel's
// staged extra coordinate. The probe is launched as a programmatic
// dependent of lsh_codes (GS_PDL, measured faster by tools/stream_tiles.py):
// its row stream starts while the codes are made, and its consumers wait
// for them (griddepcontrol.wait) before the first count.
#include "gather_stream.cuh"
#include "streaming.cuh"

using gstream::copy_word;
using gstream::FULL;
using gstream::Layout;
using gstream::LaneFold;
using gstream::layout;
using gstream::QT;
using gstream::run;
using gstream::score;
using gstream::Stage;
using gstream::threads;
using gstream::Tile;
using gstream::zero_words;
using streaming::merge_partials;
using streaming::MERGE_THREADS;
using streaming::NEG;

#ifndef GS_PDL
#define GS_PDL 1        // launch the probe as a programmatic dependent
#endif

__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float to_f32(float x) { return x; }

template <class T>
__global__ void lsh_codes_kernel(const T* __restrict__ h,
                                 const float* __restrict__ proj, int d,
                                 int L, int K, int* __restrict__ qcodes) {
  __shared__ int bits[32];
#if GS_PDL
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
#endif
  const int q = blockIdx.x, t = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* p = proj + ((size_t)t * K + warp) * (d + 1);
  const T* hq = h + (size_t)q * d;
  float s = 0.f;
#pragma unroll 32                      // loads in flight; the same sums
  for (int j = lane; j < d; j += 32) s += to_f32(hq[j]) * p[j];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) bits[warp] = s > 0.f ? 1 : 0;
  __syncthreads();
  if (threadIdx.x == 0) {
    int code = 0;
    for (int b = 0; b < K; ++b) code |= bits[b] << b;
    qcodes[(size_t)q * L + t] = code;
  }
}

template <class T>
static cudaError_t launch_codes(const T* h, const float* proj, int Q, int d,
                                int L, int K, int* qcodes,
                                cudaStream_t stream) {
  lsh_codes_kernel<T><<<dim3(Q, L), 32 * K, 0, stream>>>(h, proj, d, L, K,
                                                          qcodes);
  return cudaGetLastError();
}

template <class T, int KMAX>
struct ProbeJob {
  const T* w;
  const int* cand_rows;
  const int* cand_live;
  const int* codes;
  const int* slot_of_row;
  const int* tail_ids;
  const bool* accept;
  const float* tail_bias;
  const int* qcodes;
  int C, d, L, NT, k;
  int* counts;
  float *part_hm, *part_hs, *part_v, *part_tm, *part_ts;
  int* part_i;
  int side_bytes, extra_bytes;
  uint8_t* own = nullptr;              // this Job's shared memory (run sets it)
  // live candidates; this CTA's tail samples [tl, tl + nt) (its rows
  // 0 .. nt - 1) and candidates [hl, ...) (its rows from nt on)
  int live = 0, tl = 0, nt = 0, hl = 0;

  static constexpr int ROWS = Tile<T>::ROWS, CW = Tile<T>::WARPS;
  using Fold = LaneFold<T, KMAX>;
  Fold fold;                           // query warp + CW u, lane a row

  struct Src {
    int id;
  };

  // this Job's shared memory: query codes [QT][L], then per partial
  // buffer a flag (count or acceptance) per (row, query) and an id or a
  // bias a row
  __host__ __device__ static int extra(int L) {
    return QT * L * 4 + 2 * ROWS * (QT + 1) * 4;
  }
  __device__ int* qc() const { return reinterpret_cast<int*>(own); }
  __device__ int* flags(int buf) const {
    return qc() + QT * L + buf * ROWS * (QT + 1);
  }

  // an equal share of the tail samples, then of the live candidates
  __device__ int rows() {
    const int n = *cand_live;
    live = n < 0 ? 0 : (n < C ? n : C);
    const long long b = blockIdx.x, g = gridDim.x;
    tl = (int)(NT * b / g);
    nt = (int)(NT * (b + 1) / g) - tl;
    hl = (int)(live * b / g);
    return nt + (int)(live * (b + 1) / g) - hl;
  }
  __device__ Src src(int i) const {
    return {i < nt ? tail_ids[tl + i] : cand_rows[hl + i - nt]};
  }
  __device__ const T* ptr(const Src& s) const {
    return w + (size_t)s.id * d;
  }
  // a candidate's id, L codes and L slots; nothing beside a tail sample
  __device__ void side(const Src& s, int i, uint32_t dst) const {
    if (i < nt) return;
    copy_word(dst, cand_rows + hl + i - nt);
    const int* rc = codes + (size_t)s.id * L;
    const int* rs = slot_of_row + (size_t)s.id * L;
    for (int t = 0; t < L; ++t) {
      copy_word(dst + 4 + 4 * t, rc + t);
      copy_word(dst + 4 + 4 * (L + t), rs + t);
    }
  }

  // a tail sample's acceptance by query q and its bias, into buffer buf
  __device__ void tail_flags(int buf, int r, int q, int q0, int i) const {
    int* f = flags(buf);
    f[r * QT + q] = accept[(size_t)(q0 + q) * NT + tl + i] ? 1 : 0;
    if (q == 0) reinterpret_cast<float*>(f)[ROWS * QT + r] = tail_bias[tl + i];
  }

  __device__ void start(int t, int q0, int nq) {
    constexpr int CT = CW * 32;
    const long long idx = (long long)blockIdx.x * CT + t;
    const long long stride = (long long)gridDim.x * CT;
    for (int q = 0; q < nq; ++q)                    // dead columns: count 0
      zero_words(reinterpret_cast<uint32_t*>(counts + (size_t)(q0 + q) * C +
                                             live),
                 C - live, idx, stride);
    // the first stage's tail samples, while its rows are in flight
    for (int p = t; p < ROWS * QT; p += CT) {
      const int r = p % ROWS, q = p / ROWS;
      if (r < nt && q < nq) tail_flags(0, r, q, q0, r);
    }
    fold.init();
#if GS_PDL
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
#endif
    int* qcs = qc();
    for (int i = t; i < QT * L; i += CT) {
      const int q = i / L;
      qcs[i] = q < nq ? qcodes[(size_t)(q0 + q) * L + i % L] : -1;
    }
  }

  // collisions of the stage's candidates, acceptance and bias of its later
  // tail samples: one (row, query) pair a thread, rows of a query adjacent
  __device__ void pre(const Stage& st, int t, int q0, int nq) const {
    int* f = flags(st.buf);
    const int* qcs = qc();
    for (int p = t; p < ROWS * QT; p += CW * 32) {
      const int r = p % ROWS, q = p / ROWS, i = st.j0 + r;
      if (r >= st.n || q >= nq) continue;
      if (i < nt) {
        if (st.j0 > 0) tail_flags(st.buf, r, q, q0, i);
        continue;
      }
      const int* sw = reinterpret_cast<const int*>(st.side + r * side_bytes);
      const int* mq = qcs + q * L;
      int cnt = 0;
#pragma unroll 4
      for (int tb = 0; tb < L; ++tb)
        cnt += (int)(sw[1 + tb] == mq[tb]) & (int)(sw[1 + L + tb] >= 0);
      counts[(size_t)(q0 + q) * C + hl + i - nt] = cnt;
      f[r * QT + q] = cnt;
      if (q == 0) f[ROWS * QT + r] = sw[0];         // the candidate's id
    }
  }

  // query q = warp + CW u is folded by consumer warp q % CW, a lane a row
  // (LaneFold); a tail sample's score takes its bias
  __device__ void post(const Stage& st, int t, int q0, int nq) {
    static_assert(ROWS <= 32, "a lane a row");
    const int warp = t / 32, lane = t % 32;
    const int* f = flags(st.buf);
    const bool mine = lane < st.n;
    const bool tail = st.j0 + lane < nt;
    const int id = mine ? f[ROWS * QT + lane] : 0;
    const float bias =
        mine ? reinterpret_cast<const float*>(f)[ROWS * QT + lane] : 0.f;
#pragma unroll
    for (int u = 0; u < Fold::UQ; ++u) {
      const int q = warp + CW * u;
      if (q >= nq) break;
      const bool in = mine && f[lane * QT + q] != 0;
      if (!__any_sync(FULL, in)) continue;
      const float x = in ? score<T>(st, lane, q) : NEG;
      fold.row(u, lane, in, tail, tail ? x + bias : x, id);
    }
  }

  __device__ void finish(int t, int q0, int nq) {
    fold.finish(t, q0, nq, k, part_hm, part_hs, part_tm, part_ts, part_v,
                part_i);
  }
};

template <class T, int KMAX>
__global__ void __launch_bounds__((Tile<T>::WARPS + 1) * 32, GS_CTAS)
lsh_probe_partial(ProbeJob<T, KMAX> job, const T* __restrict__ h, int Q) {
  run<T>(job, h, Q, job.d);
}

template <class T, int KMAX>
static cudaError_t launch_probe(
    const T* w, const T* h, const float* proj,
    const int* cand_rows, const int* cand_live, const int* codes,
    const int* slot_of_row, const int* tail_ids, const bool* accept,
    const float* tail_bias, int Q, int C, int d, int L, int K, int NT, int k,
    int grid_x, int* qcodes, int* counts, float* phm, float* phs, float* pv,
    int* pi, float* ptm, float* pts, float* head_lse, float* tail_lse,
    float* topv, int* topi, cudaStream_t stream) {
  using Job = ProbeJob<T, KMAX>;
  Job job{w, cand_rows, cand_live, codes, slot_of_row, tail_ids, accept,
          tail_bias, qcodes, C, d, L, NT, k, counts, phm, phs, pv, ptm,
          pts, pi, 4 + 8 * L, Job::extra(L)};
  const Layout m = layout<T>(d, job.side_bytes, job.extra_bytes);
  if (m.nst < 1) return cudaErrorInvalidValue;    // d too wide for the ring
  cudaError_t err = launch_codes(h, proj, Q, d, L, K, qcodes, stream);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(lsh_probe_partial<T, KMAX>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             m.total);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid_x, (Q + QT - 1) / QT);
  cfg.blockDim = dim3(threads<T>());
  cfg.dynamicSmemBytes = m.total;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = GS_PDL ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, lsh_probe_partial<T, KMAX>, job, h, Q);
  if (err != cudaSuccess) return err;
  merge_partials<KMAX><<<Q, MERGE_THREADS, 0, stream>>>(
      grid_x, k, phm, phs, pv, pi, ptm, pts, head_lse, tail_lse, topv, topi,
      nullptr);
  return cudaGetLastError();
}

// f32: 1 if h is f32, 0 if bf16.
extern "C" int lsh_codes_launch(const void* h, const void* proj, int Q,
                                int d, int L, int K, void* qcodes, int f32,
                                void* stream) {
  auto pj = static_cast<const float*>(proj);
  auto qc = static_cast<int*>(qcodes);
  auto st = static_cast<cudaStream_t>(stream);
  if (f32)
    return (int)launch_codes(static_cast<const float*>(h), pj, Q, d, L, K, qc,
                             st);
  return (int)launch_codes(static_cast<const __nv_bfloat16*>(h), pj, Q, d, L,
                           K, qc, st);
}

template <class T>
static cudaError_t dispatch(
    const void* w, const void* h, const void* proj, const void* cand_rows,
    const void* cand_live, const void* codes, const void* slot_of_row,
    const void* tail_ids, const void* tail_accept, const void* tail_bias,
    int Q, int C, int d, int L, int K, int NT, int k, int grid_x,
    void* qcodes, void* counts, void* part_hm, void* part_hs, void* part_v,
    void* part_i, void* part_tm, void* part_ts, void* head_lse,
    void* tail_lse, void* topv, void* topi, cudaStream_t st) {
  auto wb = static_cast<const T*>(w);
  auto hb = static_cast<const T*>(h);
  auto pj = static_cast<const float*>(proj);
  auto cr = static_cast<const int*>(cand_rows);
  auto cl = static_cast<const int*>(cand_live);
  auto cd = static_cast<const int*>(codes);
  auto sl = static_cast<const int*>(slot_of_row);
  auto ti = static_cast<const int*>(tail_ids);
  auto ac = static_cast<const bool*>(tail_accept);
  auto tb = static_cast<const float*>(tail_bias);
  auto qc = static_cast<int*>(qcodes);
  auto cn = static_cast<int*>(counts);
  auto phm = static_cast<float*>(part_hm);
  auto phs = static_cast<float*>(part_hs);
  auto pv = static_cast<float*>(part_v);
  auto pi = static_cast<int*>(part_i);
  auto ptm = static_cast<float*>(part_tm);
  auto pts = static_cast<float*>(part_ts);
  auto hl = static_cast<float*>(head_lse);
  auto tl = static_cast<float*>(tail_lse);
  auto tv = static_cast<float*>(topv);
  auto tix = static_cast<int*>(topi);
  if (k <= 8)
    return launch_probe<T, 8>(wb, hb, pj, cr, cl, cd, sl, ti, ac, tb, Q, C,
                              d, L, K, NT, k, grid_x, qc, cn, phm, phs, pv,
                              pi, ptm, pts, hl, tl, tv, tix, st);
  return launch_probe<T, 32>(wb, hb, pj, cr, cl, cd, sl, ti, ac, tb, Q, C, d,
                             L, K, NT, k, grid_x, qc, cn, phm, phs, pv, pi,
                             ptm, pts, hl, tl, tv, tix, st);
}

// f32: 1 if w and h are f32, 0 if bf16.
extern "C" int lsh_probe_launch(
    const void* w, const void* h, const void* proj, const void* cand_rows,
    const void* cand_live, const void* codes, const void* slot_of_row,
    const void* tail_ids, const void* tail_accept, const void* tail_bias,
    int Q, int C, int d, int L, int K, int NT, int k, int grid_x,
    void* qcodes, void* counts, void* part_hm, void* part_hs, void* part_v,
    void* part_i, void* part_tm, void* part_ts, void* head_lse,
    void* tail_lse, void* topv, void* topi, int f32, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (f32)
    return (int)dispatch<float>(
        w, h, proj, cand_rows, cand_live, codes, slot_of_row, tail_ids,
        tail_accept, tail_bias, Q, C, d, L, K, NT, k, grid_x, qcodes, counts,
        part_hm, part_hs, part_v, part_i, part_tm, part_ts, head_lse,
        tail_lse, topv, topi, st);
  return (int)dispatch<__nv_bfloat16>(
      w, h, proj, cand_rows, cand_live, codes, slot_of_row, tail_ids,
      tail_accept, tail_bias, Q, C, d, L, K, NT, k, grid_x, qcodes, counts,
      part_hm, part_hs, part_v, part_i, part_tm, part_ts, head_lse, tail_lse,
      topv, topi, st);
}
