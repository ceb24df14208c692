// A Hopper pipeline that scores rows gathered by id against an 8-query tile
// (union_scores.cu, ivf_score.cu, ivf_decode.cu, lsh_probe.cu, fmbe_z.cu).
//
// These kernels read rows by id (the blocks of a probe union and the tail
// rows of a MIMPS plan, the candidates and tail samples of an LSH probe, or
// the packed +-1 projection rows of an FMBE feature map) and dot each with
// a small tile of decode queries. They are bound by the bytes of those
// rows. The design keeps many bytes in flight and spends few
// instructions per byte:
//
// * Work split. A persistent grid (one CTA per SM; GS_CTAS) over the
//   query tiles. Each CTA reads the number of live rows from the device and
//   takes an equal, contiguous range of them (the Job's `rows`), so no CTA
//   runs a partial second round and the host never synchronises on the
//   plan. The split is a fixed function of the live count and the grid, and
//   every sum below runs in a fixed order, so two calls give the same bits.
// * Loads. Warp WARPS is the producer: its lane r issues one bulk
//   asynchronous copy (cp.async.bulk, completed on an mbarrier by its byte
//   count) of row r of each stage into a ring of stages in shared memory,
//   each stage with a "full" and an "empty" mbarrier. It loads the row ids
//   AHEAD stages before it issues their copies. A Job may copy a few words
//   beside each row (4-byte cp.async, tracked by the same mbarrier). Rows
//   are padded to an odd number of 16-byte units (16 or 32 bytes of zeros
//   past the row), so the 8 rows an ldmatrix reads hit distinct banks. The
//   queries come in the same way, once, on their own mbarrier. The ring
//   takes as many stages as shared memory holds, up to MAX_STAGES, of ROWS
//   rows, or of fewer where two stages of ROWS do not fit (wide rows): at
//   d 2560, 2 stages of 16 rows in bf16 (164 KB) and 2 of 4 in f32.
// * bf16. The consumer warps split the depth of each stage: each runs
//   mma.sync m16n8k16 (rows as A from ldmatrix, the 8 queries as B; N = 8
//   is the query tile) over its share of d, with f32 accumulators. f32
//   queries against bf16 rows (fmbe_z.cu) come as NP = 3 exact bf16 planes
//   in the query tile, each plane's sums taken alone and added, smallest
//   first. wgmma
//   does not fit: its smallest tile is 64 rows a warpgroup, and it needs its
//   shared operand in the core-matrix layout, which a row-contiguous bulk
//   copy does not give (TMA cannot gather rows by id). The query tile stays
//   bf16 in shared memory.
// * f32. The same split on the CUDA cores: each lane takes 16-byte pieces
//   of its warp's share of the stage's rows and the queries, and a
//   butterfly over the lanes leaves one (row, query) sum in each lane.
// * Reduction. Each warp writes its partial sums (row, query) to shared
//   memory; after a named barrier of the consumers the Job's `post` sums the
//   warps' partials in warp order. The partial buffers alternate between
//   stages, so one barrier a stage suffices.
//
// LaneFold (at the end) is the per-query online logsumexp and top-k that
// ivf_decode.cu and lsh_probe.cu fold their scores into; UnionJob the rows
// of a deduplicated block union that union_scores.cu and ivf_score.cu
// score.
//
// A Job supplies (see UnionJob at the end and lsh_probe.cu):
//   int rows()                     this CTA's share of the live rows (read
//                                  from the device), numbered from 0
//   Src src(int j)                 its row j's source (producer; loads its
//                                  id, read AHEAD stages later)
//   const T* ptr(const Src&)       its row in device memory
//   void side(const Src&, int j, uint32_t dst)   words copied beside row j
//   int side_bytes, extra_bytes    per-row side bytes (a multiple of 4);
//                                  the Job's own smem
//   uint8_t* own                   set by run to the Job's own smem
//   void start(...)                consumers, before the first stage
//   void pre(...)                  per stage, before the stage is released
//   void post(...)                 per stage, after the warps' partials meet
//   void finish(...)               consumers, after the last stage
#pragma once

#include <cstdio>

#include "hopper_gemm.cuh"
#include "streaming.cuh"

namespace gstream {

using bf16 = __nv_bfloat16;
using hgemm::bar_arrive;
using hgemm::bar_expect_tx;
using hgemm::bar_init;
using hgemm::bar_wait;
using hgemm::smem_u32;

constexpr int QT = 8;                  // queries a CTA scores
constexpr int AHEAD = 6;               // stages of row ids the producer holds
constexpr unsigned FULL = 0xffffffffu;

// Tile constants, chosen by tools/stream_tiles.py on an H100 (the -D
// overrides are for that tool's builds). ROWS rows make a stage; the ring
// holds as many stages as fit, at most MAX_STAGES; WARPS consumer warps.
#ifndef GS_ROWS_BF16
#define GS_ROWS_BF16 16
#endif
#ifndef GS_STAGES_BF16
#define GS_STAGES_BF16 8
#endif
#ifndef GS_WARPS_BF16
#define GS_WARPS_BF16 8
#endif
#ifndef GS_ROWS_F32
#define GS_ROWS_F32 4
#endif
#ifndef GS_STAGES_F32
#define GS_STAGES_F32 2                // a third stage fits and measured slower
#endif
#ifndef GS_WARPS_F32
#define GS_WARPS_F32 8
#endif
#ifndef GS_CTAS
#define GS_CTAS 1                      // CTAs per SM the grid is sized for
#endif
// Timing diagnostics for tools/stream_tiles.py: 1 = the copies alone (the
// consumers only wait and release), 2 = the math alone (nothing copied),
// 3 = the whole kernel, two CTAs printing their cycles by phase (Phases).
#ifndef GS_DIAG
#define GS_DIAG 0
#endif

template <class T>
struct Tile;
template <>
struct Tile<bf16> {
  static constexpr int ROWS = GS_ROWS_BF16;
  static constexpr int MAX_STAGES = GS_STAGES_BF16;
  static constexpr int WARPS = GS_WARPS_BF16;
  static_assert(ROWS >= 1 && ROWS <= 16, "one m16 tile a stage");
};
template <>
struct Tile<float> {
  static constexpr int ROWS = GS_ROWS_F32;
  static constexpr int MAX_STAGES = GS_STAGES_F32;
  static constexpr int WARPS = GS_WARPS_F32;
  static_assert(ROWS == 1 || ROWS == 2 || ROWS == 4,
                "ROWS x QT sums fold into one lane each");
};

template <class T>
constexpr int threads() {
  return (Tile<T>::WARPS + 1) * 32;
}

// Shared memory a CTA may take: all of it, or an equal share of the SM's
// 228 KB less the 1 KB the system keeps per CTA.
constexpr int SMEM_LIMIT = GS_CTAS == 1 ? 232448 : 233472 / GS_CTAS - 1024;

__host__ __device__ constexpr int align_up(int x, int a) {
  return (x + a - 1) / a * a;
}

// Byte offsets in dynamic shared memory, the same on the host and the
// device: the query tile (NP planes of QT rows), the partial sums (two
// buffers), the Job's own bytes, the mbarriers, then the ring of `nst`
// stages of `rows` rows (rows, then each row's side words). A stage holds
// ROWS rows, or fewer where two stages of ROWS do not fit (wide rows).
// nst == 0 means the tile and one stage of one row do not fit.
struct Layout {
  int row_bytes, pitch, rows, stage_bytes, nst;
  int red_off, job_off, bar_off, ring_off, total;
};

template <class T, int NP = 1>
__host__ __device__ inline Layout layout(int d, int side_bytes,
                                         int extra_bytes) {
  using Tl = Tile<T>;
  Layout m;
  m.row_bytes = d * (int)sizeof(T);
  m.pitch = m.row_bytes + (((m.row_bytes / 16) & 1) ? 32 : 16);
  m.red_off = NP * QT * m.pitch;
  m.job_off = m.red_off + 2 * Tl::WARPS * Tl::ROWS * QT * 4;
  m.bar_off = align_up(m.job_off + extra_bytes, 16);
  m.ring_off = align_up(m.bar_off + (2 * Tl::MAX_STAGES + 1) * 8, 128);
  m.rows = Tl::ROWS;
  while (m.rows > 1 && (SMEM_LIMIT - m.ring_off) <
                           2 * align_up(m.rows * (m.pitch + side_bytes), 16))
    --m.rows;
  m.stage_bytes = align_up(m.rows * (m.pitch + side_bytes), 16);
  const int fit = (SMEM_LIMIT - m.ring_off) / m.stage_bytes;
  m.nst = fit < 0 ? 0 : (fit < Tl::MAX_STAGES ? fit : Tl::MAX_STAGES);
  m.total = m.ring_off + m.nst * m.stage_bytes;
  return m;
}

// ---- copies -----------------------------------------------------------------

// `bytes` (a multiple of 16) from device memory at `src` (16-byte aligned)
// to shared memory at `dst`, completing `bar` by the byte count.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// One 4-byte word, asynchronously; `copies_arrive` hands the thread's
// outstanding words to an mbarrier.
__device__ __forceinline__ void copy_word(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

// The barrier's current phase cannot complete before this thread's
// earlier cp.async words have landed (the pending count is raised now and
// lowered when they land).
__device__ __forceinline__ void copies_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.shared.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Named barrier 1: the consumer warps only.
template <int WARPS>
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(WARPS * 32) : "memory");
}

// Zeros n 4-byte words at p: `idx` of `stride` threads, 16-byte stores
// between the unaligned ends.
__device__ __forceinline__ void zero_words(uint32_t* p, long long n,
                                           long long idx, long long stride) {
  long long head = (long long)((16 - ((uintptr_t)p & 15)) & 15) / 4;
  head = head < n ? head : n;
  const long long body = (n - head) / 4;
  for (long long i = idx; i < head; i += stride) p[i] = 0u;
  uint4* pb = reinterpret_cast<uint4*>(p + head);
  for (long long i = idx; i < body; i += stride)
    pb[i] = make_uint4(0u, 0u, 0u, 0u);
  for (long long i = head + 4 * body + idx; i < n; i += stride) p[i] = 0u;
}

// ---- partial scores ---------------------------------------------------------

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2(uint32_t addr, uint32_t& r0,
                                        uint32_t& r1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

// c (16 x 8, f32) += a (16 x 16, bf16, row) b (16 x 8, bf16, col)
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A (rows) and B (queries) fragments of one 16-deep step.
template <int ROWS>
__device__ __forceinline__ void load_step(uint32_t a_addr, uint32_t b_addr,
                                          uint32_t (&a)[4], uint32_t& b0,
                                          uint32_t& b1) {
  if constexpr (ROWS > 8) {
    ldsm_x4(a_addr, a);
  } else {                             // rows 8..15 of the m16 tile are 0
    ldsm_x2(a_addr, a[0], a[2]);
    a[1] = 0u;
    a[3] = 0u;
  }
  ldsm_x2(b_addr, b0, b1);
}

// This warp's partial sums over its share of d of the stage's `rows` rows
// (at `sp`; at most ROWS) against the queries (at `qp`), written to `red`
// [ROWS][QT]. bf16: ceil(d / 16) steps of 16 split evenly over the warps; a
// step past d reads the zero padding of rows and queries. With NP query
// planes (three exact bf16 planes of f32 queries, plane p at rows p * QT
// of the tile) each plane's sums are taken alone and added, last plane
// (the smallest) first.
template <int ROWS, int WARPS, int NP = 1>
__device__ __forceinline__ void partial(const bf16*, const uint8_t* sp,
                                        const uint8_t* qp, int pitch, int d,
                                        int rows, int warp, int lane,
                                        float* red) {
  const int n16 = (d + 15) / 16;
  const int k0 = warp * n16 / WARPS, k1 = (warp + 1) * n16 / WARPS;
  const uint32_t sa = smem_u32(sp), qa = smem_u32(qp);
  // lanes of rows past `rows` read the last row again (their sums are
  // unused)
  const int a_row = ROWS > 8 ? (lane & 7) + ((lane >> 3) & 1) * 8 : lane & 7;
  const uint32_t a_addr =
      sa + (a_row < rows ? a_row : rows - 1) * pitch +
      (ROWS > 8 ? (lane >> 4) : ((lane >> 3) & 1)) * 16;
  float c0[4];
#pragma unroll
  for (int p = NP - 1; p >= 0; --p) {
    const uint32_t b_addr =
        qa + (p * QT + (lane & 7)) * pitch + ((lane >> 3) & 1) * 16;
    float c[4][4] = {};
    uint32_t a[4][4], b[4][2];
    int k = k0;
#pragma unroll 1
    for (; k + 3 < k1; k += 4) {       // four chains of dependent mma
#pragma unroll
      for (int e = 0; e < 4; ++e)
        load_step<ROWS>(a_addr + (k + e) * 32, b_addr + (k + e) * 32, a[e],
                        b[e][0], b[e][1]);
#pragma unroll
      for (int e = 0; e < 4; ++e) mma16816(c[e], a[e], b[e][0], b[e][1]);
    }
#pragma unroll 1
    for (; k < k1; ++k) {
      load_step<ROWS>(a_addr + k * 32, b_addr + k * 32, a[0], b[0][0],
                      b[0][1]);
      mma16816(c[0], a[0], b[0][0], b[0][1]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float x = (c[0][i] + c[1][i]) + (c[2][i] + c[3][i]);
      c0[i] = p == NP - 1 ? x : c0[i] + x;
    }
  }
  const int g = lane >> 2, t = 2 * (lane & 3);
  if (g < rows) {
    red[g * QT + t] = c0[0];
    red[g * QT + t + 1] = c0[1];
  }
  if (ROWS > 8 && g + 8 < rows) {
    red[(g + 8) * QT + t] = c0[2];
    red[(g + 8) * QT + t + 1] = c0[3];
  }
}

// Butterfly over the lanes: N values a lane in, and lane l out with the
// lane sum of value l / (32 / N) in v[0].
template <int N, int O>
__device__ __forceinline__ void fold(float* v, int lane) {
  if constexpr (N > 1) {
    constexpr int H = N / 2;
    const bool up = (lane & O) != 0;
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const float send = up ? v[i] : v[i + H];
      const float keep = up ? v[i + H] : v[i];
      v[i] = keep + __shfl_xor_sync(FULL, send, O);
    }
  } else {
    v[0] += __shfl_xor_sync(FULL, v[0], O);
  }
  if constexpr (O > 1) fold<(N > 1 ? N / 2 : 1), O / 2>(v, lane);
}

// f32: the warps take 512-byte column groups of the stage in turn, each
// lane 16 bytes of every row and query; a butterfly over the lanes then
// leaves one (row, query) sum in each lane.
template <int ROWS, int WARPS, int NP = 1>
__device__ __forceinline__ void partial(const float*, const uint8_t* sp,
                                        const uint8_t* qp, int pitch, int d,
                                        int rows, int warp, int lane,
                                        float* red) {
  static_assert(NP == 1, "f32 queries are read as they are");
  constexpr int N = ROWS * QT;
  float v[N];
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = 0.f;
  const int nch = d / 4;
#pragma unroll 1
  for (int c = warp * 32 + lane; c < nch; c += WARPS * 32) {
    float4 x[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
      x[r] = *reinterpret_cast<const float4*>(
          sp + (r < rows ? r : rows - 1) * pitch + c * 16);
#pragma unroll
    for (int q = 0; q < QT; ++q) {
      const float4 y =
          *reinterpret_cast<const float4*>(qp + q * pitch + c * 16);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        float& a = v[r * QT + q];
        a = fmaf(x[r].x, y.x, a);
        a = fmaf(x[r].y, y.y, a);
        a = fmaf(x[r].z, y.z, a);
        a = fmaf(x[r].w, y.w, a);
      }
    }
  }
  fold<N, 16>(v, lane);
  constexpr int PER = 32 / N;
  if (lane % PER == 0) red[lane / PER] = v[0];
}

// ---- the pipeline -----------------------------------------------------------

// Where the consumers find a stage: its rows, side words and partials.
struct Stage {
  int buf;        // partial buffer of this stage (0 or 1)
  int j0, n;      // first row of the stage (of the CTA's) and rows in it
  const uint8_t* side;   // row r's side words at side + r * side_bytes
  const float* red;      // partials [WARPS][ROWS][QT]
};

// Sum over the warps' partials of (row r, query q), in warp order.
template <class T>
__device__ __forceinline__ float score(const Stage& st, int r, int q) {
  constexpr int ROWS = Tile<T>::ROWS;
  float x = st.red[r * QT + q];
#pragma unroll
  for (int w = 1; w < Tile<T>::WARPS; ++w)
    x += st.red[(w * ROWS + r) * QT + q];
  return x;
}

// GS_DIAG 3: a thread's cycles by phase; nothing otherwise. `mark(k)` adds
// the cycles since the last mark to phase k.
struct Phases {
  long long clk[6] = {0, 0, 0, 0, 0, 0};
  long long last = 0;
  uint64_t entry = 0;
  __device__ void begin() {
    if constexpr (GS_DIAG == 3) {
      entry = hgemm::global_ns();
      last = clock64();
    }
  }
  __device__ void mark(int k) {
    if constexpr (GS_DIAG == 3) {
      const long long now = clock64();
      clk[k] += now - last;
      last = now;
    }
  }
  // printed by thread 0 of two CTAs of the first query tile
  __device__ bool reports() const {
    return GS_DIAG == 3 && threadIdx.x % 32 == 0 && blockIdx.y == 0 &&
           (blockIdx.x == 0 || blockIdx.x == gridDim.x / 2);
  }
};

// `h` holds NP planes of (Q, d) queries, `plane` elements apart.
template <class T, class Job, int NP = 1>
__device__ __forceinline__ void run(Job& job, const T* __restrict__ h, int Q,
                                    int d, size_t plane = 0) {
  using Tl = Tile<T>;
  constexpr int ROWS = Tl::ROWS, WARPS = Tl::WARPS;
  extern __shared__ __align__(128) uint8_t smem[];
  Phases ph;
  ph.begin();
  const Layout m = layout<T, NP>(d, job.side_bytes, job.extra_bytes);
  job.own = smem + m.job_off;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + m.bar_off);
  uint64_t* empty = full + Tl::MAX_STAGES;
  uint64_t* qbar = empty + Tl::MAX_STAGES;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = blockIdx.y * QT;
  const int nq = Q - q0 < QT ? Q - q0 : QT;
  const int pad_words = (m.pitch - m.row_bytes) / 4;

  // zeros past every row of the ring and of the query tile, and in the
  // rows of absent queries
  const int R = m.rows;                // rows a stage
  for (int i = threadIdx.x; i < (m.nst * R + NP * QT) * pad_words;
       i += blockDim.x) {
    const int row = i / pad_words, w = i - row * pad_words;
    const int s = row / R, r = row - s * R;
    uint8_t* p = row < m.nst * R
                     ? smem + m.ring_off + s * m.stage_bytes + r * m.pitch
                     : smem + (row - m.nst * R) * m.pitch;
    reinterpret_cast<uint32_t*>(p + m.row_bytes)[w] = 0u;
  }
  for (int i = threadIdx.x; i < NP * (QT - nq) * (m.row_bytes / 4);
       i += blockDim.x) {
    const int a = i / (m.row_bytes / 4), pl = a / (QT - nq);
    reinterpret_cast<uint32_t*>(smem + (pl * QT + nq) * m.pitch)[
        (a - pl * (QT - nq)) * (m.pitch / 4) + i % (m.row_bytes / 4)] = 0u;
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < m.nst; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], WARPS);      // lane 0 of each consumer warp
    }
    bar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == WARPS) {                 // the queries, before the row count
    if (lane == 0) bar_expect_tx(qbar, NP * nq * m.row_bytes);
    __syncwarp();
    if (lane < NP * nq) {
      const int pl = lane / nq, q = lane - pl * nq;
      bulk_copy(smem_u32(smem + (pl * QT + q) * m.pitch),
                h + pl * plane + (size_t)(q0 + q) * d, m.row_bytes, qbar);
    }
  }
  const int cnt = job.rows();          // this CTA's rows, 0 .. cnt - 1
  const int n_st = (cnt + R - 1) / R;
  const uint32_t ring = smem_u32(smem + m.ring_off);

  if (warp == WARPS) {                 // the producer
    // row ids AHEAD stages ahead: the loop is unrolled AHEAD times, so
    // each id stays in its own register until its stage is issued
    typename Job::Src ids[AHEAD];
#pragma unroll
    for (int a = 0; a < AHEAD; ++a) {
      const int j = a * R + lane;
      if (lane < R && j < cnt) ids[a] = job.src(j);
    }
    for (int i0 = 0; i0 < n_st; i0 += AHEAD) {
#pragma unroll
      for (int a = 0; a < AHEAD; ++a) {
        const int i = i0 + a;
        if (i >= n_st) break;
        const int s = i % m.nst, j = i * R + lane;
        const int nr = cnt - i * R < R ? cnt - i * R : R;
        const typename Job::Src cur = ids[a];
        if (lane < R && j + AHEAD * R < cnt) ids[a] = job.src(j + AHEAD * R);
        ph.mark(0);
        if (i >= m.nst) bar_wait(&empty[s], ((i / m.nst) & 1) ^ 1);
        ph.mark(1);
        const uint32_t sa = ring + s * m.stage_bytes;
        if (GS_DIAG == 2) {
          if (lane == 0) bar_arrive(&full[s]);
          continue;
        }
        if (job.side_bytes > 0 && lane < nr) {
          job.side(cur, j, sa + R * m.pitch + lane * job.side_bytes);
          copies_arrive(&full[s]);
        }
        __syncwarp();
        if (lane == 0) bar_expect_tx(&full[s], nr * m.row_bytes);
        __syncwarp();
        if (lane < nr)
          bulk_copy(sa + lane * m.pitch, job.ptr(cur), m.row_bytes, &full[s]);
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    ph.mark(0);
    if (ph.reports() && lane == 0)
      printf("gather_stream CTA %d producer: %lld cycles, %lld waiting for "
             "a free stage\n", blockIdx.x, ph.clk[0] + ph.clk[1],
             ph.clk[1]);
    return;
  }

  // the consumers
  ph.mark(5);                          // the set-up is not a phase
  ph.clk[5] = 0;
  job.start(threadIdx.x, q0, nq);
  consumers_sync<WARPS>();
  bar_wait(qbar, 0);
  ph.mark(0);
  float* red0 = reinterpret_cast<float*>(smem + m.red_off);
  for (int i = 0; i < n_st; ++i) {
    const int s = i % m.nst;
    Stage st;
    st.buf = i & 1;
    st.j0 = i * R;
    st.n = cnt - st.j0 < R ? cnt - st.j0 : R;
    st.side = smem + m.ring_off + s * m.stage_bytes + R * m.pitch;
    float* red = red0 + st.buf * WARPS * ROWS * QT;
    st.red = red;
    bar_wait(&full[s], (i / m.nst) & 1);
    ph.mark(1);
    if (GS_DIAG != 1) {
      partial<ROWS, WARPS, NP>(h, smem + m.ring_off + s * m.stage_bytes, smem,
                           m.pitch, d, R, warp, lane, red + warp * ROWS * QT);
      ph.mark(2);
      job.pre(st, threadIdx.x, q0, nq);
    }
    __syncwarp();
    if (lane == 0) bar_arrive(&empty[s]);
    ph.mark(3);
    consumers_sync<WARPS>();
    ph.mark(4);
    if (GS_DIAG != 1) job.post(st, threadIdx.x, q0, nq);
    ph.mark(5);
  }
  job.finish(threadIdx.x, q0, nq);
  if (ph.reports() && threadIdx.x == 0)
    printf("gather_stream CTA %d: %d rows, %d stages of %d; cycles: start "
           "%lld, wait %lld, partial %lld, pre %lld, sync %lld, post %lld, "
           "total %lld; %lld ns from entry\n", blockIdx.x, cnt, n_st, R,
           ph.clk[0], ph.clk[1], ph.clk[2], ph.clk[3], ph.clk[4], ph.clk[5],
           ph.clk[0] + ph.clk[1] + ph.clk[2] + ph.clk[3] + ph.clk[4] +
               ph.clk[5],
           (long long)(hgemm::global_ns() - ph.entry));
}

// ---- per-lane online logsumexp and top-k (lsh_probe.cu, ivf_decode.cu) ----

// A Job whose consumer warp folds query q = warp + CW u of the tile, one
// lane a row of the stage: each lane adds its row to its own (m, s) of the
// head and of the tail, and the rows that beat the k-th best of lane u's
// top-k (every lane keeps a copy of that entry) go to lane u in row order,
// by ballot. At the end the lanes' (m, s) fold in a fixed tree and lane u
// writes query q's partial for merge_partials (streaming.cuh). Every sum
// runs in an order fixed by the rows' order, so two calls are bit-equal.
template <class T, int KMAX>
struct LaneFold {
  static constexpr int CW = Tile<T>::WARPS;
  static constexpr int UQ = (QT + CW - 1) / CW;   // queries a warp folds
  float hm[UQ], hs[UQ], tm[UQ], ts[UQ];
  streaming::TopK<KMAX> top;
  float kv[UQ];                        // lane u's k-th best, in every lane
  int ki[UQ];

  __device__ void init() {
#pragma unroll
    for (int u = 0; u < UQ; ++u) {
      hm[u] = streaming::NEG;
      hs[u] = 0.f;
      tm[u] = streaming::NEG;
      ts[u] = 0.f;
      kv[u] = streaming::NEG;          // TopK's filler
      ki[u] = 0;
    }
    top.init();
  }

  // (m, s) += x with one exp: exp(-|x - m|) scales whichever side is lower
  static __device__ void add(float& m, float& s, float x) {
    const float e = expf(-fabsf(x - m));
    s = x > m ? s * e + 1.f : s + e;
    m = fmaxf(m, x);
  }

  // (m, s) += (m2, s2), either possibly empty (s == 0)
  static __device__ void merge(float& m, float& s, float m2, float s2) {
    if (s2 <= 0.f) return;
    const float mn = fmaxf(m, m2);
    s = s * expf(m - mn) + s2 * expf(m2 - mn);
    m = mn;
  }

  // this lane's row for query slot u: counted if `in`, into the tail if
  // `tail` (value x) or else into the head and its top-k (value x, id)
  __device__ void row(int u, int lane, bool in, bool tail, float x, int id) {
    if (in && tail) add(tm[u], ts[u], x);
    if (in && !tail) add(hm[u], hs[u], x);
    unsigned enter = __ballot_sync(
        FULL, in && !tail && streaming::better(x, id, kv[u], ki[u]));
    if (enter == 0u) return;
    do {
      const int r = __ffs(enter) - 1;
      enter &= enter - 1;
      const float rx = __shfl_sync(FULL, x, r);
      const int rid = __shfl_sync(FULL, id, r);
      if (lane == u) top.insert(rx, rid);
    } while (enter);
    kv[u] = __shfl_sync(FULL, top.v[KMAX - 1], u);
    ki[u] = __shfl_sync(FULL, top.i[KMAX - 1], u);
  }

  // the lanes' (m, s) folded in a fixed tree; lane u writes query q's
  // partial (index (query, CTA); top-k (query, CTA, k))
  __device__ void finish(int t, int q0, int nq, int k, float* part_hm,
                         float* part_hs, float* part_tm, float* part_ts,
                         float* part_v, int* part_i) {
    const int warp = t / 32, lane = t % 32;
#pragma unroll
    for (int u = 0; u < UQ; ++u) {
      const int q = warp + CW * u;
      if (q >= nq) break;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float m2 = __shfl_xor_sync(FULL, hm[u], o);
        const float s2 = __shfl_xor_sync(FULL, hs[u], o);
        const float n2 = __shfl_xor_sync(FULL, tm[u], o);
        const float t2 = __shfl_xor_sync(FULL, ts[u], o);
        merge(hm[u], hs[u], m2, s2);
        merge(tm[u], ts[u], n2, t2);
      }
      if (lane != u) continue;
      const size_t idx = (size_t)(q0 + q) * gridDim.x + blockIdx.x;
      part_hm[idx] = hm[u];
      part_hs[idx] = hs[u];
      part_tm[idx] = tm[u];
      part_ts[idx] = ts[u];
      streaming::write_topk(top, k, part_v, part_i, idx * k);
    }
  }
};

// ---- the rows of a deduplicated block union (union_scores.cu, ivf_score.cu)

// A Job over the live slots of a sorted block union: each CTA takes an
// equal, contiguous share of the live slots' live x br rows and copies
// them, block id by block id. `Out` writes the scores: its start(job, t,
// q0, nq) runs before the first stage, its post(job, st, t, q0, nq) after
// each stage's partials meet. With Out::PER_TILE each query tile has a
// union of its own (tile y's U slots at head_ids + y * U, its live count
// at head_live[y]), written by the kernel this one is a programmatic
// dependent of, so rows() waits for that kernel first; otherwise every
// tile reads the one union.
template <class T, class Out>
struct UnionJob {
  using Elem = T;
  const T* wb;
  const int* head_ids;
  const int* head_live;
  int U, br, d;
  Out out;
  int side_bytes = 0, extra_bytes = 0;
  uint8_t* own = nullptr;              // unused: no shared memory of its own
  const int* ids = nullptr;            // this tile's union
  int live = 0, lo = 0;                // live slots; the CTA's first row

  struct Src {
    int id, row;                       // block id and row in the block
  };

  // rows [lo, hi) of the live slots' live x br
  __device__ int rows() {
    int tile = 0;
    if constexpr (Out::PER_TILE) {
      asm volatile("griddepcontrol.wait;\n" ::: "memory");
      tile = blockIdx.y;
    }
    ids = head_ids + (size_t)tile * U;
    const int n = head_live[tile];
    live = n < 0 ? 0 : (n < U ? n : U);
    const long long all = (long long)live * br;
    lo = (int)(all * blockIdx.x / gridDim.x);
    return (int)(all * (blockIdx.x + 1) / gridDim.x) - lo;
  }
  __device__ Src src(int i) const {
    const int j = lo + i, slot = j / br;
    return {ids[slot], j - slot * br};
  }
  __device__ const T* ptr(const Src& s) const {
    return wb + ((size_t)s.id * br + s.row) * d;
  }
  __device__ void side(const Src&, int, uint32_t) const {}
  __device__ void start(int t, int q0, int nq) const {
    out.start(*this, t, q0, nq);
  }
  __device__ void pre(const Stage&, int, int, int) const {}
  __device__ void post(const Stage& st, int t, int q0, int nq) const {
    out.post(*this, st, t, q0, nq);
  }
  __device__ void finish(int, int, int) const {}
};

}  // namespace gstream
