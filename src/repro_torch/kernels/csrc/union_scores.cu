// Scores of a deduplicated block union for a whole decode batch.
//
// Replaces the TPU kernel src/repro/kernels/ivf_score.py::union_scores
// (_union_kernel): for a query batch h (Q, d) and a sorted union table
// head_ids (U_cap,) of which the first head_live slots are real, write
// out[q, s, r] = h[q] . w_blocks[head_ids[s], r] in f32 for live slots and
// exactly 0 for pad slots (s >= head_live). It is the head of the MINCE,
// FMBE and top-k decodes, which mask the scores themselves.
//
// Bound on this card: bytes. The kernel reads head_live blocks of br x d
// rows once and writes the (Q, U_cap, br) f32 output (qwen1.5-4b in bf16 at
// Q = 8: about 23 blocks of 512 x 2560 plus a 2 MB output, about 62 MB,
// about 19 us at 3.35 TB/s; about twice that in f32) and does 2*Q flops per
// element read. Rows and queries are both bf16 or both f32.
//
// Design: the gathered-row pipeline of gather_stream.cuh, as its UnionJob
// (which ivf_score.cu runs too). The TPU grid walked the union slots in
// order for one query tile with scalar-prefetched block ids; here the live
// rows (head_live x br, read from the device) are split into equal
// contiguous ranges over a persistent grid, and each CTA's producer warp
// copies its rows, block id by block id, into the ring.
// Pad slots load nothing: every consumer thread of every CTA writes their
// zeros with 16-byte stores first, so the output needs no separate fill.
// There is no reduction across CTAs: every output element is written by
// exactly one thread.
#include "gather_stream.cuh"

using namespace gstream;

// union_scores' epilogue: out[q, s, r] for the live slots, zeros at the
// pad slots
struct SlotScores {
  static constexpr bool PER_TILE = false;    // one union for every tile
  float* out;

  // pad slots [live, U) of each query: zeros over every CTA
  template <class Job>
  __device__ void start(const Job& j, int t, int q0, int nq) const {
    constexpr int CT = Tile<typename Job::Elem>::WARPS * 32;
    const long long idx = (long long)blockIdx.x * CT + t;
    const long long stride = (long long)gridDim.x * CT;
    for (int q = 0; q < nq; ++q)
      zero_words(reinterpret_cast<uint32_t*>(
                     out + ((size_t)(q0 + q) * j.U + j.live) * j.br),
                 (long long)(j.U - j.live) * j.br, idx, stride);
  }
  // one (query, row) score a thread, rows of a query on adjacent threads
  template <class Job>
  __device__ void post(const Job& j, const Stage& st, int t, int q0,
                       int nq) const {
    using T = typename Job::Elem;
    constexpr int ROWS = Tile<T>::ROWS;
    for (int p = t; p < ROWS * QT; p += Tile<T>::WARPS * 32) {
      const int r = p % ROWS, q = p / ROWS;
      if (r >= st.n || q >= nq) continue;
      const int jr = j.lo + st.j0 + r, slot = jr / j.br;
      out[((size_t)(q0 + q) * j.U + slot) * j.br + (jr - slot * j.br)] =
          score<T>(st, r, q);
    }
  }
};

template <class T>
__global__ void __launch_bounds__((Tile<T>::WARPS + 1) * 32, GS_CTAS)
union_scores_kernel(UnionJob<T, SlotScores> job, const T* __restrict__ h,
                    int Q) {
  run<T>(job, h, Q, job.d);
}

template <class T>
static cudaError_t launch(const void* w_blocks, const void* h,
                          const void* head_ids, const void* head_live, int Q,
                          int U, int br, int d, int grid_x, void* out,
                          cudaStream_t stream) {
  UnionJob<T, SlotScores> job{static_cast<const T*>(w_blocks),
                              static_cast<const int*>(head_ids),
                              static_cast<const int*>(head_live), U, br, d,
                              SlotScores{static_cast<float*>(out)}};
  const Layout m = layout<T>(d, job.side_bytes, job.extra_bytes);
  if (m.nst < 1) return cudaErrorInvalidValue;    // d too wide for the ring
  cudaError_t err = cudaFuncSetAttribute(
      union_scores_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      m.total);
  if (err != cudaSuccess) return err;
  dim3 grid(grid_x, (Q + QT - 1) / QT);
  union_scores_kernel<T><<<grid, threads<T>(), m.total, stream>>>(
      job, static_cast<const T*>(h), Q);
  return cudaGetLastError();
}

// f32: 1 if the rows and queries are f32, 0 if bf16.
extern "C" int union_scores_launch(const void* w_blocks, const void* h,
                                   const void* head_ids,
                                   const void* head_live, int Q, int U,
                                   int br, int d, int grid_x, void* out,
                                   int f32, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (f32)
    return (int)launch<float>(w_blocks, h, head_ids, head_live, Q, U, br, d,
                              grid_x, out, st);
  return (int)launch<bf16>(w_blocks, h, head_ids, head_live, Q, U, br, d,
                           grid_x, out, st);
}

// The ring geometry `layout` picks for these rows at width d (ivf_score's
// UnionJob takes the same): out = {rows a stage, stages, row pitch in
// bytes, dynamic shared memory in bytes}. Nothing is launched.
extern "C" int union_scores_geometry(int d, int f32, int* out) {
  const Layout m = f32 ? layout<float>(d, 0, 0) : layout<bf16>(d, 0, 0);
  out[0] = m.rows;
  out[1] = m.nst;
  out[2] = m.pitch;
  out[3] = m.total;
  return 0;
}
