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
// Design: the gathered-row pipeline of gather_stream.cuh. The TPU grid
// walked the union slots in order for one query tile with scalar-prefetched
// block ids; here the live rows (head_live x br, read from the device) are
// split into equal contiguous ranges over a persistent grid, and each
// CTA's producer warp copies its rows, block id by block id, into the ring.
// Pad slots load nothing: every consumer thread of every CTA writes their
// zeros with 16-byte stores first, so the output needs no separate fill.
// There is no reduction across CTAs: every output element is written by
// exactly one thread.
#include "gather_stream.cuh"

using namespace gstream;

template <class T>
struct UnionJob {
  const T* wb;
  const int* head_ids;
  const int* head_live;
  int U, br, d;
  float* out;
  int side_bytes = 0, extra_bytes = 0;
  uint8_t* own = nullptr;              // unused: no shared memory of its own
  int live = 0, lo = 0;                // live slots; the CTA's first row

  struct Src {
    int id, row;                       // block id and row in the block
  };

  // rows [lo, hi) of the live slots' head_live x br
  __device__ int rows() {
    const int n = *head_live;
    live = n < 0 ? 0 : (n < U ? n : U);
    const long long all = (long long)live * br;
    lo = (int)(all * blockIdx.x / gridDim.x);
    return (int)(all * (blockIdx.x + 1) / gridDim.x) - lo;
  }
  __device__ Src src(int i) const {
    const int j = lo + i, slot = j / br;
    return {head_ids[slot], j - slot * br};
  }
  __device__ const T* ptr(const Src& s) const {
    return wb + ((size_t)s.id * br + s.row) * d;
  }
  __device__ void side(const Src&, int, uint32_t) const {}

  // pad slots [live, U) of each query: zeros over every CTA
  __device__ void start(int t, int q0, int nq) const {
    constexpr int CT = Tile<T>::WARPS * 32;
    const long long idx = (long long)blockIdx.x * CT + t;
    const long long stride = (long long)gridDim.x * CT;
    for (int q = 0; q < nq; ++q)
      zero_words(reinterpret_cast<uint32_t*>(
                     out + ((size_t)(q0 + q) * U + live) * br),
                 (long long)(U - live) * br, idx, stride);
  }
  __device__ void pre(const Stage&, int, int, int) const {}
  // one (query, row) score a thread, rows of a query on adjacent threads
  __device__ void post(const Stage& st, int t, int q0, int nq) const {
    constexpr int ROWS = Tile<T>::ROWS;
    for (int p = t; p < ROWS * QT; p += Tile<T>::WARPS * 32) {
      const int r = p % ROWS, q = p / ROWS;
      if (r >= st.n || q >= nq) continue;
      const int j = lo + st.j0 + r, slot = j / br;
      out[((size_t)(q0 + q) * U + slot) * br + (j - slot * br)] =
          score<T>(st, r, q);
    }
  }
  __device__ void finish(int, int, int) const {}
};

template <class T>
__global__ void __launch_bounds__((Tile<T>::WARPS + 1) * 32, GS_CTAS)
union_scores_kernel(UnionJob<T> job, const T* __restrict__ h, int Q) {
  run<T>(job, h, Q, job.d);
}

template <class T>
static cudaError_t launch(const void* w_blocks, const void* h,
                          const void* head_ids, const void* head_live, int Q,
                          int U, int br, int d, int grid_x, void* out,
                          cudaStream_t stream) {
  UnionJob<T> job{static_cast<const T*>(w_blocks),
                  static_cast<const int*>(head_ids),
                  static_cast<const int*>(head_live), U, br, d,
                  static_cast<float*>(out)};
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
