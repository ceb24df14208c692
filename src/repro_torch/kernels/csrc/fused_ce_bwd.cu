// Streaming softmax cross-entropy, backward: dh (T, d) and dW (V, d) of
// g_nll . nll + g_lse . lse, recomputing the scores instead of reading
// (T, V) logits.
//
// Replaces the TPU kernel src/repro/kernels/fused_ce.py::fused_ce_bwd
// (_bwd_kernel): one sequential (token tile, vocab tile) grid whose score
// tile feeds both dh (accumulated in VMEM) and dW (through an aliased HBM
// buffer).
//
// With p = exp(s - lse) and coef = (g_nll + g_lse) p - g_nll onehot(label):
//   dh = coef W,   dW = coef^T h.
// coef is rounded to bf16 before both products, as the TPU kernel does; the
// products accumulate in f32.
//
// Bound on this card: operations. Three products of 2*T*V*d each (qwen1.5-4b
// at T = 1024: 2.4e12, about 2.4 ms at the bf16 tensor-core rate).
//
// Design: the scores are computed once per (token, vocab) pair. The
// vocabulary is walked in chunks of C columns (the wrapper's schedule: C is
// the largest multiple of 128 with T x C x 2 bytes <= 32 MB, 16384 at
// T = 1024), and for each chunk, in order:
//  (a) ce_coef: S = h W[chunk]^T on the Hopper mainloop (hopper_gemm.cuh,
//      both operands K-major); the epilogue turns the accumulator registers
//      into coef, rounds it to bf16 and writes it to a (T, C) scratch buffer
//      (zeros past V), which stays in L2 for (b) and (c).
//  (b)+(c) ce_grad, one persistent launch over two kinds of 128 x 128 items:
//      dh items, dh += coef W[chunk] (A = scratch K-major, B = W MN-major,
//      K = C), accumulated in f32 over the chunks in chunk order into one
//      (T, d) buffer (the f32 output with cast = 0); the last chunk's items
//      write dh in bf16 with cast; and dW items, dW[chunk] = coef^T h (both
//      operands MN-major, K = T), whose rows are complete and written once,
//      in bf16 (cast) or f32. The items differ in length (a dh item has C of
//      depth, a dW item T: 256 and 16 stages at T = 1024), and the 160 dh
//      items of T = 1024 do not fill 132 SMs evenly alone, so the wrapper
//      deals them to the CTAs longest first, each to the least loaded CTA,
//      and passes each CTA's list.
// Every output element has one owner and a fixed order of sums, with no
// float atomics, so two calls are bit-equal.
// Resources (hopper_gemm.cuh): 128 x 128 tiles, 6 stages of 32 KB (about
// 193 KB of shared memory, one CTA of 384 threads per SM), 232 registers a
// consumer thread. Memory beside the outputs: the scratch, T x C x 2 bytes
// (32 MB at T = 1024), and with cast a T x d x 4 byte f32 dh (10.5 MB at
// T = 1024), never O(T V).
#include <algorithm>

#include "hopper_gemm.cuh"

using namespace hgemm;

namespace {

struct Chunk {
  int T, V, d;
  int C;             // scratch columns (row stride)
  int c0;            // first vocab row of the chunk
  int valid;         // vocab rows in the chunk, <= C
  int n_tt;          // token tiles
};

// ---- (a) the coefficient --------------------------------------------------

struct CoefArgs {
  Chunk ch;
  const int* labels;
  const float* lse;
  const float* gn;   // g_nll + g_lse
  const float* go;   // g_nll
  bf16* coef;        // (T, C)
};

struct TileItem {
  int nk;
  int m0, n0;
};

struct NoState {};

struct CoefJob {
  const CUtensorMap* mh;
  const CUtensorMap* mw;
  CoefArgs a;
  int n_items;
  using State = NoState;

  __device__ int begin() const { return blockIdx.x; }
  __device__ bool valid(int p) const { return p < n_items; }
  __device__ void advance(int& p) const { p += gridDim.x; }
  __device__ TileItem item(int p) const {
    return {(a.ch.d + BK - 1) / BK, (p % a.ch.n_tt) * BM, (p / a.ch.n_tt) * BN};
  }
  __device__ void load(const TileItem& it, int k, uint32_t sa, uint32_t sb,
                       uint64_t* bar) const {
    load_slice(mh, false, sa, bar, it.m0, k * BK);
    load_slice(mw, false, sb, bar, a.ch.c0 + it.n0, k * BK);
  }
  __device__ void mma(const TileItem&, float (&acc)[2][64], uint32_t sa,
                      uint32_t sb) const {
    mma_stage<false, false>(acc, sa, sb);
  }
  __device__ void init(NoState&) const {}
  __device__ void after(const TileItem&, NoState&, int) const {}
  __device__ void epilogue(const TileItem& it, float (&acc)[2][64],
                           NoState&) const {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = it.m0 + acc_row(h, e);
        if (row >= a.ch.T) continue;
        const float l = a.lse[row] * LOG2E, g = a.gn[row], o = a.go[row];
        const int lab = a.labels[row] - a.ch.c0;   // column in the chunk
        bf16* out = a.coef + (size_t)row * a.ch.C;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int col = it.n0 + acc_col(j);
          float v[2];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float x = acc[h][4 * j + 2 * e + c];
            v[c] = col + c < a.ch.valid
                       ? g * fast_exp2(fmaf(x, LOG2E, -l)) -
                             (col + c == lab ? o : 0.f)
                       : 0.f;
          }
          *reinterpret_cast<__nv_bfloat162*>(out + col) =
              __floats2bfloat162_rn(v[0], v[1]);
        }
      }
  }
};

__global__ void __launch_bounds__(THREADS, 1)
ce_coef(const __grid_constant__ CUtensorMap mh,
        const __grid_constant__ CUtensorMap mw, CoefArgs a, int n_items) {
  run(CoefJob{&mh, &mw, a, n_items});
}

// ---- (b) dW and (c) dh ----------------------------------------------------

struct GradArgs {
  Chunk ch;
  int n_dt;          // 128-column tiles of d
  int first;         // first chunk: dh32 is written, not added to
  int last;          // last chunk: with cast, dh goes out in bf16
  int cast;          // 1: dh (last chunk) and dW in bf16, 0: f32
  float* dh32;       // (T, d) f32 sum over the chunks so far
  bf16* dh;          // (T, d) bf16 output with cast
  void* dw;          // (V, d)
};

struct GradItem {
  int nk;
  int m0, n0;
  bool dh;           // a dh item, else a dW item
};

struct GradJob {
  const CUtensorMap* mc_k;   // coef (T, C), K-major boxes
  const CUtensorMap* mc_mn;  // coef (T, C), MN-major boxes
  const CUtensorMap* mw_mn;  // W (V, d), MN-major boxes
  const CUtensorMap* mh_mn;  // h (T, d), MN-major boxes
  GradArgs a;
  int n_dh;                  // item ids: dh items, then dW items
  const int* order;          // item ids, CTA by CTA
  const int* start;          // CTA b takes order[start[b] .. start[b + 1])
  using State = NoState;

  __device__ int begin() const { return start[blockIdx.x]; }
  __device__ bool valid(int i) const { return i < start[blockIdx.x + 1]; }
  __device__ void advance(int& i) const { ++i; }
  __device__ GradItem item(int i) const {
    const int p = order[i];
    GradItem it;
    it.dh = p < n_dh;
    if (it.dh) {
      it.m0 = (p % a.ch.n_tt) * BM;
      it.n0 = (p / a.ch.n_tt) * BN;
      it.nk = (a.ch.valid + BK - 1) / BK;
    } else {
      const int q = p - n_dh;
      it.n0 = (q % a.n_dt) * BN;
      it.m0 = (q / a.n_dt) * BM;
      it.nk = (a.ch.T + BK - 1) / BK;
    }
    return it;
  }
  __device__ void load(const GradItem& it, int k, uint32_t sa, uint32_t sb,
                       uint64_t* bar) const {
    if (it.dh) {
      load_slice(mc_k, false, sa, bar, it.m0, k * BK);
      load_slice(mw_mn, true, sb, bar, it.n0, a.ch.c0 + k * BK);
    } else {
      load_slice(mc_mn, true, sa, bar, it.m0, k * BK);
      load_slice(mh_mn, true, sb, bar, it.n0, k * BK);
    }
  }
  __device__ void mma(const GradItem& it, float (&acc)[2][64], uint32_t sa,
                      uint32_t sb) const {
    if (it.dh)
      mma_stage<false, true>(acc, sa, sb);
    else
      mma_stage<true, true>(acc, sa, sb);
  }
  __device__ void init(NoState&) const {}
  __device__ void after(const GradItem&, NoState&, int) const {}
  __device__ void epilogue(const GradItem& it, float (&acc)[2][64],
                           NoState&) const {
    const int d = a.ch.d;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = it.m0 + acc_row(h, e);
        if (it.dh) {
          if (r >= a.ch.T) continue;
          float2* sum = reinterpret_cast<float2*>(a.dh32 + (size_t)r * d);
          // all of the row's earlier sums are loaded before any store, so
          // the loads are in flight together
          float2 old[16];
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const int col = it.n0 + acc_col(j);
            old[j] = !a.first && col < d ? sum[col / 2] : make_float2(0.f, 0.f);
          }
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const int col = it.n0 + acc_col(j);
            if (col >= d) continue;
            const float x = acc[h][4 * j + 2 * e] + old[j].x;
            const float y = acc[h][4 * j + 2 * e + 1] + old[j].y;
            if (a.last && a.cast)
              *reinterpret_cast<__nv_bfloat162*>(a.dh + (size_t)r * d + col) =
                  __floats2bfloat162_rn(x, y);
            else
              sum[col / 2] = make_float2(x, y);
          }
        } else {
          if (r >= a.ch.valid) continue;
          const size_t off = (size_t)(a.ch.c0 + r) * d;
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const int col = it.n0 + acc_col(j);
            if (col >= d) continue;
            const float x = acc[h][4 * j + 2 * e];
            const float y = acc[h][4 * j + 2 * e + 1];
            if (a.cast)
              *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(a.dw) +
                                                 off + col) =
                  __floats2bfloat162_rn(x, y);
            else
              *reinterpret_cast<float2*>(static_cast<float*>(a.dw) + off +
                                         col) = make_float2(x, y);
          }
        }
      }
  }
};

__global__ void __launch_bounds__(THREADS, 1)
ce_grad(const __grid_constant__ CUtensorMap mc_k,
        const __grid_constant__ CUtensorMap mc_mn,
        const __grid_constant__ CUtensorMap mw_mn,
        const __grid_constant__ CUtensorMap mh_mn, GradArgs a, int n_dh,
        const int* order, const int* start) {
  run(GradJob{&mc_k, &mc_mn, &mw_mn, &mh_mn, a, n_dh, order, start});
}

}  // namespace

// Schedule from the wrapper (fused_ce.py::bwd_schedule): chunk columns C,
// grid CTAs for ce_coef; ce_grad's item lists (fused_ce.py::grad_order) for
// a full chunk and for the last chunk, each over its own grid of CTAs.
// scratch: (T, C) bf16; dh32: (T, d) f32, the dh output itself with
// cast = 0; dh: (T, d) bf16 with cast != 0 (unused otherwise); dw: (V, d),
// bf16 with cast != 0, else f32.
extern "C" int fused_ce_bwd_launch(const void* h, const void* w,
                                   const void* labels, const void* lse,
                                   const void* gn, const void* go, int T,
                                   int V, int d, int C, int grid, int cast,
                                   const void* order_full,
                                   const void* start_full, int grid_full,
                                   const void* order_last,
                                   const void* start_last, int grid_last,
                                   void* scratch, void* dh32, void* dh,
                                   void* dw, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  CUtensorMap mh_k, mw_k, mc_k, mc_mn, mw_mn, mh_mn;
  if (make_map(&mh_k, h, d, T, false) || make_map(&mw_k, w, d, V, false) ||
      make_map(&mc_k, scratch, C, T, false) ||
      make_map(&mc_mn, scratch, C, T, true) ||
      make_map(&mw_mn, w, d, V, true) || make_map(&mh_mn, h, d, T, true))
    return ERR_TENSOR_MAP;
  cudaError_t err = cudaFuncSetAttribute(
      ce_coef, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      ce_grad, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const int n_tt = (T + BM - 1) / BM;
  const int n_dt = (d + BN - 1) / BN;
  for (int c0 = 0; c0 < V; c0 += C) {
    Chunk ch;
    ch.T = T;
    ch.V = V;
    ch.d = d;
    ch.C = C;
    ch.c0 = c0;
    ch.valid = std::min(C, V - c0);
    ch.n_tt = n_tt;
    CoefArgs ca;
    ca.ch = ch;
    ca.labels = static_cast<const int*>(labels);
    ca.lse = static_cast<const float*>(lse);
    ca.gn = static_cast<const float*>(gn);
    ca.go = static_cast<const float*>(go);
    ca.coef = static_cast<bf16*>(scratch);
    const int n_coef = n_tt * ((ch.valid + BN - 1) / BN);
    ce_coef<<<std::min(grid, n_coef), THREADS, SMEM_BYTES, st>>>(mh_k, mw_k, ca,
                                                           n_coef);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    GradArgs ga;
    ga.ch = ch;
    ga.n_dt = n_dt;
    ga.first = c0 == 0;
    ga.last = c0 + C >= V;
    ga.cast = cast;
    ga.dh32 = static_cast<float*>(dh32);
    ga.dh = static_cast<bf16*>(dh);
    ga.dw = dw;
    ce_grad<<<ga.last ? grid_last : grid_full, THREADS, SMEM_BYTES, st>>>(
        mc_k, mc_mn, mw_mn, mh_mn, ga, n_tt * n_dt,
        static_cast<const int*>(ga.last ? order_last : order_full),
        static_cast<const int*>(ga.last ? start_last : start_full));
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
