// Streaming softmax cross-entropy, backward: dh (T, d) and dW (V, d) of
// g_nll . nll + g_lse . lse, recomputing the scores instead of reading
// (T, V) logits, for bf16 and for f32 h and W.
//
// Replaces the TPU kernel src/repro/kernels/fused_ce.py::fused_ce_bwd
// (_bwd_kernel): one sequential (token tile, vocab tile) grid whose score
// tile feeds both dh (accumulated in VMEM) and dW (through an aliased HBM
// buffer).
//
// With p = exp(s - lse) and coef = (g_nll + g_lse) p - g_nll onehot(label):
//   dh = coef W,   dW = coef^T h.
// bf16 (P = 1 plane): coef is rounded to bf16 before both products, as the
// TPU kernel does; the products accumulate in f32.
// f32 (P = 3 planes): each f32 operand is split exactly into three bf16
// planes and each product sums six plane pairs, smallest first
// (ce_planes.cuh): an f32-accurate product on the bf16 tensor cores, coef
// not rounded, as the f32 reference computes it. (TF32 wgmma would read
// both operands K-major only, and dh reads W, dW coef and h MN-major; bf16
// wgmma reads them in place.) The tensor cores' f32 sums lose low bits at
// each 16-deep step with a bias that grows with the depth of one sum, so
// at f32 no sum is more than 8192 deep (fused_ce.py::F32_MAX_DEPTH): a
// chunk has at most 8192 columns (dh's depth), and the wrapper launches
// the kernels once for each slice of at most 8192 tokens (dW's depth),
// each slice adding its dW to the earlier slices' in f32 (dw_add).
//
// Bound on this card: operations. bf16: three products of 2*T*V*d each
// (qwen1.5-4b at T = 1024: 2.4e12, about 2.4 ms at the bf16 tensor-core
// rate). f32: six times that, 36*T*V*d bf16 operations (14.3e12, about
// 14.5 ms), against 6*T*V*d at the f32 rate outside the tensor cores
// (35.7 ms).
//
// Design: the scores are computed once per (token, vocab) pair. The
// vocabulary is walked in chunks of C columns (the wrapper's schedule: C is
// the largest multiple of 128 with P x T x C x 2 bytes <= 32 MiB and, at
// f32, C <= 8192: 16384 at T = 1024 in bf16, 5376 in f32; T is the token
// slice's at f32), and for each chunk, in order:
//  (s) f32 only, ce_split: the chunk's rows of W into (3, C, dp) planes,
//      dp = d rounded up to 64, zeros past d and past the chunk's rows
//      (h is split likewise once a call, into (3, T, dp)). Zeros stand
//      where a TMA box reaches past the data inside the buffer, so d need
//      only be a multiple of 4, as the f32 contract has it.
//  (a) ce_coef: S = h W[chunk]^T on the Hopper mainloop (hopper_gemm.cuh,
//      both operands K-major; at f32 the (0, 0) pass's sums promoted
//      every two stages into an f32 sum in shared memory, ce_planes.cuh);
//      the epilogue turns the accumulator registers into coef and writes
//      it to a (P, T, C) scratch buffer, rounded to bf16 or split into
//      planes (zeros past V), which stays in L2 for (b) and (c).
//  (b)+(c) ce_grad, one persistent launch over two kinds of 128 x 128 items:
//      dh items, dh += coef W[chunk] (A = scratch K-major, B = W MN-major,
//      K = C), accumulated in f32 over the chunks in chunk order into one
//      (T, d) buffer (the f32 output with cast = 0); the last chunk's items
//      write dh in bf16 with cast; and dW items, dW[chunk] = coef^T h (both
//      operands MN-major, K = T), whose rows are complete and written once,
//      in bf16 (cast) or f32 (added to, in a token slice after the
//      first). The items differ in length (a dh item has C of depth, a dW
//      item T: 256 and 16 stages at T = 1024 in bf16, six times C and T at
//      f32), and the 160 dh items of T = 1024 do not fill
//      132 SMs evenly alone, so the wrapper deals them to the CTAs longest
//      first, each to the least loaded CTA, and passes each CTA's list
//      (the same lists at f32, where every item is six times longer).
// Every plane has a TMA map of its own, so a box that reaches past T, past
// a plane's last row, reads TMA's zeros and never the next plane's rows.
// Every output element has one owner and a fixed order of sums, with no
// float atomics, so two calls are bit-equal.
// Resources (hopper_gemm.cuh): 128 x 128 tiles, 6 stages of 32 KB (about
// 193 KB of shared memory, one CTA of 384 threads per SM; ce_coef at f32 5
// stages and the 64 KB f32 sum, 225 KB), 232 registers a consumer thread.
// Memory beside the outputs: the scratch, P x T x C x 2 bytes (33.6 MB
// at T = 1024 in bf16, 33.0 MB in f32), a T x d x 4 byte f32 dh with cast
// (10.5 MB at T = 1024; at f32 it is the output), and at f32 the planes of
// h and of a chunk of W, 6 x T x dp and 6 x C x dp bytes (15.7 MB and 82.6
// MB at T = 1024, d = 2560): O(T C + C d + T d), never O(T V) or O(V d).
#include <algorithm>

#include "ce_planes.cuh"

using namespace hgemm;

namespace {

struct Chunk {
  int T, V, d;
  int C;             // scratch columns (row stride)
  int c0;            // first vocab row of the chunk
  int w0;            // the chunk's first row in W's maps: c0, or 0 in planes
  int valid;         // vocab rows in the chunk, <= C
  int n_tt;          // token tiles
};

struct CoefArgs {
  Chunk ch;
  const int* labels;
  const float* lse;
  const float* gn;   // g_nll + g_lse
  const float* go;   // g_nll
  bf16* coef;        // (P, T, C)
};

struct TileItem {
  int nk;            // stages: passes x nks
  int nks;           // K slices
  int m0, n0;
};

struct NoState {};

template <int P>
struct CoefJob {
  const CUtensorMap* mh;     // h, or its planes, K-major boxes
  const CUtensorMap* mw;     // W, or the chunk's planes, K-major boxes
  CoefArgs a;
  int n_items;
  using State = NoState;

  __device__ int begin() const { return blockIdx.x; }
  __device__ bool valid(int p) const { return p < n_items; }
  __device__ void advance(int& p) const { p += gridDim.x; }
  __device__ TileItem item(int p) const {
    const int nks = (a.ch.d + BK - 1) / BK;
    return {passes<P>() * nks, nks, (p % a.ch.n_tt) * BM,
            (p / a.ch.n_tt) * BN};
  }
  __device__ void load(const TileItem& it, int k, uint32_t sa, uint32_t sb,
                       uint64_t* bar) const {
    int ks, pa, pb;
    stage_of<P>(k, it.nks, ks, pa, pb);
    load_slice(mh + pa, false, sa, bar, it.m0, ks * BK);
    load_slice(mw + pb, false, sb, bar, a.ch.w0 + it.n0, ks * BK);
  }
  __device__ void mma(const TileItem&, float (&acc)[2][64], uint32_t sa,
                      uint32_t sb) const {
    mma_stage<false, false>(acc, sa, sb);
  }
  // P = 3: the (0, 0) pass, the last, promoted every PROMOTE stages
  __device__ void after_stage(const TileItem& it, int k,
                              float (&acc)[2][64]) const {
    promote_stage<P == 3 ? PROMOTE : 0>(k, it.nk, it.nks, acc,
                                        COEF3_STAGES * STAGE_BYTES);
  }
  __device__ void init(NoState&) const {}
  __device__ void after(const TileItem&, NoState&, int) const {}
  __device__ void epilogue(const TileItem& it, float (&acc)[2][64],
                           NoState&) const {
    const size_t plane = (size_t)a.ch.T * a.ch.C;
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
          if constexpr (P == 1) {
            *reinterpret_cast<__nv_bfloat162*>(out + col) =
                __floats2bfloat162_rn(v[0], v[1]);
          } else {
            __nv_bfloat162 q[3];
            split3(v[0], q[0].x, q[1].x, q[2].x);
            split3(v[1], q[0].y, q[1].y, q[2].y);
#pragma unroll
            for (int pl = 0; pl < 3; ++pl)
              *reinterpret_cast<__nv_bfloat162*>(out + pl * plane + col) =
                  q[pl];
          }
        }
      }
  }
};

template <int P>
struct CoefMaps {
  CUtensorMap h[P];
  CUtensorMap w[P];
};

template <int P>
__global__ void __launch_bounds__(THREADS, 1)
ce_coef(const __grid_constant__ CoefMaps<P> m, CoefArgs a, int n_items) {
  run<CoefJob<P>, P == 1 ? STAGES : COEF3_STAGES>(
      CoefJob<P>{m.h, m.w, a, n_items});
}

// ---- (b) dW and (c) dh ----------------------------------------------------

struct GradArgs {
  Chunk ch;
  int n_dt;          // 128-column tiles of d
  int first;         // first chunk: dh32 is written, not added to
  int last;          // last chunk: with cast, dh goes out in bf16
  int cast;          // 1: dh (last chunk) and dW in bf16, 0: f32
  int dw_add;        // f32: dW rows are added to, not written
  float* dh32;       // (T, d) f32 sum over the chunks so far
  bf16* dh;          // (T, d) bf16 output with cast
  void* dw;          // (V, d)
};

struct GradItem {
  int nk;            // stages: passes x nks
  int nks;           // K slices
  int m0, n0;
  bool dh;           // a dh item, else a dW item
};

template <int P>
struct GradMaps {
  CUtensorMap c_k[P];    // coef (T, C) planes, K-major boxes
  CUtensorMap c_mn[P];   // coef (T, C) planes, MN-major boxes
  CUtensorMap w_mn[P];   // W (V, d), or the chunk's planes, MN-major boxes
  CUtensorMap h_mn[P];   // h (T, d), or its planes, MN-major boxes
};

template <int P>
struct GradJob {
  const GradMaps<P>* m;
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
      it.nks = (a.ch.valid + BK - 1) / BK;
    } else {
      const int q = p - n_dh;
      it.n0 = (q % a.n_dt) * BN;
      it.m0 = (q / a.n_dt) * BM;
      it.nks = (a.ch.T + BK - 1) / BK;
    }
    it.nk = passes<P>() * it.nks;
    return it;
  }
  __device__ void load(const GradItem& it, int k, uint32_t sa, uint32_t sb,
                       uint64_t* bar) const {
    int ks, pa, pb;
    stage_of<P>(k, it.nks, ks, pa, pb);
    if (it.dh) {
      load_slice(&m->c_k[pa], false, sa, bar, it.m0, ks * BK);
      load_slice(&m->w_mn[pb], true, sb, bar, it.n0, a.ch.w0 + ks * BK);
    } else {
      load_slice(&m->c_mn[pa], true, sa, bar, it.m0, ks * BK);
      load_slice(&m->h_mn[pb], true, sb, bar, it.n0, ks * BK);
    }
  }
  __device__ void mma(const GradItem& it, float (&acc)[2][64], uint32_t sa,
                      uint32_t sb) const {
    if (it.dh)
      mma_stage<false, true>(acc, sa, sb);
    else
      mma_stage<true, true>(acc, sa, sb);
  }
  __device__ void after_stage(const GradItem&, int, float (&)[2][64]) const {}
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
          float2 old[16];
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const int col = it.n0 + acc_col(j);
            old[j] = P == 3 && a.dw_add && col < d
                         ? *reinterpret_cast<const float2*>(
                               static_cast<const float*>(a.dw) + off + col)
                         : make_float2(0.f, 0.f);
          }
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const int col = it.n0 + acc_col(j);
            if (col >= d) continue;
            float x = acc[h][4 * j + 2 * e];
            float y = acc[h][4 * j + 2 * e + 1];
            if (P == 3 && a.dw_add) {
              x += old[j].x;
              y += old[j].y;
            }
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

template <int P>
__global__ void __launch_bounds__(THREADS, 1)
ce_grad(const __grid_constant__ GradMaps<P> m, GradArgs a, int n_dh,
        const int* order, const int* start) {
  run(GradJob<P>{&m, a, n_dh, order, start});
}

struct Launch {
  const void *h, *w, *labels, *lse, *gn, *go;
  int T, V, d, C, grid, cast, dw_add;
  const void *order_full, *start_full, *order_last, *start_last;
  int grid_full, grid_last;
  void *scratch, *dh32, *dh, *dw, *h_planes, *w_planes;
  cudaStream_t st;
};

template <int P>
int launch(const Launch& L) {
  // P = 1 reads h and W in place; P = 3 their planes, dp columns wide
  const int dp = P == 1 ? L.d : planes_width(L.d);
  const void* h = P == 1 ? L.h : L.h_planes;
  const void* w = P == 1 ? L.w : L.w_planes;
  const int w_rows = P == 1 ? L.V : L.C;
  CoefMaps<P> cm;
  GradMaps<P> gm;
  if (plane_maps<P>(cm.h, h, dp, L.T, false) ||
      plane_maps<P>(cm.w, w, dp, w_rows, false) ||
      plane_maps<P>(gm.c_k, L.scratch, L.C, L.T, false) ||
      plane_maps<P>(gm.c_mn, L.scratch, L.C, L.T, true) ||
      plane_maps<P>(gm.w_mn, w, dp, w_rows, true) ||
      plane_maps<P>(gm.h_mn, h, dp, L.T, true))
    return ERR_TENSOR_MAP;
  cudaError_t err = cudaFuncSetAttribute(
      ce_coef<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)scores_smem_bytes<P>());
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(ce_grad<P>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  if (P == 3) {
    const int e = split_launch(static_cast<const float*>(L.h), L.T, L.d, L.T,
                               dp, static_cast<bf16*>(L.h_planes), L.st);
    if (e) return e;
  }
  const int n_tt = (L.T + BM - 1) / BM;
  const int n_dt = (L.d + BN - 1) / BN;
  for (int c0 = 0; c0 < L.V; c0 += L.C) {
    Chunk ch;
    ch.T = L.T;
    ch.V = L.V;
    ch.d = L.d;
    ch.C = L.C;
    ch.c0 = c0;
    ch.w0 = P == 1 ? c0 : 0;
    ch.valid = std::min(L.C, L.V - c0);
    ch.n_tt = n_tt;
    if (P == 3) {
      const int e = split_launch(static_cast<const float*>(L.w) +
                                     (size_t)c0 * L.d,
                                 ch.valid, L.d, L.C, dp,
                                 static_cast<bf16*>(L.w_planes), L.st);
      if (e) return e;
    }
    CoefArgs ca;
    ca.ch = ch;
    ca.labels = static_cast<const int*>(L.labels);
    ca.lse = static_cast<const float*>(L.lse);
    ca.gn = static_cast<const float*>(L.gn);
    ca.go = static_cast<const float*>(L.go);
    ca.coef = static_cast<bf16*>(L.scratch);
    const int n_coef = n_tt * ((ch.valid + BN - 1) / BN);
    ce_coef<P><<<std::min(L.grid, n_coef), THREADS, scores_smem_bytes<P>(),
                 L.st>>>(cm, ca, n_coef);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    GradArgs ga;
    ga.ch = ch;
    ga.n_dt = n_dt;
    ga.first = c0 == 0;
    ga.last = c0 + L.C >= L.V;
    ga.cast = L.cast;
    ga.dw_add = L.dw_add;
    ga.dh32 = static_cast<float*>(L.dh32);
    ga.dh = static_cast<bf16*>(L.dh);
    ga.dw = L.dw;
    ce_grad<P><<<ga.last ? L.grid_last : L.grid_full, THREADS, SMEM_BYTES,
                 L.st>>>(
        gm, ga, n_tt * n_dt,
        static_cast<const int*>(ga.last ? L.order_last : L.order_full),
        static_cast<const int*>(ga.last ? L.start_last : L.start_full));
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

// Schedule from the wrapper (fused_ce.py::bwd_schedule): chunk columns C,
// grid CTAs for ce_coef; ce_grad's item lists (fused_ce.py::grad_order) for
// a full chunk and for the last chunk, each over its own grid of CTAs.
// scratch: (P, T, C) bf16; dh32: (T, d) f32, the dh output itself with
// cast = 0; dh: (T, d) bf16 with cast != 0 (unused otherwise); dw: (V, d),
// bf16 with cast != 0, else f32. f32 != 0: h and w are f32 (cast must be
// 0), h_planes (3, T, dp) and w_planes (3, C, dp) bf16 buffers, dp = d
// rounded up to 64, and dw_add != 0 adds dW to the f32 dw given (the
// wrapper's token slices); f32 = 0: h and w are bf16, the plane buffers
// unused, dw_add 0.
extern "C" int fused_ce_bwd_launch(
    const void* h, const void* w, const void* labels, const void* lse,
    const void* gn, const void* go, int T, int V, int d, int C, int grid,
    int cast, int dw_add, const void* order_full, const void* start_full,
    int grid_full, const void* order_last, const void* start_last,
    int grid_last, void* scratch, void* dh32, void* dh, void* dw,
    void* h_planes, void* w_planes, int f32, void* stream) {
  const Launch L{h, w, labels, lse, gn, go, T, V, d, C, grid, cast, dw_add,
                 order_full, start_full, order_last, start_last, grid_full,
                 grid_last, scratch, dh32, dh, dw, h_planes, w_planes,
                 static_cast<cudaStream_t>(stream)};
  return f32 ? launch<3>(L) : launch<1>(L);
}

// The split alone (fused_ce.py::planes_launch): out (3, rows, dp) bf16 =
// the planes of x (R rows of d f32), zeros past R and d.
extern "C" int ce_split_launch(const void* x, int R, int d, int rows, int dp,
                               void* out, void* stream) {
  return split_launch(static_cast<const float*>(x), R, d, rows, dp,
                      static_cast<bf16*>(out),
                      static_cast<cudaStream_t>(stream));
}
