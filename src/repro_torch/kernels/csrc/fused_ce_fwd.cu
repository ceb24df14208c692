// Streaming softmax cross-entropy, forward: per token the LSE over the
// vocabulary and the label's score, without writing the (T, V) logits, for
// bf16 and for f32 h and W.
//
// Replaces the TPU kernel src/repro/kernels/fused_ce.py::fused_ce_fwd
// (_fwd_kernel): an online (m, s) and the label's score carried across a
// sequential vocab grid per token tile.
//
// bf16 (P = 1 plane): the scores of h and W as they are, summed in f32.
// f32 (P = 3 planes): ce_split first splits h into (3, T, dp) and W into
// (3, V, dp) exact bf16 planes (dp = d rounded up to 64, zeros past d and
// past the last row), and each score sums the six plane pairs, smallest
// first (ce_planes.cuh): an f32-accurate product on the bf16 tensor cores.
// The scores feed exp, so their error is the LSE's: the (0, 0) pass, at
// full magnitude, is promoted into an f32 sum in shared memory every
// PROMOTE stages, as the backward's ce_coef<3> does. The forward's only
// sum is over d, which the wrapper caps at F32_MAX_DEPTH.
//
// Bound on this card: operations. bf16: 2*T*V*d (qwen1.5-4b at T = 1024:
// 8.0e11, about 0.81 ms at the bf16 tensor-core rate) against 778 MB of W
// read once (0.23 ms). f32: six times that in bf16 operations issued
// (4.78e12, about 4.83 ms), against 2*T*V*d at the f32 rate outside the
// tensor cores (11.9 ms); writing and reading W's planes (2.33 GB) adds
// memory traffic of about 1.2 ms beside them.
//
// Design: the scores run on the Hopper mainloop of hopper_gemm.cuh (TMA
// into a 6-stage ring of 32 KB stages, wgmma m64n128k16 with f32
// accumulators in registers, 128 x 128 tiles, a producer warp and two
// consumer warpgroups in ping-pong, 232 registers a consumer thread, about
// 193 KB of shared memory, one CTA per SM). Work units are (128-token
// tile, vocab split); persistent CTAs walk their units' 128-column vocab
// tiles in order, and consecutive tiles go to alternate consumers. The
// epilogue folds a tile straight from the accumulator registers: a thread
// holds 32 columns of 4 rows; the row max is shared by the 4 threads of a
// row (two quad shuffles), and each thread keeps the running (m, s, label
// score) of its rows, so no f32 score goes through shared memory. At the
// end of a unit the quad sums its s and each consumer writes one partial
// (m, s, p) per token; a second kernel merges the 2 x n_split partials of
// each token in a fixed order, so two calls are bit-equal. Units are
// ordered token tile first, so CTAs that run at once share W's tiles in L2.
// At f32 an item runs passes x nks stages, one TMA map a plane, on a ring
// of COEF3_STAGES stages beside the 64 KB sums (225 KB); W is split once a
// call, so the walk over vocab splits is the same at both dtypes. Memory
// beside the outputs at f32: the planes, 6 x (T + V) x dp bytes (2.35 GB at
// T = 1024 for qwen1.5-4b).
#include "ce_planes.cuh"

using namespace hgemm;

namespace {

constexpr float NEG = -1e30f;

struct FwdArgs {
  const int* labels;
  int T, V, d;
  int n_tt;          // token tiles
  int n_vt;          // vocab tiles
  int n_split;       // vocab splits
  int per;           // vocab tiles per split
  float* part_m;     // (2 n_split, T)
  float* part_s;
  float* part_p;
  float* nll;        // (T,)
  float* lse;        // (T,)
};

struct FwdCursor {
  int u;             // unit: token tile u % n_tt, split u / n_tt
  int t;             // vocab tile within the unit
};

struct FwdItem {
  int nk;            // stages: passes x nks
  int nks;           // K slices
  int m0, v0, split;
  bool last;         // last vocab tile of the unit
};

struct FwdState {
  float m[4], s[4], p[4];    // rows acc_row(h, e) at index 2 h + e
};

template <int P>
struct FwdJob {
  const CUtensorMap* mh;     // h, or its planes, K-major boxes
  const CUtensorMap* mw;     // W, or its planes, K-major boxes
  FwdArgs a;
  using State = FwdState;

  __device__ int tiles(int split) const {
    return min(a.per, a.n_vt - split * a.per);
  }
  __device__ FwdCursor begin() const { return {(int)blockIdx.x, 0}; }
  __device__ bool valid(const FwdCursor& c) const {
    return c.u < a.n_tt * a.n_split;
  }
  __device__ void advance(FwdCursor& c) const {
    if (c.t + 1 < tiles(c.u / a.n_tt)) {
      ++c.t;
    } else {
      c.u += gridDim.x;
      c.t = 0;
    }
  }
  __device__ FwdItem item(const FwdCursor& c) const {
    const int split = c.u / a.n_tt;
    FwdItem it;
    it.nks = (a.d + BK - 1) / BK;
    it.nk = passes<P>() * it.nks;
    it.m0 = (c.u % a.n_tt) * BM;
    it.v0 = (split * a.per + c.t) * BN;
    it.split = split;
    it.last = c.t + 1 == tiles(split);
    return it;
  }
  __device__ void load(const FwdItem& it, int k, uint32_t sa, uint32_t sb,
                       uint64_t* bar) const {
    int ks, pa, pb;
    stage_of<P>(k, it.nks, ks, pa, pb);
    load_slice(mh + pa, false, sa, bar, it.m0, ks * BK);
    load_slice(mw + pb, false, sb, bar, it.v0, ks * BK);
  }
  __device__ void mma(const FwdItem&, float (&acc)[2][64], uint32_t sa,
                      uint32_t sb) const {
    mma_stage<false, false>(acc, sa, sb);
  }
  // P = 3: the (0, 0) pass, the last, promoted every PROMOTE stages
  __device__ void after_stage(const FwdItem& it, int k,
                              float (&acc)[2][64]) const {
    promote_stage<P == 3 ? PROMOTE : 0>(k, it.nk, it.nks, acc,
                                        COEF3_STAGES * STAGE_BYTES);
  }
  __device__ void init(FwdState& st) const {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      st.m[r] = NEG;
      st.s[r] = 0.f;
      st.p[r] = NEG;
    }
  }
  __device__ void epilogue(const FwdItem& it, float (&acc)[2][64],
                           FwdState& st) const {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = 2 * h + e;
        const int row = it.m0 + acc_row(h, e);
        const int lab = row < a.T ? a.labels[row] : -1;
        float mx = -INFINITY, pick = NEG;
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int col = it.v0 + acc_col(j) + c;
            float& x = acc[h][4 * j + 2 * e + c];
            if (col >= a.V) x = -INFINITY;
            mx = fmaxf(mx, x);
            if (col == lab) pick = x;
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(st.m[r], mx);
        const float ms = m_new * LOG2E;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            sum += fast_exp2(fmaf(acc[h][4 * j + 2 * e + c], LOG2E, -ms));
        st.s[r] = st.s[r] * fast_exp2((st.m[r] - m_new) * LOG2E) + sum;
        st.m[r] = m_new;
        st.p[r] = fmaxf(st.p[r], pick);
      }
  }
  __device__ void after(const FwdItem& it, FwdState& st, int wg) const {
    if (!it.last) return;
    const size_t part = (size_t)(2 * it.split + wg) * a.T;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = 2 * h + e;
        float s = st.s[r], p = st.p[r];
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        p = fmaxf(p, __shfl_xor_sync(0xffffffffu, p, 1));
        p = fmaxf(p, __shfl_xor_sync(0xffffffffu, p, 2));
        const int row = it.m0 + acc_row(h, e);
        if ((threadIdx.x & 3) == 0 && row < a.T) {
          a.part_m[part + row] = st.m[r];
          a.part_s[part + row] = s;
          a.part_p[part + row] = p;
        }
      }
    init(st);
  }
};

template <int P>
struct FwdMaps {
  CUtensorMap h[P];
  CUtensorMap w[P];
};

template <int P>
__global__ void __launch_bounds__(THREADS, 1)
fused_ce_fwd_partial(const __grid_constant__ FwdMaps<P> m, FwdArgs a) {
  run<FwdJob<P>, P == 1 ? STAGES : COEF3_STAGES>(FwdJob<P>{m.h, m.w, a});
}

// One thread per token: lse = m + log(sum_p s_p exp(m_p - m)) over the
// partials in order, nll = lse - the label's score.
__global__ void fused_ce_fwd_merge(int T, int n_part,
                                   const float* __restrict__ part_m,
                                   const float* __restrict__ part_s,
                                   const float* __restrict__ part_p,
                                   float* __restrict__ nll,
                                   float* __restrict__ lse) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T) return;
  float mx = NEG, p = NEG;
  for (int k = 0; k < n_part; ++k) {
    const size_t i = (size_t)k * T + t;
    if (part_s[i] > 0.f) mx = fmaxf(mx, part_m[i]);
    p = fmaxf(p, part_p[i]);
  }
  float sum = 0.f;
  for (int k = 0; k < n_part; ++k) {
    const size_t i = (size_t)k * T + t;
    if (part_s[i] > 0.f) sum += part_s[i] * expf(part_m[i] - mx);
  }
  const float l = mx + logf(sum);
  lse[t] = l;
  nll[t] = l - p;
}

template <int P>
int launch(const void* h, const void* w, const FwdArgs& a, int grid,
           void* h_planes, void* w_planes, cudaStream_t st) {
  // P = 1 reads h and W in place; P = 3 their planes, dp columns wide
  const int dp = P == 1 ? a.d : planes_width(a.d);
  if (P == 3) {
    int e = split_launch(static_cast<const float*>(h), a.T, a.d, a.T, dp,
                         static_cast<bf16*>(h_planes), st);
    if (!e)
      e = split_launch(static_cast<const float*>(w), a.V, a.d, a.V, dp,
                       static_cast<bf16*>(w_planes), st);
    if (e) return e;
  }
  FwdMaps<P> m;
  if (plane_maps<P>(m.h, P == 1 ? h : h_planes, dp, a.T, false) ||
      plane_maps<P>(m.w, P == 1 ? w : w_planes, dp, a.V, false))
    return ERR_TENSOR_MAP;
  cudaError_t err = cudaFuncSetAttribute(
      fused_ce_fwd_partial<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)scores_smem_bytes<P>());
  if (err != cudaSuccess) return (int)err;
  fused_ce_fwd_partial<P>
      <<<grid, THREADS, scores_smem_bytes<P>(), st>>>(m, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fused_ce_fwd_merge<<<(a.T + 255) / 256, 256, 0, st>>>(
      a.T, 2 * a.n_split, a.part_m, a.part_s, a.part_p, a.nll, a.lse);
  return (int)cudaGetLastError();
}

}  // namespace

// part_m / part_s / part_p: (2 n_split, T) f32 each; grid: persistent CTAs.
// f32 != 0: h and w are f32, h_planes (3, T, dp) and w_planes (3, V, dp)
// bf16 buffers, dp = d rounded up to 64; f32 = 0: h and w are bf16, the
// plane buffers unused.
extern "C" int fused_ce_fwd_launch(const void* h, const void* w,
                                   const void* labels, int T, int V, int d,
                                   int n_split, int per, int grid,
                                   void* part_m, void* part_s, void* part_p,
                                   void* nll, void* lse, void* h_planes,
                                   void* w_planes, int f32, void* stream) {
  FwdArgs a;
  a.labels = static_cast<const int*>(labels);
  a.T = T;
  a.V = V;
  a.d = d;
  a.n_tt = (T + BM - 1) / BM;
  a.n_vt = (V + BN - 1) / BN;
  a.n_split = n_split;
  a.per = per;
  a.part_m = static_cast<float*>(part_m);
  a.part_s = static_cast<float*>(part_s);
  a.part_p = static_cast<float*>(part_p);
  a.nll = static_cast<float*>(nll);
  a.lse = static_cast<float*>(lse);
  auto st = static_cast<cudaStream_t>(stream);
  return f32 ? launch<3>(h, w, a, grid, h_planes, w_planes, st)
             : launch<1>(h, w, a, grid, h_planes, w_planes, st);
}
