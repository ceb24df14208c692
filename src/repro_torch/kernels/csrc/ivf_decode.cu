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
// br x d rows plus l tail rows once (qwen1.5-4b in bf16: 16 blocks of
// 512 x 2560 plus 1000 rows is about 47 MB, about 14 us at 3.35 TB/s; twice
// that in f32) and does 2*Q flops per element read. Rows, queries and tail
// rows are all bf16 or all f32.
//
// Design: the TPU grid walked the union slots then the tail tiles in order
// for one query tile, with scalar-prefetched block ids. Here every 32-row
// group of every union slot and of the tail is one unit of work, spread
// over every warp of 2 CTAs per SM, so the whole card streams the plan's
// rows at once. There is no scalar prefetch: each CTA reads head_live and
// the block id of its slot from device memory itself, and skips groups of
// pad slots (s >= head_live) without loading anything, so the host never
// synchronises on the plan. Each warp keeps partial (m, s, top-k) for the
// head and (m, s) for the tail, the CTA folds its warps' partials, and
// merge_partials (streaming.cuh) combines the CTAs'. A row counts only
// where its score plus row_logw is above NEG/2 (cluster-pad rows carry NEG)
// and the query is a member of the slot.
#include "streaming.cuh"

using namespace streaming;

template <class T, int KMAX>
__global__ void __launch_bounds__(THREADS, KMAX <= 8 ? 2 : 1)
ivf_decode_partial(const T* __restrict__ wb, const T* __restrict__ h,
                   const int* __restrict__ head_ids,
                   const int* __restrict__ head_live,
                   const bool* __restrict__ member,
                   const float* __restrict__ row_logw,
                   const T* __restrict__ tail,
                   const bool* __restrict__ accept, int Q, int U, int br,
                   int d, int L, int k, float* __restrict__ part_hm,
                   float* __restrict__ part_hs, float* __restrict__ part_v,
                   int* __restrict__ part_i, float* __restrict__ part_tm,
                   float* __restrict__ part_ts) {
  extern __shared__ float hs[];
  const int q0 = blockIdx.y * QT;
  load_query_tile(h, Q, d, q0, hs);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int qg = q0 + lane;
  const bool owner = lane < QT && qg < Q;
  const int live = *head_live;
  const int per_slot = (br + GROUP - 1) / GROUP;
  const int head_groups = U * per_slot;
  const int n_groups = head_groups + (L + GROUP - 1) / GROUP;
  float hm = NEG, hsum = 0.f, tm = NEG, tsum = 0.f;
  TopK<KMAX> top;
  top.init();
  for (int g = blockIdx.x; g < n_groups; g += gridDim.x) {
    const T* rows[R];
    float acc[R][QT];
    if (g < head_groups) {
      const int slot = g / per_slot;
      if (slot >= live) continue;              // pad slot: no load, no work
      const int blk = head_ids[slot];
      const int row0 = (g - slot * per_slot) * GROUP + warp * R;
#pragma unroll
      for (int r = 0; r < R; ++r)
        rows[r] = (row0 + r < br)
                      ? wb + ((size_t)blk * br + row0 + r) * d : nullptr;
      score_rows(rows, hs, d, lane, acc);
      if (owner && member[(size_t)qg * U + slot]) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (rows[r] == nullptr) continue;
          const int sid = blk * br + row0 + r;
          const float x = pick(acc[r], lane) + row_logw[sid];
          if (x > NEG * 0.5f) {
            online_add(hm, hsum, x);
            top.insert(x, sid);
          }
        }
      }
    } else {
      const int row0 = (g - head_groups) * GROUP + warp * R;
#pragma unroll
      for (int r = 0; r < R; ++r)
        rows[r] = (row0 + r < L) ? tail + (size_t)(row0 + r) * d : nullptr;
      score_rows(rows, hs, d, lane, acc);
      if (owner) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (rows[r] == nullptr || !accept[(size_t)qg * L + row0 + r])
            continue;
          online_add(tm, tsum, pick(acc[r], lane));
        }
      }
    }
  }
  __shared__ float sm[WARPS][QT], ss[WARPS][QT];
  __shared__ float sv[WARPS][QT][KMAX];
  __shared__ int si[WARPS][QT][KMAX];
  cta_lse(hm, hsum, warp, lane, sm, ss);
  cta_topk(top, warp, lane, sv, si);
  __syncthreads();                          // sm/ss are reused for the tail
  cta_lse(tm, tsum, warp, lane, sm, ss);
  if (warp == 0 && owner) {
    const size_t idx = (size_t)qg * gridDim.x + blockIdx.x;
    part_hm[idx] = hm;
    part_hs[idx] = hsum;
    part_tm[idx] = tm;
    part_ts[idx] = tsum;
    write_topk(top, k, part_v, part_i, idx * k);
  }
}

template <class T, int KMAX>
static cudaError_t launch(const T* wb, const T* h,
                          const int* head_ids, const int* head_live,
                          const bool* member, const float* row_logw,
                          const T* tail, const bool* accept,
                          int Q, int U, int br, int d, int L, int k,
                          int grid_x, float* phm, float* phs, float* pv,
                          int* pi, float* ptm, float* pts, float* head_lse,
                          float* tail_lse, float* topv, int* topi,
                          cudaStream_t stream) {
  const size_t smem = (size_t)QT * d * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ivf_decode_partial<T, KMAX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(grid_x, (Q + QT - 1) / QT);
  ivf_decode_partial<T, KMAX><<<grid, THREADS, smem, stream>>>(
      wb, h, head_ids, head_live, member, row_logw, tail, accept, Q, U, br, d,
      L, k, phm, phs, pv, pi, ptm, pts);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  merge_partials<KMAX><<<Q, MERGE_THREADS, 0, stream>>>(
      grid_x, k, phm, phs, pv, pi, ptm, pts, head_lse, tail_lse,
      topv, topi);
  return cudaGetLastError();
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
