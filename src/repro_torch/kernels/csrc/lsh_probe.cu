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
// once, by id (bf16 or f32, as the queries), plus l tail rows, the candidates' codes and slots and
// writes the (Q, C) counts (qwen1.5-4b, trimmed union: up to 38016 rows of
// 2560, about 195 MB plus 5.1 MB of tail rows, about 0.06 ms at 3.35 TB/s;
// the dense fallback reads all 151936 rows, about 0.24 ms), and does 2*Q
// flops per element read.
//
// Design: three launches on the caller's stream. (1) lsh_codes: one CTA per
// (query, table), one warp per hyperplane: an f32 dot product over d on the
// CUDA cores (h, bf16 or f32, is exact in f32; no tensor cores, so no
// TF32), the
// sign bits packed with integer shifts. The TPU kernel made the codes in
// every query tile's first grid step with two matmuls; here every probe CTA
// would redo 64 dot products of length d, so they are made once. (2) The
// probe, as ivf_decode.cu: every 32-column group of the candidate table and
// of the tail is one unit of work spread over every warp of 2 CTAs per SM.
// There is no staged copy of the candidates' rows (the TPU kernel's VMEM
// slabs): a warp loads its columns' ids and reads those rows of w, their
// codes and slots straight from device memory. Columns at or past
// cand_live, read from the device, load nothing and get count 0, so the
// host never synchronises on the plan. Each warp keeps partial (m, s,
// top-k) of the head and (m, s) of the tail, the CTA folds its warps'. (3)
// merge_partials (streaming.cuh) combines the CTAs' partials in a fixed
// order. The tail bias is added per sample instead of the TPU kernel's
// staged extra coordinate.
#include "streaming.cuh"

using namespace streaming;

constexpr int MAX_TABLES = 64;

__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float to_f32(float x) { return x; }

template <class T>
__global__ void lsh_codes_kernel(const T* __restrict__ h,
                                 const float* __restrict__ proj, int d,
                                 int L, int K, int* __restrict__ qcodes) {
  __shared__ int bits[32];
  const int q = blockIdx.x, t = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* p = proj + ((size_t)t * K + warp) * (d + 1);
  const T* hq = h + (size_t)q * d;
  float s = 0.f;
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
__global__ void __launch_bounds__(THREADS, KMAX <= 8 ? 2 : 1)
lsh_probe_partial(const T* __restrict__ w, const T* __restrict__ h,
                  const int* __restrict__ qcodes,
                  const int* __restrict__ cand_rows,
                  const int* __restrict__ cand_live,
                  const int* __restrict__ codes,
                  const int* __restrict__ slot_of_row,
                  const int* __restrict__ tail_ids,
                  const bool* __restrict__ accept,
                  const float* __restrict__ tail_bias, int Q, int C, int d,
                  int L, int NT, int* __restrict__ counts,
                  float* __restrict__ part_hm, float* __restrict__ part_hs,
                  float* __restrict__ part_v, int* __restrict__ part_i,
                  float* __restrict__ part_tm, float* __restrict__ part_ts,
                  int k) {
  extern __shared__ __align__(16) float hs[];
  __shared__ int qc[QT * MAX_TABLES];
  const int q0 = blockIdx.y * QT;
  for (int i = threadIdx.x; i < QT * L; i += blockDim.x) {
    const int qq = q0 + i / L;
    qc[i] = qq < Q ? qcodes[(size_t)qq * L + i % L] : -1;
  }
  load_query_tile(h, Q, d, q0, hs);          // ends in __syncthreads
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int qg = q0 + lane;
  const bool owner = lane < QT && qg < Q;
  const int live = min(*cand_live, C);
  const int head_groups = (C + GROUP - 1) / GROUP;
  const int n_groups = head_groups + (NT + GROUP - 1) / GROUP;
  const int* my_qc = qc + (owner ? lane : 0) * L;
  float hm = NEG, hsum = 0.f, tm = NEG, tsum = 0.f;
  TopK<KMAX> top;
  top.init();
  for (int g = blockIdx.x; g < n_groups; g += gridDim.x) {
    const T* rows[R];
    float acc[R][QT];
    if (g < head_groups) {
      const int j0 = g * GROUP + warp * R;
      if (j0 >= live) {                        // dead columns: count 0
        if (owner) {
#pragma unroll
          for (int r = 0; r < R; ++r)
            if (j0 + r < C) counts[(size_t)qg * C + j0 + r] = 0;
        }
        continue;
      }
      int ids[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        ids[r] = (j0 + r < live) ? cand_rows[j0 + r] : -1;
        rows[r] = ids[r] >= 0 ? w + (size_t)ids[r] * d : nullptr;
      }
      score_rows(rows, hs, d, lane, acc);
      if (owner) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (j0 + r >= C) continue;
          int cnt = 0;
          if (ids[r] >= 0) {
            const int* rc = codes + (size_t)ids[r] * L;
            const int* rs = slot_of_row + (size_t)ids[r] * L;
            for (int t = 0; t < L; ++t)
              cnt += (rc[t] == my_qc[t] && rs[t] >= 0) ? 1 : 0;
          }
          counts[(size_t)qg * C + j0 + r] = cnt;
          if (cnt > 0) {
            const float x = pick(acc[r], lane);
            online_add(hm, hsum, x);
            top.insert(x, ids[r]);
          }
        }
      }
    } else {
      const int j0 = (g - head_groups) * GROUP + warp * R;
#pragma unroll
      for (int r = 0; r < R; ++r)
        rows[r] = (j0 + r < NT) ? w + (size_t)tail_ids[j0 + r] * d : nullptr;
      score_rows(rows, hs, d, lane, acc);
      if (owner) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (rows[r] == nullptr || !accept[(size_t)qg * NT + j0 + r])
            continue;
          online_add(tm, tsum, pick(acc[r], lane) + tail_bias[j0 + r]);
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
static cudaError_t launch_probe(
    const T* w, const T* h, const float* proj,
    const int* cand_rows, const int* cand_live, const int* codes,
    const int* slot_of_row, const int* tail_ids, const bool* accept,
    const float* tail_bias, int Q, int C, int d, int L, int K, int NT, int k,
    int grid_x, int* qcodes, int* counts, float* phm, float* phs, float* pv,
    int* pi, float* ptm, float* pts, float* head_lse, float* tail_lse,
    float* topv, int* topi, cudaStream_t stream) {
  cudaError_t err = launch_codes(h, proj, Q, d, L, K, qcodes, stream);
  if (err != cudaSuccess) return err;
  const size_t smem = (size_t)QT * d * sizeof(float);
  err = cudaFuncSetAttribute(lsh_probe_partial<T, KMAX>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(grid_x, (Q + QT - 1) / QT);
  lsh_probe_partial<T, KMAX><<<grid, THREADS, smem, stream>>>(
      w, h, qcodes, cand_rows, cand_live, codes, slot_of_row, tail_ids,
      accept, tail_bias, Q, C, d, L, NT, counts, phm, phs, pv, pi, ptm, pts,
      k);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  merge_partials<KMAX><<<Q, MERGE_THREADS, 0, stream>>>(
      grid_x, k, phm, phs, pv, pi, ptm, pts, head_lse, tail_lse, topv, topi);
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
