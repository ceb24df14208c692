// Exact bf16 planes of f32 operands for the Hopper mainloop
// (hopper_gemm.cuh), shared by the f32 routes of fused_ce_fwd.cu,
// fused_ce_bwd.cu and fmbe_phi_wgmma.cu.
//
// Each f32 operand x is split exactly into three bf16 planes, x = x0 + x1 +
// x2 with x0 = bf16(x), x1 = bf16(x - x0), x2 = bf16(x - x0 - x1)
// (fused_ce.py::split_planes). A product of two split operands sums the six
// plane pairs (i, j) with i + j <= 2, whose dropped terms are of order
// 2**-24 of |a||b|: an f32-accurate product on the bf16 tensor cores. Each
// pass of an item runs one pair over all of K, smallest terms first and
// (0, 0) last (fused_ce.py::PAIRS), so that the small sums are not added
// into a large accumulator K times over. Every plane has a TMA map of its
// own, so that a box that reaches past a plane's last row reads TMA's zeros
// and never the next plane's rows.
//
// The tensor cores' f32 sums lose low bits at each 16-deep step, relative
// to the magnitude of the sum so far. So a pass at full magnitude may sum
// PROMOTE stages (128 deep) at a time on the tensor cores from zero and add
// each such sum, rounded to nearest, to an f32 sum in shared memory
// (promote_stage): 128 threads x 128 floats beside the ring, which serves
// both consumers because their mainloops run one at a time.
#pragma once

#include <algorithm>

#include "hopper_gemm.cuh"

// In the including file's anonymous namespace: each kernel library compiles
// its own copy.
namespace {

using namespace hgemm;

// The three pairs of order 2**-16 of |a||b|, then (0, 1), (1, 0), (0, 0):
// the plane of A and of B of pass q are nibble q of PAIR_A and PAIR_B
// (fused_ce.py::PAIRS). A file that includes this one may define other
// pairs first (tools/ce_f32_pairs.cu).
#ifndef CE_PASSES3
#define CE_PASSES3 6
#define CE_PAIR_A 0x010201
#define CE_PAIR_B 0x001021
#endif
constexpr int PASSES3 = CE_PASSES3;
constexpr uint32_t PAIR_A = CE_PAIR_A;
constexpr uint32_t PAIR_B = CE_PAIR_B;

template <int P>
__host__ __device__ constexpr int passes() {
  static_assert(P == 1 || P == 3, "one plane (bf16) or three (f32)");
  return P == 1 ? 1 : PASSES3;
}

// x0 + x1 + x2 == x exactly for finite x; a zero residual keeps x's sign.
__device__ __forceinline__ void split3(float x, bf16& x0, bf16& x1, bf16& x2) {
  const float zero = copysignf(0.f, x);
  x0 = __float2bfloat16_rn(x);
  float r = x - __bfloat162float(x0);
  r = r == 0.f ? zero : r;
  x1 = __float2bfloat16_rn(r);
  r -= __bfloat162float(x1);
  x2 = __float2bfloat16_rn(r == 0.f ? zero : r);
}

// out (3, rows, dp) = the planes of x (valid rows of d floats, d a
// multiple of 4), zeros past valid rows and past d. One thread a group of
// 4 columns: one float4 read, one 8-byte store a plane.
__global__ void __launch_bounds__(256)
ce_split(const float* __restrict__ x, int valid, int d, int rows, int dp,
         bf16* __restrict__ out) {
  const size_t plane = (size_t)rows * dp;
  const int groups = dp / 4;
  const size_t n = (size_t)rows * groups;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const int r = (int)(i / groups), c = (int)(i % groups) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < valid && c < d)
      v = __ldg(reinterpret_cast<const float4*>(x + (size_t)r * d + c));
    __align__(8) bf16 p[3][4];
    split3(v.x, p[0][0], p[1][0], p[2][0]);
    split3(v.y, p[0][1], p[1][1], p[2][1]);
    split3(v.z, p[0][2], p[1][2], p[2][2]);
    split3(v.w, p[0][3], p[1][3], p[2][3]);
    bf16* dst = out + (size_t)r * dp + c;
#pragma unroll
    for (int q = 0; q < 3; ++q)
      *reinterpret_cast<uint2*>(dst + q * plane) =
          *reinterpret_cast<const uint2*>(p[q]);
  }
}

inline int split_grid(size_t groups) {
  return (int)std::min<size_t>((groups + 255) / 256, 132 * 16);
}

// ce_split of `valid` rows of x (d floats each) into out (3, rows, dp) on
// `st`; returns the launch's error.
inline int split_launch(const float* x, int valid, int d, int rows, int dp,
                        bf16* out, cudaStream_t st) {
  ce_split<<<split_grid((size_t)rows * dp / 4), 256, 0, st>>>(x, valid, d,
                                                             rows, dp, out);
  return (int)cudaGetLastError();
}

// Columns of a plane: d rounded up to whole 64-column TMA boxes.
inline int planes_width(int d) { return (d + BK - 1) / BK * BK; }

// The maps of P planes of a (rows, inner) bf16 matrix, inner x rows
// elements apart.
template <int P>
int plane_maps(CUtensorMap* maps, const void* base, uint64_t inner,
               uint64_t rows, bool mn) {
  for (int q = 0; q < P; ++q)
    if (make_map(&maps[q], static_cast<const bf16*>(base) + q * inner * rows,
                 inner, rows, mn))
      return ERR_TENSOR_MAP;
  return 0;
}

// Stage k of an item of `nks` K slices: its slice and the planes of A and
// B it reads. One plane: slice k of planes 0.
template <int P>
__device__ __forceinline__ void stage_of(int k, int nks, int& ks, int& pa,
                                         int& pb) {
  if constexpr (P == 1) {
    ks = k;
    pa = pb = 0;
  } else {
    const int q = k / nks;
    ks = k - q * nks;
    pa = (PAIR_A >> (4 * q)) & 15;
    pb = (PAIR_B >> (4 * q)) & 15;
  }
}

// ---- promoted sums -----------------------------------------------------------

// The stages of one tensor-core sum of a scores pass at full magnitude. A
// score feeds exp, so its error is its coefficient's (or the LSE's): summed
// over all of d, the scores of logits about N(0, 16) left dh and dW 5e-5
// of their terms off on average (tools/ce_f32_pairs.py). A file that
// includes this one may define another PROMOTE first (0: one sum over all
// of d).
#ifndef CE_COEF3_PROMOTE
#define CE_COEF3_PROMOTE 2
#endif
constexpr int PROMOTE = CE_COEF3_PROMOTE;
constexpr int COEF3_STAGES = 5;         // the ring beside the sums
constexpr int SUMS_BYTES = 128 * 128 * 4;

// Dynamic shared memory of a scores kernel: the mainloop's at P = 1; at
// P = 3 a ring of COEF3_STAGES stages and the sums.
template <int P>
constexpr size_t scores_smem_bytes() {
  return P == 1 ? SMEM_BYTES
                : (size_t)COEF3_STAGES * STAGE_BYTES + SUMS_BYTES + 1024;
}

__device__ __forceinline__ float4 lds4(uint32_t a) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a)
               : "memory");
  return v;
}

__device__ __forceinline__ void sts4(uint32_t a, float x, float y, float z,
                                     float w) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(a),
               "f"(x), "f"(y), "f"(z), "f"(w)
               : "memory");
}

// sum = acc (first), sum += acc, or acc += sum (last); acc = 0 but after
// the last. The sums lie `offset` bytes past the aligned base of dynamic
// shared memory; thread t keeps acc[h][4 j .. 4 j + 3] at group 16 h + j,
// 16 bytes at sums + (group x 128 + t) x 16: a warp's accesses are
// contiguous.
__device__ __forceinline__ void promote(float (&acc)[2][64], bool first,
                                        bool last, uint32_t offset) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sums = ((smem_u32(smem_raw) + 1023u) & ~1023u) + offset +
                        (threadIdx.x & 127) * 16;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      float* a = &acc[h][4 * j];
      const uint32_t at = sums + (16 * h + j) * 2048;
      if (first) {
        sts4(at, a[0], a[1], a[2], a[3]);
      } else {
        const float4 y = lds4(at);
        if (last) {
          a[0] += y.x;
          a[1] += y.y;
          a[2] += y.z;
          a[3] += y.w;
          continue;
        }
        sts4(at, y.x + a[0], y.y + a[1], y.z + a[2], y.w + a[3]);
      }
      a[0] = a[1] = a[2] = a[3] = 0.f;
    }
}

// A Job's after_stage hook for an item of nk stages whose last pass (nks
// stages) is at full magnitude: that pass promoted every EVERY stages into
// the sums at `offset` (EVERY = 0: not at all).
template <int EVERY>
__device__ __forceinline__ void promote_stage(int k, int nk, int nks,
                                              float (&acc)[2][64],
                                              uint32_t offset) {
  if constexpr (EVERY > 0) {
    const int r = k - (nk - nks);        // stage in the pass
    const bool last = k == nk - 1;
    if (r < 0 || ((r + 1) % EVERY != 0 && !last)) return;
    const bool first = r < EVERY;
    if (first && last) return;           // one sum: nothing to add
    wg_wait<0>();
    fence_acc(acc);
    promote(acc, first, last, offset);
  }
}

}  // namespace
