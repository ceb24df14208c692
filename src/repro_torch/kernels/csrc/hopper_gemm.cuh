// The Hopper GEMM mainloop shared by the fused cross-entropy kernels
// (fused_ce_fwd.cu, fused_ce_bwd.cu): 128 x 128 output tiles of A (M, K)
// times B (K, N) in bf16 with f32 accumulators in registers.
//
// Shape of a CTA: 384 threads in three warpgroups. Warpgroup 2 is the
// producer: one thread walks the CTA's work items and issues TMA loads
// (cp.async.bulk.tensor, 128-byte swizzle) of 64-deep K slices of A and B
// into a ring of STAGES stages, each completed on an mbarrier ("full") by
// the copy's byte count. Warpgroups 0 and 1 are consumers: they take the
// CTA's work items in turn (ping-pong) and run wgmma.mma_async m64n128k16
// on each stage, two per 16-deep step (the two 64-row halves of the tile),
// then hand the stage back on its "empty" mbarrier once the wgmma group
// that read it has retired. The ring is filled in item order, and two named
// barriers keep the consumers' mainloops in that order, so while one
// consumer runs its epilogue on the registers of its tile, the other's
// wgmma run on the next item's stages. setmaxnreg moves registers from the
// producer (40 a thread) to the consumers (232: 128 accumulators, the
// epilogue's state and addresses).
//
// Operands are read in place: a K-major operand (K contiguous in memory,
// as h (T, d) and W (V, d) are for the scores) is one TMA box of 128 rows x
// 64 columns; an MN-major one (M or N contiguous, as W (V, d) is for
// dh = coef W and h (T, d) for dW = coef^T h) is two boxes of 64 K-rows x
// 64 columns side by side. wgmma reads either through its descriptor and
// the transpose bits, so nothing is transposed in memory. TMA fills reads
// past the tensor's edge with zeros, so ragged T, V and d need no padding.
//
// Shared memory: STAGES x 32 KB (+1 KB for alignment), one CTA per SM; a
// Job may take a shallower ring and shared memory of its own beside it.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace hgemm {

using bf16 = __nv_bfloat16;

constexpr int BM = 128;                         // rows of a tile
constexpr int BN = 128;                         // columns of a tile
constexpr int BK = 64;                          // depth of a stage
constexpr int STAGES = 6;
constexpr int TILE_BYTES = BM * BK * 2;         // one operand's stage slice
constexpr int HALF_BYTES = TILE_BYTES / 2;      // 64 rows, or 64 columns
constexpr int STAGE_BYTES = 2 * TILE_BYTES;
constexpr int CONSUMERS = 2;                    // consumer warpgroups
constexpr int THREADS = (CONSUMERS + 1) * 128;
constexpr size_t SMEM_BYTES = (size_t)STAGES * STAGE_BYTES + 1024;
constexpr float LOG2E = 1.4426950408889634f;
static_assert(BN == 128 && BK == 64, "one 128-byte swizzle atom per row");

// ---- shared memory, mbarriers, TMA ------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

__device__ __forceinline__ bool bar_try_wait(uint32_t addr, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(addr), "r"(parity)
      : "memory");
  return done != 0;
}

constexpr uint64_t WAIT_LIMIT_NS = 10000000000ull;   // 10 s

// Waits until the phase of parity `parity` of `bar` has completed. A wait
// of more than WAIT_LIMIT_NS traps, so that a stuck pipeline fails the
// launch instead of holding the card.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  if (bar_try_wait(addr, parity)) return;
  const uint64_t t0 = global_ns();
  while (!bar_try_wait(addr, parity))
    if (global_ns() - t0 > WAIT_LIMIT_NS) __trap();
}

// One 2D box of `map` at (c0 inner, c1 outer) into shared memory at `dst`,
// completing `bar` by its byte count.
__device__ __forceinline__ void tma_load(const CUtensorMap* map, uint32_t dst,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// A stage slice of an operand: 128 rows (M or N) at `row0` by 64 of K at
// `k0`. K-major: one box (k0, row0) of 64 x 128. MN-major: two boxes
// (row0, k0) and (row0 + 64, k0) of 64 x 64, 8 KB apart.
__device__ __forceinline__ void load_slice(const CUtensorMap* map, bool mn,
                                           uint32_t dst, uint64_t* bar,
                                           int row0, int k0) {
  if (mn) {
    tma_load(map, dst, bar, row0, k0);
    tma_load(map, dst + HALF_BYTES, bar, row0 + 64, k0);
  } else {
    tma_load(map, dst, bar, k0, row0);
  }
}

// ---- wgmma ------------------------------------------------------------------

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of the accumulators
// across the asynchronous wgmma and its wait.
__device__ __forceinline__ void fence_acc(float (&acc)[2][64]) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(acc[h][i])::"memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle. K-major: `lbo` is
// unused (16), `sbo` the 1024 bytes between 8-row groups. MN-major: `lbo`
// is the stride between 64-column atoms along M/N, `sbo` the stride
// between 8-deep groups along K.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// d (64 x 128, f32) += A (64 x 16) B (16 x 128); TA / TB: 1 = MN-major.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// acc += the stage's A (128 x 64) times B (64 x 128): four 16-deep steps,
// each one wgmma per 64-row half of A, committed as one group.
template <bool A_MN, bool B_MN>
__device__ __forceinline__ void mma_stage(float (&acc)[2][64], uint32_t sa,
                                          uint32_t sb) {
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint64_t db = make_desc(sb + (B_MN ? kk * 2048 : kk * 32),
                                  B_MN ? HALF_BYTES : 16, 1024);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint64_t da =
          make_desc(sa + h * HALF_BYTES + (A_MN ? kk * 2048 : kk * 32),
                    A_MN ? HALF_BYTES : 16, 1024);
      wgmma_m64n128k16<A_MN ? 1 : 0, B_MN ? 1 : 0>(acc[h], da, db);
    }
  }
  wg_commit();
}

// Where accumulator acc[h][4 j + 2 e + c] of this thread lies in the tile:
// row acc_row(h, e), column acc_col(j) + c.
__device__ __forceinline__ int acc_row(int h, int e) {
  return h * 64 + ((threadIdx.x & 127) >> 5) * 16 + ((threadIdx.x & 31) >> 2) +
         8 * e;
}

__device__ __forceinline__ int acc_col(int j) {
  return 8 * j + 2 * (threadIdx.x & 3);
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Named barriers 1 and 2 order the two consumers' mainloops: consumer w
// signals barrier 1 + w when its mainloop has waited on all its stages, and
// the other consumer syncs on it before its own mainloop.
__device__ __forceinline__ void order_signal(int wg) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(1 + wg) : "memory");
}

__device__ __forceinline__ void order_wait(int wg) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(2 - wg) : "memory");
}

// ---- the warp-specialised loop ----------------------------------------------
//
// A Job describes the CTA's work items and what to do with each:
//   Cursor begin() / bool valid(Cursor) / void advance(Cursor&) walk this
//     CTA's items in order (the same walk in every role);
//   Item item(Cursor) has `nk`, the number of K stages of the item (>= 1);
//   load(item, k, sa, sb, bar) issues stage k's TMA loads;
//   mma(item, acc, sa, sb) runs one stage (mma_stage with its layouts);
//   after_stage(item, k, acc) runs once stage k has been issued and the
//     stage before it handed back (stage k's wgmma may still run);
//   init(State&), epilogue(item, acc, State&) and after(item, State&, wg)
//     run in the consumers: the epilogue on the consumer's own items, and
//     `after` on every item of the walk.
// NST is the depth of the ring (STAGES unless the Job needs shared memory
// of its own beside it, past NST x STAGE_BYTES from the aligned base).
template <class Job, int NST = STAGES>
__device__ __forceinline__ void run(const Job& job) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[NST];
  __shared__ __align__(8) uint64_t empty[NST];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < NST; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], 4);          // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (wg == CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == CONSUMERS * 128) {
      uint32_t it = 0;
      for (auto c = job.begin(); job.valid(c); job.advance(c)) {
        const auto item = job.item(c);
        for (int k = 0; k < item.nk; ++k, ++it) {
          const int s = it % NST;
          bar_wait(&empty[s], ((it / NST) & 1) ^ 1);
          bar_expect_tx(&full[s], STAGE_BYTES);
          const uint32_t sa = base + s * STAGE_BYTES;
          job.load(item, k, sa, sa + TILE_BYTES, &full[s]);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    typename Job::State st;
    job.init(st);
    float acc[2][64];
    uint32_t it = 0;
    int i = 0;
    for (auto c = job.begin(); job.valid(c); job.advance(c), ++i) {
      const auto item = job.item(c);
      if ((i & 1) == wg) {
        auto next = c;
        job.advance(next);
        // The consumers' mainloops run in item order: a consumer waits on a
        // stage's full barrier only once the other has waited on every
        // earlier stage, so that no wait is more than one phase ahead of
        // its barrier (a parity wait cannot tell phase r from r + 2).
        if (i > 0) order_wait(wg);
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int r = 0; r < 64; ++r) acc[h][r] = 0.f;
        for (int k = 0; k < item.nk; ++k) {
          const uint32_t u = it + k;
          const int s = u % NST;
          bar_wait(&full[s], (u / NST) & 1);
          const uint32_t sa = base + s * STAGE_BYTES;
          job.mma(item, acc, sa, sa + TILE_BYTES);
          wg_wait<1>();                  // the previous stage's group is done
          if (k > 0) {
            __syncwarp();
            if ((threadIdx.x & 31) == 0) bar_arrive(&empty[(u - 1) % NST]);
          }
          job.after_stage(item, k, acc);
        }
        if (job.valid(next)) order_signal(wg);
        wg_wait<0>();
        fence_acc(acc);
        __syncwarp();
        if ((threadIdx.x & 31) == 0)
          bar_arrive(&empty[(it + item.nk - 1) % NST]);
        job.epilogue(item, acc, st);
      }
      it += item.nk;
      job.after(item, st, wg);
    }
  }
}

// ---- host: tensor maps --------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, looked up through the runtime, so
// that the build needs no -lcuda.
static EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

constexpr int ERR_TENSOR_MAP = 999;   // cudaErrorUnknown

// A bf16 row-major (outer, inner) matrix as a TMA map with 128-byte swizzle
// and boxes of 64 x `box_rows` (inner x outer). Returns 0 or
// ERR_TENSOR_MAP.
static int make_map_rows(CUtensorMap* map, const void* ptr, uint64_t inner,
                         uint64_t outer, uint32_t box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return ERR_TENSOR_MAP;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {inner * sizeof(bf16)};
  const cuuint32_t box[2] = {64, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                        const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_TENSOR_MAP;
}

// The GEMM's operand maps: K-major operands take boxes of 64 x 128 (inner x
// outer), MN-major ones 64 x 64.
static int make_map(CUtensorMap* map, const void* ptr, uint64_t inner,
                    uint64_t outer, bool mn) {
  return make_map_rows(map, ptr, inner, outer, mn ? 64u : (uint32_t)BM);
}

}  // namespace hgemm

// The dynamic shared memory a CTA of the mainloop asks for (reports).
extern "C" int hgemm_smem_bytes() { return (int)hgemm::SMEM_BYTES; }

// The library's CUDA error state, read and cleared (cudaGetLastError).
// Each source builds into a library with its own static CUDA runtime, so a
// caller reads each kernel's library apart (kernels/_build.py last_error).
extern "C" int kernel_last_error() { return (int)cudaGetLastError(); }
