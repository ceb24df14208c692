// Mainloop microbenchmark for the fused cross-entropy kernels: the product
// C (M, N) = A (M, K) B (K, N) in bf16 with f32 accumulators, each operand
// K-major or MN-major, on two tile shapes, with no epilogue beyond a sum
// of the accumulators (so the product is not optimised away and can be
// checked):
//  - "pingpong": the kernels' own mainloop (hopper_gemm.cuh run): 128 x 128
//    tiles, two consumer warpgroups taking alternate tiles, 6 stages of
//    32 KB, wgmma m64n128k16;
//  - "coop": 128 x 256 tiles, both consumer warpgroups on every tile (each
//    a 64-row half, wgmma m64n256k16, 128 accumulators a thread), 4 stages
//    of 48 KB; no epilogue overlaps the next tile's products.
// A K-major operand is (rows, K) row-major, an MN-major one (K, rows).
// M must be a multiple of 128, N of 256, K of 64. Each consumer thread
// writes the sum of its accumulators over its tiles to out[CTA * 256 +
// thread] (pingpong adds to it).
#include "../src/repro_torch/kernels/csrc/hopper_gemm.cuh"

using namespace hgemm;

namespace {

struct Item {
  int nk, m0, n0;
};

struct NoState {};

template <bool AMN, bool BMN>
struct PingPong {
  const CUtensorMap* ma;
  const CUtensorMap* mb;
  int M, N, K;
  float* out;
  using State = NoState;

  __device__ int begin() const { return blockIdx.x; }
  __device__ bool valid(int p) const { return p < (M / BM) * (N / BN); }
  __device__ void advance(int& p) const { p += gridDim.x; }
  __device__ Item item(int p) const {
    return {K / BK, (p % (M / BM)) * BM, (p / (M / BM)) * BN};
  }
  __device__ void load(const Item& it, int k, uint32_t sa, uint32_t sb,
                       uint64_t* bar) const {
    load_slice(ma, AMN, sa, bar, it.m0, k * BK);
    load_slice(mb, BMN, sb, bar, it.n0, k * BK);
  }
  __device__ void mma(const Item&, float (&acc)[2][64], uint32_t sa,
                      uint32_t sb) const {
    mma_stage<AMN, BMN>(acc, sa, sb);
  }
  __device__ void after_stage(const Item&, int, float (&)[2][64]) const {}
  __device__ void init(NoState&) const {}
  __device__ void after(const Item&, NoState&, int) const {}
  __device__ void epilogue(const Item&, float (&acc)[2][64], NoState&) const {
    float s = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 64; ++i) s += acc[h][i];
    out[(size_t)blockIdx.x * 256 + threadIdx.x] += s;
  }
};

template <bool AMN, bool BMN>
__global__ void __launch_bounds__(THREADS, 1)
pingpong(const __grid_constant__ CUtensorMap ma,
         const __grid_constant__ CUtensorMap mb, int M, int N, int K,
         float* out) {
  run(PingPong<AMN, BMN>{&ma, &mb, M, N, K, out});
}

constexpr int CO_STAGES = 4;
constexpr int CO_A = BM * BK * 2;                  // 16 KB
constexpr int CO_B = 256 * BK * 2;                 // 32 KB
constexpr int CO_STAGE = CO_A + CO_B;
constexpr int CO_SMEM = CO_STAGES * CO_STAGE + 1024;

// d (64 x 256, f32) += A (64 x 16) B (16 x 256); TA / TB: 1 = MN-major.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, "
      "%71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, "
      "%85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, "
      "%99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, "
      "%121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, %131, %132;\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <bool AMN, bool BMN>
__global__ void __launch_bounds__(THREADS, 1)
coop(const __grid_constant__ CUtensorMap ma,
     const __grid_constant__ CUtensorMap mb, int M, int N, int K,
     float* out) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[CO_STAGES];
  __shared__ __align__(8) uint64_t empty[CO_STAGES];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const int wg = threadIdx.x / 128;
  const int n_m = M / BM, n_items = n_m * (N / 256), nk = K / BK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < CO_STAGES; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], 8);          // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (wg == CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == CONSUMERS * 128) {
      uint32_t it = 0;
      for (int p = blockIdx.x; p < n_items; p += gridDim.x) {
        const int m0 = (p % n_m) * BM, n0 = (p / n_m) * 256;
        for (int k = 0; k < nk; ++k, ++it) {
          const int s = it % CO_STAGES;
          bar_wait(&empty[s], ((it / CO_STAGES) & 1) ^ 1);
          bar_expect_tx(&full[s], CO_STAGE);
          const uint32_t sa = base + s * CO_STAGE, sb = sa + CO_A;
          load_slice(&ma, AMN, sa, &full[s], m0, k * BK);
          if (BMN) {
            for (int q = 0; q < 4; ++q)
              tma_load(&mb, sb + q * HALF_BYTES, &full[s], n0 + 64 * q,
                       k * BK);
          } else {
            tma_load(&mb, sb, &full[s], k * BK, n0);
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    float acc[128];
    float total = 0.f;
    uint32_t it = 0;
    for (int p = blockIdx.x; p < n_items; p += gridDim.x) {
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] = 0.f;
      for (int k = 0; k < nk; ++k) {
        const uint32_t u = it + k;
        const int s = u % CO_STAGES;
        bar_wait(&full[s], (u / CO_STAGES) & 1);
        const uint32_t sa = base + s * CO_STAGE, sb = sa + CO_A;
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          const uint64_t db = make_desc(sb + (BMN ? kk * 2048 : kk * 32),
                                        BMN ? HALF_BYTES : 16, 1024);
          const uint64_t da =
              make_desc(sa + wg * HALF_BYTES + (AMN ? kk * 2048 : kk * 32),
                        AMN ? HALF_BYTES : 16, 1024);
          wgmma_m64n256k16<AMN ? 1 : 0, BMN ? 1 : 0>(acc, da, db);
        }
        wg_commit();
        wg_wait<1>();
        if (k > 0) {
          __syncwarp();
          if ((threadIdx.x & 31) == 0)
            bar_arrive(&empty[(u - 1) % CO_STAGES]);
        }
      }
      wg_wait<0>();
#pragma unroll
      for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(acc[i])::"memory");
      __syncwarp();
      if ((threadIdx.x & 31) == 0)
        bar_arrive(&empty[(it + nk - 1) % CO_STAGES]);
      it += nk;
#pragma unroll
      for (int i = 0; i < 128; ++i) total += acc[i];
    }
    out[(size_t)blockIdx.x * 256 + threadIdx.x] = total;
  }
}

// A bf16 row-major (outer, inner) matrix as a TMA map with 128-byte swizzle
// and boxes of 64 x `rows` (inner x outer).
int map_rows(CUtensorMap* map, const void* ptr, uint64_t inner,
             uint64_t outer, uint32_t rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return ERR_TENSOR_MAP;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {inner * sizeof(bf16)};
  const cuuint32_t box[2] = {64, rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? 0
             : ERR_TENSOR_MAP;
}

template <bool AMN, bool BMN>
int launch(int variant, const void* a, const void* b, int M, int N, int K,
           float* out, int grid, cudaStream_t st) {
  CUtensorMap ma, mb;
  if (make_map(&ma, a, AMN ? M : K, AMN ? K : M, AMN)) return ERR_TENSOR_MAP;
  if (variant == 0) {
    if (make_map(&mb, b, BMN ? N : K, BMN ? K : N, BMN)) return ERR_TENSOR_MAP;
    cudaFuncSetAttribute(pingpong<AMN, BMN>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)SMEM_BYTES);
    pingpong<AMN, BMN><<<grid, THREADS, SMEM_BYTES, st>>>(ma, mb, M, N, K,
                                                          out);
  } else {
    if (map_rows(&mb, b, BMN ? N : K, BMN ? K : N, BMN ? 64 : 256))
      return ERR_TENSOR_MAP;
    cudaFuncSetAttribute(coop<AMN, BMN>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, CO_SMEM);
    coop<AMN, BMN><<<grid, THREADS, CO_SMEM, st>>>(ma, mb, M, N, K, out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// variant 0: pingpong, 1: coop; mode bit 1: A MN-major, bit 0: B MN-major.
// out: grid x 256 f32.
extern "C" int gemm_tiles_launch(int variant, int mode, const void* a,
                                 const void* b, int M, int N, int K,
                                 void* out, int grid, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto o = static_cast<float*>(out);
  switch (mode) {
    case 0: return launch<false, false>(variant, a, b, M, N, K, o, grid, st);
    case 1: return launch<false, true>(variant, a, b, M, N, K, o, grid, st);
    case 2: return launch<true, false>(variant, a, b, M, N, K, o, grid, st);
    default: return launch<true, true>(variant, a, b, M, N, K, o, grid, st);
  }
}
