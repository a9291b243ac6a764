// The Hopper main loop of the weight-only quantized GEMMs (sm_90a):
//
//   y[M, O] = h[M, K] . W^T,   h bf16, W stored quantized, fp32 accumulation
//
// shared by the tiled regimes of K1/K2 (int8, csrc/int8_mm.cu) and K4 (int4
// group 128, csrc/int4_mm.cu), which each give it a weight format (the Fmt
// policy below). At prefill rows the work is bound by tensor-core
// operations; mma.sync (the design this replaces) reaches about a quarter
// of the card's bf16 rate, wgmma is the only way to the full rate. So:
//
// * a block owns kBM = 128 rows of h x kBN = 256 output columns and walks K
//   in k-steps (64 for int8; 32 packed rows = 64 for int4);
// * one producer thread keeps a ring of Fmt::kStages shared-memory stages
//   filled by TMA (cp.async.bulk.tensor, completion on an mbarrier): the
//   activation tile, already in wgmma's swizzled K-major layout, and the raw
//   quantized weight tile (plus, for int4, the two group-scale rows). A
//   stage is refilled once both consumer warpgroups have released it, so
//   loads for steps k+1 and k+2 are in flight while step k computes;
// * two consumer warpgroups (64 rows each) widen the stage's weight tile to
//   bf16 on the CUDA cores into one of three bf16 buffers, in the 128-byte
//   swizzled layout wgmma reads (K-major for int8's [O, D] rows, MN-major
//   with the transpose bit for int4's [D/2, O] rows), fence it into the
//   async proxy, meet at a named barrier, and issue 4 m64n256k16 SS-wgmma
//   (A = h from the TMA tile, B = the widened tile). wgmma.wait_group 1
//   leaves the step's MMAs running while the next step is widened; three
//   buffers make sure neither warpgroup overwrites a buffer the other's
//   MMAs may still read;
// * the epilogue writes bf16 outputs from the accumulators (int8: times the
//   per-channel scale, after the fp32 reduction, as the TPU kernel does).
//
// No dense weight is ever written to device memory. The grid's fastest axis
// is the row tile, so the blocks that share a weight tile run together and
// read it from device memory once. Where the row and column tiles cannot
// fill the card's SMs (decode rows, a narrow stack), K is split over blocks:
// each split writes fp32 partials to a workspace and splitk_reduce_kernel
// sums them in a fixed order (deterministic, no atomics).
//
// Tensor maps are encoded on the host per call with cuTensorMapEncodeTiled,
// fetched through cudaGetDriverEntryPoint, so the library need not link
// libcuda. Ragged edges (rows past M, columns past O) are TMA's zero fill;
// the epilogue masks them.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: the driver is reached by entry point
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace wq {

constexpr int kBM = 128;                   // rows of h per block: two warpgroups of 64
constexpr int kBN = 256;                   // output columns per block: n of one wgmma
constexpr int kConsumers = 256;            // threads of the two consumer warpgroups
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kBBufs = 3;                  // widened bf16 weight tiles
constexpr int kBBytes = kBN * 64 * 2;      // one widened tile: 256 columns x k 64
constexpr int kMinStepsPerSplit = 4;
constexpr uint64_t kSw128 = 1, kSw64 = 2;  // wgmma descriptor layout types

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// wait until the barrier's phase differs from `parity`
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                            int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                            int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma's shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units), layout type (swizzle)
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo, uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (layout << 62);
}

template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D[64, 256] = A[64, 16] . B[16, 256] + (scale_d ? D : 0), A and B from
// shared memory; TB: B is MN-major (1) or K-major (0)
template <int TB>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %131, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, %130;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "n"(TB), "r"(scale_d));
}

// One CTA: Fmt::kStages ring stages, then kBBufs widened tiles, then the
// full and empty barriers, from a 1024-byte-aligned base (the swizzle atom).
template <class F>
constexpr int smem_bytes() {
  return F::kStages * F::kStageBytes + kBBufs * kBBytes + 2 * F::kStages * 8 + 1024;
}

// Grid: (ceil(M / kBM), ceil(O / kBN), splits); split z covers k-steps
// [z * per, min(nsteps, (z + 1) * per)). `hi`: a column offset the format
// may use (int4: D/2, where h's high half starts). `colscale`: per-output
// fp32 scale (int8) or null.
template <class F>
__global__ void __launch_bounds__(kThreads, 1)
wq_gemm_kernel(const __grid_constant__ CUtensorMap tmA, const __grid_constant__ CUtensorMap tmW,
               const __grid_constant__ CUtensorMap tmS, const float* __restrict__ colscale,
               __nv_bfloat16* __restrict__ y, float* __restrict__ part, int M, int O, int nsteps, int per,
               int hi) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* smem = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  uint8_t* bbuf = smem + F::kStages * F::kStageBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(bbuf + kBBufs * kBBytes);
  uint64_t* empty = full + F::kStages;

  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int t0 = blockIdx.z * per;
  const int nt = min(nsteps, t0 + per) - t0;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int i = 0; i < F::kStages; ++i) {
      mbar_init(&full[i], 1);   // the producer's expect_tx; the bytes complete it
      mbar_init(&empty[i], 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {  // the producer warp: one thread keeps the ring full
    if (tid == kConsumers) {
      for (int t = 0; t < nt; ++t) {
        const int st = t % F::kStages;
        if (t >= F::kStages) mbar_wait(&empty[st], ((t / F::kStages) - 1) & 1);
        mbar_expect_tx(&full[st], F::kStageBytes);
        F::load(&tmA, &tmW, &tmS, smem + st * F::kStageBytes, &full[st], t0 + t, m0, n0, hi);
      }
    }
    return;
  }

  const int wg = tid >> 7;
  // no instruction but wgmma may define acc while MMAs are in flight, or
  // ptxas serializes them: the first MMA starts from zero (scale_d = 0)
  // instead of zeroed registers, and the registers are fenced only after
  // the last wait
  float acc[128];

  for (int t = 0; t < nt; ++t) {
    const int st = t % F::kStages;
    const uint8_t* stage = smem + st * F::kStageBytes;
    uint8_t* b = bbuf + (t % kBBufs) * kBBytes;
    mbar_wait(&full[st], (t / F::kStages) & 1);
    // b was last read by the MMAs of step t - 3: this warpgroup waited for
    // its own at step t - 1, the other one before the barrier of step t - 1
    F::widen(stage, b, tid);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // generic stores -> wgmma reads
    asm volatile("bar.sync 1, 256;\n" ::: "memory");                 // both halves of b written
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wgmma_m64n256k16<F::kTransB>(acc, F::desc_a(stage, wg, j), F::desc_b(b, j), (t | j) != 0);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");  // step t - 1's MMAs are done
    if (t > 0 && (tid & 127) == 0) mbar_arrive(&empty[(t - 1) % F::kStages]);
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_regs(acc);

  // accumulator layout: register i of lane l in warp w holds row
  // 16w + l/4 + 8((i/2)&1), column 8(i/4) + 2(l&3) + (i&1)
  const int lane = tid & 31;
  const int row0 = m0 + wg * 64 + ((tid & 127) >> 5) * 16 + (lane >> 2);
  const int col0 = n0 + 2 * (lane & 3);
  const bool even = (O & 1) == 0;
#pragma unroll
  for (int i = 0; i < 128; i += 2) {
    const int row = row0 + 8 * ((i >> 1) & 1);
    const int col = col0 + 8 * (i >> 2);
    if (row >= M || col >= O) continue;
    const bool two = col + 1 < O;
    float v0 = acc[i], v1 = acc[i + 1];
    if constexpr (F::kColScale) {
      v0 *= colscale[col];
      if (two) v1 *= colscale[col + 1];
    }
    if (part != nullptr) {
      float* p = part + (static_cast<size_t>(blockIdx.z) * M + row) * O + col;
      p[0] = v0;
      if (two) p[1] = v1;
    } else {
      __nv_bfloat16* p = y + static_cast<size_t>(row) * O + col;
      if (two && even) {
        *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
      } else {
        p[0] = __float2bfloat16_rn(v0);
        if (two) p[1] = __float2bfloat16_rn(v1);
      }
    }
  }
}

// y = the sum over the S split partials part [S, n] (fixed order), cast
template <typename T>
__global__ void splitk_reduce_kernel(const float* __restrict__ part, T* __restrict__ y, int S, size_t n) {
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float a = part[i];
    for (int s = 1; s < S; ++s) a += part[static_cast<size_t>(s) * n + i];
    if constexpr (sizeof(T) == 4)
      y[i] = a;
    else
      y[i] = __float2bfloat16_rn(a);
  }
}

template <typename T>
cudaError_t splitk_reduce(const float* part, void* y, int S, size_t n, cudaStream_t st) {
  const int threads = 256;
  const size_t want = (n + threads - 1) / threads;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  splitk_reduce_kernel<T><<<blocks, threads, 0, st>>>(part, static_cast<T*>(y), S, n);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

inline int num_sms() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 132;
  }
  return n;
}

struct Plan {
  dim3 grid;
  int per;     // k-steps per split
  int splits;
};

// Split K only while the tiles leave at least half the SMs idle, each split
// keeping kMinStepsPerSplit k-steps.
inline Plan plan(int M, int O, int nsteps) {
  const int mt = (M + kBM - 1) / kBM;
  const int nt = (O + kBN - 1) / kBN;
  int want = num_sms() / (mt * nt);
  const int cap = nsteps / kMinStepsPerSplit;
  if (want > cap) want = cap;
  if (want < 1) want = 1;
  Plan p;
  p.per = (nsteps + want - 1) / want;
  p.splits = (nsteps + p.per - 1) / p.per;
  p.grid = dim3(mt, nt, p.splits);
  return p;
}

// fp32 elements of split-K workspace a call needs (0: no split)
inline size_t workspace(int M, int O, int nsteps) {
  const Plan p = plan(M, O, nsteps);
  return p.splits > 1 ? static_cast<size_t>(p.splits) * M * O : 0;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A tiled tensor map over a row-major tensor: dims and boxes innermost
// first, strides (rank - 1 of them) in bytes; out-of-bounds reads are zeros.
inline bool encode(CUtensorMap* map, CUtensorMapDataType type, int rank, const void* ptr,
                   const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box,
                   CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_fn();
  const cuuint32_t ones[3] = {1, 1, 1};
  return fn != nullptr &&
         fn(map, type, rank, const_cast<void*>(ptr), dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
            swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// h [M, K] bf16 row-major as wgmma's A: boxes of `box_k` columns x kBM rows
inline bool encode_h(CUtensorMap* map, const void* h, int M, int K, int box_k, CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(M)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_k), kBM};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, h, dims, strides, box, swizzle);
}

template <class F>
cudaError_t launch(const CUtensorMap& a, const CUtensorMap& w, const CUtensorMap& s, const float* colscale,
                   void* y, float* work, int M, int O, int nsteps, int hi, cudaStream_t st) {
  const Plan p = plan(M, O, nsteps);
  float* part = p.splits > 1 ? work : nullptr;
  if (p.splits > 1 && part == nullptr) return cudaErrorInvalidValue;
  constexpr int smem = smem_bytes<F>();
  static bool opted_in = false;  // above 48 KB of dynamic shared memory only after opting in
  if (!opted_in) {
    const cudaError_t err =
        cudaFuncSetAttribute(wq_gemm_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  wq_gemm_kernel<F><<<p.grid, kThreads, smem, st>>>(a, w, s, colscale, static_cast<__nv_bfloat16*>(y),
                                                    part, M, O, nsteps, p.per, hi);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || part == nullptr) return err;
  return splitk_reduce<__nv_bfloat16>(part, y, p.splits, static_cast<size_t>(M) * O, st);
}

}  // namespace wq
}  // namespace
