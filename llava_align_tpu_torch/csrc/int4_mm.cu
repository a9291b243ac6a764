// Weight-only int4 (group 128) stacked GEMM for Hopper (sm_90a):
//   y[B,O] = h[B, :D/2] . W_lo + h[B, D/2:] . W_hi,  W = nibble x group scale.
//
// Replaces the TPU kernel llava_align_tpu/ops/quant.py:_make_int4_stacked_kernel
// (wrapper int4_matmul_stacked, dispatch int4_matmul_stacked_dispatch), which
// runs every decoder linear of the int4 config (fused qkv, o, fused gate|up,
// down) at every row count, prefill and decode.
//
//   h   [B, D]        activations, contiguous (bf16; fp32 in the skinny regime)
//   q4  [L, D/2, O]   int8, two int4 codes per byte, O contiguous, split-half:
//                     the low nibble of q4[d, o] is W[d, o], the high nibble
//                     W[D/2 + d, o]; layer li is a pointer offset, no copy
//   gs  [L, D/128, O] fp32 group scales: rows d of the low half use group
//                     d/128, rows of the high half group D/256 + d/128
//   y   [B, O]        output in h's dtype
//
// Unpack, exact: lo = ((p & 15) ^ 8) - 8, hi = p >> 4 (arithmetic). The
// skinny and mma.sync regimes widen both to fp32 without an int->float
// instruction: (nibble + 8) is placed as the low mantissa byte of 2^23 by a
// byte-permute, then 2^23 + 8 is subtracted; the wgmma regime does the same
// in bf16 pairs (Int4Fmt::widen).
//
// Three regimes, picked by row count: up to kSkinnyMaxRows, below
// kWgmmaMinRows, and from it on (both crossovers measured on the H100;
// ops/quant.py mirrors them as INT4_SKINNY_MAX_ROWS and
// INT4_WGMMA_MIN_ROWS):
//
// * Skinny (one or two rows): weight streaming on the CUDA cores. Its bound
//   at a few rows is weight bytes: each packed byte feeds 2*B multiply-adds,
//   far below the ~295 operations per byte at which the card leaves its
//   memory bound; but from three rows on the unpack and FMA work saturates
//   the CUDA cores, and the tensor cores are faster. A lane owns 4
//   consecutive output columns and reads one 32-bit word per packed row (a
//   warp: 128 contiguous bytes), 32 rows at a time in registers; the h rows
//   (both halves) are staged in shared memory as fp32 and read as
//   broadcasts. Each 128-row group is summed in fp32 per half, then
//   multiplied once by its scale and added to the total (one multiply per
//   group, not per weight). The 13B stacks have too few column tiles to
//   fill 132 SMs, so D is split over blocks by whole groups (split-K); each
//   split writes fp32 partials to a workspace and a second small kernel
//   sums them in a fixed order (deterministic) and casts.
// * mma.sync tiles (3 to 32 rows: the 18-row grouped decode step and the
//   microbenchmark twins' 16): bf16 tensor-core MMA (mma.sync m16n8k16,
//   fp32 accumulators). A block owns 32 rows x 128 columns and walks
//   D/2 in steps of 32 packed rows, which always lie inside one group. Per
//   step it unpacks the int4 tile, multiplies by the group scale rounded to
//   bf16 and rounds the product to bf16 (as the TPU kernel does in bf16),
//   and writes it to shared memory as one k = 64 slab: 32 low-half rows
//   paired with h[:, d-range] and 32 high-half rows paired with h[:, D/2 +
//   d-range]. Fragments come from shared memory by ldmatrix (.trans for the
//   [k][n] weight slab). The next step's global loads are issued before the
//   current step's MMAs (register double buffering). At these rows the
//   bound is weight bytes; the wgmma regime's 128-row tiles, mostly zero
//   rows here, measured 3-10% slower at the 13B stacks at 3-18 rows (a tie
//   at 32) and 12-28% slower at the 7B stacks at 3-32 rows, and 40-49%
//   faster at 72 rows (NVIDIA H100 80GB HBM3, 700 W; PERF.md), so they
//   take over above 32 rows.
// * wgmma (the prefills' 2048-4608 rows and the 72-row grouped decode
//   step): the main loop of wq_gemm.cuh with the Int4Fmt format below. Its
//   bound at prefill rows is tensor-core operations, which mma.sync reached
//   only at 25-29% of the card's bf16 rate; wgmma fed by a TMA ring, with
//   the int4 tile widened to bf16 pairs beside the running MMAs, is the
//   design for that. At 72 rows the bound is weight bytes: each weight tile
//   is read once per 128-row block, three stages ahead.
// No dense weight is ever written to device memory in any regime.
//
// C interface (bound with ctypes): every pointer and the stream are void*,
// launches go on the caller's stream, nothing is allocated (the caller
// passes the split-K workspace, sized by int4_mm_workspace), and the return
// value is cudaGetLastError() after the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wq_gemm.cuh"

namespace {

constexpr int kGroup = 128;        // rows of W per scale group
constexpr int kSkinnyMaxRows = 2;  // rows up to here run the skinny regime
constexpr int kWgmmaMinRows = 33;  // rows from here on run the wgmma regime

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Four packed bytes (four output columns of one packed row) -> their four low
// and four high nibbles as exact fp32 values in [-8, 7].
__device__ __forceinline__ void unpack4(uint32_t w, float lo[4], float hi[4]) {
  const uint32_t ulo = (w & 0x0F0F0F0Fu) ^ 0x08080808u;         // lo + 8, per byte
  const uint32_t uhi = ((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;  // hi + 8, per byte
  const float bias = 8388616.0f;                                // 2^23 + 8
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    lo[j] = __uint_as_float(__byte_perm(ulo, 0x4B000000u, 0x7650 + j)) - bias;
    hi[j] = __uint_as_float(__byte_perm(uhi, 0x4B000000u, 0x7650 + j)) - bias;
  }
}

// ---------------------------------------------------------------------------
// skinny regime
// ---------------------------------------------------------------------------

constexpr int kSkCols = 4;   // output columns per lane (one 32-bit word per packed row)
constexpr int kSkSlab = 32;  // packed rows held in registers at once
constexpr int kSkTileCols = 32 * kSkCols;

// Grid: (ceil(O / 128) column tiles, splits); block: one warp, NB = B rows.
// Split s covers groups [s * gps, min(Gh, (s + 1) * gps)) of each half.
template <typename T, int NB>
__global__ void __launch_bounds__(32)
int4_skinny_kernel(const T* __restrict__ h, const uint8_t* __restrict__ q,
                   const float* __restrict__ gs, T* __restrict__ y, float* __restrict__ part,
                   int B, int O, int Dp, int gps) {
  __shared__ float hs[2][NB][kSkSlab];
  const int lane = threadIdx.x & 31;
  const int col = blockIdx.x * kSkTileCols + lane * kSkCols;
  const int D = 2 * Dp;
  const int Gh = Dp / kGroup;
  const int g_begin = blockIdx.y * gps;
  const int g_end = min(Gh, g_begin + gps);
  const bool col_ok = col < O;

  float tot[NB][kSkCols];
#pragma unroll
  for (int i = 0; i < NB; ++i)
#pragma unroll
    for (int c = 0; c < kSkCols; ++c) tot[i][c] = 0.f;

  for (int g = g_begin; g < g_end; ++g) {
    float acc_lo[NB][kSkCols], acc_hi[NB][kSkCols];
#pragma unroll
    for (int i = 0; i < NB; ++i)
#pragma unroll
      for (int c = 0; c < kSkCols; ++c) acc_lo[i][c] = acc_hi[i][c] = 0.f;

    for (int slab = 0; slab < kGroup / kSkSlab; ++slab) {
      const int d0 = g * kGroup + slab * kSkSlab;
      uint32_t w[kSkSlab];
#pragma unroll
      for (int r = 0; r < kSkSlab; ++r)
        w[r] = col_ok ? __ldg(reinterpret_cast<const uint32_t*>(q + (size_t)(d0 + r) * O + col))
                      : 0u;
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        hs[0][i][lane] = to_float(h[(size_t)i * D + d0 + lane]);
        hs[1][i][lane] = to_float(h[(size_t)i * D + Dp + d0 + lane]);
      }
      __syncwarp();
#pragma unroll
      for (int r = 0; r < kSkSlab; ++r) {
        float lo[4], hi[4];
        unpack4(w[r], lo, hi);
#pragma unroll
        for (int i = 0; i < NB; ++i) {
          const float xl = hs[0][i][r];
          const float xh = hs[1][i][r];
#pragma unroll
          for (int c = 0; c < kSkCols; ++c) {
            acc_lo[i][c] = fmaf(xl, lo[c], acc_lo[i][c]);
            acc_hi[i][c] = fmaf(xh, hi[c], acc_hi[i][c]);
          }
        }
      }
      __syncwarp();
    }
    if (col_ok) {
      const float4 sl = __ldg(reinterpret_cast<const float4*>(gs + (size_t)g * O + col));
      const float4 sh = __ldg(reinterpret_cast<const float4*>(gs + (size_t)(Gh + g) * O + col));
      const float s_lo[4] = {sl.x, sl.y, sl.z, sl.w};
      const float s_hi[4] = {sh.x, sh.y, sh.z, sh.w};
#pragma unroll
      for (int i = 0; i < NB; ++i)
#pragma unroll
        for (int c = 0; c < kSkCols; ++c)
          tot[i][c] = fmaf(acc_hi[i][c], s_hi[c], fmaf(acc_lo[i][c], s_lo[c], tot[i][c]));
    }
  }

  if (!col_ok) return;
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    if (part != nullptr) {
      *reinterpret_cast<float4*>(part + ((size_t)blockIdx.y * B + i) * O + col) =
          make_float4(tot[i][0], tot[i][1], tot[i][2], tot[i][3]);
    } else {
#pragma unroll
      for (int c = 0; c < kSkCols; ++c) y[(size_t)i * O + col + c] = from_float<T>(tot[i][c]);
    }
  }
}

// ---------------------------------------------------------------------------
// tiled regime (bf16 tensor cores)
// ---------------------------------------------------------------------------

constexpr int kTKp = 32;             // packed rows per k-step
constexpr int kTK = 2 * kTKp;        // k per step: 32 low-half + 32 high-half rows
constexpr int kAStride = kTK + 8;    // bf16 per A row in shared memory (ldmatrix without conflicts)

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const __nv_bfloat16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const __nv_bfloat16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// One tile shape of the tiled regime: BM rows x BN columns per block,
// WARPS_M x WARPS_N warps, each owning a (BM / WARPS_M) x (BN / WARPS_N)
// piece; MINB blocks per SM asked of the register allocator.
template <int BM_, int BN_, int WARPS_M_, int WARPS_N_, int MINB_>
struct TileCfg {
  static constexpr int BM = BM_, BN = BN_, WARPS_M = WARPS_M_, WARPS_N = WARPS_N_, MINB = MINB_;
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  static constexpr int WM = BM / WARPS_M;  // rows per warp
  static constexpr int WN = BN / WARPS_N;  // columns per warp
  static constexpr int MT = WM / 16;       // m16 tiles per warp
  static constexpr int NT = WN / 8;        // n8 tiles per warp (pairs load by one ldmatrix)
  static constexpr int WSTRIDE = BN + 8;   // bf16 per W row in shared memory
  static constexpr int W_ROW_THREADS = BN / 4;                 // 4 columns (one word) each
  static constexpr int W_ROWS_PER_PASS = THREADS / W_ROW_THREADS;
  static constexpr int W_PASSES = kTKp / W_ROWS_PER_PASS;      // words per thread per step
  static constexpr int A_CHUNKS = BM * 8 / THREADS;            // 16-byte chunks per thread per step
  static constexpr int SMEM = 2 * (BM * kAStride + kTK * WSTRIDE) * (int)sizeof(__nv_bfloat16);
  static_assert(WM % 16 == 0 && WN % 16 == 0, "warp tile");
  static_assert(THREADS % W_ROW_THREADS == 0 && kTKp % W_ROWS_PER_PASS == 0, "weight tile");
  static_assert((BM * 8) % THREADS == 0, "activation tile");
};

// Grid: (ceil(O / BN), ceil(M / BM), splits). Split s covers k-steps
// [s * sps, min(Dp / 32, (s + 1) * sps)).
template <class C>
__global__ void __launch_bounds__(C::THREADS, C::MINB)
int4_tiled_kernel(const __nv_bfloat16* __restrict__ h, const uint8_t* __restrict__ q,
                  const float* __restrict__ gs, __nv_bfloat16* __restrict__ y,
                  float* __restrict__ part, int M, int O, int Dp, int sps) {
  constexpr int BM = C::BM, MT = C::MT, NT = C::NT, WS = C::WSTRIDE;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [2][BM][kAStride]
  __nv_bfloat16* Ws = As + 2 * BM * kAStride;                       // [2][kTK][WSTRIDE]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp / C::WARPS_N;
  const int wn = warp % C::WARPS_N;
  const int n0 = blockIdx.x * C::BN;
  const int m0 = blockIdx.y * BM;
  const int D = 2 * Dp;
  const int Gh = Dp / kGroup;
  const int nsteps = Dp / kTKp;
  const int s_begin = blockIdx.z * sps;
  const int s_end = min(nsteps, s_begin + sps);

  // this thread's share of a step's weight tile: packed rows
  // wr0 + W_ROWS_PER_PASS * j at 4 columns wc..wc+3 (a warp reads 128
  // contiguous bytes of one row)
  const int wc = (tid % C::W_ROW_THREADS) * 4;
  const int wr0 = tid / C::W_ROW_THREADS;
  const bool wcol_ok = n0 + wc < O;

  uint32_t wreg[C::W_PASSES];
  float4 sreg_lo, sreg_hi;
  uint4 areg[C::A_CHUNKS];

  auto load_global = [&](int step) {
    const int d0 = step * kTKp;
#pragma unroll
    for (int j = 0; j < C::W_PASSES; ++j)
      wreg[j] = wcol_ok ? __ldg(reinterpret_cast<const uint32_t*>(
                              q + (size_t)(d0 + wr0 + C::W_ROWS_PER_PASS * j) * O + n0 + wc))
                        : 0u;
    const int g = d0 / kGroup;
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    sreg_lo = wcol_ok ? __ldg(reinterpret_cast<const float4*>(gs + (size_t)g * O + n0 + wc)) : z;
    sreg_hi = wcol_ok ? __ldg(reinterpret_cast<const float4*>(gs + (size_t)(Gh + g) * O + n0 + wc))
                      : z;
#pragma unroll
    for (int c = 0; c < C::A_CHUNKS; ++c) {
      const int idx = tid + c * C::THREADS;
      const int row = idx >> 3;
      const int ch = idx & 7;  // chunks 0-3: h[:, d0 + 8ch], 4-7: h[:, Dp + d0 + 8(ch-4)]
      const int hc = ch < 4 ? d0 + ch * 8 : Dp + d0 + (ch - 4) * 8;
      areg[c] = m0 + row < M
                    ? __ldg(reinterpret_cast<const uint4*>(h + (size_t)(m0 + row) * D + hc))
                    : make_uint4(0u, 0u, 0u, 0u);
    }
  };

  auto store_smem = [&](int buf) {
    __nv_bfloat16* A = As + buf * BM * kAStride;
    __nv_bfloat16* W = Ws + buf * kTK * WS;
#pragma unroll
    for (int c = 0; c < C::A_CHUNKS; ++c) {
      const int idx = tid + c * C::THREADS;
      *reinterpret_cast<uint4*>(A + (idx >> 3) * kAStride + (idx & 7) * 8) = areg[c];
    }
    // the group scale rounded to bf16, the product rounded to bf16: the TPU
    // kernel's bf16 multiply
    const float sl[4] = {round_bf16(sreg_lo.x), round_bf16(sreg_lo.y), round_bf16(sreg_lo.z),
                         round_bf16(sreg_lo.w)};
    const float sh[4] = {round_bf16(sreg_hi.x), round_bf16(sreg_hi.y), round_bf16(sreg_hi.z),
                         round_bf16(sreg_hi.w)};
#pragma unroll
    for (int j = 0; j < C::W_PASSES; ++j) {
      float lo[4], hi[4];
      unpack4(wreg[j], lo, hi);
      const int r = wr0 + C::W_ROWS_PER_PASS * j;
      *reinterpret_cast<uint2*>(W + r * WS + wc) =
          make_uint2(pack_bf16x2(lo[0] * sl[0], lo[1] * sl[1]),
                     pack_bf16x2(lo[2] * sl[2], lo[3] * sl[3]));
      *reinterpret_cast<uint2*>(W + (kTKp + r) * WS + wc) =
          make_uint2(pack_bf16x2(hi[0] * sh[0], hi[1] * sh[1]),
                     pack_bf16x2(hi[2] * sh[2], hi[3] * sh[3]));
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  auto compute = [&](int buf) {
    const __nv_bfloat16* A = As + buf * BM * kAStride;
    const __nv_bfloat16* W = Ws + buf * kTK * WS;
#pragma unroll
    for (int kk = 0; kk < kTK / 16; ++kk) {
      uint32_t af[MT][4];
      uint32_t bf[NT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldmatrix_x4(af[mt], A + (wm * C::WM + mt * 16 + (lane & 15)) * kAStride + kk * 16 +
                                (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, W + (kk * 16 + (lane & 15)) * WS + wn * C::WN + np * 16 +
                                 (lane >> 4) * 8);
        bf[2 * np][0] = r[0];
        bf[2 * np][1] = r[1];
        bf[2 * np + 1][0] = r[2];
        bf[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[mt][nt], af[mt], bf[nt]);
    }
  };

  if (s_begin < s_end) {
    load_global(s_begin);
    store_smem(0);
    __syncthreads();
    for (int s = s_begin; s < s_end; ++s) {
      const int buf = (s - s_begin) & 1;
      const bool more = s + 1 < s_end;
      if (more) load_global(s + 1);  // in flight during this step's MMAs
      compute(buf);
      if (more) store_smem(buf ^ 1);
      __syncthreads();
    }
  }

  const int gid = lane >> 2;
  const int tig = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = n0 + wn * C::WN + nt * 8 + tig * 2;
      if (col >= O) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm * C::WM + mt * 16 + gid + half * 8;
        if (row >= M) continue;
        const float v0 = acc[mt][nt][2 * half];
        const float v1 = acc[mt][nt][2 * half + 1];
        if (part != nullptr)
          *reinterpret_cast<float2*>(part + ((size_t)blockIdx.z * M + row) * O + col) =
              make_float2(v0, v1);
        else
          *reinterpret_cast<__nv_bfloat162*>(y + (size_t)row * O + col) =
              __floats2bfloat162_rn(v0, v1);
      }
    }
}

// ---------------------------------------------------------------------------
// wgmma regime (rows from kWgmmaMinRows on): the main loop of
// wq_gemm.cuh with this int4 format. A k-step is 32 packed rows d0..d0+31,
// inside one group: TMA brings h[:, d0..] and h[:, D/2 + d0..] as two
// [128 rows][32] tiles, 64-byte swizzled (wgmma's K-major A), the raw
// [32][256] packed tile and the step's two group-scale rows (low half
// group g, high half group D/256 + g) as [2][256] fp32. The consumers
// unpack both nibbles, multiply by the group scale rounded to bf16 and round
// the product to bf16 (the TPU kernel's bf16 multiply), and store the
// [k 64][256] slab MN-major (output columns contiguous, as q4 stores them),
// 128-byte swizzled: wgmma reads it as B with the transpose bit. Rows 0..31
// of the slab (the low half) pair with A's first tile, rows 32..63 with the
// second.
// ---------------------------------------------------------------------------

struct Int4Fmt {
  static constexpr int kStages = 4;
  static constexpr int kAHalf = wq::kBM * 64;  // h: 128 rows x 32 bf16, one half
  static constexpr int kABytes = 2 * kAHalf;
  static constexpr int kWBytes = kTKp * wq::kBN;  // 32 packed rows x 256 columns
  static constexpr int kSBytes = 2 * wq::kBN * 4;  // two group-scale rows
  static constexpr int kStageBytes = kABytes + kWBytes + kSBytes;
  static constexpr int kTransB = 1;
  static constexpr bool kColScale = false;
  static constexpr int kNBlock = 64 * 64 * 2;  // MN-major slab: 64 columns x k 64, bf16

  static __device__ __forceinline__ void load(const CUtensorMap* a, const CUtensorMap* w, const CUtensorMap* s,
                                              uint8_t* stage, uint64_t* bar, int step, int m0, int n0,
                                              int hi) {
    const int d0 = step * kTKp;
    wq::tma_load_2d(stage, a, bar, d0, m0);
    wq::tma_load_2d(stage + kAHalf, a, bar, hi + d0, m0);
    wq::tma_load_2d(stage + kABytes, w, bar, n0, d0);
    wq::tma_load_3d(stage + kABytes + kWBytes, s, bar, n0, d0 / kGroup, 0);
  }

  // the half tile (j / 2) of warpgroup wg, k16 slice j % 2: 64-byte rows,
  // 8-row atoms 512 bytes apart
  static __device__ __forceinline__ uint64_t desc_a(const uint8_t* stage, int wg, int j) {
    return wq::desc(stage + (j >> 1) * kAHalf + wg * 64 * 64 + 32 * (j & 1), 16, 512, wq::kSw64);
  }
  // MN-major: 64-column blocks kNBlock apart (leading), 8-k atoms 1024 apart
  // (stride); k16 slice j starts 16 rows of 128 bytes further
  static __device__ __forceinline__ uint64_t desc_b(const uint8_t* b, int j) {
    return wq::desc(b + 2048 * j, kNBlock, 1024, wq::kSw128);
  }

  // thread: columns c8..c8+7, packed rows warp + 8i; k row r of the slab
  // holds columns n at block n / 64, 16-byte chunk ((n % 64) / 8) ^ (r % 8).
  // Widening works on bf16 pairs: a nibble n, flipped to n ^ 8, becomes the
  // low mantissa bits of bf16 128 (0x4300), the exact value 128 + (n ^ 8);
  // minus 136 that is the signed code, exact; the bf16 multiply by the
  // bf16-rounded scale rounds the exact product to bf16, as the TPU kernel's
  // bf16 multiply does. Three bf16x2 operations and a few bit operations
  // per two weights, where fp32 needs four operations per weight.
  static __device__ __forceinline__ void widen(const uint8_t* stage, uint8_t* b, int tid) {
    const uint8_t* raw = stage + kABytes;
    const float* sc = reinterpret_cast<const float*>(stage + kABytes + kWBytes);
    const int c8 = (tid & 31) * 8;
    __nv_bfloat162 sl[4], sh[4];
#pragma unroll
    for (int e = 0; e < 8; e += 4) {
      const float4 l = *reinterpret_cast<const float4*>(sc + c8 + e);
      const float4 h = *reinterpret_cast<const float4*>(sc + wq::kBN + c8 + e);
      sl[e / 2] = __floats2bfloat162_rn(l.x, l.y), sl[e / 2 + 1] = __floats2bfloat162_rn(l.z, l.w);
      sh[e / 2] = __floats2bfloat162_rn(h.x, h.y), sh[e / 2 + 1] = __floats2bfloat162_rn(h.z, h.w);
    }
    const __nv_bfloat162 bias = __floats2bfloat162_rn(136.f, 136.f);
    uint8_t* blk = b + (c8 >> 6) * kNBlock;
    const int chunk = (c8 & 63) >> 3;
#pragma unroll
    for (int i = 0; i < kTKp / 8; ++i) {
      const int d = (tid >> 5) + 8 * i;
      const uint2 v = *reinterpret_cast<const uint2*>(raw + d * wq::kBN + c8);
      uint32_t lo[4], hi[4];
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        // columns 2p, 2p + 1: their bytes, flipped, in the low byte of each half
        const uint32_t x = __byte_perm((p < 2 ? v.x : v.y) ^ 0x88888888u, 0u, (p & 1) ? 0x4342 : 0x4140);
        const uint32_t l = (x & 0x000F000Fu) | 0x43004300u;
        const uint32_t h = ((x >> 4) & 0x000F000Fu) | 0x43004300u;
        const __nv_bfloat162 wl = __hmul2(__hsub2(*reinterpret_cast<const __nv_bfloat162*>(&l), bias), sl[p]);
        const __nv_bfloat162 wh = __hmul2(__hsub2(*reinterpret_cast<const __nv_bfloat162*>(&h), bias), sh[p]);
        lo[p] = *reinterpret_cast<const uint32_t*>(&wl);
        hi[p] = *reinterpret_cast<const uint32_t*>(&wh);
      }
      const int off = (chunk ^ (d & 7)) << 4;  // (32 + d) % 8 == d % 8
      *reinterpret_cast<uint4*>(blk + d * 128 + off) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      *reinterpret_cast<uint4*>(blk + (kTKp + d) * 128 + off) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    }
  }
};

cudaError_t run_wgmma(const void* h, const uint8_t* q, const float* gs, void* y, float* work, int M, int O,
                      int Dp, cudaStream_t st) {
  const int Gh = Dp / kGroup;
  CUtensorMap ta, tw, ts;
  const cuuint64_t wdims[2] = {static_cast<cuuint64_t>(O), static_cast<cuuint64_t>(Dp)};
  const cuuint64_t wstrides[1] = {static_cast<cuuint64_t>(O)};
  const cuuint32_t wbox[2] = {wq::kBN, kTKp};
  // gs [D/128, O] as [2 halves][Gh][O]: one box brings both halves' rows
  const cuuint64_t sdims[3] = {static_cast<cuuint64_t>(O), static_cast<cuuint64_t>(Gh), 2};
  const cuuint64_t sstrides[2] = {static_cast<cuuint64_t>(O) * 4, static_cast<cuuint64_t>(Gh) * O * 4};
  const cuuint32_t sbox[3] = {wq::kBN, 1, 2};
  if (!wq::encode_h(&ta, h, M, 2 * Dp, kTKp, CU_TENSOR_MAP_SWIZZLE_64B) ||
      !wq::encode(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, q, wdims, wstrides, wbox, CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !wq::encode(&ts, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, gs, sdims, sstrides, sbox, CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorInvalidValue;
  return wq::launch<Int4Fmt>(ta, tw, ts, nullptr, y, work, M, O, Dp / kTKp, Dp, st);
}

// ---------------------------------------------------------------------------
// host side: one plan for both entry points
// ---------------------------------------------------------------------------

// The mma.sync regime's tile shape (up to 32 rows), the fastest of the
// shapes timed at the 13B stacks (PERF.md).
using TileSmall = TileCfg<32, 128, 1, 4, 4>;
static_assert(kWgmmaMinRows == TileSmall::BM + 1, "the mma.sync tiles take one row tile");

enum class Regime { kSkinny, kSmall, kWgmma };

struct Plan {
  Regime regime;
  dim3 grid;
  int per;     // groups (skinny) or k-steps (mma.sync tiles) per split
  int splits;
};

// Split D when the row and column tiles alone leave the card short of
// `target` blocks; a split keeps at least `min_per` units of work.
void split_k(Plan& p, int base, int units, int target, int min_per) {
  int want = (target + base - 1) / base;
  const int cap = units / min_per > 1 ? units / min_per : 1;
  if (want > cap) want = cap;
  p.per = (units + want - 1) / want;
  p.splits = (units + p.per - 1) / p.per;
}

template <class C>
void plan_tiled(Plan& p, int B, int O, int Dp) {
  const int tiles = (O + C::BN - 1) / C::BN;
  const int mtiles = (B + C::BM - 1) / C::BM;
  // MINB blocks per SM in flight; a split keeps at least 4 k-steps
  split_k(p, tiles * mtiles, Dp / kTKp, C::MINB * wq::num_sms(), 4);
  p.grid = dim3(tiles, mtiles, p.splits);
}

Plan make_plan(int B, int O, int D) {
  Plan p{};
  const int Dp = D / 2;
  if (B <= kSkinnyMaxRows) {
    p.regime = Regime::kSkinny;
    const int tiles = (O + kSkTileCols - 1) / kSkTileCols;
    // about 8 warps in flight per SM to cover the memory latency
    split_k(p, tiles, Dp / kGroup, 8 * wq::num_sms(), 1);
    p.grid = dim3(tiles, p.splits);
  } else if (B >= kWgmmaMinRows) {
    p.regime = Regime::kWgmma;
    const wq::Plan w = wq::plan(B, O, Dp / kTKp);
    p.grid = w.grid, p.per = w.per, p.splits = w.splits;
  } else {
    p.regime = Regime::kSmall;
    plan_tiled<TileSmall>(p, B, O, Dp);
  }
  return p;
}

template <typename T, int NB>
void launch_skinny(const Plan& p, const void* h, const uint8_t* q, const float* gs, void* y,
                   float* part, int B, int O, int Dp, cudaStream_t st) {
  int4_skinny_kernel<T, NB><<<p.grid, 32, 0, st>>>(
      static_cast<const T*>(h), q, gs, static_cast<T*>(y), part, B, O, Dp, p.per);
}

template <typename T>
cudaError_t run_skinny(const Plan& p, const void* h, const uint8_t* q, const float* gs, void* y,
                       float* part, int B, int O, int Dp, cudaStream_t st) {
  static_assert(kSkinnyMaxRows == 2, "one instance per row count");
  if (B == 1)
    launch_skinny<T, 1>(p, h, q, gs, y, part, B, O, Dp, st);
  else
    launch_skinny<T, 2>(p, h, q, gs, y, part, B, O, Dp, st);
  return cudaGetLastError();
}

template <class C>
cudaError_t run_tiled(const Plan& p, const void* h, const uint8_t* q, const float* gs, void* y,
                      float* part, int M, int O, int Dp, cudaStream_t st) {
  // above 48 KB of dynamic shared memory only after opting in
  const cudaError_t err = cudaFuncSetAttribute(
      int4_tiled_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  int4_tiled_kernel<C><<<p.grid, C::THREADS, C::SMEM, st>>>(
      static_cast<const __nv_bfloat16*>(h), q, gs, static_cast<__nv_bfloat16*>(y), part, M, O,
      Dp, p.per);
  return cudaGetLastError();
}

bool valid(int B, int O, int D, int dtype) {
  if (B < 1 || O < 16 || O % 16 != 0 || D < 256 || D % 256 != 0) return false;
  if (dtype == 0) return B <= kSkinnyMaxRows;  // fp32 activations: skinny regime only
  return dtype == 1;
}

}  // namespace

extern "C" {

// fp32 elements of split-K workspace int4_mm_stacked needs for this call
// (0 when D is not split).
int int4_mm_workspace(int B, int O, int D) {
  if (B < 1 || D < 256) return 0;
  const Plan p = make_plan(B, O, D);
  return p.splits > 1 ? p.splits * B * O : 0;
}

// dtype: 0 = fp32 (skinny regime only), 1 = bf16. Rows B <= kSkinnyMaxRows
// run the skinny regime, B >= kWgmmaMinRows the wgmma regime, the rows
// between the mma.sync tiles. Preconditions (checked by the Python
// wrapper): group 128, D % 256 == 0, O % 16 == 0, 0 <= li < L, contiguous
// 16-byte-aligned operands, `work` holding int4_mm_workspace(...) floats.
int int4_mm_stacked(const void* h, const void* q4, const void* gs, void* y, void* work, int B,
                    int O, int D, int li, int dtype, void* stream) {
  if (!valid(B, O, D, dtype) || li < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int Dp = D / 2;
  const uint8_t* q = static_cast<const uint8_t*>(q4) + (size_t)li * Dp * O;
  const float* g = static_cast<const float*>(gs) + (size_t)li * (D / kGroup) * O;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Plan p = make_plan(B, O, D);
  float* part = p.splits > 1 ? static_cast<float*>(work) : nullptr;
  if (p.splits > 1 && part == nullptr) return static_cast<int>(cudaErrorInvalidValue);

  cudaError_t err;
  switch (p.regime) {
    case Regime::kWgmma:  // reduces its own splits
      return static_cast<int>(run_wgmma(h, q, g, y, part, B, O, Dp, st));
    case Regime::kSkinny:
      err = dtype == 1 ? run_skinny<__nv_bfloat16>(p, h, q, g, y, part, B, O, Dp, st)
                       : run_skinny<float>(p, h, q, g, y, part, B, O, Dp, st);
      break;
    default:
      err = run_tiled<TileSmall>(p, h, q, g, y, part, B, O, Dp, st);
  }
  if (err != cudaSuccess || part == nullptr) return static_cast<int>(err);
  const size_t n = static_cast<size_t>(B) * O;
  return static_cast<int>(dtype == 1 ? wq::splitk_reduce<__nv_bfloat16>(part, y, p.splits, n, st)
                                     : wq::splitk_reduce<float>(part, y, p.splits, n, st));
}

}  // extern "C"
