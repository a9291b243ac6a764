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
// skinny regime widens both to fp32 without an int->float instruction:
// (nibble + 8) is placed as the low mantissa byte of 2^23 by a
// byte-permute, then 2^23 + 8 is subtracted; the streaming and wgmma
// regimes do the same in bf16 pairs (n + 8 in the mantissa of bf16 128,
// minus 136).
//
// Three regimes, picked by dtype and row count (regime() below; the bf16
// crossovers measured on the H100, PERF.md; ops/quant.py mirrors the rule
// as int4_regime and the C entry int4_mm_regime reports it):
//
// * Skinny (fp32 activations, one or two rows): weight streaming on the
//   CUDA cores; bf16 at 1-2 rows measured faster on the streaming kernel
//   below (PERF.md), so bf16 never runs here. A lane owns 4
//   consecutive output columns and reads one 32-bit word per packed row (a
//   warp: 128 contiguous bytes), 32 rows at a time in registers; the h rows
//   (both halves) are staged in shared memory as fp32 and read as
//   broadcasts. Each 128-row group is summed in fp32 per half, then
//   multiplied once by its scale (one multiply per group, not per weight:
//   fp32 activations keep fp32 arithmetic throughout). The 13B stacks have
//   too few column tiles to fill 132 SMs, so D is split over blocks by
//   whole groups; each split writes fp32 partials to a workspace and a
//   second small kernel sums them in a fixed order and casts.
// * Streaming (bf16, the decode rows up to kStreamMaxRows: the grouped
//   path's 18- and 72-row steps, the microbenchmark twin's 16): weight
//   streaming on the tensor cores (k4s::int4_stream_kernel below, whose
//   note gives its design). Its bound is weight bytes. One launch, no
//   workspace.
// * wgmma (bf16 above kStreamMaxRows: the prefills' 2048-4608 rows): the
//   main loop of wq_gemm.cuh with the Int4Fmt format below. Its bound at
//   prefill rows is tensor-core operations; wgmma fed by a TMA ring, with
//   the int4 tile widened to bf16 pairs beside the running MMAs, is the
//   design for that.
// No dense weight is ever written to device memory in any regime.
//
// C interface (bound with ctypes): every pointer and the stream are void*,
// launches go on the caller's stream, nothing is allocated (the caller
// passes the split-K workspace, sized by int4_mm_workspace), and the return
// value is cudaGetLastError() after the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "stream_mma.cuh"
#include "wq_gemm.cuh"

namespace {

constexpr int kGroup = 128;  // rows of W per scale group
// the regime rule (regime() below; ops/quant.py mirrors it as int4_regime):
constexpr int kSkinnyMaxRows = 2;   // fp32 rows up to here: the skinny regime (fp32 takes no other)
constexpr int kStreamMaxRows = 72;  // bf16 rows up to here: the streaming kernel; above: wgmma

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
template <int NB>
__global__ void __launch_bounds__(32)
int4_skinny_kernel(const float* __restrict__ h, const uint8_t* __restrict__ q,
                   const float* __restrict__ gs, float* __restrict__ y, float* __restrict__ part,
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
        hs[0][i][lane] = h[(size_t)i * D + d0 + lane];
        hs[1][i][lane] = h[(size_t)i * D + Dp + d0 + lane];
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
      for (int c = 0; c < kSkCols; ++c) y[(size_t)i * O + col + c] = tot[i][c];
    }
  }
}

// ---------------------------------------------------------------------------
// streaming regime (bf16, decode rows): weight streaming on the tensor cores
// ---------------------------------------------------------------------------
//
// Replaces, at decode rows, the TPU kernel
// llava_align_tpu/ops/quant.py:_make_int4_stacked_kernel.
//
// What bounds it: weight bytes. One 13B layer's four stacks hold 168 MB of
// packed int4 (plus 10.5 MB of scales), about 0.050 ms at 3.35 TB/s; at
// 72 rows that layer is 45.6 GFLOP, about 270 operations per byte, still
// under the ~295 at which the card leaves its memory bound, so the MMAs
// must keep near the memory's pace too. The mma.sync tiles this replaces widened every weight to bf16 in
// fp32 arithmetic, wrote the slab to shared memory and read it back with
// ldmatrix.trans, held one 32-row step in flight in registers and reduced
// split-K in a second kernel; the wgmma regime at 72 rows ran 128-row
// tiles, 56 of 128 rows padding. Both reached 0.7-0.8 TB/s. The design:
//
// * Operands swapped, as in stream_mma.cuh: the output channels fill the
//   MMA's M, the rows of h its N. mma.sync m16n8k16 (bf16, fp32
//   accumulators), which takes A from registers, where the weight is
//   widened. A block of 8 warps owns 256 channels; warp w the 32 channels
//   [32 w, 32 w + 32) of the tile, two m16 tiles, over all of its K. An
//   instance holds 8, 16, 24, 32, 48 or 72 rows and runs all of its n8
//   tiles (rows past B are zeros): straight-line code, so that ptxas
//   overlaps the B-fragment reads of later tiles with the MMAs of earlier
//   ones (a branch per n-tile, tried first, was slower).
// * A fragment mapping for the JAX layout [D/2, O], nothing transposed. A
//   k16 slice is 8 packed rows: the low nibbles are logical k 0..7, the
//   high nibbles k 8..15. Lane (g, t) reads one 32-bit word (4 consecutive
//   channels 4g..4g+3 of the warp's 32) from packed rows 2t and 2t + 1.
//   Channel 4g + j is row g + 8 (j % 2) of m-tile j / 2 (M permuted, and y
//   stored back in the same order), and byte j of the two words gives its
//   A pairs at k {2t, 2t+1} (low nibbles) and k {2t+8, 2t+9} (high): two
//   words are a lane's A fragments for both m-tiles. Its B fragments are
//   h[r][d0 + 2t..] and h[r][D/2 + d0 + 2t..], the matching 32 bits of each
//   half, read for two n-tiles at once by one ldmatrix.x4.
// * Widening in bf16 pairs, exact: a nibble flipped by ^ 8 is n + 8, the
//   low mantissa bits of bf16 128 (0x4300), minus 136 is the signed code;
//   a pair's two weights share their channel and group, so the scale is
//   one bf16x2 multiply by the bf16-rounded scale, the product rounded to
//   bf16 once: the TPU kernel's bf16 multiply. About two operations a
//   weight. A lane keeps its 8 scales (4 channels, 2 halves) in registers
//   across the 4 k-steps of a group.
// * A cp.async ring of 4 stages (3 in flight): each k-step's raw
//   [32 packed rows][256 channels] tile (each row a contiguous run of 256
//   bytes of q4, padded by 16 bytes so that the quads' word reads fall in
//   distinct banks), h's two matching [rows][32] half-slices (padded the
//   same way for ldmatrix) and, at a group's first step, its two scale
//   rows. Channels past O and rows past B are the copy's zero fill; each
//   thread's copies are planned once, before the main loop.
// * Narrow stacks (the 13B o and down: 20 channel tiles) cannot fill 132
//   SMs: K is split over 2-8 blocks of one thread-block cluster on the
//   plan of stream_mma.cuh (smma::plan_splits) and reduced through
//   distributed shared memory in rank order (smma::reduce_store, 16-byte
//   reads of a row-major partial tile): one launch, no workspace,
//   deterministic.
// stream_mma.cuh's kernel itself cannot serve: its copy and its fragment
// mapping assume K contiguous per channel (row-major), where here a
// channel's K is strided by O. Its ring discipline, plan, launch and
// reduction are shared. Tried on the card and not kept (PERF.md): wgmma
// with A from registers (m64nNk16, N = the instance's rows, B = h by
// descriptor) in place of mma.sync, and 5-8 ring stages: neither was
// faster at 3, 18 or 72 rows.

namespace k4s {

namespace cg = cooperative_groups;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kBM = 32 * kWarps;                   // channels per block: 32 per warp
constexpr int kKP = 32;                            // packed rows per k-step: 4 k16 slices
constexpr int kStages = 4;                         // ring stages, 3 in flight (5-8 were no faster)
constexpr int kStepsPerGroup = kGroup / kKP;
constexpr int kWStride = kBM + 16;                 // bytes per packed row of a stage
constexpr int kHStride = 2 * 2 * kKP + 16;         // bytes per row of h: both halves' kKP columns
constexpr int kMaxRows = 72;                       // the largest instance
constexpr int kBlocksPerSM = 2;                    // at most 128 registers a thread

template <int NB>
struct Geo {
  static constexpr int kWBytes = kKP * kWStride;
  static constexpr int kHBytes = NB * kHStride;
  static constexpr int kSBytes = 2 * kBM * 4;      // a group's low- and high-half scale rows
  static constexpr int kStageBytes = kWBytes + kHBytes + kSBytes;
  static constexpr int kRedStride = kBM + 4;       // fp32 per row of h in the partial tile
  static constexpr int kRedBytes = NB * kRedStride * 4;
  static constexpr int kBytes = kStages * kStageBytes > kRedBytes ? kStages * kStageBytes : kRedBytes;
  static_assert(kStageBytes % 16 == 0 && kBlocksPerSM == 2 && kBytes <= smma::kSmemTwoBlocks, "shared memory");
  static_assert(kBM % (4 * smma::kMaxSplits) == 0, "splits");
};

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smma::smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x2(uint32_t r[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smma::smem_u32(p)));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) { return *reinterpret_cast<uint32_t*>(&v); }

// (n + 8 | bf16 128) pairs -> the exact signed codes times the scale pair,
// rounded to bf16
__device__ __forceinline__ uint32_t scaled_pair(uint32_t biased, uint32_t scale) {
  const __nv_bfloat162 v = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&biased),
                                   __floats2bfloat162_rn(136.f, 136.f));
  return bf16x2_bits(__hmul2(v, *reinterpret_cast<const __nv_bfloat162*>(&scale)));
}

// Grid: (S splits, ceil(O / kBM) channel tiles), cluster (S, 1, 1); split z
// walks k-steps [z * n / S, (z + 1) * n / S) of n = Dp / kKP.
template <int NB>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
int4_stream_kernel(const __nv_bfloat16* __restrict__ h, const uint8_t* __restrict__ q,
                   const float* __restrict__ gs, __nv_bfloat16* __restrict__ y, int B, int O, int Dp) {
  using G = Geo<NB>;
  constexpr int NT = NB / 8;
  extern __shared__ __align__(16) uint8_t smem[];

  cg::cluster_group cluster = cg::this_cluster();
  const int S = gridDim.x;
  const int z = blockIdx.x;
  const int o0 = blockIdx.y * kBM;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int D = 2 * Dp;
  const int Gh = Dp / kGroup;
  const int nsteps = Dp / kKP;
  const int k_begin = static_cast<int>(static_cast<long long>(z) * nsteps / S);
  const int nt_steps = static_cast<int>(static_cast<long long>(z + 1) * nsteps / S) - k_begin;
  // a split's first step, and every group's first, brings the group's scales
  auto new_group = [&](int i) { return i == 0 || (k_begin + i) % kStepsPerGroup == 0; };

  // This thread's copies, the same every step but for the step's offset:
  // kWCopies 16-byte pieces of the weight tile (packed row r, channels
  // o0 + 16 p ..), kHCopies of h (row n, piece c: c < 4 the low half's
  // columns d0 + 8 c .., else the high half's; rows B..NB-1 zero-filled)
  // and, at a group's first step, one of the scales (threads below 2 kBM / 4).
  constexpr int kWCopies = kKP * (kBM / 16) / kThreads;
  constexpr int kHCopies = (NB * 8 + kThreads - 1) / kThreads;
  const uint8_t* w_src[kWCopies];
  int w_dst[kWCopies], w_bytes[kWCopies];
#pragma unroll
  for (int j = 0; j < kWCopies; ++j) {
    const int idx = tid + j * kThreads;
    const int o = o0 + 16 * (idx % (kBM / 16));
    const bool ok = o < O;  // O % 16 == 0: a piece is whole or absent
    w_src[j] = q + static_cast<size_t>(idx / (kBM / 16)) * O + (ok ? o : 0);
    w_dst[j] = (idx / (kBM / 16)) * kWStride + 16 * (idx % (kBM / 16));
    w_bytes[j] = ok ? 16 : 0;
  }
  const __nv_bfloat16* h_src[kHCopies];
  int h_dst[kHCopies], h_bytes[kHCopies];
#pragma unroll
  for (int j = 0; j < kHCopies; ++j) {
    const int idx = tid + j * kThreads;
    const int n = idx >> 3;
    const int c = idx & 7;
    const bool ok = n < B;
    h_src[j] = h + static_cast<size_t>(ok ? n : 0) * D + (c < 4 ? 0 : Dp) + 8 * (c & 3);
    h_dst[j] = idx < NB * 8 ? n * kHStride + 16 * c : -1;
    h_bytes[j] = ok ? 16 : 0;
  }
  const int s_half = tid / (kBM / 4);
  const int s_o = o0 + 4 * (tid % (kBM / 4));
  const bool s_ok = s_o < O;
  const float* s_src = gs + static_cast<size_t>(s_half * Gh) * O + (s_ok ? s_o : 0);

  auto load_stage = [&](int i) {
    const int d0 = (k_begin + i) * kKP;
    uint8_t* st = smem + (i % kStages) * G::kStageBytes;
#pragma unroll
    for (int j = 0; j < kWCopies; ++j)
      smma::cp_async16(st + w_dst[j], w_src[j] + static_cast<size_t>(d0) * O, w_bytes[j]);
    uint8_t* hs = st + G::kWBytes;
#pragma unroll
    for (int j = 0; j < kHCopies; ++j)
      if (h_dst[j] >= 0) smma::cp_async16(hs + h_dst[j], h_src[j] + d0, h_bytes[j]);
    if (s_half < 2 && new_group(i))
      smma::cp_async16(hs + G::kHBytes + 4 * (tid % (kBM / 4)) * 4 + s_half * kBM * 4,
                       s_src + static_cast<size_t>(d0 / kGroup) * O, s_ok ? 16 : 0);
  };

  float acc[2][NT][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;
  uint32_t sc[2][4];  // [half][j]: the bf16 scale of channel 4g + j, twice

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < nt_steps) load_stage(i);
    smma::cp_async_commit();
  }

  // ldmatrix: lane l addresses row l % 8 of matrix l / 8, which is the
  // low (even) or high (odd) half of n-tile n + l / 16
  const int ld_row = ((lane >> 4) * 8 + (lane & 7)) * kHStride + ((lane >> 3) & 1) * 2 * kKP;
  const int w_col = warp * 32 + 4 * g;

  for (int i = 0; i < nt_steps; ++i) {
    smma::cp_async_wait<kStages - 2>();
    __syncthreads();  // stage i landed for all threads; stage i - 1 is free
    if (i + kStages - 1 < nt_steps) load_stage(i + kStages - 1);
    smma::cp_async_commit();

    const uint8_t* st = smem + (i % kStages) * G::kStageBytes;
    const uint8_t* hs = st + G::kWBytes;
    if (new_group(i)) {
      const float* ss = reinterpret_cast<const float*>(hs + G::kHBytes);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float4 v = *reinterpret_cast<const float4*>(ss + half * kBM + w_col);
        sc[half][0] = bf16x2_bits(__floats2bfloat162_rn(v.x, v.x));
        sc[half][1] = bf16x2_bits(__floats2bfloat162_rn(v.y, v.y));
        sc[half][2] = bf16x2_bits(__floats2bfloat162_rn(v.z, v.z));
        sc[half][3] = bf16x2_bits(__floats2bfloat162_rn(v.w, v.w));
      }
    }
    // every n-tile of the instance, unconditionally (rows past B are zeros):
    // straight-line code, so the B-fragment loads of later tiles and slices
    // overlap the MMAs of earlier ones
#pragma unroll
    for (int sl = 0; sl < kKP / 8; ++sl) {
      const uint8_t* wr = st + (8 * sl + 2 * t) * kWStride + w_col;
      const uint32_t w0 = *reinterpret_cast<const uint32_t*>(wr) ^ 0x88888888u;
      const uint32_t w1 = *reinterpret_cast<const uint32_t*>(wr + kWStride) ^ 0x88888888u;
      // a[m][0..3]: m-tile m's A fragment; channel 4g + j is its row g + 8 (j % 2)
      uint32_t a[2][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // byte j of w0 (packed row 2t) to bits 0-7, of w1 (row 2t + 1) to bits 16-23
        const uint32_t x = __byte_perm(w0, w1, j | (j << 4) | ((4 + j) << 8) | ((4 + j) << 12));
        a[j >> 1][j & 1] = scaled_pair((x & 0x000F000Fu) | 0x43004300u, sc[0][j]);
        a[j >> 1][2 + (j & 1)] = scaled_pair(((x >> 4) & 0x000F000Fu) | 0x43004300u, sc[1][j]);
      }
      const uint8_t* hb = hs + ld_row + 16 * sl;
#pragma unroll
      for (int n = 0; n + 1 < NT; n += 2) {
        uint32_t b[4];
        ldmatrix_x4(b, hb + n * 8 * kHStride);
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          smma::mma16816(acc[m][n], a[m][0], a[m][1], a[m][2], a[m][3], b[0], b[1]);
          smma::mma16816(acc[m][n + 1], a[m][0], a[m][1], a[m][2], a[m][3], b[2], b[3]);
        }
      }
      if constexpr (NT % 2 == 1) {
        uint32_t b[2];
        ldmatrix_x2(b, hb + (NT - 1) * 8 * kHStride);
#pragma unroll
        for (int m = 0; m < 2; ++m)
          smma::mma16816(acc[m][NT - 1], a[m][0], a[m][1], a[m][2], a[m][3], b[0], b[1]);
      }
    }
  }
  smma::cp_async_wait<0>();
  __syncthreads();

  // the partial tile [NB rows][kBM channels]: c0, c1 of m-tile m are
  // channel 4g + 2m, rows 2t, 2t + 1 of n-tile n; c2, c3 channel 4g + 2m + 1
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      float* r0 = red + (n * 8 + 2 * t) * G::kRedStride + w_col + 2 * m;
      float* r1 = r0 + G::kRedStride;
      r0[0] = acc[m][n][0], r1[0] = acc[m][n][1], r0[1] = acc[m][n][2], r1[1] = acc[m][n][3];
    }
  __syncthreads();
  smma::reduce_store<false>(cluster, red, G::kRedStride, kBM, nullptr, y, B, O, o0);
}

// blocks per channel tile: the streaming kernel's split plan
inline int splits(int O, int Dp) { return smma::plan_splits((O + kBM - 1) / kBM, Dp / kKP); }

template <int NB>
cudaError_t launch(const void* h, const uint8_t* q, const float* gs, void* y, int B, int O, int Dp,
                   cudaStream_t st) {
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = smma::opt_in(int4_stream_kernel<NB>, Geo<NB>::kBytes);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  return smma::launch_cluster(int4_stream_kernel<NB>, splits(O, Dp), (O + kBM - 1) / kBM, kThreads,
                              Geo<NB>::kBytes, st, static_cast<const __nv_bfloat16*>(h), q, gs,
                              static_cast<__nv_bfloat16*>(y), B, O, Dp);
}

// the instance for B rows: NB = B rounded up to 8, 16, 24, 32, 48 or 72
// (every n-tile of an instance runs, so the grouped path's 18 and 72 rows
// and the twins' 16 have instances of their own)
inline cudaError_t run(const void* h, const uint8_t* q, const float* gs, void* y, int B, int O, int Dp,
                       cudaStream_t st) {
  if (B < 1 || B > kMaxRows) return cudaErrorInvalidValue;
  if (B <= 8) return launch<8>(h, q, gs, y, B, O, Dp, st);
  if (B <= 16) return launch<16>(h, q, gs, y, B, O, Dp, st);
  if (B <= 24) return launch<24>(h, q, gs, y, B, O, Dp, st);
  if (B <= 32) return launch<32>(h, q, gs, y, B, O, Dp, st);
  if (B <= 48) return launch<48>(h, q, gs, y, B, O, Dp, st);
  return launch<72>(h, q, gs, y, B, O, Dp, st);
}

}  // namespace k4s

static_assert(kStreamMaxRows == k4s::kMaxRows, "the streaming kernel takes every bf16 row count up to the wgmma regime's");

// ---------------------------------------------------------------------------
// wgmma regime (bf16 rows above kStreamMaxRows): the main loop of
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

constexpr int kTKp = 32;  // packed rows per k-step of the wgmma regime

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
// host side
// ---------------------------------------------------------------------------

enum class Regime { kNone = -1, kSkinny = 0, kStream = 1, kWgmma = 2 };

// The regime of a call: fp32 activations only in the skinny regime (up to
// kSkinnyMaxRows rows); bf16 in the streaming kernel up to kStreamMaxRows
// rows, the wgmma regime above.
Regime regime(int B, int dtype) {
  if (B < 1) return Regime::kNone;
  if (dtype == 0) return B <= kSkinnyMaxRows ? Regime::kSkinny : Regime::kNone;
  if (dtype != 1) return Regime::kNone;
  return B <= kStreamMaxRows ? Regime::kStream : Regime::kWgmma;
}

bool valid(int B, int O, int D) { return B >= 1 && O >= 16 && O % 16 == 0 && D >= 256 && D % 256 == 0; }

// The skinny regime's plan: D split by whole groups while the column tiles
// leave the card short of about 8 warps in flight per SM (to cover the
// memory latency).
struct SkinnyPlan {
  dim3 grid;
  int per;  // groups per split
  int splits;
};

SkinnyPlan skinny_plan(int O, int Dp) {
  const int tiles = (O + kSkTileCols - 1) / kSkTileCols;
  const int groups = Dp / kGroup;
  const int target = 8 * wq::num_sms();
  int want = (target + tiles - 1) / tiles;
  if (want > groups) want = groups;
  SkinnyPlan p;
  p.per = (groups + want - 1) / want;
  p.splits = (groups + p.per - 1) / p.per;
  p.grid = dim3(tiles, p.splits);
  return p;
}

template <int NB>
void launch_skinny(const SkinnyPlan& p, const void* h, const uint8_t* q, const float* gs, void* y,
                   float* part, int B, int O, int Dp, cudaStream_t st) {
  int4_skinny_kernel<NB><<<p.grid, 32, 0, st>>>(
      static_cast<const float*>(h), q, gs, static_cast<float*>(y), part, B, O, Dp, p.per);
}

// the skinny kernel, then (when D is split) the fixed-order sum of its splits
cudaError_t run_skinny(const void* h, const uint8_t* q, const float* gs, void* y, float* work, int B, int O,
                       int Dp, cudaStream_t st) {
  static_assert(kSkinnyMaxRows == 2, "one instance per row count");
  const SkinnyPlan p = skinny_plan(O, Dp);
  float* part = p.splits > 1 ? work : nullptr;
  if (p.splits > 1 && part == nullptr) return cudaErrorInvalidValue;
  if (B == 1)
    launch_skinny<1>(p, h, q, gs, y, part, B, O, Dp, st);
  else
    launch_skinny<2>(p, h, q, gs, y, part, B, O, Dp, st);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || part == nullptr) return err;
  return wq::splitk_reduce<float>(part, y, p.splits, static_cast<size_t>(B) * O, st);
}

}  // namespace

extern "C" {

// The regime int4_mm_stacked runs for this call: 0 = skinny, 1 = the
// streaming kernel, 2 = wgmma; -1 for a shape or dtype no regime takes.
int int4_mm_regime(int B, int O, int D, int dtype) {
  return valid(B, O, D) ? static_cast<int>(regime(B, dtype)) : -1;
}

// fp32 elements of split-K workspace int4_mm_stacked needs for this call
// (0 when D is not split; the streaming kernel never needs one).
int int4_mm_workspace(int B, int O, int D, int dtype) {
  if (!valid(B, O, D)) return 0;
  switch (regime(B, dtype)) {
    case Regime::kSkinny: {
      const SkinnyPlan p = skinny_plan(O, D / 2);
      return p.splits > 1 ? p.splits * B * O : 0;
    }
    case Regime::kWgmma:
      return static_cast<int>(wq::workspace(B, O, D / 2 / kTKp));
    default:
      return 0;
  }
}

// Blocks per channel tile of the streaming kernel's split plan for this
// call (1, 2, 4 or 8), on the current device; -1 where the call takes
// another regime.
int int4_mm_splits(int B, int O, int D, int dtype) {
  return int4_mm_regime(B, O, D, dtype) == static_cast<int>(Regime::kStream) ? k4s::splits(O, D / 2) : -1;
}

// dtype: 0 = fp32 (skinny regime only), 1 = bf16; the regime as
// int4_mm_regime. Preconditions (checked by the Python wrapper): group 128,
// D % 256 == 0, O % 16 == 0, 0 <= li < L, contiguous 16-byte-aligned
// operands, `work` holding int4_mm_workspace(...) floats.
int int4_mm_stacked(const void* h, const void* q4, const void* gs, void* y, void* work, int B,
                    int O, int D, int li, int dtype, void* stream) {
  if (!valid(B, O, D) || li < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int Dp = D / 2;
  const uint8_t* q = static_cast<const uint8_t*>(q4) + (size_t)li * Dp * O;
  const float* g = static_cast<const float*>(gs) + (size_t)li * (D / kGroup) * O;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(work);
  switch (regime(B, dtype)) {
    case Regime::kStream:
      return static_cast<int>(k4s::run(h, q, g, y, B, O, Dp, st));
    case Regime::kWgmma:  // reduces its own splits
      return static_cast<int>(run_wgmma(h, q, g, y, part, B, O, Dp, st));
    case Regime::kSkinny:
      return static_cast<int>(run_skinny(h, q, g, y, part, B, O, Dp, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
