// The weight-streaming GEMM on Hopper's tensor cores (sm_90a), bf16
// activations, 1-64 rows:
//
//   y[B, O] = h[B, D] . W[li]^T,  computed as y^T[O, B] = W[li] . h^T
//
// for three formats of the row-major weight W (D, or packed D/2, contiguous
// per output channel): int8 with per-channel scales (K1/K2), split-half
// int4 with per-channel or group-128 scales (the TPU scripts' row-major
// int4) and bf16 (the TPU script's bf16 stream). csrc/int8_mm.cu owns the C
// entry points and says which TPU kernel each replaces.
//
// What bounds it: weight bytes. At 1-64 rows each weight byte feeds at most
// 64 (int8) or 128 (int4) multiply-adds, under the ~295 operations per byte
// at which the card leaves its memory bound. The CUDA-core body this
// replaces spent an fp32 FMA and an L1 load of h per weight per row, so from
// 16 rows on the CUDA cores, not the memory, set its time. The design:
//
// * Operands swapped: the output channels fill the MMA's M (16 per m-tile,
//   32 per warp), the activation rows fill N (padded to a multiple of 8).
//   Both operands are K-major as stored, so nothing is transposed.
//   mma.sync m16n8k16 (bf16, fp32 accumulators), not wgmma: its 8-wide N
//   fits 1-64 rows and its 16-row M keeps narrow stacks in many blocks;
//   K4's measurement (PERF.md) had 128-row wgmma tiles 3-28% slower
//   than mma.sync tiles at 3-32 rows.
// * A block's 8 warps are C along K (each takes one chunk of every k-step)
//   by 8 / C along the channels: C = 2 chunks (128-channel blocks) or C = 4
//   (64-channel blocks, twice the bytes of each row per k-step), so an SM
//   runs 8-16 warps to hide the latencies of shared-memory reads, widening
//   and MMAs; the chunks' sums meet in shared memory at the end.
// * One k-order inside each k16 slice for both operands: lane t of a quad
//   owns 16 consecutive columns of a 64-column chunk, and the MMA's logical
//   k {2t, 2t+1, 2t+8, 2t+9} of slice j are that run's columns 4j..4j+3.
//   So a lane's A fragments are one 16-byte shared-memory read of its own
//   raw weights (16 int8, or 16 nibbles of each split half, or 8+8 bf16),
//   widened in registers, and its B fragments two 16-byte reads of h's
//   matching columns. No widened copy of W goes to shared or device memory.
// * Widening: int8 by the byte-permute trick (a byte as the low mantissa
//   byte of 2^23, minus the bias: exact) to fp32, whose top halves are the
//   exact bf16; int4 nibbles straight into bf16 pairs (a nibble + 8 as the
//   mantissa of bf16 128, minus 136: exact). Group-128 int4 multiplies each
//   exact weight by its fp32 scale and rounds the product to bf16 before
//   the MMA: the TPU script's rounding, which the plain version keeps.
//   Per-channel scales multiply the fp32 sum once, as in the TPU kernel.
// * A cp.async ring of 3-4 stages (2-3 in flight while one is computed)
//   holds each k-step's raw weight tile (16-byte pieces XOR-swizzled by row,
//   no padding), h's matching [rows][columns] slice and, in group mode, the
//   tile's group scales. h is read from L2 once per block per k-step.
//   Ragged edges (channels past O, columns past D, rows past B) are the
//   copy's zero fill, so every D the wrappers accept runs here.
// * Narrow stacks (o and down: 32-64 channel tiles) cannot fill 132 SMs, so
//   K is split over the blocks of one thread-block cluster (2, 4 or 8:
//   plan(), from the shape and the card's SM count). Each block leaves its
//   fp32 partial tile in its own shared memory; after a cluster barrier,
//   block r sums its 1/S of the tile's channels over the S blocks in rank
//   order through distributed shared memory (fixed order: deterministic),
//   scales and stores (reduce_store). No workspace, no second kernel.
//
// The split plan (plan_splits), the cluster launch (launch_cluster) and the
// reduction (reduce_store) also serve K4's streaming kernel
// (csrc/int4_mm.cu), which streams the JAX layout [D/2, O].

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace smma {

namespace cg = cooperative_groups;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMT = 2;                        // m16 tiles per warp: 32 channels
constexpr int kMaxSplits = 8;                 // blocks per cluster (portable limit)
constexpr int kSmemLimit = 227 * 1024;
constexpr int kSmemTwoBlocks = 113 * 1024;    // per block, with two on one SM

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes global -> shared, asynchronously; `bytes` = 0 zero-fills
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mma16816(float c[4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// four int8 codes of a word -> two bf16 pairs, exact: each byte x ^ 0x80 =
// x + 128 placed as the low mantissa byte of 2^23, minus 2^23 + 128, then
// the fp32's top half (an integer below 256 is exact in bf16)
__device__ __forceinline__ void widen_i8(uint32_t word, uint32_t& p01, uint32_t& p23) {
  const uint32_t u = word ^ 0x80808080u;
  const float bias = 8388736.0f;
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - bias;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - bias;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - bias;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - bias;
  p01 = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  p23 = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

__device__ __forceinline__ uint32_t bf2_sub136(uint32_t v) {
  __nv_bfloat162 x = *reinterpret_cast<__nv_bfloat162*>(&v);
  x = __hsub2(x, __floats2bfloat162_rn(136.f, 136.f));
  return *reinterpret_cast<uint32_t*>(&x);
}

// four nibbles, each n + 8 in a byte's low bits -> two exact bf16 pairs
// (bf16 0x43NN is 128 + NN)
__device__ __forceinline__ void widen_nib(uint32_t u, uint32_t& p01, uint32_t& p23) {
  p01 = bf2_sub136(__byte_perm(u, 0x43434343u, 0x4140));
  p23 = bf2_sub136(__byte_perm(u, 0x43434343u, 0x4342));
}

// an exact bf16 pair times an fp32 scale, each product rounded to bf16
__device__ __forceinline__ uint32_t scale_pair(uint32_t p, float s) {
  const float lo = __uint_as_float(p << 16) * s;
  const float hi = __uint_as_float(p & 0xffff0000u) * s;
  __nv_bfloat162 r = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&r);
}

// ---------------------------------------------------------------------------
// Weight formats, each for C chunks per k-step. A k-step covers kRowBytes
// of every weight row and kHCols columns of h; in each (chunk, half) lane t
// of a quad owns 16 weights of a row: widen() turns its raw bytes (the
// 16-byte pieces from piece(kk, t) on) into 8 bf16 pairs in k order, paired
// with h's 16 columns at stage column h_col. A weight row's 16-byte piece p
// lies in shared memory at p ^ swz(row), so that the two rows a
// quarter-warp reads fall in other banks (no padding).
// ---------------------------------------------------------------------------

template <int C>
struct FmtInt8 {  // int8 [O, D], per-channel scale after the sum
  static constexpr int kChunks = C, kRowBytes = 64 * C, kHCols = 64 * C, kHalves = 1, kScales = 0;
  static constexpr bool kGroup = false, kColScale = true;
  static __device__ __forceinline__ size_t row_bytes(int D) { return D; }
  static __device__ __forceinline__ int swz(int row) { return (row & 1) << 2; }
  static __device__ __forceinline__ int piece(int kk, int t) { return kk * 4 + t; }
  static __device__ __forceinline__ int h_col(int kk, int, int t) { return kk * 64 + 16 * t; }
  // h column of stage column c (a multiple of 8) at k-step `step`, or -1
  static __device__ __forceinline__ int h_global(int step, int c, int D) {
    const int col = step * kHCols + c;
    return col < D ? col : -1;
  }
  static __device__ __forceinline__ void widen(const uint8_t* row, int p, int x, int, float, uint32_t (&out)[8]) {
    const uint4 v = *reinterpret_cast<const uint4*>(row + 16 * (p ^ x));
    widen_i8(v.x, out[0], out[1]);
    widen_i8(v.y, out[2], out[3]);
    widen_i8(v.z, out[4], out[5]);
    widen_i8(v.w, out[6], out[7]);
  }
};

// split-half int4 [O, D/2]: the low nibble of p[o, d] is W[o, d], the high
// nibble W[o, D/2 + d]; a k-step is 64 C packed columns, so stage columns
// [0, 64 C) of h are h[:, 64 C step ..] and [64 C, 128 C) are h[:, D/2 +
// 64 C step ..]; in group mode the step spans C / 2 groups of each half,
// whose scales (kScales per channel) ride in the stage
template <bool kGroupScale, int C>
struct FmtInt4 {
  static constexpr int kChunks = C, kRowBytes = 64 * C, kHCols = 128 * C, kHalves = 2;
  static constexpr int kScales = kGroupScale ? C : 0;
  static constexpr bool kGroup = kGroupScale, kColScale = !kGroupScale;
  static __device__ __forceinline__ size_t row_bytes(int D) { return D / 2; }
  static __device__ __forceinline__ int swz(int row) { return (row & 1) << 2; }
  static __device__ __forceinline__ int piece(int kk, int t) { return kk * 4 + t; }
  static __device__ __forceinline__ int h_col(int kk, int part, int t) { return part * 64 * C + kk * 64 + 16 * t; }
  static __device__ __forceinline__ int h_global(int step, int c, int D) {
    const int d = step * 64 * C + c % (64 * C);
    return d < D / 2 ? (c >= 64 * C ? D / 2 + d : d) : -1;
  }
  // the stage's scale slot of chunk kk's group in half `part`
  static __device__ __forceinline__ int scale_slot(int kk, int part) { return part * (C / 2) + kk / 2; }
  static __device__ __forceinline__ void widen(const uint8_t* row, int p, int x, int part, float s,
                                               uint32_t (&out)[8]) {
    const uint4 v = *reinterpret_cast<const uint4*>(row + 16 * (p ^ x));
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t nib = part ? (w[i] >> 4) : w[i];
      widen_nib((nib & 0x0F0F0F0Fu) ^ 0x08080808u, out[2 * i], out[2 * i + 1]);  // each code + 8
      if constexpr (kGroupScale) {
        out[2 * i] = scale_pair(out[2 * i], s);
        out[2 * i + 1] = scale_pair(out[2 * i + 1], s);
      }
    }
  }
};

template <int C>
struct FmtBf16 {  // bf16 [O, D], no scale
  static constexpr int kChunks = C, kRowBytes = 128 * C, kHCols = 64 * C, kHalves = 1, kScales = 0;
  static constexpr bool kGroup = false, kColScale = false;
  static __device__ __forceinline__ size_t row_bytes(int D) { return 2 * static_cast<size_t>(D); }
  static __device__ __forceinline__ int swz(int row) { return row & 1; }
  static __device__ __forceinline__ int piece(int kk, int t) { return kk * 8 + 2 * t; }
  static __device__ __forceinline__ int h_col(int kk, int, int t) { return kk * 64 + 16 * t; }
  static __device__ __forceinline__ int h_global(int step, int c, int D) {
    const int col = step * kHCols + c;
    return col < D ? col : -1;
  }
  static __device__ __forceinline__ void widen(const uint8_t* row, int p, int x, int, float, uint32_t (&out)[8]) {
    const uint4 a = *reinterpret_cast<const uint4*>(row + 16 * (p ^ x));
    const uint4 b = *reinterpret_cast<const uint4*>(row + 16 * ((p + 1) ^ x));
    out[0] = a.x, out[1] = a.y, out[2] = a.z, out[3] = a.w;
    out[4] = b.x, out[5] = b.y, out[6] = b.z, out[7] = b.w;
  }
};

// One instance's geometry and shared memory. A block's 8 warps are kKW
// along K (one chunk of each k-step each) by kRW along the channels (32
// channels each); kStages stages of [W tile][h slice][group scales], and
// after the main loop the first bytes hold the fp32 partial tile. Four
// stages where two blocks fit on an SM, else three.
template <class F, int NB>
struct Layout {
  static constexpr int kKW = F::kChunks;
  static constexpr int kRW = kWarps / kKW;
  static constexpr int kBM = kRW * kMT * 16;  // output channels per block
  static constexpr int kHStride = 2 * F::kHCols + 16;  // bytes: a quarter-warp's two rows in other banks
  static constexpr int kWBytes = kBM * F::kRowBytes;
  static constexpr int kHBytes = NB * kHStride;
  static constexpr int kSBytes = kBM * F::kScales * 4;
  static constexpr int kStageBytes = kWBytes + kHBytes + kSBytes;
  static constexpr int kStages = 4 * kStageBytes <= kSmemTwoBlocks ? 4 : 3;
  static constexpr int kBytes = kStages * kStageBytes;
  // per SM: two up to 16 rows where the shared memory fits; at 17-64 rows
  // one, whose 8 warps may use more than 128 registers a thread (two
  // blocks there spilled or ran slower, PERF.md)
  static constexpr int kBlocks = kBytes <= kSmemTwoBlocks && NB <= 16 ? 2 : 1;
  static constexpr int kRedStride = kBM + 4;  // fp32 per row of h in the partial tile
  static_assert(kRW * kKW == kWarps && kBM % kMaxSplits == 0, "warps");
  static_assert(NB * kRedStride * 4 <= kBytes && kBM % (4 * kMaxSplits) == 0, "partial tile");
  static_assert(kBytes <= kSmemLimit, "shared memory");
};

// The end of a cluster-split kernel: each of the S = gridDim.x blocks of a
// cluster has left its fp32 partial tile red[row b of h][stride] (the tile's
// kBM channels contiguous in each row; stride a multiple of 4) in its own
// shared memory; block z sums its 1/S of the channels over the S blocks in
// rank order through distributed shared memory (a fixed order:
// deterministic), scales them (kColScale: by s[o]) and stores y[:, o0 ..]
// in bf16. A thread takes 4 consecutive channels of a row and reads each
// block's 16 bytes at once, all S in flight, so a warp reads 512
// contiguous bytes of a remote block (element-wise reads across the
// channels were slower than the main loop at 72 rows). No workspace, no
// second kernel.
template <bool kColScale>
__device__ __forceinline__ void reduce_store(cg::cluster_group& cluster, float* red, int stride, int kBM,
                                             const float* __restrict__ s, __nv_bfloat16* __restrict__ y, int B,
                                             int O, int o0) {
  const int S = gridDim.x;
  const int z = blockIdx.x;
  if (S > 1) cluster.sync();  // every split's partial tile is written
  const int quads = kBM / S / 4;  // 4-channel pieces of this block's share of a row
  for (int idx = threadIdx.x; idx < quads * B; idx += blockDim.x) {
    const int b = idx / quads;
    const int c = z * (kBM / S) + 4 * (idx % quads);
    const int o = o0 + c;
    if (o >= O) continue;
    float4 part[kMaxSplits];
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r)
      if (r < S)
        part[r] = *reinterpret_cast<const float4*>((S == 1 ? red : cluster.map_shared_rank(red, r)) + b * stride + c);
    float v[4] = {part[0].x, part[0].y, part[0].z, part[0].w};
#pragma unroll
    for (int r = 1; r < kMaxSplits; ++r)
      if (r < S) v[0] += part[r].x, v[1] += part[r].y, v[2] += part[r].z, v[3] += part[r].w;
    __nv_bfloat16* yo = y + static_cast<size_t>(b) * O + o;
    if (o + 4 <= O && O % 4 == 0) {
      if constexpr (kColScale) {
        const float4 sc = *reinterpret_cast<const float4*>(s + o);
        v[0] *= sc.x, v[1] *= sc.y, v[2] *= sc.z, v[3] *= sc.w;
      }
      __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]), hi = __floats2bfloat162_rn(v[2], v[3]);
      *reinterpret_cast<uint2*>(yo) = make_uint2(*reinterpret_cast<uint32_t*>(&lo), *reinterpret_cast<uint32_t*>(&hi));
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (o + e >= O) break;
        float x = v[e];
        if constexpr (kColScale) x *= s[o + e];
        yo[e] = __float2bfloat16_rn(x);
      }
    }
  }
  if (S > 1) cluster.sync();  // no block leaves while another reads its shared memory
}

// Grid: (S splits, ceil(O / kBM) channel tiles), cluster (S, 1, 1). Split z
// walks k-steps [z * nsteps / S, (z + 1) * nsteps / S). Warp w computes
// channels [32 (w % kRW), 32 (w % kRW) + 32) of the tile over chunk w / kRW
// of every k-step; the chunks' sums meet in the partial tile.
template <class F, int NB>
__global__ void __launch_bounds__(kThreads, (Layout<F, NB>::kBlocks))
stream_mma_kernel(const __nv_bfloat16* __restrict__ h, const uint8_t* __restrict__ w,
                  const float* __restrict__ s, __nv_bfloat16* __restrict__ y, int B, int O, int D) {
  using Lo = Layout<F, NB>;
  constexpr int NT = NB / 8;
  constexpr int kStages = Lo::kStages;
  constexpr int kBM = Lo::kBM;
  // m-tiles widened at once: both at 17-64 rows, where each h fragment
  // then feeds two MMAs; one at a time up to 16 rows, which reads h twice
  // and keeps the instance within 128 registers
  constexpr int kMW = NT <= 2 ? 1 : kMT;
  extern __shared__ __align__(16) uint8_t smem[];

  cg::cluster_group cluster = cg::this_cluster();
  const int S = gridDim.x;
  const int z = blockIdx.x;
  const int o0 = blockIdx.y * kBM;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wr = warp % Lo::kRW;  // 32-channel slice of the tile
  const int kk = warp / Lo::kRW;  // chunk of each k-step
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  const size_t row_bytes = F::row_bytes(D);
  const int nsteps = static_cast<int>((row_bytes + F::kRowBytes - 1) / F::kRowBytes);
  const int k_begin = static_cast<int>(static_cast<long long>(z) * nsteps / S);
  const int k_end = static_cast<int>(static_cast<long long>(z + 1) * nsteps / S);
  const int nt_steps = k_end - k_begin;
  const int nG = D / 128;          // group mode: scales per channel
  const int rows8 = (B + 7) & ~7;  // h rows the MMAs read (the rest are never loaded)
  const int n_tiles = rows8 / 8;

  auto load_stage = [&](int i) {
    const int step = k_begin + i;
    uint8_t* st = smem + (i % kStages) * Lo::kStageBytes;
    constexpr int kPieces = F::kRowBytes / 16;
#pragma unroll
    for (int j = 0; j < kBM * kPieces / kThreads; ++j) {
      const int idx = tid + j * kThreads;
      const int r = idx / kPieces;
      const int p = idx % kPieces;
      const size_t byte = static_cast<size_t>(step) * F::kRowBytes + p * 16;
      const bool ok = o0 + r < O && byte < row_bytes;
      cp_async16(st + r * F::kRowBytes + 16 * (p ^ F::swz(r)),
                 ok ? w + static_cast<size_t>(o0 + r) * row_bytes + byte : w, ok ? 16 : 0);
    }
    uint8_t* hs = st + Lo::kWBytes;
    constexpr int kHPieces = F::kHCols / 8;
    for (int idx = tid; idx < rows8 * kHPieces; idx += kThreads) {
      const int n = idx / kHPieces;
      const int c = (idx % kHPieces) * 8;
      const int col = F::h_global(step, c, D);
      const bool ok = n < B && col >= 0;
      cp_async16(hs + n * Lo::kHStride + 2 * c, ok ? h + static_cast<size_t>(n) * D + col : h, ok ? 16 : 0);
    }
    if constexpr (F::kGroup) {  // slot j of a channel: group step * C/2 + j % (C/2) of half j / (C/2)
      float* ss = reinterpret_cast<float*>(hs + Lo::kHBytes);
      constexpr int kHalfGroups = F::kScales / 2;
      for (int idx = tid; idx < F::kScales * kBM; idx += kThreads) {
        const int r = idx / F::kScales;
        const int j = idx % F::kScales;
        const int grp = step * kHalfGroups + j % kHalfGroups;
        const bool ok = o0 + r < O && grp < nG / 2;
        cp_async4(ss + idx, ok ? s + static_cast<size_t>(o0 + r) * nG + (j / kHalfGroups) * (nG / 2) + grp : s,
                  ok ? 4 : 0);
      }
    }
  };

  float acc[kMT][NT][4];
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][n][i] = 0.f;

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < nt_steps) load_stage(i);
    cp_async_commit();
  }

  for (int i = 0; i < nt_steps; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage i landed for all threads; stage i - 1 is free
    if (i + kStages - 1 < nt_steps) load_stage(i + kStages - 1);
    cp_async_commit();

    const uint8_t* st = smem + (i % kStages) * Lo::kStageBytes;
    const uint8_t* hs = st + Lo::kWBytes;
    const float* ss = reinterpret_cast<const float*>(hs + Lo::kHBytes);
#pragma unroll
    for (int part = 0; part < F::kHalves; ++part) {
#pragma unroll
      for (int m0 = 0; m0 < kMT; m0 += kMW) {
        uint32_t a[kMW][2][8];
#pragma unroll
        for (int mi = 0; mi < kMW; ++mi)
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const int row = (wr * kMT + m0 + mi) * 16 + g + 8 * rr;
            float sc = 1.f;
            if constexpr (F::kGroup) sc = ss[row * F::kScales + F::scale_slot(kk, part)];
            F::widen(st + row * F::kRowBytes, F::piece(kk, t), F::swz(row), part, sc, a[mi][rr]);
          }
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          if (n < n_tiles) {  // warp-uniform: no row of a later n-tile exists
            const uint8_t* q = hs + (n * 8 + g) * Lo::kHStride + 2 * F::h_col(kk, part, t);
            const uint4 h0 = *reinterpret_cast<const uint4*>(q);
            const uint4 h1 = *reinterpret_cast<const uint4*>(q + 16);
            const uint32_t b[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
#pragma unroll
            for (int mi = 0; mi < kMW; ++mi)
#pragma unroll
              for (int j = 0; j < 4; ++j)
                mma16816(acc[m0 + mi][n], a[mi][0][2 * j], a[mi][1][2 * j], a[mi][0][2 * j + 1],
                         a[mi][1][2 * j + 1], b[2 * j], b[2 * j + 1]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // the partial tile [NB rows][kBM channels] in this block's shared memory:
  // the last chunk's warps write it, the others add theirs in turn
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int pass = Lo::kKW - 1; pass >= 0; --pass) {
    if (kk == pass) {
#pragma unroll
      for (int m = 0; m < kMT; ++m)
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const int row = (wr * kMT + m) * 16 + g;
          float* r0 = red + (n * 8 + 2 * t) * Lo::kRedStride + row;  // (channel row, row n * 8 + 2t of h)
          float* r1 = r0 + Lo::kRedStride;
          if (pass == Lo::kKW - 1) {  // the stage bytes beneath are no floats: overwrite them
            r0[0] = acc[m][n][0], r1[0] = acc[m][n][1], r0[8] = acc[m][n][2], r1[8] = acc[m][n][3];
          } else {
            r0[0] += acc[m][n][0], r1[0] += acc[m][n][1], r0[8] += acc[m][n][2], r1[8] += acc[m][n][3];
          }
        }
    }
    __syncthreads();
  }
  reduce_store<F::kColScale>(cluster, red, Lo::kRedStride, kBM, s, y, B, O, o0);
}

// The card's SM count, read once per device.
inline int sm_count() {
  static int count[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (count[dev] == 0 && cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    count[dev] = 0;
  return count[dev];
}

constexpr int kMinSteps = 2;  // k-steps each split keeps at least

// The split plan of `tiles` channel tiles of `steps` k-steps each: K is
// split over 2, 4 or 8 blocks of one cluster while the channel tiles alone
// leave SMs idle and each split keeps kMinSteps k-steps; split z walks
// k-steps [z * steps / S, (z + 1) * steps / S), so every step is walked once.
inline int plan_splits(long long tiles, size_t steps) {
  const int sms = sm_count();
  int splits = 1;
  while (splits < kMaxSplits && tiles * splits < sms && static_cast<size_t>(2 * splits * kMinSteps) <= steps) splits *= 2;
  return splits;
}

// the plan of instance F on O channels of row_bytes each
template <class F>
int plan(int O, size_t row_bytes) {
  constexpr int kBM = Layout<F, 8>::kBM;  // the same for every NB
  return plan_splits((O + kBM - 1) / kBM, (row_bytes + F::kRowBytes - 1) / F::kRowBytes);
}

// Once per kernel instance: above 48 KB of dynamic shared memory only after
// opting in, and all of the SM's unified L1/shared memory as shared, so
// that the blocks the instance asks for fit on one SM.
template <class Kernel>
cudaError_t opt_in(Kernel kernel, int smem_bytes) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err == cudaSuccess) err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  return err;
}

// A launch of `splits` blocks of one cluster per channel tile (no cluster
// for one): grid (splits, tiles).
template <class... Params, class... Args>
cudaError_t launch_cluster(void (*kernel)(Params...), int splits, int tiles, int threads, int smem_bytes,
                           cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, tiles, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
  return cudaGetLastError();
}

template <class F, int NB>
cudaError_t launch(const void* h, const uint8_t* w, const float* s, void* y, int B, int O, int D, size_t row_bytes,
                   cudaStream_t stream) {
  using Lo = Layout<F, NB>;
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = opt_in(stream_mma_kernel<F, NB>, Lo::kBytes);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  return launch_cluster(stream_mma_kernel<F, NB>, plan<F>(O, row_bytes), (O + Lo::kBM - 1) / Lo::kBM, kThreads,
                        Lo::kBytes, stream, static_cast<const __nv_bfloat16*>(h), w, s,
                        static_cast<__nv_bfloat16*>(y), B, O, D);
}

// rows -> the instance's chunks per k-step: up to kWideRows rows (0 or 16)
// 4 (64-channel blocks, 256-byte runs of each int4 row, 512 of bf16), else
// 2 (128-channel blocks, half the runs): measured on the H100 (PERF.md,
// runners/time_stream_rows.py), 4 chunks cut one 7B layer's time at 1-16
// rows by 3-9% in int4, 10-14% in int4 g128 and 0-5% in bf16, and slowed
// int8 by 13% at 1-8 rows.
template <int kWideRows>
constexpr int chunks(int B) {
  return B <= kWideRows ? 4 : 2;
}

// the instance for B rows: NB = B rounded up to 8, 16, 32 or 64
template <template <int> class F, int kWideRows>
cudaError_t dispatch(const void* h, const void* w, const float* s, void* y, int B, int O, int D, size_t row_bytes,
                     cudaStream_t st) {
  constexpr int C16 = chunks<kWideRows>(16);  // of the 8- and 16-row instances
  const uint8_t* wb = static_cast<const uint8_t*>(w);
  if (B < 1 || B > 64) return cudaErrorInvalidValue;
  if (B <= 8) return launch<F<C16>, 8>(h, wb, s, y, B, O, D, row_bytes, st);
  if (B <= 16) return launch<F<C16>, 16>(h, wb, s, y, B, O, D, row_bytes, st);
  if (B <= 32) return launch<F<2>, 32>(h, wb, s, y, B, O, D, row_bytes, st);
  return launch<F<2>, 64>(h, wb, s, y, B, O, D, row_bytes, st);
}

// the split plan dispatch() launches for B rows
template <template <int> class F, int kWideRows>
int splits(int B, int O, size_t row_bytes) {
  return chunks<kWideRows>(B) == 4 ? plan<F<4>>(O, row_bytes) : plan<F<2>>(O, row_bytes);
}

template <int C>
using FmtInt4Channel = FmtInt4<false, C>;
template <int C>
using FmtInt4Group = FmtInt4<true, C>;

}  // namespace smma
}  // namespace
