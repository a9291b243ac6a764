// Weight-streaming skinny GEMMs for Hopper (sm_90a), one C interface over
// three weight formats, and the int8 tiled regime on the wgmma main loop of
// wq_gemm.cuh (below, 65-640 rows):
//
//   y[B,O] = h[B,D] . W[li]^T,  W row-major (D contiguous per output row)
//
// * int8 [L, O, D], per-channel scale s [L, O] after the fp32 sum (entries
//   int8_mm_stacked, int8_mm): replaces the TPU kernels
//   llava_align_tpu/ops/quant.py:_int8_mm_stacked_kernel (every decoder
//   linear: fused qkv, o, fused gate|up, down) and _int8_mm_kernel (the int8
//   lm_head, the same computation with L = 1);
// * int4 row-major, packed [L, O, D/2] split-half (the low nibble of p[o, d]
//   is W[o, d], the high nibble W[o, D/2 + d]), per-channel scales [L, O] or
//   group-128 scales [L, O, D/128] with the low half's groups first (entry
//   int4_rowmajor_mm_stacked): replaces scripts/bench_int4_probe.py:_make_kern4,
//   scripts/bench_int4_probe2.py:_make_kern4 (every unpack flavour is exact,
//   so they are one function), scripts/bench_int4_probe3.py:_kern_rep and
//   scripts/probe_int4_kernel_bisect.py:kern (its variants are other scales,
//   built on the host, or other bf16 rounding);
// * bf16 [L, O, D], no scale (entry bf16_mm_stacked): replaces
//   scripts/bench_bf16_stream.py:_kern.
//
//   h  [B, D]  activations, contiguous: bf16 or fp32 (int8), bf16 (others)
//   y  [B, O]  output in h's dtype
//
// The layer li is a pointer offset into the whole stack, so it stays in
// device memory and no per-layer copy is made.
//
// Regimes, the same rule in ops/quant.py (stream_regime) and below:
//
// * bf16 activations, 1-64 rows, every format: the tensor-core streaming
//   kernel of stream_mma.cuh (mma.sync with the operands swapped, the raw
//   weights in a cp.async ring, widened in registers, K split over a
//   thread-block cluster on narrow stacks). Bound: weight bytes. Its split
//   plan (1, 2, 4 or 8 blocks per channel tile, smma::plan) follows from
//   the shape and the card's SM count; stream_mma_splits reports it.
//   Measured against the CUDA-core body it replaced, per 7B layer (an
//   NVIDIA H100, PERF.md, runners/time_stream_rows.py): faster in every
//   format from 3 rows on (3.9-16x at 16-64 rows) and in int8 and bf16 at
//   1-2 rows; the old body was 7% faster at 1 row in int4 per-channel
//   (device time; not in eager calls) and 11-30% at 1-2 rows in int4
//   group-128, where it skipped the per-weight bf16 rounding this kernel
//   shares with the plain version. No caller runs those, so no bf16 row
//   count keeps the CUDA-core body.
// * fp32 activations, 1-64 rows, int8 only (K1/K2's dtype 0): the CUDA-core
//   body below. bf16 MMAs would round fp32 activations, so fp32 keeps fp32
//   FMAs, as K3 keeps fp32 on the CUDA cores. A warp owns R consecutive
//   output rows, its lanes walk the row in 16-byte loads of 16 int8, widen
//   them to fp32 with a byte-permute trick and reuse each weight vector for
//   all B rows of h, read from L1/L2; the fp32 sums are reduced across the
//   warp with shuffles, then scaled. Its bound is the CUDA cores from ~16
//   rows on: each weight costs an FMA and an h load per row.
// * bf16, 65-640 rows, int8: the tiled regime below.
//
// C interface (bound with ctypes): every pointer and the stream are void*,
// the launch goes on the caller's stream, nothing is allocated, and the
// return value is cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "stream_mma.cuh"
#include "wq_gemm.cuh"

namespace {

constexpr int kWarps = 4;    // warps per block of the CUDA-core body
constexpr int kGroup = 128;  // columns per scale group (int4 group mode)
// rows up to which the tensor-core streaming kernel takes 4 chunks a k-step
// (smma::chunks: measured per format)
constexpr int kInt8WideRows = 0, kInt4WideRows = 16, kBf16WideRows = 16;

// Four int8 codes of a word -> four exact fp32 values: x ^ 0x80 = x + 128
// as an unsigned byte, placed as the low mantissa byte of 2^23
// (0x4B000000), gives the float 2^23 + x + 128.
__device__ __forceinline__ void widen4(uint32_t word, float* out) {
  const uint32_t u = word ^ 0x80808080u;
  const float bias = 8388608.0f + 128.0f;
  out[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - bias;
  out[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - bias;
  out[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - bias;
  out[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - bias;
}

// The CUDA-core body, fp32 h and int8 weights. NB: the row count rounded up
// to the instance's bound (rows >= B are skipped); R: output rows per warp.
// Grid: ceil(O / (kWarps * R)) blocks.
template <int NB, int R>
__global__ void __launch_bounds__(kWarps * 32)
stream_fp32_kernel(const float* __restrict__ h, const int8_t* __restrict__ w,
                   const float* __restrict__ s, float* __restrict__ y, int B, int O, int D) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int o0 = (blockIdx.x * kWarps + warp) * R;
  if (o0 >= O) return;  // the whole warp leaves together
  const int nchunks = D >> 4;  // 16-byte chunks per row

  float acc[NB][R];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int r = 0; r < R; ++r) acc[b][r] = 0.f;

  for (int c = lane; c < nchunks; c += 32) {
    float wf[R][16];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const uint4 v = o0 + r < O ? __ldg(reinterpret_cast<const uint4*>(w + (size_t)(o0 + r) * D) + c)
                                 : make_uint4(0u, 0u, 0u, 0u);  // decodes to zeros, never stored
      widen4(v.x, wf[r]);
      widen4(v.y, wf[r] + 4);
      widen4(v.z, wf[r] + 8);
      widen4(v.w, wf[r] + 12);
    }
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      if (b < B) {
        const float4* p4 = reinterpret_cast<const float4*>(h + (size_t)b * D + 16 * c);
        float x[16];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 v = __ldg(p4 + i);
          x[4 * i] = v.x, x[4 * i + 1] = v.y, x[4 * i + 2] = v.z, x[4 * i + 3] = v.w;
        }
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int i = 0; i < 16; ++i) acc[b][r] = fmaf(x[i], wf[r][i], acc[b][r]);
      }
    }
  }

#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float t = acc[b][r];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) t += __shfl_xor_sync(0xffffffffu, t, off);
      // every lane now holds the output's sum; spread the stores over lanes
      if (lane == ((b * R + r) & 31) && b < B && o0 + r < O) y[(size_t)b * O + o0 + r] = t * s[o0 + r];
    }
}

template <int NB, int R>
cudaError_t launch_fp32(const void* h, const int8_t* w, const float* s, void* y, int B, int O, int D,
                        cudaStream_t stream) {
  const int rows_per_block = kWarps * R;
  const dim3 grid((O + rows_per_block - 1) / rows_per_block);
  stream_fp32_kernel<NB, R><<<grid, kWarps * 32, 0, stream>>>(static_cast<const float*>(h), w, s,
                                                              static_cast<float*>(y), B, O, D);
  return cudaGetLastError();
}

cudaError_t dispatch_fp32(const void* h, const int8_t* w, const float* s, void* y, int B, int O, int D,
                          cudaStream_t stream) {
  if (B <= 4) return launch_fp32<4, 4>(h, w, s, y, B, O, D, stream);
  if (B <= 8) return launch_fp32<8, 4>(h, w, s, y, B, O, D, stream);
  if (B <= 16) return launch_fp32<16, 2>(h, w, s, y, B, O, D, stream);
  if (B <= 32) return launch_fp32<32, 1>(h, w, s, y, B, O, D, stream);
  return launch_fp32<64, 1>(h, w, s, y, B, O, D, stream);
}

// ---------------------------------------------------------------------------
// Tiled regime (65..640 rows, bf16 only): the wgmma main loop of
// wq_gemm.cuh with this int8 format (above DECODE_MAX_ROWS = 64, the JAX
// rule's streaming bound, kept as it is). It serves the lm_head at the grouped
// path's 72 rows (bound by weight bytes: each weight tile is read once per
// 128-row block) and, as on the TPU, output-major (O >= D) matrices up to
// 640 rows, such as the 7B text-branch prefill's 512 rows (bound by
// tensor-core operations). A k-step is 64 columns of D: TMA brings h's
// [128 rows][64] tile 128-byte swizzled, as wgmma's K-major A, and q's raw
// [256 rows][64] int8 tile; the consumers widen q (exact: |q| <= 127) into
// the K-major swizzled bf16 tile wgmma takes as B (y = h . q^T needs no
// transpose). The per-channel scale is applied once per output after the
// fp32 reduction, as in the streaming kernel and the TPU kernel.
// ---------------------------------------------------------------------------

struct Int8Fmt {
  static constexpr int kStages = 4;
  static constexpr int kABytes = wq::kBM * 128;  // h: 128 rows x 64 bf16
  static constexpr int kWBytes = wq::kBN * 64;   // q: 256 output rows x 64 int8
  static constexpr int kStageBytes = kABytes + kWBytes;
  static constexpr int kTransB = 0;
  static constexpr bool kColScale = true;

  static __device__ __forceinline__ void load(const CUtensorMap* a, const CUtensorMap* w, const CUtensorMap*,
                                              uint8_t* stage, uint64_t* bar, int step, int m0, int n0, int) {
    wq::tma_load_2d(stage, a, bar, step * 64, m0);
    wq::tma_load_2d(stage + kABytes, w, bar, step * 64, n0);
  }

  // h rows of warpgroup wg, k16 slice j: 128-byte rows, 8-row atoms 1024 bytes apart
  static __device__ __forceinline__ uint64_t desc_a(const uint8_t* stage, int wg, int j) {
    return wq::desc(stage + wg * 64 * 128 + 32 * j, 16, 1024, wq::kSw128);
  }
  static __device__ __forceinline__ uint64_t desc_b(const uint8_t* b, int j) {
    return wq::desc(b + 32 * j, 16, 1024, wq::kSw128);
  }

  // q's [256][64] int8 tile -> bf16 [256][64] K-major, 16-byte chunk c of
  // row n stored at chunk c ^ (n % 8) (the 128-byte swizzle)
  static __device__ __forceinline__ void widen(const uint8_t* stage, uint8_t* b, int tid) {
    const uint8_t* raw = stage + kABytes;
#pragma unroll
    for (int i = 0; i < kWBytes / 16 / wq::kConsumers; ++i) {
      const int idx = tid + i * wq::kConsumers;
      const int n = idx >> 2;
      const int c = idx & 3;  // 16 int8 = k 16c .. 16c + 15
      const uint4 v = *reinterpret_cast<const uint4*>(raw + n * 64 + c * 16);
      const uint32_t words[4] = {v.x, v.y, v.z, v.w};
      uint32_t packed[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float f[4];
        widen4(words[j], f);
        // an integer below 256 in fp32 is exact in bf16: keep the high halves
        packed[2 * j] = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
        packed[2 * j + 1] = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
      }
      uint8_t* row = b + n * 128;
      *reinterpret_cast<uint4*>(row + (((2 * c) ^ (n & 7)) << 4)) =
          make_uint4(packed[0], packed[1], packed[2], packed[3]);
      *reinterpret_cast<uint4*>(row + (((2 * c + 1) ^ (n & 7)) << 4)) =
          make_uint4(packed[4], packed[5], packed[6], packed[7]);
    }
  }
};

constexpr int kTiledK = 64;  // D per k-step of the tiled regime

cudaError_t launch_tiled(const void* h, const int8_t* q, const float* s, void* y, float* work, int B,
                         int O, int D, cudaStream_t stream) {
  CUtensorMap ta, tw;
  const cuuint64_t wdims[2] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(O)};
  const cuuint64_t wstrides[1] = {static_cast<cuuint64_t>(D)};
  const cuuint32_t wbox[2] = {kTiledK, wq::kBN};
  if (!wq::encode_h(&ta, h, B, D, kTiledK, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !wq::encode(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, q, wdims, wstrides, wbox, CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorInvalidValue;
  return wq::launch<Int8Fmt>(ta, tw, tw, s, y, work, B, O, D / kTiledK, 0, stream);
}

}  // namespace

extern "C" {

// fp32 elements of split-K workspace int8_mm_stacked / int8_mm need for
// this call (0 when D is not split; the streaming regimes need none).
int int8_mm_workspace(int B, int O, int D) {
  if (B <= 64 || B > 640 || D % kTiledK != 0) return 0;
  return static_cast<int>(wq::workspace(B, O, D / kTiledK));
}

// dtype: 0 = fp32, 1 = bf16. Preconditions (checked by the Python wrapper):
// D % 16 == 0, all pointers 16-byte aligned, 0 <= li < L; 1 <= B <= 64 (bf16:
// the tensor-core streaming kernel; fp32: the CUDA-core body), or
// 64 < B <= 640 with bf16 and D % 64 == 0 (the tiled regime), `work`
// holding int8_mm_workspace(...) floats.
int int8_mm_stacked(const void* h, const void* q, const void* s, void* y, void* work, int B, int O,
                    int D, int li, int dtype, void* stream) {
  const int8_t* ql = static_cast<const int8_t*>(q) + (size_t)li * O * D;
  const float* sl = static_cast<const float*>(s) + (size_t)li * O;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || B > 640 || D % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B > 64) {
    if (dtype != 1 || D % kTiledK != 0) return static_cast<int>(cudaErrorInvalidValue);
    return launch_tiled(h, ql, sl, y, static_cast<float*>(work), B, O, D, st);
  }
  if (dtype == 1) return smma::dispatch<smma::FmtInt8, kInt8WideRows>(h, ql, sl, y, B, O, D, D, st);
  if (dtype == 0) return dispatch_fp32(h, ql, sl, y, B, O, D, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The lm_head form (TPU _int8_mm_kernel): one [O, D] matrix, no layer axis.
int int8_mm(const void* h, const void* q, const void* s, void* y, void* work, int B, int O, int D,
            int dtype, void* stream) {
  return int8_mm_stacked(h, q, s, y, work, B, O, D, 0, dtype, stream);
}

// Row-major int4, bf16 h, on the tensor-core streaming kernel. mode: 0 =
// per-channel scales s [L, O], 1 = group-128 scales s [L, O, D/128].
// Preconditions (checked by the Python wrapper): 1 <= B <= 64, D % 32 == 0
// (mode 1: D % 256 == 0), all pointers 16-byte aligned, 0 <= li < L.
int int4_rowmajor_mm_stacked(const void* h, const void* p, const void* s, void* y, int B, int O,
                             int D, int li, int mode, void* stream) {
  if (B < 1 || B > 64 || D % 32 != 0 || (mode == 1 && D % (2 * kGroup) != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const uint8_t* pl = static_cast<const uint8_t*>(p) + (size_t)li * O * (D / 2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == 0) {
    const float* sl = static_cast<const float*>(s) + (size_t)li * O;
    return smma::dispatch<smma::FmtInt4Channel, kInt4WideRows>(h, pl, sl, y, B, O, D, D / 2, st);
  }
  if (mode == 1) {
    const float* sl = static_cast<const float*>(s) + (size_t)li * O * (D / kGroup);
    return smma::dispatch<smma::FmtInt4Group, kInt4WideRows>(h, pl, sl, y, B, O, D, D / 2, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// bf16 weights, bf16 h, no scale, on the tensor-core streaming kernel.
// Preconditions (checked by the Python wrapper): 1 <= B <= 64, D % 8 == 0,
// all pointers 16-byte aligned, 0 <= li < L.
int bf16_mm_stacked(const void* h, const void* w, void* y, int B, int O, int D, int li, void* stream) {
  if (B < 1 || B > 64 || D % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const uint8_t* wl = static_cast<const uint8_t*>(w) + (size_t)li * O * D * 2;
  return smma::dispatch<smma::FmtBf16, kBf16WideRows>(h, wl, nullptr, y, B, O, D, 2 * (size_t)D,
                                                   static_cast<cudaStream_t>(stream));
}

// The split plan of a tensor-core streaming call on the current device:
// blocks per channel tile (1, 2, 4 or 8). format: 0 = int8, 1 = int4 (both
// scale modes), 2 = bf16; -1 for a format or row count it does not take.
int stream_mma_splits(int format, int B, int O, int D) {
  if (B < 1 || B > 64) return -1;
  if (format == 0) return smma::splits<smma::FmtInt8, kInt8WideRows>(B, O, D);
  if (format == 1) return smma::splits<smma::FmtInt4Channel, kInt4WideRows>(B, O, D / 2);
  if (format == 2) return smma::splits<smma::FmtBf16, kBf16WideRows>(B, O, 2 * (size_t)D);
  return -1;
}

}  // extern "C"
