// Weight-streaming skinny GEMMs for Hopper (sm_90a), one template over the
// weight format, and the int8 tiled regime on the wgmma main loop of
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
// What bounds it on the H100: weight bytes at a few rows. At decode (B = 3
// rows of the packed VDD branch axis) every int8 weight byte feeds 3
// multiply-adds, far below the card's ~295 operations per byte of device
// memory. The design streams each weight byte exactly once: a warp owns R
// consecutive output rows, its lanes walk the row in 16-byte vector loads
// (16 int8, 32 int4 or 8 bf16 weights), the weights are widened to fp32 in
// registers (int8 and int4 with a byte-permute trick, no int->float
// conversion instruction, which runs at a quarter of the FMA rate), and each
// weight vector is reused for all B rows of h, which stay in L1/L2. The fp32
// partial sums are reduced across the warp with shuffles once per output,
// then scaled. No shared memory, no tensor cores: at 16-64 rows the fp32 FMA
// work and the h reads from L1 grow with B and the kernel leaves the memory
// bound; tensor-core tiles are the step for later work.
//
// Group scales: the 16-byte chunks a lane reads never straddle a 128-column
// group, so each chunk's half-dot is summed in fp32 and multiplied once by
// its group scale. The TPU script scales each weight in fp32 and rounds it to
// bf16 before its dot; the two differ by bf16 rounding only, and the plain
// version (ops/stream_probes.py) keeps the script's rounding.
//
// C interface (bound with ctypes): every pointer and the stream are void*,
// the launch goes on the caller's stream, nothing is allocated, and the
// return value is cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wq_gemm.cuh"

namespace {

constexpr int kWarps = 4;    // warps per block
constexpr int kGroup = 128;  // columns per scale group (int4 group mode)

// the 8 bf16 of a 16-byte vector -> exact fp32 (a bf16 is the top half of an
// fp32: shift into place)
__device__ __forceinline__ void bf16x8_to_float(const uint4 v, float* out) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    out[2 * j + 0] = __uint_as_float(w[j] << 16);
    out[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
}

template <typename T>
struct Act;

template <>
struct Act<float> {
  // N consecutive fp32 values (16-byte aligned, N % 4 == 0) -> registers
  template <int N>
  static __device__ __forceinline__ void load(const float* p, float* out) {
    const float4* p4 = reinterpret_cast<const float4*>(p);
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      float4 v = __ldg(p4 + i);
      out[4 * i + 0] = v.x;
      out[4 * i + 1] = v.y;
      out[4 * i + 2] = v.z;
      out[4 * i + 3] = v.w;
    }
  }
  static __device__ __forceinline__ float from_float(float x) { return x; }
};

template <>
struct Act<__nv_bfloat16> {
  // N consecutive bf16 values (16-byte aligned, N % 8 == 0) -> fp32 registers
  template <int N>
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* out) {
    const uint4* p4 = reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int i = 0; i < N / 8; ++i) bf16x8_to_float(__ldg(p4 + i), out + 8 * i);
  }
  static __device__ __forceinline__ __nv_bfloat16 from_float(float x) {
    return __float2bfloat16_rn(x);
  }
};

// Four bytes of a word, each a signed code x held as (x + kFlip) ^ kFlip
// (int8: kFlip = 128; an int4 nibble in the byte's low bits: kFlip = 8) ->
// four exact fp32 values. Flipping turns x into x + kFlip as an unsigned
// byte; placing that byte as the low mantissa byte of 2^23 (0x4B000000)
// gives the float 2^23 + x + kFlip.
template <uint32_t kFlip>
__device__ __forceinline__ void widen4(uint32_t word, float* out) {
  const uint32_t u = word ^ (kFlip * 0x01010101u);
  const float bias = 8388608.0f + kFlip;
  out[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - bias;
  out[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - bias;
  out[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - bias;
  out[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - bias;
}

// Weight formats. Each 16-byte chunk c of a weight row gives kParts runs of
// kN weights; run `part` pairs with h[:, col(c, part, D) ...].
enum class Scale { kChannel, kGroup, kNone };

struct Int8W {
  static constexpr int kParts = 1, kN = 16;
  static constexpr Scale kScale = Scale::kChannel;
  static __device__ __forceinline__ size_t row_bytes(int D) { return D; }
  static __device__ __forceinline__ int col(int c, int, int) { return 16 * c; }
  static __device__ __forceinline__ void unpack(const uint4 v, int, float* out) {
    widen4<0x80>(v.x, out);
    widen4<0x80>(v.y, out + 4);
    widen4<0x80>(v.z, out + 8);
    widen4<0x80>(v.w, out + 12);
  }
};

// Row-major split-half int4: the 16 codes of part 0 are the bytes' low
// nibbles (columns 16c.. of the low half), those of part 1 the high nibbles
// (columns D/2 + 16c..); both sign-extend: lo = ((p & 15) ^ 8) - 8, hi = p >> 4.
template <Scale S>
struct Int4W {
  static constexpr int kParts = 2, kN = 16;
  static constexpr Scale kScale = S;
  static __device__ __forceinline__ size_t row_bytes(int D) { return D / 2; }
  static __device__ __forceinline__ int col(int c, int part, int D) { return part * (D / 2) + 16 * c; }
  static __device__ __forceinline__ void unpack(const uint4 v, int part, float* out) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      widen4<0x08>(part ? (w[j] >> 4) & 0x0F0F0F0Fu : w[j] & 0x0F0F0F0Fu, out + 4 * j);
  }
};

struct Bf16W {
  static constexpr int kParts = 1, kN = 8;
  static constexpr Scale kScale = Scale::kNone;
  static __device__ __forceinline__ size_t row_bytes(int D) { return 2 * (size_t)D; }
  static __device__ __forceinline__ int col(int c, int, int) { return 8 * c; }
  static __device__ __forceinline__ void unpack(const uint4 v, int, float* out) { bf16x8_to_float(v, out); }
};

// NB: the row count rounded up to the template's bound (rows >= B are
// skipped); R: output rows per warp. Grid: ceil(O / (kWarps * R)) blocks.
template <typename T, typename W, int NB, int R>
__global__ void __launch_bounds__(kWarps * 32)
stream_mm_kernel(const T* __restrict__ h, const uint8_t* __restrict__ w,
                 const float* __restrict__ s, T* __restrict__ y, int B, int O, int D) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int o0 = (blockIdx.x * kWarps + warp) * R;
  if (o0 >= O) return;  // the whole warp leaves together

  const size_t row_bytes = W::row_bytes(D);
  const int nchunks = static_cast<int>(row_bytes >> 4);  // 16-byte chunks per row
  const int nG = D / kGroup;                              // group mode: scales per row

  float acc[NB][R];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int r = 0; r < R; ++r) acc[b][r] = 0.f;

  for (int c = lane; c < nchunks; c += 32) {
    uint4 v[R];
#pragma unroll
    for (int r = 0; r < R; ++r)
      v[r] = o0 + r < O ? __ldg(reinterpret_cast<const uint4*>(w + (o0 + r) * row_bytes) + c)
                        : make_uint4(0u, 0u, 0u, 0u);  // decodes to zeros, never stored
#pragma unroll
    for (int part = 0; part < W::kParts; ++part) {
      float wf[R][W::kN];
      float sc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        W::unpack(v[r], part, wf[r]);
        if constexpr (W::kScale == Scale::kGroup)
          sc[r] = o0 + r < O ? __ldg(s + (size_t)(o0 + r) * nG + part * (nG / 2) + (c * 16) / kGroup) : 0.f;
      }
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        if (b < B) {
          float x[W::kN];
          Act<T>::template load<W::kN>(h + (size_t)b * D + W::col(c, part, D), x);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            if constexpr (W::kScale == Scale::kGroup) {
              float dot = 0.f;
#pragma unroll
              for (int i = 0; i < W::kN; ++i) dot = fmaf(x[i], wf[r][i], dot);
              acc[b][r] = fmaf(dot, sc[r], acc[b][r]);
            } else {
#pragma unroll
              for (int i = 0; i < W::kN; ++i) acc[b][r] = fmaf(x[i], wf[r][i], acc[b][r]);
            }
          }
        }
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
      if (lane == ((b * R + r) & 31) && b < B && o0 + r < O) {
        if constexpr (W::kScale == Scale::kChannel) t *= s[o0 + r];
        y[(size_t)b * O + o0 + r] = Act<T>::from_float(t);
      }
    }
}

template <typename T, typename W, int NB, int R>
cudaError_t launch(const void* h, const void* w, const float* s, void* y, int B, int O, int D,
                   cudaStream_t stream) {
  const int rows_per_block = kWarps * R;
  const dim3 grid((O + rows_per_block - 1) / rows_per_block);
  stream_mm_kernel<T, W, NB, R><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(h), static_cast<const uint8_t*>(w), s, static_cast<T*>(y), B, O, D);
  return cudaGetLastError();
}

template <typename T, typename W>
cudaError_t dispatch_rows(const void* h, const void* w, const float* s, void* y, int B, int O,
                          int D, cudaStream_t stream) {
  if (B <= 4) return launch<T, W, 4, 4>(h, w, s, y, B, O, D, stream);
  if (B <= 8) return launch<T, W, 8, 4>(h, w, s, y, B, O, D, stream);
  if (B <= 16) return launch<T, W, 16, 2>(h, w, s, y, B, O, D, stream);
  if (B <= 32) return launch<T, W, 32, 1>(h, w, s, y, B, O, D, stream);
  return launch<T, W, 64, 1>(h, w, s, y, B, O, D, stream);
}

// ---------------------------------------------------------------------------
// Tiled regime (65..640 rows, bf16 only): the wgmma main loop of
// wq_gemm.cuh with this int8 format. Above 64 rows the streaming kernel's
// FMA work grows with B; this regime serves the lm_head at the grouped
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
        widen4<0x80>(words[j], f);
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
// this call (0 when D is not split; the streaming regime never splits).
int int8_mm_workspace(int B, int O, int D) {
  if (B <= 64 || B > 640 || D % kTiledK != 0) return 0;
  return static_cast<int>(wq::workspace(B, O, D / kTiledK));
}

// dtype: 0 = fp32, 1 = bf16. Preconditions (checked by the Python wrapper):
// D % 16 == 0, all pointers 16-byte aligned, 0 <= li < L; 1 <= B <= 64 (the
// streaming kernel, either dtype), or 64 < B <= 640 with bf16 and D % 64 == 0
// (the tiled regime), `work` holding int8_mm_workspace(...) floats.
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
  if (dtype == 1) return dispatch_rows<__nv_bfloat16, Int8W>(h, ql, sl, y, B, O, D, st);
  if (dtype == 0) return dispatch_rows<float, Int8W>(h, ql, sl, y, B, O, D, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The lm_head form (TPU _int8_mm_kernel): one [O, D] matrix, no layer axis.
int int8_mm(const void* h, const void* q, const void* s, void* y, void* work, int B, int O, int D,
            int dtype, void* stream) {
  return int8_mm_stacked(h, q, s, y, work, B, O, D, 0, dtype, stream);
}

// Row-major int4, bf16 h. mode: 0 = per-channel scales s [L, O], 1 =
// group-128 scales s [L, O, D/128]. Preconditions (checked by the Python
// wrapper): 1 <= B <= 64, D % 32 == 0 (mode 1: D % 256 == 0), all pointers
// 16-byte aligned, 0 <= li < L.
int int4_rowmajor_mm_stacked(const void* h, const void* p, const void* s, void* y, int B, int O,
                             int D, int li, int mode, void* stream) {
  if (B < 1 || B > 64 || D % 32 != 0 || (mode == 1 && D % (2 * kGroup) != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const uint8_t* pl = static_cast<const uint8_t*>(p) + (size_t)li * O * (D / 2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == 0) {
    const float* sl = static_cast<const float*>(s) + (size_t)li * O;
    return dispatch_rows<__nv_bfloat16, Int4W<Scale::kChannel>>(h, pl, sl, y, B, O, D, st);
  }
  if (mode == 1) {
    const float* sl = static_cast<const float*>(s) + (size_t)li * O * (D / kGroup);
    return dispatch_rows<__nv_bfloat16, Int4W<Scale::kGroup>>(h, pl, sl, y, B, O, D, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// bf16 weights, bf16 h, no scale. Preconditions (checked by the Python
// wrapper): 1 <= B <= 64, D % 8 == 0, all pointers 16-byte aligned,
// 0 <= li < L.
int bf16_mm_stacked(const void* h, const void* w, void* y, int B, int O, int D, int li,
                    void* stream) {
  if (B < 1 || B > 64 || D % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const uint8_t* wl = static_cast<const uint8_t*>(w) + (size_t)li * O * D * 2;
  return dispatch_rows<__nv_bfloat16, Bf16W>(h, wl, nullptr, y, B, O, D,
                                             static_cast<cudaStream_t>(stream));
}

}  // extern "C"
