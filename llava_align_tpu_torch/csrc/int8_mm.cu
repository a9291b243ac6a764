// Weight-only int8 skinny GEMM for Hopper (sm_90a): y[B,O] = h[B,D] . q[li]^T * s[li].
//
// Replaces the TPU kernels llava_align_tpu/ops/quant.py:_int8_mm_stacked_kernel
// (every decoder linear: fused qkv, o, fused gate|up, down) and
// llava_align_tpu/ops/quant.py:_int8_mm_kernel (the int8 lm_head), which is
// the same computation with L = 1.
//
//   h  [B, D]     activations, bf16 or fp32, contiguous
//   q  [L, O, D]  int8 weights; layer li is a pointer offset li*O*D, so the
//                 whole stack stays in device memory and no per-layer copy
//                 is made
//   s  [L, O]     fp32 per-output-channel scales, applied once after the
//                 fp32 reduction over D
//   y  [B, O]     output in h's dtype
//
// What bounds it on the H100: weight bytes. At decode (B = 3 rows of the
// packed VDD branch axis) every int8 weight byte feeds 3 multiply-adds, far
// below the card's ~295 operations per byte of device memory, so the time is
// O*D bytes over the memory bandwidth. The design streams each weight byte
// exactly once: a warp owns R consecutive output rows, its lanes walk D in
// 16-byte vector loads (16 int8 weights each), the weights are widened to
// fp32 in registers with a byte-permute trick (no int->float conversion
// instruction, which runs at a quarter of the FMA rate), and each weight
// vector is reused for all B rows of h, which stay in L1/L2 (a few KB).
// The fp32 partial sums are reduced across the warp with shuffles once per
// output row, then scaled. No shared memory, no tensor cores: the rows are
// few and the kernel is memory-bound. At 16-64 rows the fp32 FMA work grows
// with B and the kernel leaves the memory bound; tensor-core (mma/wgmma)
// tiles are the step for later work.
//
// C interface (bound with ctypes): every pointer and the stream are void*,
// the launch goes on the caller's stream, nothing is allocated, and the
// return value is cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;  // warps per block

template <typename T>
struct Act;

template <>
struct Act<float> {
  // 16 consecutive fp32 values (64 bytes, 16-byte aligned) -> registers
  static __device__ __forceinline__ void load16(const float* p, float* out) {
    const float4* p4 = reinterpret_cast<const float4*>(p);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
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
  // 16 consecutive bf16 values (32 bytes, 16-byte aligned) -> fp32 registers
  static __device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
    const uint4* p4 = reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      uint4 v = __ldg(p4 + i);
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // a bf16 is the top half of an fp32: shift into place, exact
        out[8 * i + 2 * j + 0] = __uint_as_float(w[j] << 16);
        out[8 * i + 2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
      }
    }
  }
  static __device__ __forceinline__ __nv_bfloat16 from_float(float x) {
    return __float2bfloat16_rn(x);
  }
};

// Four int8 packed in a word -> four exact fp32 values. Flipping the sign bit
// turns x into x + 128 as an unsigned byte; placing that byte as the low
// mantissa byte of 2^23 (0x4B000000) gives the float 2^23 + x + 128.
__device__ __forceinline__ void widen4(uint32_t word, float* out) {
  const uint32_t u = word ^ 0x80808080u;
  const float bias = 8388736.0f;  // 2^23 + 128
  out[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - bias;
  out[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - bias;
  out[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - bias;
  out[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - bias;
}

// NB: the row count rounded up to the template's bound (rows >= B are
// skipped); R: output rows per warp. Grid: ceil(O / (kWarps * R)) blocks.
template <typename T, int NB, int R>
__global__ void __launch_bounds__(kWarps * 32)
int8_mm_kernel(const T* __restrict__ h, const int8_t* __restrict__ q,
               const float* __restrict__ s, T* __restrict__ y, int B, int O, int D) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int o0 = (blockIdx.x * kWarps + warp) * R;
  if (o0 >= O) return;  // the whole warp leaves together

  float acc[NB][R];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int r = 0; r < R; ++r) acc[b][r] = 0.f;

  const int nchunks = D >> 4;  // 16-element chunks along D
  for (int c = lane; c < nchunks; c += 32) {
    float w[R][16];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (o0 + r < O) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(q + (size_t)(o0 + r) * D) + c);
        widen4(v.x, &w[r][0]);
        widen4(v.y, &w[r][4]);
        widen4(v.z, &w[r][8]);
        widen4(v.w, &w[r][12]);
      } else {
#pragma unroll
        for (int i = 0; i < 16; ++i) w[r][i] = 0.f;
      }
    }
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      if (b < B) {
        float x[16];
        Act<T>::load16(h + (size_t)b * D + (size_t)c * 16, x);
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int i = 0; i < 16; ++i) acc[b][r] = fmaf(x[i], w[r][i], acc[b][r]);
      }
    }
  }

#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float v = acc[b][r];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      // every lane now holds the row's sum; spread the stores over lanes
      if (lane == ((b * R + r) & 31) && b < B && o0 + r < O)
        y[(size_t)b * O + o0 + r] = Act<T>::from_float(v * s[o0 + r]);
    }
}

template <typename T, int NB, int R>
cudaError_t launch(const void* h, const void* q, const void* s, void* y, int B, int O,
                   int D, cudaStream_t stream) {
  const int rows_per_block = kWarps * R;
  const dim3 grid((O + rows_per_block - 1) / rows_per_block);
  int8_mm_kernel<T, NB, R><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(h), static_cast<const int8_t*>(q), static_cast<const float*>(s),
      static_cast<T*>(y), B, O, D);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_rows(const void* h, const void* q, const void* s, void* y, int B,
                          int O, int D, cudaStream_t stream) {
  if (B <= 4) return launch<T, 4, 4>(h, q, s, y, B, O, D, stream);
  if (B <= 8) return launch<T, 8, 4>(h, q, s, y, B, O, D, stream);
  if (B <= 16) return launch<T, 16, 2>(h, q, s, y, B, O, D, stream);
  if (B <= 32) return launch<T, 32, 1>(h, q, s, y, B, O, D, stream);
  return launch<T, 64, 1>(h, q, s, y, B, O, D, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = fp32, 1 = bf16. Preconditions (checked by the Python wrapper):
// 1 <= B <= 64, D % 16 == 0, all pointers 16-byte aligned, 0 <= li < L.
int int8_mm_stacked(const void* h, const void* q, const void* s, void* y, int B, int O,
                    int D, int li, int dtype, void* stream) {
  const int8_t* ql = static_cast<const int8_t*>(q) + (size_t)li * O * D;
  const float* sl = static_cast<const float*>(s) + (size_t)li * O;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || B > 64 || D % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1) return dispatch_rows<__nv_bfloat16>(h, ql, sl, y, B, O, D, st);
  if (dtype == 0) return dispatch_rows<float>(h, ql, sl, y, B, O, D, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The lm_head form (TPU _int8_mm_kernel): one [O, D] matrix, no layer axis.
int int8_mm(const void* h, const void* q, const void* s, void* y, int B, int O, int D,
            int dtype, void* stream) {
  return int8_mm_stacked(h, q, s, y, B, O, D, 0, dtype, stream);
}

}  // extern "C"
