// Causal flash attention (prefill) for Hopper (sm_90a).
//
// Replaces the TPU kernel llava_align_tpu/ops/attention.py:_flash_kernel.
//
//   q  [B, S, H, Dh]   bf16 or fp32, contiguous
//   k  [B, S, K, Dh]   kv heads; GQA maps query head h to kv head h / (H / K)
//   v  [B, S, K, Dh]
//   o  [B, S, H, Dh]   in q's dtype
//
// Math (as the TPU kernel): scores (q . k) * Dh^-1/2 in fp32, causal mask
// with NEG_INF = -1e30, online softmax in fp32 carried across key tiles,
// out = acc / l with the l == 0 guard. S needs no padding: rows and keys past
// S are masked here.
//
// What bounds it on the H100: FLOPs, 4*S^2/2*Dh per (batch, head), and the
// S^2 score traffic a plain version would write to device memory. The design
// never materialises the scores: one block of 4 warps owns 32 query rows of
// one (batch, head) and walks the key tiles up to its causal limit, 32 keys
// at a time. Q, K and V tiles are widened to fp32 in shared memory (K rows
// padded to a 16-byte multiple that leaves float4 reads free of bank
// conflicts). For QK^T each lane owns one key and each warp 8 query rows;
// the row max and sum are warp reductions; for PV each lane owns Dh/32
// output columns and the probabilities are broadcast with shuffles. It runs
// on the fp32 CUDA cores: at prefill lengths (128-768 tokens) the attention
// is a few per cent of a layer's FLOPs next to the linears, and a
// tensor-core (mma/wgmma) version is the step for later work.
//
// C interface (bound with ctypes): pointers and the stream are void*, the
// launch goes on the caller's stream, nothing is allocated, and the return
// value is cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 8;
constexpr int kBQ = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kBK = 32;                     // keys per tile (one per lane)
constexpr float kNegInf = -1e30f;

template <typename T>
struct Elt;

template <>
struct Elt<float> {
  static constexpr int kPerVec = 4;  // values per 16-byte load
  static __device__ __forceinline__ void widen(const float* src, float* dst) {
    const float4 v = *reinterpret_cast<const float4*>(src);
    *reinterpret_cast<float4*>(dst) = v;
  }
  static __device__ __forceinline__ float from_float(float x) { return x; }
};

template <>
struct Elt<__nv_bfloat16> {
  static constexpr int kPerVec = 8;
  static __device__ __forceinline__ void widen(const __nv_bfloat16* src, float* dst) {
    const uint4 v = *reinterpret_cast<const uint4*>(src);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    float f[8];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      f[2 * j] = __uint_as_float(w[j] << 16);
      f[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
    reinterpret_cast<float4*>(dst)[0] = make_float4(f[0], f[1], f[2], f[3]);
    reinterpret_cast<float4*>(dst)[1] = make_float4(f[4], f[5], f[6], f[7]);
  }
  static __device__ __forceinline__ __nv_bfloat16 from_float(float x) {
    return __float2bfloat16_rn(x);
  }
};

// rows [row0, row0 + nrows) of a [*, row_stride] tensor -> fp32 tile with
// `ld` floats per row; rows at or past `limit` are zero-filled.
template <typename T, int DH>
__device__ __forceinline__ void load_tile(float* tile, int ld, const T* base,
                                          size_t row_stride, int row0, int nrows, int limit) {
  constexpr int V = Elt<T>::kPerVec;
  constexpr int vecs_per_row = DH / V;
  for (int idx = threadIdx.x; idx < nrows * vecs_per_row; idx += kWarps * 32) {
    const int r = idx / vecs_per_row;
    const int c = (idx % vecs_per_row) * V;
    float* dst = tile + r * ld + c;
    if (row0 + r < limit) {
      Elt<T>::widen(base + (size_t)(row0 + r) * row_stride + c, dst);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) dst[i] = 0.f;
    }
  }
}

// DPL consecutive floats of shared memory in one vector read
template <int N>
__device__ __forceinline__ void load_cols(const float* p, float* out);

template <>
__device__ __forceinline__ void load_cols<4>(const float* p, float* out) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  out[0] = t.x;
  out[1] = t.y;
  out[2] = t.z;
  out[3] = t.w;
}

template <>
__device__ __forceinline__ void load_cols<2>(const float* p, float* out) {
  const float2 t = *reinterpret_cast<const float2*>(p);
  out[0] = t.x;
  out[1] = t.y;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// grid: (ceil(S / kBQ), B * H); block: kWarps * 32 threads.
template <typename T, int DH>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int S, int H, int K, float scale) {
  constexpr int DPL = DH / 32;  // output columns per lane
  constexpr int LDQ = DH;
  constexpr int LDK = DH + 4;   // keeps float4 reads of K rows conflict-free
  constexpr int LDV = DH;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kBQ * LDQ;
  float* Vs = Ks + kBK * LDK;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int hh = bh % H;
  const int kh = hh / (H / K);
  const int q0 = blockIdx.x * kBQ;

  const size_t q_stride = (size_t)H * DH;
  const size_t kv_stride = (size_t)K * DH;
  const T* qb = q + (size_t)b * S * q_stride + (size_t)hh * DH;
  const T* kb = k + (size_t)b * S * kv_stride + (size_t)kh * DH;
  const T* vb = v + (size_t)b * S * kv_stride + (size_t)kh * DH;

  load_tile<T, DH>(Qs, LDQ, qb, q_stride, q0, kBQ, S);

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][DPL];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int d = 0; d < DPL; ++d) acc[i][d] = 0.f;
  }

  const int row_base = warp * kRowsPerWarp;  // this warp's rows in the tile
  const int q_last = min(q0 + kBQ, S) - 1;   // causal limit of the block
  for (int k0 = 0; k0 <= q_last; k0 += kBK) {
    __syncthreads();  // previous tile fully consumed (and Q tile loaded)
    load_tile<T, DH>(Ks, LDK, kb, kv_stride, k0, kBK, S);
    load_tile<T, DH>(Vs, LDV, vb, kv_stride, k0, kBK, S);
    __syncthreads();

    // scores: lane owns key k0 + lane, for the warp's 8 query rows
    float sc[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) sc[i] = 0.f;
    const float* krow = Ks + lane * LDK;
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(krow + d);
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(Qs + (row_base + i) * LDQ + d);
        sc[i] = fmaf(qv.x, kv.x, sc[i]);
        sc[i] = fmaf(qv.y, kv.y, sc[i]);
        sc[i] = fmaf(qv.z, kv.z, sc[i]);
        sc[i] = fmaf(qv.w, kv.w, sc[i]);
      }
    }

    const int kj = k0 + lane;
    float p[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int qi = q0 + row_base + i;
      float s = sc[i] * scale;
      if (kj > qi || kj >= S) s = kNegInf;
      const float m_new = fmaxf(m[i], warp_max(s));
      p[i] = expf(s - m_new);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + warp_sum(p[i]);
#pragma unroll
      for (int d = 0; d < DPL; ++d) acc[i][d] *= corr;
      m[i] = m_new;
    }

    // PV: lane owns columns [lane*DPL, lane*DPL + DPL)
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float vv[DPL];
      load_cols<DPL>(Vs + j * LDV + lane * DPL, vv);
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float pj = __shfl_sync(0xffffffffu, p[i], j);
#pragma unroll
        for (int d = 0; d < DPL; ++d) acc[i][d] = fmaf(pj, vv[d], acc[i][d]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int qi = q0 + row_base + i;
    if (qi >= S) continue;
    const float inv = 1.f / (l[i] == 0.f ? 1.f : l[i]);
    T* orow = o + ((size_t)b * S + qi) * q_stride + (size_t)hh * DH + lane * DPL;
#pragma unroll
    for (int d = 0; d < DPL; ++d) orow[d] = Elt<T>::from_float(acc[i][d] * inv);
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
                   int K, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)kBQ * DH + (size_t)kBK * (DH + 4) + (size_t)kBK * DH);
  // above 48 KB of dynamic shared memory only after opting in
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, B * H);
  const float scale = 1.0f / sqrtf((float)DH);
  flash_fwd_kernel<T, DH><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), S, H, K, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = fp32, 1 = bf16. Preconditions (checked by the Python wrapper):
// Dh in {64, 128}, H % K == 0, contiguous 16-byte-aligned tensors.
int flash_attn_causal(const void* q, const void* k, const void* v, void* o, int B, int S,
                      int H, int K, int Dh, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K <= 0 || H % K != 0 || S <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1 && Dh == 128) return launch<__nv_bfloat16, 128>(q, k, v, o, B, S, H, K, st);
  if (dtype == 1 && Dh == 64) return launch<__nv_bfloat16, 64>(q, k, v, o, B, S, H, K, st);
  if (dtype == 0 && Dh == 128) return launch<float, 128>(q, k, v, o, B, S, H, K, st);
  if (dtype == 0 && Dh == 64) return launch<float, 64>(q, k, v, o, B, S, H, K, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
