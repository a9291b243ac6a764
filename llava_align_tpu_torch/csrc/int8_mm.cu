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

// ---------------------------------------------------------------------------
// Tiled regime (65..640 rows, bf16 only): bf16 tensor-core MMA
// (mma.sync m16n8k16, fp32 accumulators). Above 64 rows the FMA work of the
// streaming kernel grows with B; this regime serves the lm_head at the
// grouped path's 72 rows and, as on the TPU, output-major (O >= D) matrices
// up to 640 rows. A block owns kBM rows x kBN output rows of q and walks D in
// steps of kBK: the int8 weights are widened to bf16 (exact: |q| <= 127) into
// shared memory as [n][k], the activation tile is copied as [m][k], and both
// load as fragments by ldmatrix without .trans (y = h . q^T). The scale is
// applied once per output after the reduction, as in the streaming kernel.
// The next step's global loads are issued before the current step's MMAs
// (register double buffering, two shared-memory buffers, one barrier per
// step). The grid's fastest axis is the row tile, so the blocks that share a
// weight tile run together and read it once from device memory.
// ---------------------------------------------------------------------------

constexpr int kBM = 64, kBN = 64, kBK = 64;
constexpr int kTWarpsN = 2;               // 2 x 2 warps, 32 x 32 outputs each
constexpr int kTThreads = 128;
constexpr int kTStride = kBK + 8;         // bf16 per shared row (ldmatrix without conflicts)
constexpr int kAChunks = kBM * kBK / 8 / kTThreads;   // 16-byte bf16 chunks per thread
constexpr int kWChunks = kBN * kBK / 16 / kTThreads;  // 16-byte int8 chunks per thread

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const __nv_bfloat16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
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

// Grid: (ceil(B / kBM), ceil(O / kBN)); D % kBK == 0.
__global__ void __launch_bounds__(kTThreads)
int8_tiled_kernel(const __nv_bfloat16* __restrict__ h, const int8_t* __restrict__ q,
                  const float* __restrict__ s, __nv_bfloat16* __restrict__ y, int B, int O,
                  int D) {
  __shared__ __align__(128) __nv_bfloat16 As[2][kBM][kTStride];
  __shared__ __align__(128) __nv_bfloat16 Ws[2][kBN][kTStride];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp / kTWarpsN;
  const int wn = warp % kTWarpsN;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int nsteps = D / kBK;

  uint4 areg[kAChunks];
  uint4 wreg[kWChunks];

  auto load_global = [&](int step) {
    const int k0 = step * kBK;
#pragma unroll
    for (int c = 0; c < kAChunks; ++c) {
      const int idx = tid + c * kTThreads;
      const int row = idx >> 3;  // 8 chunks of 8 bf16 per row
      areg[c] = m0 + row < B
                    ? __ldg(reinterpret_cast<const uint4*>(h + (size_t)(m0 + row) * D + k0) + (idx & 7))
                    : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int c = 0; c < kWChunks; ++c) {
      const int idx = tid + c * kTThreads;
      const int row = idx >> 2;  // 4 chunks of 16 int8 per row
      wreg[c] = n0 + row < O
                    ? __ldg(reinterpret_cast<const uint4*>(q + (size_t)(n0 + row) * D + k0) + (idx & 3))
                    : make_uint4(0u, 0u, 0u, 0u);
    }
  };

  auto store_smem = [&](int buf) {
#pragma unroll
    for (int c = 0; c < kAChunks; ++c) {
      const int idx = tid + c * kTThreads;
      *reinterpret_cast<uint4*>(&As[buf][idx >> 3][(idx & 7) * 8]) = areg[c];
    }
#pragma unroll
    for (int c = 0; c < kWChunks; ++c) {
      const int idx = tid + c * kTThreads;
      const uint32_t words[4] = {wreg[c].x, wreg[c].y, wreg[c].z, wreg[c].w};
      uint32_t packed[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float f[4];
        widen4(words[j], f);
        packed[2 * j] = pack_bf16x2(f[0], f[1]);
        packed[2 * j + 1] = pack_bf16x2(f[2], f[3]);
      }
      uint4* dst = reinterpret_cast<uint4*>(&Ws[buf][idx >> 2][(idx & 3) * 16]);
      dst[0] = make_uint4(packed[0], packed[1], packed[2], packed[3]);
      dst[1] = make_uint4(packed[4], packed[5], packed[6], packed[7]);
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  auto compute = [&](int buf) {
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t af[2][4];
      uint32_t bf[4][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldmatrix_x4(af[mt], &As[buf][wm * 32 + mt * 16 + (lane & 15)][kk * 16 + (lane >> 4) * 8]);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        // matrices 0, 1: n-tile 2np at k 0-7, 8-15; matrices 2, 3: n-tile 2np + 1
        uint32_t r[4];
        ldmatrix_x4(r, &Ws[buf][wn * 32 + np * 16 + (lane >> 4) * 8 + (lane & 7)]
                          [kk * 16 + ((lane >> 3) & 1) * 8]);
        bf[2 * np][0] = r[0];
        bf[2 * np][1] = r[1];
        bf[2 * np + 1][0] = r[2];
        bf[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], af[mt], bf[nt]);
    }
  };

  load_global(0);
  store_smem(0);
  __syncthreads();
  for (int step = 0; step < nsteps; ++step) {
    const int buf = step & 1;
    const bool more = step + 1 < nsteps;
    if (more) load_global(step + 1);  // in flight during this step's MMAs
    compute(buf);
    if (more) store_smem(buf ^ 1);
    __syncthreads();
  }

  const int gid = lane >> 2;
  const int tig = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + wm * 32 + mt * 16 + gid + (e >> 1) * 8;
        const int col = n0 + wn * 32 + nt * 8 + tig * 2 + (e & 1);
        if (row < B && col < O) y[(size_t)row * O + col] = __float2bfloat16_rn(acc[mt][nt][e] * s[col]);
      }
}

cudaError_t launch_tiled(const void* h, const int8_t* q, const float* s, void* y, int B, int O,
                         int D, cudaStream_t stream) {
  const dim3 grid((B + kBM - 1) / kBM, (O + kBN - 1) / kBN);
  int8_tiled_kernel<<<grid, kTThreads, 0, stream>>>(static_cast<const __nv_bfloat16*>(h), q, s,
                                                    static_cast<__nv_bfloat16*>(y), B, O, D);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = fp32, 1 = bf16. Preconditions (checked by the Python wrapper):
// D % 16 == 0, all pointers 16-byte aligned, 0 <= li < L; 1 <= B <= 64 (the
// streaming kernel, either dtype), or 64 < B <= 640 with bf16 and D % 64 == 0
// (the tiled regime).
int int8_mm_stacked(const void* h, const void* q, const void* s, void* y, int B, int O,
                    int D, int li, int dtype, void* stream) {
  const int8_t* ql = static_cast<const int8_t*>(q) + (size_t)li * O * D;
  const float* sl = static_cast<const float*>(s) + (size_t)li * O;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || B > 640 || D % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B > 64) {
    if (dtype != 1 || D % kBK != 0) return static_cast<int>(cudaErrorInvalidValue);
    return launch_tiled(h, ql, sl, y, B, O, D, st);
  }
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
