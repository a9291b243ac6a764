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
// What bounds it on the H100. Per (batch, head) it moves 4 S Dh bf16 values
// (q, k, v, o) and does 4 Dh S (S + 1) / 2 operations (QK^T and PV over the
// causal pairs). At the prefill lengths of the model paths (128-896 tokens)
// the bytes bound it: [1,640,32,128] needs 0.0063 ms at 3.35 TB/s against
// 0.0034 ms of bf16 tensor-core operations at 989 TFLOP/s. Neither is
// within reach unless the products run on the tensor cores and the S^2
// scores never reach device memory.
//
// bf16: a FlashAttention-2-style forward on the tensor cores (mma.sync
// m16n8k16, bf16 operands, fp32 accumulators).
//  - A block of 4 warps owns 64 query rows of one (batch, head), 16 per
//    warp, and walks the key tiles 0 .. its diagonal, 64 keys at a time.
//    The grid is (B * H, query blocks) with the query blocks reversed, so
//    the longest rows of the causal triangle launch first.
//  - Q, K and V tiles come into shared memory by 16-byte cp.async.cg; K/V
//    are double-buffered (tile j + 1 is in flight during tile j's
//    products). Rows at or past S are zero-filled by the copy's src-size
//    operand, with the source clamped to row 0, so nothing reads out of
//    bounds.
//  - Each shared row is padded by 16 bytes (ld = Dh + 8 bf16): a Dh = 128
//    row is 256 bytes, so unpadded rows would all start on one bank and
//    ldmatrix would be 8-way conflicted; padded, the 8 row addresses of one
//    8x8 matrix fall on 8 distinct 4-bank groups.
//  - Q's A fragments (ldmatrix.x4) stay in registers for the whole key
//    loop; K's B fragments are ldmatrix.x4 of [key][Dh] rows (already the
//    col-major B of QK^T), V's are ldmatrix.x4.trans. The next fragment's
//    ldmatrix is issued before the current one's two mma.
//  - The fp32 C fragment of S (m16n8) has the thread/element layout of the
//    A fragment of the next m16n8k16 product once two neighbouring n8 tiles
//    are packed to bf16x2, so P feeds PV from registers. P is rounded to
//    bf16 for PV; the row sum l is taken from the fp32 p.
//  - A query row lives in the 4 threads of a quad: the row max is two
//    __shfl_xor_sync (1, 2) per tile, the row sum stays per thread (it is
//    rescaled by the quad's common factor) and is summed over the quad once
//    at the end. Each exponent is ex2.approx of one FFMA on the raw score.
//  - The mask is applied on the diagonal tile only (key > row, or key >= S).
//    Every row sees key 0 in tile 0, so m is finite before any masked entry
//    and masked entries give 2^(-1e30 c - m c) = 0.
//  - O goes back through the Q tile's shared memory, so rows leave in
//    16-byte stores.
//  Shared memory: (1 + 2 x 2) x 64 x (Dh + 8) bf16 = 87,040 bytes at
//  Dh = 128 (two blocks on an SM), 46,080 at Dh = 64.
//  What holds it back (measured, PERF.md): ~195 TFLOP/s at 768-896 tokens,
//  about half the rate of PyTorch's SDPA there. With 16 rows per warp every
//  warp reads all of a K and V tile from shared memory through ldmatrix;
//  32-key tiles, 32 rows per warp, or three blocks per SM (staging Q in a
//  K buffer) spilled registers or ran slower. wgmma with TMA, which reads
//  B from shared memory once per 64-row warpgroup, is the next step.
//
// fp32: CUDA cores (the tensor cores would need TF32 or bf16 operands). One
// block of 4 warps owns 32 query rows and walks 32-key tiles; Q, K and V
// tiles in fp32 shared memory, one key per lane for QK^T, shuffle-broadcast
// probabilities for PV. No model path runs it on the card.
//
// C interface (bound with ctypes): pointers and the stream are void*, the
// launch goes on the caller's stream, nothing is allocated, and the return
// value is cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;
constexpr int kMaxDevices = 64;

// Above 48 KB of dynamic shared memory a kernel runs only after opting in,
// which holds for the current device: `opted` remembers the devices done. A
// failure is not remembered, so the next launch tries again.
template <typename Kernel>
cudaError_t opt_in_smem(Kernel kernel, int smem, std::atomic<bool>* opted) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool keep = dev >= 0 && dev < kMaxDevices;
  if (keep && opted[dev].load(std::memory_order_acquire)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && keep) opted[dev].store(true, std::memory_order_release);
  return err;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kTile = 64;  // query rows per block = keys per tile
constexpr float kLog2e = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool full) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = full ? 16 : 0;  // 0: zero-fill the 16 bytes, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// rows [row0, row0 + kTile) of a [*, row_stride] tensor -> a [kTile][DH + 8]
// shared tile by cp.async; rows at or past `limit` are zero-filled
template <int DH>
__device__ __forceinline__ void load_tile_async(bf16* tile, const bf16* base, size_t row_stride,
                                                int row0, int limit) {
  constexpr int kChunks = DH / 8;  // 16-byte chunks per row
  constexpr int LD = DH + 8;
#pragma unroll
  for (int i = 0; i < kTile * kChunks / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * 8;
    const bool ok = row0 + r < limit;
    cp_async_16(tile + r * LD + c, base + (size_t)(ok ? row0 + r : 0) * row_stride + c, ok);
  }
}

// The fragments of one tile's products, by a flat index: QK^T's i-th
// ldmatrix is the k16 step i / 4 of key pair i % 4 (lanes 0-7 / 8-15
// address keys 0-7 at Dh offsets 0 / 8, the B fragment of one n8 tile;
// lanes 16-31 the same for keys 8-15); PV's i-th ldmatrix.trans is the key
// step i / (Dh / 16) of the Dh pair i % (Dh / 16).
template <int DH>
__device__ __forceinline__ void load_k_frag(uint32_t r[4], const bf16* Kt, int i, int lane) {
  constexpr int LD = DH + 8;
  const int kd = i / (kTile / 16), np = i % (kTile / 16);
  ldmatrix_x4(r, Kt + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + kd * 16 +
                     ((lane >> 3) & 1) * 8);
}

template <int DH>
__device__ __forceinline__ void load_v_frag(uint32_t r[4], const bf16* Vt, int i, int lane) {
  constexpr int LD = DH + 8;
  const int kk = i / (DH / 16), np = i % (DH / 16);
  ldmatrix_x4_trans(r, Vt + (kk * 16 + (lane & 15)) * LD + np * 16 + (lane >> 4) * 8);
}

// grid: (B * H, ceil(S / kTile)); block: kThreads.
template <int DH>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o, int S, int H, int K,
                     float scale_log2) {
  constexpr int LD = DH + 8;
  constexpr int KD = DH / 16;                   // k16 steps of QK^T
  constexpr int ND = DH / 8;                    // n8 tiles of O
  constexpr int NS = kTile / 8;                 // n8 tiles of S
  constexpr int NK = KD * NS / 2;               // K fragment loads per tile
  constexpr int NV = (kTile / 16) * (ND / 2);   // V fragment loads per tile
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [kTile][LD], at the end O
  bf16* Ks = Qs + kTile * LD;                     // [2][kTile][LD]
  bf16* Vs = Ks + 2 * kTile * LD;                 // [2][kTile][LD]

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // the fragment row (and row + 8) of this thread
  const int t = lane & 3;   // its column pair 2t, 2t + 1 in each n8 tile
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int hh = bh % H;
  const int kh = hh / (H / K);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;  // the longest rows launch first
  const int n_tiles = q0 / kTile + 1;                    // key tiles up to the diagonal
  const int wrow = warp * 16;                            // the warp's first row in the block

  const size_t q_stride = (size_t)H * DH;
  const size_t kv_stride = (size_t)K * DH;
  const bf16* qbase = q + (size_t)b * S * q_stride + (size_t)hh * DH;
  const bf16* kbase = k + (size_t)b * S * kv_stride + (size_t)kh * DH;
  const bf16* vbase = v + (size_t)b * S * kv_stride + (size_t)kh * DH;

  load_tile_async<DH>(Qs, qbase, q_stride, q0, S);
  load_tile_async<DH>(Ks, kbase, kv_stride, 0, S);
  load_tile_async<DH>(Vs, vbase, kv_stride, 0, S);
  cp_async_commit();

  uint32_t qf[KD][4];  // Q's A fragments, for the whole key loop
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};  // raw maxima of rows g and g + 8
  float l[2] = {0.f, 0.f};          // this thread's part of their sums

  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_tiles) {  // tile j + 1 into the other buffer, freed at the end of j - 1
      load_tile_async<DH>(Ks + (buf ^ 1) * kTile * LD, kbase, kv_stride, (j + 1) * kTile, S);
      load_tile_async<DH>(Vs + (buf ^ 1) * kTile * LD, vbase, kv_stride, (j + 1) * kTile, S);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kd = 0; kd < KD; ++kd)
        ldmatrix_x4(qf[kd], Qs + (wrow + (lane & 15)) * LD + kd * 16 + (lane >> 4) * 8);
    }
    const bf16* Kt = Ks + buf * kTile * LD;
    const bf16* Vt = Vs + buf * kTile * LD;

    // S = Q K^T. Two fragment slots: fragment i + 1's ldmatrix is in flight
    // while fragment i's two mma run.
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    uint32_t kf[2][4];
    load_k_frag<DH>(kf[0], Kt, 0, lane);
#pragma unroll
    for (int i = 0; i < NK; ++i) {
      if (i + 1 < NK) load_k_frag<DH>(kf[(i + 1) & 1], Kt, i + 1, lane);
      const uint32_t* r = kf[i & 1];
      const int kd = i / (NS / 2), np = i % (NS / 2);
      mma_bf16(s[2 * np], qf[kd], r[0], r[1]);
      mma_bf16(s[2 * np + 1], qf[kd], r[2], r[3]);
    }
    // V's first fragment loads during the softmax
    uint32_t vf[2][4];
    load_v_frag<DH>(vf[0], Vt, 0, lane);

    // mask the diagonal tile (key > row, or key >= S); online softmax on the
    // raw scores, each exponent one FFMA: e^(scale (s - m)) = 2^(s c - m c)
    if (j == n_tiles - 1) {
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = j * kTile + n * 8 + 2 * t + (e & 1);
          const int row = q0 + wrow + g + (e >> 1) * 8;
          if (key > row || key >= S) s[n][e] = kNegInf;
        }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
    }
    float corr[2], msc[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = fast_exp2((m[r] - mx[r]) * scale_log2);
      msc[r] = mx[r] * scale_log2;
      m[r] = mx[r];
      l[r] *= corr[r];
    }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }
    // P as the A fragments of PV: the k16 step kk takes S's n8 tiles 2kk and
    // 2kk + 1, packed to bf16x2; the row sums take the fp32 values
    uint32_t pa[kTile / 16][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = fast_exp2(fmaf(s[n][e], scale_log2, -msc[e >> 1]));
        l[e >> 1] += p[e];
      }
      pa[n / 2][(n & 1) * 2] = pack_bf16x2(p[0], p[1]);
      pa[n / 2][(n & 1) * 2 + 1] = pack_bf16x2(p[2], p[3]);
    }

    // O += P V
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (i + 1 < NV) load_v_frag<DH>(vf[(i + 1) & 1], Vt, i + 1, lane);
      const uint32_t* r = vf[i & 1];
      const int kk = i / (ND / 2), np = i % (ND / 2);
      mma_bf16(acc[2 * np], pa[kk], r[0], r[1]);
      mma_bf16(acc[2 * np + 1], pa[kk], r[2], r[3]);
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

  // out = acc / l (l == 0 guard), staged through the Q tile (each warp
  // writes the rows only it read), then 16-byte stores of the rows below S
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / (l[r] == 0.f ? 1.f : l[r]);
  }
  bf16* orow = Qs + (wrow + g) * LD + 2 * t;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    *reinterpret_cast<uint32_t*>(orow + n * 8) = pack_bf16x2(acc[n][0] * inv[0], acc[n][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(orow + 8 * LD + n * 8) =
        pack_bf16x2(acc[n][2] * inv[1], acc[n][3] * inv[1]);
  }
  __syncthreads();
  constexpr int kChunks = DH / 8;
  bf16* obase = o + (size_t)b * S * q_stride + (size_t)hh * DH;
#pragma unroll
  for (int i = 0; i < kTile * kChunks / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * 8;
    if (q0 + r < S)
      *reinterpret_cast<uint4*>(obase + (size_t)(q0 + r) * q_stride + c) =
          *reinterpret_cast<const uint4*>(Qs + r * LD + c);
  }
}

template <int DH>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
                       int K, cudaStream_t stream) {
  const size_t smem = sizeof(bf16) * 5 * kTile * (DH + 8);  // Q, and K and V twice
  static std::atomic<bool> opted[kMaxDevices];
  const cudaError_t attr = opt_in_smem(flash_fwd_mma_kernel<DH>, (int)smem, opted);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(B * H, (S + kTile - 1) / kTile);
  const float scale_log2 = kLog2e / sqrtf((float)DH);  // Dh^-1/2 log2(e)
  flash_fwd_mma_kernel<DH><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), S, H, K, scale_log2);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kRowsPerWarp = 8;
constexpr int kBQ = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kBK = 32;                     // keys per tile (one per lane)

// rows [row0, row0 + nrows) of a [*, row_stride] tensor -> fp32 tile with
// `ld` floats per row; rows at or past `limit` are zero-filled.
template <int DH>
__device__ __forceinline__ void load_tile(float* tile, int ld, const float* base,
                                          size_t row_stride, int row0, int nrows, int limit) {
  constexpr int vecs_per_row = DH / 4;
  for (int idx = threadIdx.x; idx < nrows * vecs_per_row; idx += kThreads) {
    const int r = idx / vecs_per_row;
    const int c = (idx % vecs_per_row) * 4;
    *reinterpret_cast<float4*>(tile + r * ld + c) =
        row0 + r < limit
            ? *reinterpret_cast<const float4*>(base + (size_t)(row0 + r) * row_stride + c)
            : make_float4(0.f, 0.f, 0.f, 0.f);
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

// grid: (ceil(S / kBQ), B * H); block: kThreads.
template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_fwd_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o, int S, int H, int K,
                      float scale) {
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
  const float* qb = q + (size_t)b * S * q_stride + (size_t)hh * DH;
  const float* kb = k + (size_t)b * S * kv_stride + (size_t)kh * DH;
  const float* vb = v + (size_t)b * S * kv_stride + (size_t)kh * DH;

  load_tile<DH>(Qs, LDQ, qb, q_stride, q0, kBQ, S);

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
    load_tile<DH>(Ks, LDK, kb, kv_stride, k0, kBK, S);
    load_tile<DH>(Vs, LDV, vb, kv_stride, k0, kBK, S);
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
    float* orow = o + ((size_t)b * S + qi) * q_stride + (size_t)hh * DH + lane * DPL;
#pragma unroll
    for (int d = 0; d < DPL; ++d) orow[d] = acc[i][d] * inv;
  }
}

template <int DH>
cudaError_t launch_fp32(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
                        int K, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)kBQ * DH + (size_t)kBK * (DH + 4) + (size_t)kBK * DH);
  static std::atomic<bool> opted[kMaxDevices];
  const cudaError_t attr = opt_in_smem(flash_fwd_fp32_kernel<DH>, (int)smem, opted);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((S + kBQ - 1) / kBQ, B * H);
  const float scale = 1.0f / sqrtf((float)DH);
  flash_fwd_fp32_kernel<DH><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), S, H, K, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = fp32 (CUDA cores), 1 = bf16 (tensor cores). Preconditions
// (checked by the Python wrapper): Dh in {64, 128}, H % K == 0, contiguous
// 16-byte-aligned tensors.
int flash_attn_causal(const void* q, const void* k, const void* v, void* o, int B, int S,
                      int H, int K, int Dh, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K <= 0 || H % K != 0 || S <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1 && Dh == 128) return launch_mma<128>(q, k, v, o, B, S, H, K, st);
  if (dtype == 1 && Dh == 64) return launch_mma<64>(q, k, v, o, B, S, H, K, st);
  if (dtype == 0 && Dh == 128) return launch_fp32<128>(q, k, v, o, B, S, H, K, st);
  if (dtype == 0 && Dh == 64) return launch_fp32<64>(q, k, v, o, B, S, H, K, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
