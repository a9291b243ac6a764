// Index-mapping 2-D copy for Hopper (sm_90a):
//
//   y[i, j] = c * x[r0 + map_r(i), c0 + map_c(j)],
//   map(i) = i % n (tile: the source window repeats as a whole)
//         or i / n (repeat: each source element repeats n times)
//
// Replaces the six kernels of scripts/probe_mosaic_ops.py (run by its tryk):
// k_rep, k_slice_rep and k_rep0 tile (pltpu.repeat tiles: repeat(x, 2, 1)
// of [[0, 1, 2]] is [[0, 1, 2, 0, 1, 2]]), k_jrep and k_bcast repeat each
// element (jnp.repeat, and broadcast_in_dim + reshape of rows), k_dyn takes
// a column window times 2. The static and dynamic slices are the window
// offset (r0, c0); the TPU script's x2 is the scale c.
//
//   x  fp32, rows of `ld` elements (a strided view's row stride), last
//      dimension contiguous
//   y  [rows, cols] fp32, contiguous
//
// What bounds it on the H100: bytes. Each output element is one fp32 load
// (from L1/L2 after the first: the source window is small and read again)
// and one store; at the script's shapes (at most 512 x 2048 outputs, 4 MB)
// the launch itself is most of the time. One thread per output element in
// a grid-stride loop; consecutive threads write consecutive addresses, so
// the stores coalesce.
//
// C interface (bound with ctypes): pointers and the stream are void*, the
// launch goes on the caller's stream, nothing is allocated, and the return
// value is cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;  // enough blocks in flight to fill 132 SMs

__device__ __forceinline__ int map_index(int i, int mode, int n) { return mode ? i / n : i % n; }

__global__ void __launch_bounds__(kThreads)
repeat2d_kernel(const float* __restrict__ x, float* __restrict__ y, long long ld, int rows,
                int cols, int r0, int c0, int mode_r, int n_r, int mode_c, int n_c, float c) {
  const long long total = (long long)rows * cols;
  for (long long idx = (long long)blockIdx.x * kThreads + threadIdx.x; idx < total;
       idx += (long long)gridDim.x * kThreads) {
    const int i = static_cast<int>(idx / cols);
    const int j = static_cast<int>(idx - (long long)i * cols);
    const long long src = (long long)(r0 + map_index(i, mode_r, n_r)) * ld + c0 + map_index(j, mode_c, n_c);
    y[idx] = c * __ldg(x + src);
  }
}

}  // namespace

extern "C" {

// mode_r / mode_c: 0 = tile (i % n), 1 = repeat (i / n). Preconditions
// (checked by the Python wrapper): n_r, n_c >= 1, every mapped index inside
// x, rows * cols >= 1.
int repeat2d(const void* x, void* y, long long ld, int rows, int cols, int r0, int c0, int mode_r,
             int n_r, int mode_c, int n_c, float c, void* stream) {
  if (rows < 1 || cols < 1 || n_r < 1 || n_c < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long total = (long long)rows * cols;
  const long long want = (total + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
  repeat2d_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y), ld, rows, cols, r0, c0, mode_r, n_r,
      mode_c, n_c, c);
  return cudaGetLastError();
}

}  // extern "C"
