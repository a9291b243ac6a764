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
// What bounds it on the H100: bytes, and at the script's shapes (at most
// 512 x 2048 outputs, 4 MB) the launch itself. The design keeps the work per
// output element to one store slot:
//  - a 2-D grid: threadIdx.x / blockIdx.x walk a row's column units,
//    threadIdx.y / blockIdx.y its rows, so each thread computes its column
//    map once and the row map once per row it writes, in 32-bit integers;
//    the row loop strides by the grid's rows when the rows outnumber it;
//  - each thread writes one 16-byte float4 of four consecutive columns
//    when cols % 4 == 0 and y is 16-byte aligned, and the four values come
//    from one source element (repeat with n % 4 == 0: one load, broadcast)
//    or from four contiguous source elements (tile with n % 4 == 0 or a
//    period past the row, or repeat by 1, with the source 16-byte aligned:
//    one float4 load); any other shape writes one element per thread;
//  - the path and the row map are template parameters, so the loop body has
//    no branch and no runtime division it does not need;
//  - the grid covers the rows up to the 65535 blocks of gridDim.y; past
//    that the row loop strides.
//
// C interface (bound with ctypes): pointers and the stream are void*, the
// launch goes on the caller's stream, nothing is allocated, and the return
// value is cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

enum RowMap { kTile = 0, kRepeat = 1 };
// column paths: one element per thread (by mode), or one float4 per thread
enum ColPath { kScalarTile, kScalarRepeat, kVecContig, kVecBcast };

template <int MODE>
__device__ __forceinline__ int map_index(int i, int n) { return MODE == kRepeat ? i / n : i % n; }

template <int MR, int CP>
__global__ void __launch_bounds__(kThreads)
repeat2d_kernel(const float* __restrict__ x, float* __restrict__ y, long long ld, int rows, int units,
                int cols, int r0, int c0, int n_r, int n_c, float c) {
  const int u = blockIdx.x * blockDim.x + threadIdx.x;  // the thread's column unit
  if (u >= units) return;
  constexpr bool kVec = CP >= kVecContig;
  // the column map, once per thread
  int src;
  if constexpr (CP == kScalarTile) src = c0 + u % n_c;
  if constexpr (CP == kScalarRepeat) src = c0 + u / n_c;
  if constexpr (CP == kVecContig) src = c0 + (4 * u) % n_c;  // n_c % 4 == 0: no wrap inside the four
  if constexpr (CP == kVecBcast) src = c0 + (4 * u) / n_c;   // n_c % 4 == 0: one element for the four
  const int row_step = gridDim.y * blockDim.y;
  for (int i = blockIdx.y * blockDim.y + threadIdx.y; i < rows; i += row_step) {
    const float* xr = x + (long long)(r0 + map_index<MR>(i, n_r)) * ld;
    float* yr = y + (long long)i * cols;
    if constexpr (!kVec) {
      yr[u] = c * __ldg(xr + src);
    } else {
      float4 v;
      if constexpr (CP == kVecContig) {
        v = __ldg(reinterpret_cast<const float4*>(xr + src));
        v.x *= c; v.y *= c; v.z *= c; v.w *= c;
      } else {
        const float s = c * __ldg(xr + src);
        v = make_float4(s, s, s, s);
      }
      reinterpret_cast<float4*>(yr)[u] = v;
    }
  }
}

template <int MR>
void launch(int path, dim3 grid, dim3 block, cudaStream_t st, const float* x, float* y, long long ld,
            int rows, int units, int cols, int r0, int c0, int n_r, int n_c, float c) {
#define REPEAT2D_CASE(CP)                                                                         \
  case CP:                                                                                        \
    repeat2d_kernel<MR, CP><<<grid, block, 0, st>>>(x, y, ld, rows, units, cols, r0, c0, n_r,     \
                                                    n_c, c);                                      \
    break;
  switch (path) {
    REPEAT2D_CASE(kScalarTile)
    REPEAT2D_CASE(kScalarRepeat)
    REPEAT2D_CASE(kVecContig)
    REPEAT2D_CASE(kVecBcast)
  }
#undef REPEAT2D_CASE
}

}  // namespace

extern "C" {

// mode_r / mode_c: 0 = tile (i % n), 1 = repeat (i / n). Preconditions
// (checked by the Python wrapper): n_r, n_c >= 1, every mapped index inside
// x, rows * cols >= 1.
int repeat2d(const void* x, void* y, long long ld, int rows, int cols, int r0, int c0, int mode_r,
             int n_r, int mode_c, int n_c, float c, void* stream) {
  if (rows < 1 || cols < 1 || n_r < 1 || n_c < 1) return static_cast<int>(cudaErrorInvalidValue);
  int path = mode_c == kRepeat ? kScalarRepeat : kScalarTile;
  if (cols % 4 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0) {
    // the four outputs of a unit read four contiguous source elements
    const bool contig = (mode_c == kTile && (n_c % 4 == 0 || n_c >= cols)) || (mode_c == kRepeat && n_c == 1);
    const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 && ld % 4 == 0 && c0 % 4 == 0;
    if (mode_c == kRepeat && n_c % 4 == 0) {
      path = kVecBcast;
    } else if (contig && aligned) {
      path = kVecContig;
      if (n_c % 4 != 0 || mode_c == kRepeat) n_c = cols;  // no wrap inside the row: a period of cols
    }
  }
  const bool vec = path >= kVecContig;
  const int units = vec ? cols / 4 : cols;
  int tx = 1;
  while (tx < units && tx < kThreads) tx *= 2;
  const int ty = kThreads / tx;
  const int gx = (units + tx - 1) / tx;
  const long long row_blocks = (rows + ty - 1) / ty;
  const long long gy = row_blocks < 65535 ? row_blocks : 65535;  // past that the row loop strides
  const dim3 grid(gx, static_cast<unsigned>(gy)), block(tx, ty);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xs = static_cast<const float*>(x);
  float* ys = static_cast<float*>(y);
  if (mode_r == kRepeat)
    launch<kRepeat>(path, grid, block, st, xs, ys, ld, rows, units, cols, r0, c0, n_r, n_c, c);
  else
    launch<kTile>(path, grid, block, st, xs, ys, ld, rows, units, cols, r0, c0, n_r, n_c, c);
  return cudaGetLastError();
}

}  // extern "C"
