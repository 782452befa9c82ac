// Shared constants and helpers of the port's kernels. The raster constants
// mirror plainrenderer_tpu/ops/raster.py:61-69 and must stay equal to
// plainrenderer_tpu_torch/ops/raster.py.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define PLAIN_TILE_H 16
#define PLAIN_TILE_W 128
#define PLAIN_GROUP 128
#define PLAIN_SLOT_BITS 11
#define PLAIN_SLOT_MASK ((1 << PLAIN_SLOT_BITS) - 1)
#define PLAIN_NATTR 30
#define PLAIN_GBUF_CHANNELS 13

// The raster kernels (gbuffer.cu, depth.cu) stage 14 of a pair's 16 edge
// rows in shared memory: e0, e1, e2, z as (a, b, c) (rows 4p + k), then
// the fine-row extents fy0 (row 3) and fy1 (row 7).
#define PLAIN_N_STAGED 14
__device__ __forceinline__ int plain_staged_row(int r) {
  return r < 12 ? (r / 3) * 4 + r % 3 : (r == 12 ? 3 : 7);
}

// Every C entry point launches on the caller's stream and returns
// cudaGetLastError(), so a refused launch (too many threads, too much
// shared memory) is reported instead of silently never running.
#define PLAIN_RETURN_LAUNCH_STATUS() return (int)cudaGetLastError()

// Per-tile kernels (texture.cu, shadow.cu): one block of 256 threads per
// 16x128 tile; thread t owns column t % 128 and rows (t / 128) * 8 .. + 8.
// PLAIN_TILE_THREADS / PLAIN_ROWS_PER_THREAD mirror ops/texture.py.
#define PLAIN_TILE_THREADS 256
#define PLAIN_ROWS_PER_THREAD 8

struct PlainAddF {
  __device__ float operator()(float a, float b) const { return __fadd_rn(a, b); }
};
struct PlainMinF {
  __device__ float operator()(float a, float b) const { return fminf(a, b); }
};
struct PlainAddI {
  __device__ int operator()(int a, int b) const { return a + b; }
};
struct PlainMinI {
  __device__ int operator()(int a, int b) const { return min(a, b); }
};
struct PlainMaxI {
  __device__ int operator()(int a, int b) const { return max(a, b); }
};

// Reduce one value per thread over the block's 256 threads by a halving
// tree, v[i] = op(v[i], v[i + s]) for s = 128 .. 1: the order of
// ops/texture.py:tile_sum, so float sums agree bit for bit with the plain
// versions. Every thread of the block must call it; all get the result.
template <typename T, typename Op>
__device__ T plain_tile_reduce(T v, T* red, Op op) {
  const int t = threadIdx.x;
  red[t] = v;
  __syncthreads();
  for (int s = PLAIN_TILE_THREADS / 2; s >= 1; s >>= 1) {
    if (t < s) red[t] = op(red[t], red[t + s]);
    __syncthreads();
  }
  const T r = red[0];
  __syncthreads();  // red is reused by the next reduction
  return r;
}

// floor division and modulo for b > 0 (Python / jnp integer semantics)
__device__ __forceinline__ int plain_floordiv(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}
__device__ __forceinline__ int plain_floormod(int a, int b) {
  const int r = a % b;
  return r < 0 ? r + b : r;
}
