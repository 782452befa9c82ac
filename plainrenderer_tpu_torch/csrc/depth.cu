// Kernel E: depth-only raster of opaque casters (the sun-shadow atlas).
//
// Replaces plainrenderer_tpu/ops/raster.py:_depth_kernel (:1465) with its
// _depth_resolve_loop (:1162; track_winner=False, depth_clamp=True,
// row_skip). For each bin of (sub * 16) x 128 px and each pixel centre:
// depth = the max of clamp(z, 1/16384, 1) over the bin's pairs whose three
// edge planes are >= 0 there (no z test: cascades render with depth
// clamping, raster.py:1368-1374), as the integer max of the positive f32
// bits; 0 where nothing covers. Planes evaluate as a*x + (b*y + c) with
// separately rounded multiplies and adds, as kernel B and the plain
// version (ops/raster.py:depth_plain) do, so the atlas is bit-identical.
// Row skip: a pair is evaluated in a 16-px sub-block only when the
// sub-block's fine row lies in the pair's [fy0, fy1] (rows 3 and 7).
//
// Bound and design on the H100: it writes the atlas once (3 x 2048^2 f32,
// 50 MB, ~15 us at 3.35 TB/s) and reads 16 rows per pair; the plane
// evaluations are 12 flops per evaluated (pair, pixel). The shadow atlas
// lets one bin hold up to 32,768 pairs (tile_cap) where most hold a few
// dozen, so one block per bin would wait on its heaviest bins. Instead the
// work is cut into items of DEPTH_CHUNK pairs of one bin; persistent
// blocks take items from an atomic counter, and each block max-merges its
// item into the zeroed atlas with atomicMax on the depth bits (an integer
// max, so the result does not depend on the order). One block is
// 128 * sub threads; thread t owns column t % 128 of 16-px sub-block
// t / 128 and keeps its 16 maxima in registers.
#include "common.cuh"

#define DEPTH_CHUNK 256  // pairs per work item; = ops/raster.py:DEPTH_CHUNK

__device__ __forceinline__ float clamp_depth(float z) {
  // NaN stays NaN, as torch.clamp and jnp.clip leave it
  return z != z ? z : fminf(fmaxf(z, 1.0f / 16384.0f), 1.0f);
}

__global__ void __launch_bounds__(8 * PLAIN_TILE_W)
depth_kernel(const float* __restrict__ edges,
             const int* __restrict__ tile_start,
             const int* __restrict__ tile_count,
             const int* __restrict__ chunk_end, int* __restrict__ counter,
             int* __restrict__ depth_bits, int n_pairs, int n_tiles_y,
             int n_tiles_x, int sub, int row_skip) {
  __shared__ float staged[PLAIN_N_STAGED][DEPTH_CHUNK];
  __shared__ int s_item;
  const int n_bins = n_tiles_y * n_tiles_x;
  const int n_items = chunk_end[n_bins - 1];
  const int width = n_tiles_x * PLAIN_TILE_W;
  const int lx = threadIdx.x % PLAIN_TILE_W;
  const int s = threadIdx.x / PLAIN_TILE_W;

  while (true) {
    if (threadIdx.x == 0) s_item = atomicAdd(counter, 1);
    __syncthreads();
    const int item = s_item;
    __syncthreads();  // all have read s_item before thread 0 writes again
    if (item >= n_items) break;
    int bin, start, n;
    plain_depth_item(chunk_end, tile_start, tile_count, n_bins, DEPTH_CHUNK,
                     item, &bin, &start, &n);
    for (int i = threadIdx.x; i < PLAIN_N_STAGED * n; i += blockDim.x) {
      const int r = i / n;
      const int p = i - r * n;
      staged[r][p] = edges[(size_t)plain_staged_row(r) * n_pairs + start + p];
    }
    __syncthreads();

    const int ty = bin / n_tiles_x;
    const int tx = bin - ty * n_tiles_x;
    const int fine_row = ty * sub + s;
    const float frow = (float)fine_row;
    const int y0 = fine_row * PLAIN_TILE_H;
    const float x = (float)(tx * PLAIN_TILE_W + lx) + 0.5f;
    int acc[PLAIN_TILE_H];
#pragma unroll
    for (int r = 0; r < PLAIN_TILE_H; ++r) acc[r] = 0;
    for (int p = 0; p < n; ++p) {
      if (row_skip && !(staged[12][p] <= frow && frow <= staged[13][p])) {
        continue;
      }
      const float a0 = staged[0][p], b0 = staged[1][p], k0 = staged[2][p];
      const float a1 = staged[3][p], b1 = staged[4][p], k1 = staged[5][p];
      const float a2 = staged[6][p], b2 = staged[7][p], k2 = staged[8][p];
      const float az = staged[9][p], bz = staged[10][p], kz = staged[11][p];
      const float ax0 = __fmul_rn(a0, x), ax1 = __fmul_rn(a1, x);
      const float ax2 = __fmul_rn(a2, x), axz = __fmul_rn(az, x);
#pragma unroll
      for (int r = 0; r < PLAIN_TILE_H; ++r) {
        const float y = (float)(y0 + r) + 0.5f;
        const float e0 = __fadd_rn(ax0, __fadd_rn(__fmul_rn(b0, y), k0));
        const float e1 = __fadd_rn(ax1, __fadd_rn(__fmul_rn(b1, y), k1));
        const float e2 = __fadd_rn(ax2, __fadd_rn(__fmul_rn(b2, y), k2));
        if (e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f) {
          const float z = __fadd_rn(axz, __fadd_rn(__fmul_rn(bz, y), kz));
          acc[r] = max(acc[r], __float_as_int(clamp_depth(z)));
        }
      }
    }
#pragma unroll
    for (int r = 0; r < PLAIN_TILE_H; ++r) {
      if (acc[r] != 0) {
        atomicMax(depth_bits + (size_t)(y0 + r) * width + tx * PLAIN_TILE_W +
                      lx,
                  acc[r]);
      }
    }
    __syncthreads();  // staged fully consumed before the next item
  }
}

extern "C" int depth_launch(const void* edges, const void* tile_start,
                            const void* tile_count, const void* chunk_end,
                            void* counter, void* depth, int n_pairs,
                            int n_tiles_y, int n_tiles_x, int sub,
                            int row_skip, int grid, void* stream) {
  depth_kernel<<<grid, PLAIN_TILE_W * sub, 0, (cudaStream_t)stream>>>(
      (const float*)edges, (const int*)tile_start, (const int*)tile_count,
      (const int*)chunk_end, (int*)counter, (int*)depth, n_pairs, n_tiles_y,
      n_tiles_x, sub, row_skip);
  PLAIN_RETURN_LAUNCH_STATUS();
}
