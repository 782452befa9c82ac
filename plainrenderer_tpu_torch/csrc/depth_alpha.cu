// Kernel J: depth-only raster of alpha-tested casters (the sun-shadow
// atlas's alpha stream).
//
// Replaces plainrenderer_tpu/ops/raster.py:_depth_kernel_alpha (:1474) and
// _depth_kernel_alpha_acc (:1483), both _depth_resolve_loop (:1162;
// track_winner=False, depth_clamp=True, masks_ref, optional init_ref).
// For each bin of (sub * 16) x 128 px and each pixel centre: depth = the
// max of clamp(z, 1/16384, 1) over the bin's pairs whose three edge planes
// are >= 0 there and that pass the alpha test (common.cuh,
// plain_alpha_passes: the perspective-correct uv of planes 4-6 picks one
// bit of the pair's 64x64 mask), as the integer max of the positive f32
// bits. The _acc body starts from init_depth's bits instead of 0: the
// wrapper (ops/raster.py:rasterize_depth) hands the kernel init_depth
// itself as its output, and the kernel max-merges into it in place, so
// one kernel serves both bodies. Planes evaluate as a*x + (b*y + c) with
// separately rounded multiplies and adds, the uv math with _rn
// intrinsics, so kernel and plain version (ops/raster.py:depth_plain)
// agree on every texel: one ulp of u at a 1/64 texel edge would flip a
// coverage bit.
//
// Bound and design on the H100: kernel E's work-item design (depth.cu):
// DEPTH_CHUNK-pair slices of each bin, taken by persistent blocks from an
// atomic counter, merged into the atlas by atomicMax on the depth bits
// (an integer max, so the order does not matter). Merged in place, it
// touches only the texels that a passing caster covers, a small part of
// the atlas: the alpha stream is a few thousand pairs, so the work is
// small and launch-sized. The 24 staged rows of a slice (24 KB) and the
// mask table (n_masks x 128 words, <= 4 KB) sit in shared memory; the
// per-pair slot test is uniform across the block, so opaque pairs skip
// the uv work.
#include "common.cuh"

#define DEPTH_CHUNK 256  // pairs per work item; = ops/raster.py:DEPTH_CHUNK

__global__ void __launch_bounds__(8 * PLAIN_TILE_W)
depth_alpha_kernel(const float* __restrict__ edges,
                   const int* __restrict__ masks,
                   const int* __restrict__ tile_start,
                   const int* __restrict__ tile_count,
                   const int* __restrict__ chunk_end,
                   int* __restrict__ counter, int* __restrict__ depth_bits,
                   int n_pairs, int n_masks, int n_tiles_y, int n_tiles_x,
                   int sub, int row_skip) {
  __shared__ float staged[PLAIN_N_STAGED_ALPHA][DEPTH_CHUNK];
  __shared__ int s_masks[PLAIN_MAX_ALPHA_MASKS * PLAIN_ALPHA_MASK_WORDS];
  __shared__ int s_item;
  const int n_bins = n_tiles_y * n_tiles_x;
  const int n_items = chunk_end[n_bins - 1];
  const int width = n_tiles_x * PLAIN_TILE_W;
  const int lx = threadIdx.x % PLAIN_TILE_W;
  const int s = threadIdx.x / PLAIN_TILE_W;
  for (int i = threadIdx.x; i < n_masks * PLAIN_ALPHA_MASK_WORDS;
       i += blockDim.x) {
    s_masks[i] = masks[i];
  }

  while (true) {
    if (threadIdx.x == 0) s_item = atomicAdd(counter, 1);
    __syncthreads();
    const int item = s_item;
    __syncthreads();  // all have read s_item before thread 0 writes again
    if (item >= n_items) break;
    int bin, start, n;
    plain_depth_item(chunk_end, tile_start, tile_count, n_bins, DEPTH_CHUNK,
                     item, &bin, &start, &n);
    for (int i = threadIdx.x; i < PLAIN_N_STAGED_ALPHA * n;
         i += blockDim.x) {
      const int r = i / n;
      const int p = i - r * n;
      staged[r][p] =
          edges[(size_t)plain_staged_row_alpha(r) * n_pairs + start + p];
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
      const float slot = staged[PLAIN_STAGED_SLOT][p];
      const bool tested = slot >= 0.5f;  // uniform over the block
#pragma unroll
      for (int r = 0; r < PLAIN_TILE_H; ++r) {
        const float y = (float)(y0 + r) + 0.5f;
        const float e0 =
            plain_plane(staged[0][p], staged[1][p], staged[2][p], x, y);
        const float e1 =
            plain_plane(staged[3][p], staged[4][p], staged[5][p], x, y);
        const float e2 =
            plain_plane(staged[6][p], staged[7][p], staged[8][p], x, y);
        if (!(e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f)) continue;
        if (tested &&
            !plain_alpha_passes(
                plain_plane(staged[14][p], staged[15][p], staged[16][p], x,
                            y),
                plain_plane(staged[17][p], staged[18][p], staged[19][p], x,
                            y),
                plain_plane(staged[20][p], staged[21][p], staged[22][p], x,
                            y),
                slot, s_masks, n_masks)) {
          continue;
        }
        const float z =
            plain_plane(staged[9][p], staged[10][p], staged[11][p], x, y);
        // NaN stays NaN, as torch.clamp and jnp.clip leave it
        const float zc =
            z != z ? z : fminf(fmaxf(z, 1.0f / 16384.0f), 1.0f);
        acc[r] = max(acc[r], __float_as_int(zc));
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

extern "C" int depth_alpha_launch(const void* edges, const void* masks,
                                  const void* tile_start,
                                  const void* tile_count,
                                  const void* chunk_end, void* counter,
                                  void* depth, int n_pairs, int n_masks,
                                  int n_tiles_y, int n_tiles_x, int sub,
                                  int row_skip, int grid, void* stream) {
  depth_alpha_kernel<<<grid, PLAIN_TILE_W * sub, 0, (cudaStream_t)stream>>>(
      (const float*)edges, (const int*)masks, (const int*)tile_start,
      (const int*)tile_count, (const int*)chunk_end, (int*)counter,
      (int*)depth, n_pairs, n_masks, n_tiles_y, n_tiles_x, sub, row_skip);
  PLAIN_RETURN_LAUNCH_STATUS();
}
