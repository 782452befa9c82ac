// Kernel J: depth-only raster of alpha-tested casters (the sun-shadow
// atlas's alpha stream).
//
// Replaces plainrenderer_tpu/ops/raster.py:_depth_kernel_alpha (:1474) and
// _depth_kernel_alpha_acc (:1483), both _depth_resolve_loop (:1162;
// track_winner=False, depth_clamp=True, masks_ref, optional init_ref).
// For each bin of (sub * 16) x 128 px and each pixel centre: depth = the
// max of clamp(z, 1/16384, 1) over the bin's pairs whose three edge planes
// are >= 0 there and that pass the alpha test (common.cuh,
// plain_alpha_mask and plain_alpha_bit: the perspective-correct uv of
// planes 4-6 picks one bit of the pair's 64x64 mask), as the integer max
// of the positive f32 bits. The _acc body starts from init_depth's bits
// instead of 0: the wrapper (ops/raster.py:rasterize_depth) hands the
// kernel init_depth itself as its output, and the kernel max-merges into
// it in place, so one kernel serves both bodies. Planes evaluate as a*x +
// (b*y + c) with separately rounded multiplies and adds, the uv math with
// _rn intrinsics, so kernel and plain version (ops/raster.py:depth_plain)
// agree on every texel: one ulp of u at a 1/64 texel edge would flip a
// coverage bit.
//
// Bound on the H100: merged in place, it reads and writes only the texels
// that a passing caster covers, and reads each live pair's rows once. On
// slice 5's atlas that is 1,176 pairs in 257 of 1,536 bins (median 4
// pairs, at most 18), 2.29 M pixels of the 16 x 16 blocks that pass the
// corner test (chip_smoke.stream_counts), and a 0.00184 ms bytes bound:
// the kernel is set by latency and by how evenly the work spreads over
// the warps.
//
// Design: strip items as kernel E's (depth.cu; common.cuh,
// plain_slice_prefix, plain_strip_item, plain_strip_pairs), cut finer. A
// work item is one 16 x 16 block of a bin and one J_CHUNK-pair slice of
// its pairs; one warp does an item, with no block barrier. A warp's first
// item is its index in the grid, the rest come from an atomic counter
// (plain_next_item). Bins without pairs have no items (the atlas already
// holds their values); bins go heaviest first, bucketed by pairs.
//   1. 32 pairs at a time, one per lane (coalesced loads of 22 rows: the
//      edge and z planes, planes 4-6 and the mask slot), each lane tests
//      its pair's row skip and the exact corner test of the block's three
//      edges (plain_plane_may_pass). Passing pairs go to the warp's stash
//      (23 floats a pair).
//   2. For each passing pair, every lane computes the row terms of its 4
//      rows once and its 2 columns' terms, then 8 pixels. The alpha test
//      (its mask row picked once per pair; the masks and a row of ones in
//      shared memory) runs on all 8 pixels without a branch, so the 8
//      tests are independent chains that overlap.
//   3. As in E, the maxima are of z itself when the pair's z coefficients
//      are below 2^64 (z finite); other pairs clamp each z and map a NaN
//      (the card's canonical 0x7fffffff, the largest key) to +inf.
//   4. Every item atomicMax-es its covered texels onto the atlas: it holds
//      kernel E's values (or the wrapper's zero fill), so the slices of a
//      bin need no store-first path or ready flag.
// ptxas: 80 registers, no spill, no stack, 28,192 B of static shared
// memory (+ 2 ints per bin dynamic): 3 blocks of 8 warps per SM.
//
// Times on slice 5's atlas (H100 80GB HBM3, 700.00 W; compare_trees.py,
// each tree in its own process; medians; [base / variant] in one call,
// the base being the design of that moment; a lone time had its base in
// the call before). The previous design (256-pair items of 1,024-thread
// blocks, no block test): 0.0575 ms; without its alpha test 0.0582,
// without its pair walk 0.0144 (each thread's walk over every pair of its
// item was 3/4 of it), without its staging too 0.0144, without its
// atomics 0.0555.
// This design's steps:
//   half strips (16 x 64, E's items), the alpha test behind a branch
//                                                    [0.0575 / 0.0572]
//   16 x 16 items, 4 blocks/SM                       [0.0557 / 0.0341]
//     16 x 32 items [/ 0.0383]; 5 blocks/SM, spilling [/ 0.0385]; that
//     design without its alpha test 0.0626 (more texels covered, more
//     atomics), without any pair work 0.0152
//   items only in turn, no counter                   0.0358 (0.0342)
//     and reading the atlas first, atomics only where they raise it
//                                                    [0.0358 / 0.0367]
//   the alpha test without a branch                  [0.0343 / 0.0296]
//     at 3 blocks/SM (80 registers, no spill)        [0.0296 / 0.0277]
//   reading the counter before taking from it        0.0341 (0.0275)
//     and two rounds of items in turn first          [0.0341 / 0.0283]
//   asking the counter for the next item ahead       [0.0279 / 0.0294]
//   counter batches of 2 and 4              [0.0284 / 0.0323, 0.0404]
//   bins' starts in shared memory, the prefix's loads batched
//                                                    [0.0279 / 0.0288]
//   the uv planes' row terms once per pair           [0.0279 / 0.0280]
//   scratch the kernel zeroes itself, no fill launch [0.0276 / 0.0266]
//     (kept out: a buffer cached across calls for 0.001 ms)
//   J_CHUNK 16                                       [0.0274 / 0.0273]
//   bins bucketed by pairs, not slices               [0.0280 / 0.0255]
//   16 x 32 items again                              [0.0254 / 0.0260]
//   the alpha test inside the edge tests' && (a branch again): 0.0278;
//   apart from them (this design) 0.0253 in the next call
#include "common.cuh"

#define J_CHUNK 32  // pairs per work item
#define J_WARPS 8
#define J_MIN_BLOCKS 3  // blocks of J_WARPS warps per SM
#define J_STRIDE (PLAIN_ROWS_ALPHA + 1)
#define J_SAFE 2u        // flag bit beside the block bit: z is finite

__device__ __forceinline__ float depth_clamp(float z) {
  return fminf(fmaxf(z, 1.0f / 16384.0f), 1.0f);
}

// the depth bits of a pixel's maximum (+inf: a NaN)
__device__ __forceinline__ int depth_key(float m) {
  return m == INFINITY ? 0x7fffffff : __float_as_int(depth_clamp(m));
}

// One pair's 8 pixels of the lane: 4 rows and 2 columns from (x0, y0) in
// the item's 16 x 16 block; uvw: the pair's planes 4-6 in the stash, mask:
// its mask row. The alpha test runs on all 8 pixels, covered or not, with
// no branch, so the lane's 8 tests are independent chains that overlap.
template <bool SAFE>
__device__ __forceinline__ void depth_alpha_pair(float (&acc)[8],
                                                 const float* c,
                                                 const float* uvw,
                                                 const int* mask, int x0,
                                                 int y0) {
  const float xb = (float)x0 + 0.5f, yb = (float)y0 + 0.5f;  // exact
  float br[4][4];  // [plane][row]: fl(fl(b * y) + c)
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float y = yb + (float)r;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      br[q][r] = __fadd_rn(__fmul_rn(c[3 * q + 1], y), c[3 * q + 2]);
    }
  }
#pragma unroll
  for (int cc = 0; cc < 2; ++cc) {
    const float x = xb + (float)cc;
    const float a0 = __fmul_rn(c[0], x), a1 = __fmul_rn(c[3], x);
    const float a2 = __fmul_rn(c[6], x), az = __fmul_rn(c[9], x);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float y = yb + (float)r;
      // evaluated apart from the edge tests, so it is not a branch
      const bool pass =
          plain_alpha_bit(plain_plane(uvw[0], uvw[1], uvw[2], x, y),
                          plain_plane(uvw[3], uvw[4], uvw[5], x, y),
                          plain_plane(uvw[6], uvw[7], uvw[8], x, y), mask);
      const bool cov = __fadd_rn(a0, br[0][r]) >= 0.0f &&
                       __fadd_rn(a1, br[1][r]) >= 0.0f &&
                       __fadd_rn(a2, br[2][r]) >= 0.0f && pass;
      float z = __fadd_rn(az, br[3][r]);
      if (!SAFE) z = z != z ? INFINITY : depth_clamp(z);
      float& a = acc[2 * r + cc];
      if (cov && z > a) a = z;
    }
  }
}

// aux: the item counter, then the global order's scratch
// (plain_strip_launch)
__host__ __device__ __forceinline__ int* depth_alpha_order(int* aux) {
  return aux + 1;
}

template <bool GLOBAL>
__global__ void __launch_bounds__(J_WARPS * 32, J_MIN_BLOCKS)
depth_alpha_kernel(const float* __restrict__ edges,
                   const int* __restrict__ masks,
                   const int* __restrict__ tile_start,
                   const int* __restrict__ tile_count, int* __restrict__ aux,
                   int* __restrict__ depth_bits, int n_pairs, int n_masks,
                   int n_tiles_y, int n_tiles_x, int sub, int row_skip) {
  extern __shared__ int s_dyn[];  // ordered bin keys, then slice prefix
  __shared__ float s_coef[J_WARPS][32 * J_STRIDE];
  __shared__ int s_masks[(PLAIN_MAX_ALPHA_MASKS + 1) *
                         PLAIN_ALPHA_MASK_WORDS];
  __shared__ int s_wsum[J_WARPS];
  const int n_bins = n_tiles_y * n_tiles_x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  plain_load_masks(masks, n_masks, s_masks);
  const int* s_key = s_dyn;
  const int* s_end = s_dyn + n_bins;
  if constexpr (GLOBAL) {
    s_key = depth_alpha_order(aux);
    s_end = s_key + n_bins;
    __syncthreads();  // publishes s_masks
  } else {
    // its barriers also publish s_masks
    plain_slice_prefix<true, true>(tile_count, n_bins, J_CHUNK, s_dyn,
                                   s_dyn + n_bins, s_wsum);
  }

  int* counter = aux;
  // 8 blocks a fine row
  const int n_items = plain_order_end<GLOBAL>(s_end, n_bins - 1) * sub * 8;
  const int width = n_tiles_x * PLAIN_TILE_W;
  const int cx = 2 * (lane & 7);   // the lane's 2 columns in the block
  const int ry = 4 * (lane >> 3);  // its 4 rows
  float* stash = s_coef[warp];

  const int n_warps = gridDim.x * J_WARPS;
  for (int item = blockIdx.x * J_WARPS + warp; item < n_items;
       item = plain_next_item(counter, n_warps, n_items)) {
    const PlainStrip it =
        plain_strip_item<GLOBAL>(s_key, s_end, tile_start, tile_count,
                                 n_bins, J_CHUNK, sub * 8, item);
    const int ty = it.bin / n_tiles_x;
    const int tx = it.bin - ty * n_tiles_x;
    const int fine_row = ty * sub + (it.part >> 3);
    const int y0 = fine_row * PLAIN_TILE_H;
    const int x0 = tx * PLAIN_TILE_W + (it.part & 7) * 16;

    float acc[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = -INFINITY;

    plain_strip_pairs<PLAIN_ROWS_ALPHA>(
        edges, n_pairs, it.start, it.n, row_skip, (float)fine_row, stash,
        [&](const float* cf) {
          if (!(plain_plane_may_pass(cf[0], cf[1], cf[2], x0, y0, 16, 16) &&
                plain_plane_may_pass(cf[3], cf[4], cf[5], x0, y0, 16, 16) &&
                plain_plane_may_pass(cf[6], cf[7], cf[8], x0, y0, 16, 16))) {
            return 0u;
          }
          const float lim = 18446744073709551616.0f;  // 2^64
          const bool safe = fabsf(cf[9]) < lim && fabsf(cf[10]) < lim &&
                            fabsf(cf[11]) < lim;  // z finite at every pixel
          return safe ? 1u | J_SAFE : 1u;
        },
        [&](const float* c, unsigned m, int p) {
          const float* s = stash + (p & 31) * J_STRIDE;
          const int* mask =
              plain_alpha_mask(s[PLAIN_ROW_SLOT], s_masks, n_masks);
          if (m & J_SAFE) {
            depth_alpha_pair<true>(acc, c, s + 12, mask, x0 + cx, y0 + ry);
          } else {
            depth_alpha_pair<false>(acc, c, s + 12, mask, x0 + cx, y0 + ry);
          }
        });

    int* out = depth_bits + (size_t)(y0 + ry) * width + x0 + cx;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (acc[i] != -INFINITY) {
        atomicMax(out + (size_t)(i >> 1) * width + (i & 1),
                  depth_key(acc[i]));
      }
    }
  }
}

extern "C" int depth_alpha_launch(const void* edges, const void* masks,
                                  const void* tile_start,
                                  const void* tile_count, void* aux,
                                  void* depth, int n_pairs, int n_masks,
                                  int n_tiles_y, int n_tiles_x, int sub,
                                  int row_skip, void* stream) {
  const int n_bins = n_tiles_y * n_tiles_x;
  if (n_bins < 1 || n_masks < 1 || n_masks > PLAIN_MAX_ALPHA_MASKS) {
    return (int)cudaErrorInvalidValue;
  }
  static PlainGridCache cache;
  const PlainStripLaunch l =
      plain_strip_launch(cache, depth_alpha_kernel<false>,
                         depth_alpha_kernel<true>, J_WARPS * 32, n_bins);
  if (l.global) {
    const int err = plain_order_launch<true, true>(
        tile_count, n_bins, J_CHUNK, depth_alpha_order((int*)aux), stream);
    if (err != 0) return err;
  }
  auto kernel = l.global ? depth_alpha_kernel<true> : depth_alpha_kernel<false>;
  kernel<<<l.grid, J_WARPS * 32, l.smem, (cudaStream_t)stream>>>(
      (const float*)edges, (const int*)masks, (const int*)tile_start,
      (const int*)tile_count, (int*)aux, (int*)depth, n_pairs, n_masks,
      n_tiles_y, n_tiles_x, sub, row_skip);
  PLAIN_RETURN_LAUNCH_STATUS();
}
