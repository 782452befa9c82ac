// Kernel E: depth-only raster of opaque casters (the sun-shadow atlas).
//
// Replaces plainrenderer_tpu/ops/raster.py:_depth_kernel (:1465) with its
// _depth_resolve_loop (:1162; track_winner=False, depth_clamp=True,
// row_skip). For each bin of (sub * 16) x 128 px and each pixel centre:
// depth = the max of clamp(z, 1/16384, 1) over the bin's pairs whose three
// edge planes are >= 0 there (no z test: cascades render with depth
// clamping, raster.py:1368-1374), as the integer max of the positive f32
// bits; 0 where nothing covers. Planes evaluate as a*x + (b*y + c) with
// separately rounded multiplies and adds, as the plain version
// (ops/raster.py:depth_plain) does, so the atlas is bit-identical. Row
// skip: a pair is evaluated in a 16-px fine row only when that row lies in
// the pair's [fy0, fy1] (pair_edges rows 3 and 7).
//
// Bound on the H100: it writes the atlas once (3 x 2048^2 f32, 50 MB,
// ~15 us at 3.35 TB/s) and reads 14 rows per pair; the work is the plane
// evaluations: 12 rounded ops per (pair, block) corner test and per pixel
// of the blocks that pass, counted at the block size that needs the least
// (chip_smoke.py, block_work: 8 x 8 to 64 x 16; this kernel uses 16 x
// 16). These ops do not fuse into FMAs, so they issue at half the 67
// TFLOP/s that counts an FMA as 2 flops.
//
// Design. A work item is one half strip of a bin (16 rows x 64 columns,
// in one fine row) and one E_CHUNK-pair slice of the bin's pairs (a half
// strip needs 79 registers, so 3 blocks fit per SM); one warp does an item,
// with no block barrier, and takes the next from an atomic counter. Every
// thread block orders the bins, those of several slices first, and sums
// their slice counts into shared memory once, at its start (common.cuh,
// plain_slice_prefix), so short items come last; slices of E_CHUNK pairs
// keep a heavy strip from holding one warp for long. Where the order of
// the bins does not fit shared memory or the packed key (more than 8,192
// bins), the launcher writes it once into aux's tail and the GLOBAL
// instance reads it there (common.cuh, plain_strip_launch); kernels B, J
// and K do the same. No bin count is refused.
//   1. 32 pairs at a time, one per lane (coalesced loads of the 14 rows),
//      each lane tests its pair's row skip and, per 16 x 16 block of the
//      item, the exact corner test (common.cuh, plain_plane_may_pass):
//      a 4-bit mask of the blocks the pair may cover. Its coefficients go
//      to the warp's shared stash (common.cuh, plain_strip_pairs).
//   2. For each pair with a nonzero mask (a ballot), every lane reads the
//      coefficients as broadcasts, computes the row terms fl(fl(b*y) + c)
//      of its 4 rows once, and for each block in the mask the column
//      terms fl(a*x) of its 2 columns, then 8 pixels: 4 adds, 3 compares
//      and a max. The warp keeps the item's 1024 maxima in registers
//      (32 per lane: per block, 4 rows x 2 columns).
//   3. Maxima are of z itself (clamping is monotone, so the clamp moves to
//      the end), when the pair's z coefficients are below 2^64 and z is
//      therefore finite; other pairs take a path that clamps each z and
//      maps a NaN (the card's canonical 0x7fffffff, the largest bits) to
//      +inf, which the end maps back. Clamping every pair's z instead
//      measured 0.1816 ms against 0.1557 on slice 5's atlas (H100 80GB
//      HBM3, 700 W; compare_trees.py, medians of 3 alternated runs).
//   4. A half strip whose bin has one slice stores its 1024 depths (0
//      where nothing covers) with plain stores. A heavier bin's slices merge:
//      the first to finish stores and raises a ready flag; the others
//      wait for it, then atomicMax their covered pixels (an integer max,
//      so the order does not matter). So the atlas needs no zero fill.
#include "common.cuh"

#define E_CHUNK 128  // pairs per work item (short items: heavy strips spread)
#define E_WARPS 8
#define E_BLOCKS 4  // 16 x 16 blocks per item: half a 128-px strip

__device__ __forceinline__ float depth_clamp(float z) {
  return fminf(fmaxf(z, 1.0f / 16384.0f), 1.0f);
}

// the depth bits of a pixel's maximum (-inf: nothing covers; +inf: a NaN)
__device__ __forceinline__ int depth_key(float m) {
  if (m == -INFINITY) return 0;
  if (m == INFINITY) return 0x7fffffff;
  return __float_as_int(depth_clamp(m));
}

// One pair's pixels in the blocks of mask m: the lane's 4 rows (ry..) and
// 2 columns (cx, cx + 1) of each 16 x 16 block. SAFE pairs (finite z)
// max z itself; the others clamp each z and max +inf for a NaN.
template <bool SAFE>
__device__ __forceinline__ void depth_pair(float (&acc)[E_BLOCKS][8],
                                           const float* c, unsigned m,
                                           int x0, int y0) {
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
  for (int b = 0; b < E_BLOCKS; ++b) {
    if (!(m & (1u << b))) continue;
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      const float x = xb + (float)(16 * b + cc);
      const float a0 = __fmul_rn(c[0], x), a1 = __fmul_rn(c[3], x);
      const float a2 = __fmul_rn(c[6], x), az = __fmul_rn(c[9], x);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (__fadd_rn(a0, br[0][r]) >= 0.0f &&
            __fadd_rn(a1, br[1][r]) >= 0.0f &&
            __fadd_rn(a2, br[2][r]) >= 0.0f) {
          float z = __fadd_rn(az, br[3][r]);
          if (!SAFE) z = z != z ? INFINITY : depth_clamp(z);
          acc[b][2 * r + cc] = fmaxf(acc[b][2 * r + cc], z);
        }
      }
    }
  }
}

// aux: the item counter, per half strip a merge counter and a ready
// flag, then the global order's scratch (plain_strip_launch)
__host__ __device__ __forceinline__ int* depth_order(int* aux, int n_bins,
                                                     int sub) {
  return aux + 1 + 4 * (size_t)n_bins * sub;
}

template <bool GLOBAL>
__global__ void __launch_bounds__(E_WARPS * 32, 3)
depth_kernel(const float* __restrict__ edges,
             const int* __restrict__ tile_start,
             const int* __restrict__ tile_count, int* __restrict__ aux,
             int* __restrict__ depth_bits, int n_pairs, int n_tiles_y,
             int n_tiles_x, int sub, int row_skip) {
  extern __shared__ int s_dyn[];  // ordered bin keys, then slice prefix
  __shared__ float s_coef[E_WARPS][32][13];  // 13: no bank conflicts
  __shared__ int s_wsum[E_WARPS];
  const int n_bins = n_tiles_y * n_tiles_x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  const int* s_key = s_dyn;
  const int* s_end = s_dyn + n_bins;
  if constexpr (GLOBAL) {
    s_key = depth_order(aux, n_bins, sub);
    s_end = s_key + n_bins;
  } else {
    plain_slice_prefix(tile_count, n_bins, E_CHUNK, s_dyn, s_dyn + n_bins,
                       s_wsum);
  }

  int* counter = aux;
  int* done = aux + 1;                   // per half strip: slices done
  int* ready = done + n_bins * sub * 2;  // per half strip: first slice in
  const int n_items =
      plain_order_end<GLOBAL>(s_end, n_bins - 1) * sub * 2;
  const int width = n_tiles_x * PLAIN_TILE_W;
  const int cx = 2 * (lane & 7);   // the lane's 2 columns in a block
  const int ry = 4 * (lane >> 3);  // its 4 rows in the strip
  float* stash = &s_coef[warp][0][0];

  while (true) {
    int item = 0;
    if (lane == 0) item = atomicAdd(counter, 1);
    item = __shfl_sync(PLAIN_FULL_MASK, item, 0);
    if (item >= n_items) break;
    const PlainStrip it =
        plain_strip_item<GLOBAL>(s_key, s_end, tile_start, tile_count,
                                 n_bins, E_CHUNK, 2 * sub, item);
    const int bin = it.bin, s = it.part >> 1, n = it.n, start = it.start;
    const int half = it.part & 1;
    const int ty = bin / n_tiles_x;
    const int tx = bin - ty * n_tiles_x;
    const int fine_row = ty * sub + s;
    const float frow = (float)fine_row;
    const int y0 = fine_row * PLAIN_TILE_H;
    const int x0 = tx * PLAIN_TILE_W + half * E_BLOCKS * 16;

    float acc[E_BLOCKS][8];
#pragma unroll
    for (int b = 0; b < E_BLOCKS; ++b) {
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[b][i] = -INFINITY;
    }

    plain_strip_pairs(
        edges, n_pairs, start, n, row_skip, frow, stash,
        [&](const float* cf) {
          unsigned mask = 0;
#pragma unroll
          for (int b = 0; b < E_BLOCKS; ++b) {
            const int bx = x0 + 16 * b;
            if (plain_plane_may_pass(cf[0], cf[1], cf[2], bx, y0, 16, 16) &&
                plain_plane_may_pass(cf[3], cf[4], cf[5], bx, y0, 16, 16) &&
                plain_plane_may_pass(cf[6], cf[7], cf[8], bx, y0, 16, 16)) {
              mask |= 1u << b;
            }
          }
          const float lim = 18446744073709551616.0f;  // 2^64
          if (mask && fabsf(cf[9]) < lim && fabsf(cf[10]) < lim &&
              fabsf(cf[11]) < lim) {
            mask |= 1u << E_BLOCKS;  // safe: z is finite at every pixel
          }
          return mask;
        },
        [&](const float* c, unsigned m, int) {
          if (m & (1u << E_BLOCKS)) {
            depth_pair<true>(acc, c, m, x0 + cx, y0 + ry);
          } else {
            depth_pair<false>(acc, c, m, x0 + cx, y0 + ry);
          }
        });

    const int strip = bin * sub * 2 + it.part;  // this half strip
    const int order = plain_finish_order(done + strip, it.n_slices);
    int* out = depth_bits + (size_t)(y0 + ry) * width + x0 + cx;
    if (order == 0) {
#pragma unroll
      for (int b = 0; b < E_BLOCKS; ++b) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          *reinterpret_cast<int2*>(out + (size_t)r * width + 16 * b) =
              make_int2(depth_key(acc[b][2 * r]),
                        depth_key(acc[b][2 * r + 1]));
        }
      }
      if (it.n_slices > 1) plain_raise_flag(ready + strip);
    } else {
      plain_wait_flag(ready + strip);
#pragma unroll
      for (int b = 0; b < E_BLOCKS; ++b) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (acc[b][i] != -INFINITY) {
            atomicMax(out + (size_t)(i >> 1) * width + 16 * b + (i & 1),
                      depth_key(acc[b][i]));
          }
        }
      }
    }
  }
}

extern "C" int depth_launch(const void* edges, const void* tile_start,
                            const void* tile_count, void* aux, void* depth,
                            int n_pairs, int n_tiles_y, int n_tiles_x,
                            int sub, int row_skip, void* stream) {
  const int n_bins = n_tiles_y * n_tiles_x;
  if (n_bins < 1) return (int)cudaErrorInvalidValue;
  static PlainGridCache cache;
  const PlainStripLaunch l = plain_strip_launch(
      cache, depth_kernel<false>, depth_kernel<true>, E_WARPS * 32, n_bins);
  if (l.global) {
    const int err = plain_order_launch(
        tile_count, n_bins, E_CHUNK, depth_order((int*)aux, n_bins, sub),
        stream);
    if (err != 0) return err;
  }
  auto kernel = l.global ? depth_kernel<true> : depth_kernel<false>;
  kernel<<<l.grid, E_WARPS * 32, l.smem, (cudaStream_t)stream>>>(
      (const float*)edges, (const int*)tile_start, (const int*)tile_count,
      (int*)aux, (int*)depth, n_pairs, n_tiles_y, n_tiles_x, sub, row_skip);
  PLAIN_RETURN_LAUNCH_STATUS();
}
