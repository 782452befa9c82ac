// Kernel B: opaque main-view G-buffer raster (visibility + attributes).
//
// Replaces plainrenderer_tpu/ops/raster.py:_gbuffer_kernel (:1564) with its
// _depth_resolve_loop (:1162, track_winner=True, row_skip) and _attr_phase
// (:1603), for opaque geometry.
//
// Semantics kept from the TPU kernel (tests/test_torch_raster.py and
// chip_smoke.py hold the kernel to its plain twin, ops/raster.py):
// - coverage at pixel centres: all three edge planes >= 0 and reverse-Z
//   0 < z <= 1; planes evaluate as a*x + (b*y + c) with separate rounded
//   multiplies and adds (__fmul_rn/__fadd_rn: no FMA contraction, so the
//   plain PyTorch version agrees bit for bit);
// - the winner is the integer max of (bits(z) & ~2047) | slot, where slot
//   counts from the group-aligned floor base = start / 128 * 128 of the
//   bin's segment (raster.py:1211-1213); vis and winner_triangle_ids
//   decode against that base;
// - only pairs in [start, start + count) are evaluated (the TPU kernel
//   poisons the rest instead, raster.py:1276-1282);
// - row skip (row_skip != 0): a pair is evaluated in a 16-px fine row
//   only when that row lies in the pair's [fy0, fy1] (pair_edges rows 3
//   and 7); the TPU skips per 32-pair slice on the slice's row extent;
// - depth keeps its low 11 slot bits cleared (raster.py:1456-1460);
// - attribute coefficients are rounded as the TPU's two-pass bf16 one-hot
//   matmul rounds them (raster.py:1650-1670): hi = bf16(a),
//   lo = bf16(a - hi), coeff = hi + lo; a gather replaces the matmul;
// - 1/w is _kernel_recip (raster.py:1148): rsqrt(x)^2 with one Newton step;
// - normals and tangents are normalised and masked by valid; channel 12 is
//   the constant material row coeff[29];
// - a dynamic scene's 40-row pair_attrs (prev != 0, the PREV instance)
//   adds channels 13-14, the previous NDC of the prev-clip planes (rows
//   30-38, raster.py:1728-1740); the static instance keeps 13 channels.
//
// Bound on the H100: at 1080p it must write 125 MB (depth, vis and 13 f32
// channels per pixel; 142 MB with 15), ~37 us at 3.35 TB/s, and read the
// pair tables once. The visibility work is 12 rounded ops per pixel a pair
// may cover, which the block test below cuts to the 16 x 16 blocks that
// the pair's edges and z range can reach (the bound counts the block size
// that needs the least: chip_smoke.py, block_work).
//
// Design: strip items (common.cuh, plain_strip_item, as kernel E's):
// one warp does one 16 x 128 strip of a bin against one CHUNK-pair slice
// of the bin's pairs, with no block barrier, taking items from an atomic
// counter; a second queue then resolves the strips' attributes.
//   1. 32 pairs at a time, one per lane: row skip, then per 16 x 16 block
//      of the strip the exact corner tests of the three edges and of the
//      z range (common.cuh, plain_plane_may_pass, plain_depth_may_pass).
//      Strip 0's item of each slice also split-rounds its pairs' attribute
//      rows once, into the rounded table (the resolve then reads them as
//      they are: per pixel that saves ~30 bf16 splits).
//   2. For each pair with a nonzero block mask (a ballot), every lane
//      takes the coefficients from the warp's shared stash, computes its
//      4 rows' terms fl(fl(b*y) + c) once and per block its 2 columns'
//      fl(a*x), and max-merges the packed (depth | slot) candidates of its
//      8 pixels; the warp holds the strip's 2048 maxima in registers.
//   3. The maxima go to vis. A strip whose bin has one slice stores them;
//      the slices of a heavier bin merge: the first to finish stores, the
//      others wait for its flag and atomicMax theirs. The strip is final
//      when the last has merged.
//   4. When the visibility queue is empty, warps take resolve items, a
//      32-column block of a strip each (4 per strip, so the whole card
//      resolves), wait until every strip of the bin is final, and write
//      depth, vis and the channels: lane l walks column l of the block
//      down its 16 rows, so every store is coalesced across the warp.
// One launch in all; a warp waits only on items that running warps took
// earlier, so every wait ends.
#include "common.cuh"

#define CHUNK 32  // pairs per work item (short items: heavy strips spread)
#define B_WARPS 8
#define B_BLOCKS 8        // 16 x 16 blocks per 128-px strip
#define B_PARTS 4         // 32-column resolve items per strip

// One pair's candidates in the blocks of mask m: the lane's 4 rows and
// 2 columns of each 16 x 16 block, origin (x0, y0) the lane's first.
// Kernel E's depth_pair walks the same pixels; one template for both, with
// the per-pixel step as a functor, measured B at 0.117-0.119 ms against
// 0.109 (H100 80GB HBM3, 700 W; compare_trees.py), so each keeps its own.
__device__ __forceinline__ void gbuffer_pair(int (&acc)[B_BLOCKS][8],
                                             const float* c, unsigned m,
                                             int slot, int x0, int y0) {
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
  for (int b = 0; b < B_BLOCKS; ++b) {
    if (!(m & (1u << b))) continue;
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      const float x = xb + (float)(16 * b + cc);
      const float a0 = __fmul_rn(c[0], x), a1 = __fmul_rn(c[3], x);
      const float a2 = __fmul_rn(c[6], x), az = __fmul_rn(c[9], x);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float z = __fadd_rn(az, br[3][r]);
        // explicit compares: NaN never covers (as the TPU's min-based test)
        if (__fadd_rn(a0, br[0][r]) >= 0.0f &&
            __fadd_rn(a1, br[1][r]) >= 0.0f &&
            __fadd_rn(a2, br[2][r]) >= 0.0f && z > 0.0f && z <= 1.0f) {
          acc[b][2 * r + cc] = max(acc[b][2 * r + cc],
                                   (__float_as_int(z) & ~PLAIN_SLOT_MASK) |
                                       slot);
        }
      }
    }
  }
}

// One resolve item: columns x0 .. x0 + 31 of the 16-row strip at y0,
// from the packed maxima in vis and the winners' rounded attribute rows;
// lane l takes column x0 + l down the 16 rows.
template <bool PREV>
__device__ __forceinline__ void gbuffer_resolve(
    const float* __restrict__ rounded, int n_pairs, int base, int x0,
    int y0, int width, size_t plane, float* __restrict__ depth,
    int* __restrict__ vis, float* __restrict__ gbuf) {
  constexpr int n_ch = PREV ? PLAIN_GBUF_CHANNELS_PREV : PLAIN_GBUF_CHANNELS;
  constexpr int n_attr = PREV ? PLAIN_NATTR_PREV : PLAIN_NATTR;
  const int x = x0 + (threadIdx.x & 31);
  for (int row = 0; row < PLAIN_TILE_H; ++row) {
    const size_t o = (size_t)(y0 + row) * width + x;
    const int a = __ldcg(vis + o);  // written by other warps: skip L1
    depth[o] = __int_as_float(a & ~PLAIN_SLOT_MASK);
    float ch[n_ch];
#pragma unroll
    for (int k = 0; k < n_ch; ++k) ch[k] = 0.0f;
    if (a != 0) {
      const int slot = a & PLAIN_SLOT_MASK;
      vis[o] = slot;
      float cf[n_attr];
#pragma unroll
      for (int k = 0; k < n_attr; ++k) {
        cf[k] = __ldcg(rounded + (size_t)k * n_pairs + base + slot);
      }
      plain_gbuffer_eval<PREV>(cf, (float)x + 0.5f,
                               (float)(y0 + row) + 0.5f, ch);
    } else {
      vis[o] = -1;
    }
#pragma unroll
    for (int k = 0; k < n_ch; ++k) gbuf[k * plane + o] = ch[k];
  }
}

// aux: the two item counters, per strip a merge counter, three flags,
// then the global order's scratch (plain_strip_launch)
__host__ __device__ __forceinline__ int* gbuffer_order(int* aux, int n_bins,
                                                       int sub) {
  return aux + 2 + 4 * (size_t)n_bins * sub;
}

template <bool PREV, bool GLOBAL>
__global__ void __launch_bounds__(B_WARPS * 32, 2)
gbuffer_kernel(const float* __restrict__ edges,
               const float* __restrict__ attrs, float* __restrict__ rounded,
               const int* __restrict__ tile_start,
               const int* __restrict__ tile_count, int* __restrict__ aux,
               float* __restrict__ depth, int* __restrict__ vis,
               float* __restrict__ gbuf, int n_pairs, int n_tiles_y,
               int n_tiles_x, int sub, int row_skip) {
  constexpr int n_attr = PREV ? PLAIN_NATTR_PREV : PLAIN_NATTR;
  extern __shared__ int s_dyn[];  // ordered bin keys, then slice prefix
  __shared__ float s_coef[B_WARPS][32][13];  // 13: no bank conflicts
  __shared__ int s_wsum[B_WARPS];
  const int n_bins = n_tiles_y * n_tiles_x;
  const int n_strips = n_bins * sub;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int* s_key = s_dyn;
  const int* s_end = s_dyn + n_bins;
  if constexpr (GLOBAL) {
    s_key = gbuffer_order(aux, n_bins, sub);
    s_end = s_key + n_bins;
  } else {
    plain_slice_prefix(tile_count, n_bins, CHUNK, s_dyn, s_dyn + n_bins,
                       s_wsum);
  }

  int* counter = aux;                 // visibility items
  int* r_counter = aux + 1;           // resolve items
  int* done = aux + 2;                // per strip: slices finished
  int* ready = done + n_strips;       // per strip: first slice stored
  int* merged = ready + n_strips;     // per strip: slices merged after it
  int* complete = merged + n_strips;  // per strip: its maxima are in vis
  const int n_items = plain_order_end<GLOBAL>(s_end, n_bins - 1) * sub;
  const int width = n_tiles_x * PLAIN_TILE_W;
  const size_t plane = (size_t)n_tiles_y * sub * PLAIN_TILE_H * width;
  const int cx = 2 * (lane & 7);   // the lane's 2 columns in a block
  const int ry = 4 * (lane >> 3);  // its 4 rows in the strip
  float* stash = &s_coef[warp][0][0];

  while (true) {  // visibility
    int item = 0;
    if (lane == 0) item = atomicAdd(counter, 1);
    item = __shfl_sync(PLAIN_FULL_MASK, item, 0);
    if (item >= n_items) break;
    const PlainStrip it = plain_strip_item<GLOBAL>(
        s_key, s_end, tile_start, tile_count, n_bins, CHUNK, sub, item);
    const int bin = it.bin, n = it.n, start = it.start;
    const int lead = tile_start[bin] % PLAIN_GROUP;
    const int ty = bin / n_tiles_x;
    const int tx = bin - ty * n_tiles_x;
    const int fine_row = ty * sub + it.part;
    const float frow = (float)fine_row;
    const int y0 = fine_row * PLAIN_TILE_H;
    const int x0 = tx * PLAIN_TILE_W;

    int acc[B_BLOCKS][8];
#pragma unroll
    for (int b = 0; b < B_BLOCKS; ++b) {
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[b][i] = 0;
    }

    if (it.part == 0) {  // the slice's attribute rows, rounded once
      for (int p = lane; p < n; p += 32) {
        const size_t col = (size_t)start + p;
#pragma unroll 5
        for (int k = 0; k < n_attr; ++k) {
          rounded[(size_t)k * n_pairs + col] =
              plain_split_round(attrs[(size_t)k * n_pairs + col]);
        }
      }
    }
    plain_strip_pairs(
        edges, n_pairs, start, n, row_skip, frow, stash,
        [&](const float* cf) {
          unsigned mask = 0;
#pragma unroll
          for (int b = 0; b < B_BLOCKS; ++b) {
            const int bx = x0 + 16 * b;
            if (plain_plane_may_pass(cf[0], cf[1], cf[2], bx, y0, 16, 16) &&
                plain_plane_may_pass(cf[3], cf[4], cf[5], bx, y0, 16, 16) &&
                plain_plane_may_pass(cf[6], cf[7], cf[8], bx, y0, 16, 16) &&
                plain_depth_may_pass(cf[9], cf[10], cf[11], bx, y0, 16,
                                     16)) {
              mask |= 1u << b;
            }
          }
          return mask;
        },
        [&](const float* c, unsigned m, int p) {
          gbuffer_pair(acc, c, m, lead + it.p0 + p, x0 + cx, y0 + ry);
        });

    // the packed maxima into vis; the strip is final once all are in
    const int strip = bin * sub + it.part;
    const int order = plain_finish_order(done + strip, it.n_slices);
    int* out = vis + (size_t)(y0 + ry) * width + x0 + cx;
    if (order == 0) {
#pragma unroll
      for (int b = 0; b < B_BLOCKS; ++b) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          *reinterpret_cast<int2*>(out + (size_t)r * width + 16 * b) =
              make_int2(acc[b][2 * r], acc[b][2 * r + 1]);
        }
      }
      plain_raise_flag(it.n_slices == 1 ? complete + strip : ready + strip);
    } else {
      plain_wait_flag(ready + strip);
#pragma unroll
      for (int b = 0; b < B_BLOCKS; ++b) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (acc[b][i] != 0) {
            atomicMax(out + (size_t)(i >> 1) * width + 16 * b + (i & 1),
                      acc[b][i]);
          }
        }
      }
      __threadfence();
      __syncwarp();
      int last = 0;
      if (lane == 0) {
        last = atomicAdd(merged + strip, 1) == it.n_slices - 2;
      }
      if (__shfl_sync(PLAIN_FULL_MASK, last, 0)) {
        plain_raise_flag(complete + strip);
      }
    }
  }

  const int n_resolve = n_strips * B_PARTS;
  while (true) {  // resolve
    int item = 0;
    if (lane == 0) item = atomicAdd(r_counter, 1);
    item = __shfl_sync(PLAIN_FULL_MASK, item, 0);
    if (item >= n_resolve) break;
    // bins in the visibility queue's order, so early items wait least
    const int bin = plain_order_bin<GLOBAL>(s_key, item / (sub * B_PARTS));
    for (int s = 0; s < sub; ++s) {  // strip 0 rounded the bin's rows
      plain_wait_flag(complete + bin * sub + s);
    }
    const int ty = bin / n_tiles_x;
    const int tx = bin - ty * n_tiles_x;
    const int part = item % (sub * B_PARTS);
    gbuffer_resolve<PREV>(
        rounded, n_pairs, tile_start[bin] / PLAIN_GROUP * PLAIN_GROUP,
        tx * PLAIN_TILE_W + 32 * (part % B_PARTS),
        (ty * sub + part / B_PARTS) * PLAIN_TILE_H, width, plane, depth,
        vis, gbuf);
  }
}

extern "C" int gbuffer_launch(const void* edges, const void* attrs,
                              void* rounded, const void* tile_start,
                              const void* tile_count, void* aux, void* depth,
                              void* vis, void* gbuf, int n_pairs,
                              int n_tiles_y, int n_tiles_x, int sub,
                              int row_skip, int prev, void* stream) {
  const int n_bins = n_tiles_y * n_tiles_x;
  if (n_bins < 1) return (int)cudaErrorInvalidValue;
  static PlainGridCache caches[2];  // the static and PREV instances
  const PlainStripLaunch l =
      prev ? plain_strip_launch(caches[1], gbuffer_kernel<true, false>,
                                gbuffer_kernel<true, true>, B_WARPS * 32,
                                n_bins)
           : plain_strip_launch(caches[0], gbuffer_kernel<false, false>,
                                gbuffer_kernel<false, true>, B_WARPS * 32,
                                n_bins);
  if (l.global) {
    const int err = plain_order_launch(tile_count, n_bins, CHUNK,
                                       gbuffer_order((int*)aux, n_bins, sub),
                                       stream);
    if (err != 0) return err;
  }
  auto kernel = prev ? (l.global ? gbuffer_kernel<true, true>
                                 : gbuffer_kernel<true, false>)
                     : (l.global ? gbuffer_kernel<false, true>
                                 : gbuffer_kernel<false, false>);
  kernel<<<l.grid, B_WARPS * 32, l.smem, (cudaStream_t)stream>>>(
      (const float*)edges, (const float*)attrs, (float*)rounded,
      (const int*)tile_start, (const int*)tile_count, (int*)aux,
      (float*)depth, (int*)vis, (float*)gbuf, n_pairs, n_tiles_y, n_tiles_x,
      sub, row_skip);
  PLAIN_RETURN_LAUNCH_STATUS();
}
