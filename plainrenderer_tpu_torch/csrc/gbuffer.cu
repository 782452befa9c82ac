// Kernel B: opaque main-view G-buffer raster (visibility + attributes).
//
// Replaces plainrenderer_tpu/ops/raster.py:_gbuffer_kernel (:1564) with its
// _depth_resolve_loop (:1162, track_winner=True, row_skip) and _attr_phase
// (:1603), for opaque geometry. One thread block per (sub * 16) x 128 px
// bin (sub <= 4); thread t owns column t % 128 of 16-px sub-block
// t / 128, i.e. 16 pixels of one column, and keeps their packed
// (depth | slot) maxima in registers.
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
// - row skip (row_skip != 0): a pair is evaluated in a 16-px sub-block
//   only when the sub-block's fine row lies in the pair's [fy0, fy1]
//   (pair_edges rows 3 and 7); the TPU skips per 32-pair slice on the
//   slice's row extent;
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
// Bound on the H100: at 1080p it must write 125 MB (depth, vis and 13
// f32 channels per pixel; 142 MB with 15) and read the pair tables once; the plane
// evaluations are 12 flops per evaluated (pair, pixel). Design: pair
// setups are staged through shared memory in chunks of CHUNK pairs (14 of
// the 16 edge rows: 4 planes x (a, b, c) plus the fine-row extents), read
// as broadcasts; the per-thread column makes a*x one multiply per pair;
// the row skip test is uniform across a warp. Winner attributes are read
// straight from pair_attrs once per covered pixel (neighbouring pixels
// share winners, so those reads mostly hit L1/L2). No wgmma or TMA: the
// work is per-pixel scalar compares, not a matrix product.
#include "common.cuh"

#define CHUNK 256

// at most 4 sub-blocks of 128 threads: caps registers at 128 per thread
template <bool PREV>
__global__ void __launch_bounds__(4 * PLAIN_TILE_W)
gbuffer_kernel(const float* __restrict__ edges,
                               const float* __restrict__ attrs,
                               const int* __restrict__ tile_start,
                               const int* __restrict__ tile_count,
                               float* __restrict__ depth,
                               int* __restrict__ vis,
                               float* __restrict__ gbuf, int n_pairs,
                               int n_tiles_y, int n_tiles_x, int sub,
                               int row_skip) {
  __shared__ float staged[PLAIN_N_STAGED][CHUNK];

  const int bin = blockIdx.x;
  const int ty = bin / n_tiles_x;
  const int tx = bin - ty * n_tiles_x;
  const int start = tile_start[bin];
  const int count = tile_count[bin];
  const int base = start / PLAIN_GROUP * PLAIN_GROUP;
  const int lead = start - base;

  const int lx = threadIdx.x % PLAIN_TILE_W;
  const int s = threadIdx.x / PLAIN_TILE_W;
  const int fine_row = ty * sub + s;
  const float frow = (float)fine_row;
  const int y0 = fine_row * PLAIN_TILE_H;
  const float x = (float)(tx * PLAIN_TILE_W + lx) + 0.5f;

  int acc[PLAIN_TILE_H];
#pragma unroll
  for (int r = 0; r < PLAIN_TILE_H; ++r) acc[r] = 0;

  for (int c0 = 0; c0 < count; c0 += CHUNK) {
    const int n = min(CHUNK, count - c0);
    __syncthreads();  // previous chunk fully consumed
    for (int i = threadIdx.x; i < PLAIN_N_STAGED * n; i += blockDim.x) {
      const int r = i / n;
      const int p = i - r * n;
      staged[r][p] =
          edges[(size_t)plain_staged_row(r) * n_pairs + start + c0 + p];
    }
    __syncthreads();
    for (int p = 0; p < n; ++p) {
      if (row_skip && !(staged[12][p] <= frow && frow <= staged[13][p])) {
        continue;
      }
      const int slot = lead + c0 + p;
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
        const float z = __fadd_rn(axz, __fadd_rn(__fmul_rn(bz, y), kz));
        // explicit compares: NaN never covers (as the TPU's min-based test)
        if (e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f && z > 0.0f &&
            z <= 1.0f) {
          const int cand = (__float_as_int(z) & ~PLAIN_SLOT_MASK) | slot;
          acc[r] = max(acc[r], cand);
        }
      }
    }
  }

  const int width = n_tiles_x * PLAIN_TILE_W;
  const size_t plane = (size_t)n_tiles_y * sub * PLAIN_TILE_H * width;
  const int px = tx * PLAIN_TILE_W + lx;
  // unrolled: a runtime row index would put acc[] in local memory
#pragma unroll
  for (int r = 0; r < PLAIN_TILE_H; ++r) {
    const size_t o = (size_t)(y0 + r) * width + px;
    const int a = acc[r];
    depth[o] = __int_as_float(a & ~PLAIN_SLOT_MASK);
    constexpr int n_ch = PREV ? PLAIN_GBUF_CHANNELS_PREV : PLAIN_GBUF_CHANNELS;
    float ch[n_ch];
#pragma unroll
    for (int c = 0; c < n_ch; ++c) ch[c] = 0.0f;
    if (a != 0) {
      const int slot = a & PLAIN_SLOT_MASK;
      vis[o] = slot;
      plain_gbuffer_channels<PREV>(attrs, n_pairs, base + slot, x,
                                   (float)(y0 + r) + 0.5f, ch);
    } else {
      vis[o] = -1;
    }
#pragma unroll
    for (int c = 0; c < n_ch; ++c) gbuf[c * plane + o] = ch[c];
  }
}

extern "C" int gbuffer_launch(const void* edges, const void* attrs,
                              const void* tile_start, const void* tile_count,
                              void* depth, void* vis, void* gbuf, int n_pairs,
                              int n_tiles_y, int n_tiles_x, int sub,
                              int row_skip, int prev, void* stream) {
  const int blocks = n_tiles_y * n_tiles_x;
  const int threads = PLAIN_TILE_W * sub;
  auto kernel = prev ? gbuffer_kernel<true> : gbuffer_kernel<false>;
  kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)edges, (const float*)attrs, (const int*)tile_start,
      (const int*)tile_count, (float*)depth, (int*)vis, (float*)gbuf,
      n_pairs, n_tiles_y, n_tiles_x, sub, row_skip);
  PLAIN_RETURN_LAUNCH_STATUS();
}
