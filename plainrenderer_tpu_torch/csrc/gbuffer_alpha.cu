// Kernels K and L: the alpha-tested main-view G-buffer, in two launches.
//
// K replaces plainrenderer_tpu/ops/raster.py:_winner_alpha_kernel (:1743),
// _depth_resolve_loop (:1162) with track_winner=True and the alpha test
// (:1393-1416). L replaces _attr_resolve_kernel (:1755), the winners'
// attribute phase (:1603) read back through the vis contract (_vis_encode
// / _vis_decode, :1129-1145). The TPU split them only for Mosaic's compile
// time (:1571-1575); they stay two launches here so that each has its own
// time and bound beside its TPU body.
//
// K: one thread block per (sub * 16) x 128 bin (sub <= 4), thread t owns
// column t % 128 of 16-px sub-block t / 128 and keeps 16 packed
// (depth | slot) maxima in registers, as kernel B (gbuffer.cu): coverage
// is the three edge planes >= 0 at the pixel centre, the alpha test
// (common.cuh, plain_alpha_passes) and reverse-Z 0 < z <= 1; the winner
// is the integer max of (bits(z) & ~2047) | slot, slot counted from the
// group-aligned floor of the bin's segment. It writes depth with the slot
// bits cleared and vis = slot, or -1 where nothing covers. Pair setups
// (24 of the 32 rows) and the masks are staged in shared memory; every
// multiply and add is rounded on its own, so K equals its plain version
// (ops/raster.py:winner_alpha_plain) on every pixel.
//
// L: one thread per pixel. It reads vis, takes the winner's 30 attribute
// rows (39 in a dynamic scene, prev != 0) at column base + vis of its bin,
// split-rounds them and evaluates the 13 channels (15 with the previous
// NDC) exactly as kernel B's attribute phase (common.cuh,
// plain_gbuffer_channels); uncovered pixels get zeros.
//
// Bound on the H100: both are bytes-bound at 1080p. K writes depth and vis
// (8 B per pixel, 16.7 MB) and reads the few thousand alpha pairs; L reads
// vis (4 B) and writes 13 f32 channels (52 B; 15, 60 B, in a dynamic
// scene) per pixel, ~117 MB. The
// alpha stream covers a small share of the screen, so most of L's threads
// only write zeros; its writes are coalesced across a warp.
#include "common.cuh"

#define CHUNK 256

__global__ void __launch_bounds__(4 * PLAIN_TILE_W)
winner_alpha_kernel(const float* __restrict__ edges,
                    const int* __restrict__ masks,
                    const int* __restrict__ tile_start,
                    const int* __restrict__ tile_count,
                    float* __restrict__ depth, int* __restrict__ vis,
                    int n_pairs, int n_masks, int n_tiles_y, int n_tiles_x,
                    int sub, int row_skip) {
  __shared__ float staged[PLAIN_N_STAGED_ALPHA][CHUNK];
  __shared__ int s_masks[PLAIN_MAX_ALPHA_MASKS * PLAIN_ALPHA_MASK_WORDS];

  const int bin = blockIdx.x;
  const int ty = bin / n_tiles_x;
  const int tx = bin - ty * n_tiles_x;
  const int start = tile_start[bin];
  const int count = tile_count[bin];
  const int lead = start - start / PLAIN_GROUP * PLAIN_GROUP;

  const int lx = threadIdx.x % PLAIN_TILE_W;
  const int s = threadIdx.x / PLAIN_TILE_W;
  const int fine_row = ty * sub + s;
  const float frow = (float)fine_row;
  const int y0 = fine_row * PLAIN_TILE_H;
  const float x = (float)(tx * PLAIN_TILE_W + lx) + 0.5f;
  for (int i = threadIdx.x; i < n_masks * PLAIN_ALPHA_MASK_WORDS;
       i += blockDim.x) {
    s_masks[i] = masks[i];
  }

  int acc[PLAIN_TILE_H];
#pragma unroll
  for (int r = 0; r < PLAIN_TILE_H; ++r) acc[r] = 0;

  for (int c0 = 0; c0 < count; c0 += CHUNK) {
    const int n = min(CHUNK, count - c0);
    __syncthreads();  // previous chunk fully consumed
    for (int i = threadIdx.x; i < PLAIN_N_STAGED_ALPHA * n;
         i += blockDim.x) {
      const int r = i / n;
      const int p = i - r * n;
      staged[r][p] = edges[(size_t)plain_staged_row_alpha(r) * n_pairs +
                           start + c0 + p];
    }
    __syncthreads();
    for (int p = 0; p < n; ++p) {
      if (row_skip && !(staged[12][p] <= frow && frow <= staged[13][p])) {
        continue;
      }
      const int slot_bits = lead + c0 + p;
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
        const float z =
            plain_plane(staged[9][p], staged[10][p], staged[11][p], x, y);
        // explicit compares: NaN never covers (as the TPU's min-based test)
        if (!(e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f && z > 0.0f &&
              z <= 1.0f)) {
          continue;
        }
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
        acc[r] = max(acc[r], (__float_as_int(z) & ~PLAIN_SLOT_MASK) |
                                 slot_bits);
      }
    }
  }

  const int width = n_tiles_x * PLAIN_TILE_W;
  const int px = tx * PLAIN_TILE_W + lx;
#pragma unroll
  for (int r = 0; r < PLAIN_TILE_H; ++r) {
    const size_t o = (size_t)(y0 + r) * width + px;
    const int a = acc[r];
    depth[o] = __int_as_float(a & ~PLAIN_SLOT_MASK);
    vis[o] = a != 0 ? (a & PLAIN_SLOT_MASK) : -1;
  }
}

template <bool PREV>
__global__ void attr_resolve_kernel(const float* __restrict__ attrs,
                                    const int* __restrict__ tile_start,
                                    const int* __restrict__ vis,
                                    float* __restrict__ gbuf, int n_pairs,
                                    int n_tiles_y, int n_tiles_x, int sub) {
  const int width = n_tiles_x * PLAIN_TILE_W;
  const int height = n_tiles_y * sub * PLAIN_TILE_H;
  const size_t plane = (size_t)height * width;
  const size_t o = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= plane) return;
  const int py = (int)(o / width);
  const int px = (int)(o - (size_t)py * width);
  const int slot = vis[o];
  constexpr int n_ch = PREV ? PLAIN_GBUF_CHANNELS_PREV : PLAIN_GBUF_CHANNELS;
  float ch[n_ch];
#pragma unroll
  for (int c = 0; c < n_ch; ++c) ch[c] = 0.0f;
  if (slot >= 0) {
    const int bin = py / (sub * PLAIN_TILE_H) * n_tiles_x + px / PLAIN_TILE_W;
    const int base = tile_start[bin] / PLAIN_GROUP * PLAIN_GROUP;
    plain_gbuffer_channels<PREV>(attrs, n_pairs,
                                 min(base + slot, n_pairs - 1),
                                 (float)px + 0.5f, (float)py + 0.5f, ch);
  }
#pragma unroll
  for (int c = 0; c < n_ch; ++c) gbuf[c * plane + o] = ch[c];
}

extern "C" int winner_alpha_launch(const void* edges, const void* masks,
                                   const void* tile_start,
                                   const void* tile_count, void* depth,
                                   void* vis, int n_pairs, int n_masks,
                                   int n_tiles_y, int n_tiles_x, int sub,
                                   int row_skip, void* stream) {
  winner_alpha_kernel<<<n_tiles_y * n_tiles_x, PLAIN_TILE_W * sub, 0,
                        (cudaStream_t)stream>>>(
      (const float*)edges, (const int*)masks, (const int*)tile_start,
      (const int*)tile_count, (float*)depth, (int*)vis, n_pairs, n_masks,
      n_tiles_y, n_tiles_x, sub, row_skip);
  PLAIN_RETURN_LAUNCH_STATUS();
}

extern "C" int attr_resolve_launch(const void* attrs, const void* tile_start,
                                   const void* vis, void* gbuf, int n_pairs,
                                   int n_tiles_y, int n_tiles_x, int sub,
                                   int prev, void* stream) {
  const size_t n_pix =
      (size_t)n_tiles_y * sub * PLAIN_TILE_H * n_tiles_x * PLAIN_TILE_W;
  const int threads = 256;
  auto kernel = prev ? attr_resolve_kernel<true> : attr_resolve_kernel<false>;
  kernel<<<(unsigned)((n_pix + threads - 1) / threads), threads, 0,
           (cudaStream_t)stream>>>(
      (const float*)attrs, (const int*)tile_start, (const int*)vis,
      (float*)gbuf, n_pairs, n_tiles_y, n_tiles_x, sub);
  PLAIN_RETURN_LAUNCH_STATUS();
}
