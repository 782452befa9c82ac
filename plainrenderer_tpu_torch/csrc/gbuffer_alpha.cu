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
// L, two grids enqueued by one call (attr_resolve_launch), so the host
// pays one launch call as for the previous one-grid design:
//   1. attr_round_kernel: one thread per pair column split-rounds its 30
//      attribute rows (39 in a dynamic scene, prev != 0) once into a
//      pair-major record of L_REC (L_REC_PREV) floats, 16-byte aligned
//      (ops/raster.py:attr_table_plain). Kernel B does the same in its
//      strip 0 (gbuffer.cu).
//   2. attr_resolve_kernel: a warp takes the 128 columns of one row (a
//      bin's width), a thread 4 adjacent pixels (vis as one int4); a
//      winner's record is read as 8 (10) float4s, once for each run of
//      the thread's pixels with the same winner, and the 13 channels (15
//      with the previous NDC) are evaluated as kernel B's attribute phase
//      (common.cuh, plain_gbuffer_eval) and written as float4 streaming
//      stores. A warp whose 128 pixels are all uncovered only stores
//      zeros. The records hold the values the previous design rounded per
//      pixel, so the channels keep its bits (compare_trees.py checks).
// ptxas: resolve 94 registers (13 channels) and 122 (15), round 40 and
// 48, no spill. Slice 5 (H100 80GB HBM3, 700 W): PR 8's one thread per
// pixel, 30 strided loads and 30 splits per covered pixel, took 0.098 ms;
// this design 0.054 (both launches; compare_trees.py).
//
// Bound on the H100: both are bytes-bound at 1080p. K writes depth and vis
// (8 B per pixel, 16.7 MB) and reads the few thousand alpha pairs; L reads
// vis (4 B) and writes 13 f32 channels (52 B; 15, 60 B, in a dynamic
// scene) per pixel, ~117 MB, plus the winners' rows. Where the alpha
// stream covers most of the screen (slice 5's banner 0 fills the view)
// nearly every pixel evaluates its winner's channels.
#include "common.cuh"

#define CHUNK 256
#define L_REC 32       // floats per pair record: 30 rounded rows, 2 zeros
#define L_REC_PREV 40  // a dynamic scene's: 39 rows, 1 zero
#define L_ROWS 8       // rows per block of kernel L
#define L_THREADS (32 * L_ROWS)

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

// L, part 1: each pair column's attribute rows, split-rounded once into a
// pair-major record of L_REC (L_REC_PREV) floats, the rows then zeros.
template <bool PREV>
__global__ void __launch_bounds__(256)
attr_round_kernel(const float* __restrict__ attrs, float* __restrict__ table,
                  int n_pairs) {
  constexpr int n_attr = PREV ? PLAIN_NATTR_PREV : PLAIN_NATTR;
  constexpr int rec = PREV ? L_REC_PREV : L_REC;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n_pairs) return;
  float r[rec];
#pragma unroll
  for (int k = 0; k < rec; ++k) {
    r[k] = k < n_attr ? plain_split_round(attrs[(size_t)k * n_pairs + j])
                      : 0.0f;
  }
  float4* dst = reinterpret_cast<float4*>(table + (size_t)j * rec);
#pragma unroll
  for (int q = 0; q < rec / 4; ++q) {
    dst[q] = make_float4(r[4 * q], r[4 * q + 1], r[4 * q + 2], r[4 * q + 3]);
  }
}

// L, part 2: 4 adjacent pixels per thread; a warp takes 128 columns of
// one row (a bin's width), a block 8 rows, so the whole block lies in
// one bin.
template <bool PREV>
__global__ void __launch_bounds__(L_THREADS)
attr_resolve_kernel(const float* __restrict__ table,
                    const int* __restrict__ tile_start,
                    const int* __restrict__ vis, float* __restrict__ gbuf,
                    int n_pairs, int n_tiles_x, int sub, size_t plane) {
  constexpr int n_ch = PREV ? PLAIN_GBUF_CHANNELS_PREV : PLAIN_GBUF_CHANNELS;
  constexpr int n_attr = PREV ? PLAIN_NATTR_PREV : PLAIN_NATTR;
  constexpr int rec = PREV ? L_REC_PREV : L_REC;
  const int width = n_tiles_x * PLAIN_TILE_W;
  const int lane = threadIdx.x & 31;
  const int py = blockIdx.y * L_ROWS + (threadIdx.x >> 5);
  const int px = blockIdx.x * PLAIN_TILE_W + 4 * lane;
  const size_t o = (size_t)py * width + px;
  const int4 v4 = __ldcs(reinterpret_cast<const int4*>(vis + o));
  const int slot[4] = {v4.x, v4.y, v4.z, v4.w};
  float4* dst = reinterpret_cast<float4*>(gbuf + o);
  const bool any = v4.x >= 0 || v4.y >= 0 || v4.z >= 0 || v4.w >= 0;
  if (!__any_sync(PLAIN_FULL_MASK, any)) {  // no winner in the warp's row
#pragma unroll
    for (int c = 0; c < n_ch; ++c) {
      __stcs(dst + c * (plane / 4), make_float4(0.0f, 0.0f, 0.0f, 0.0f));
    }
    return;
  }
  const int bin = py / (sub * PLAIN_TILE_H) * n_tiles_x + blockIdx.x;
  const int base = tile_start[bin] / PLAIN_GROUP * PLAIN_GROUP;
  float ch[n_ch][4];
  float cf[n_attr];
  int loaded = -1;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < n_ch; ++c) ch[c][i] = 0.0f;
    if (slot[i] < 0) continue;
    const int idx = min(base + slot[i], n_pairs - 1);
    if (idx != loaded) {  // the pixels of a winner share its record
      const float4* r = reinterpret_cast<const float4*>(table) +
                        (size_t)idx * (rec / 4);
#pragma unroll
      for (int q = 0; q < rec / 4; ++q) {
        const float4 f = __ldg(r + q);
        if (4 * q < n_attr) cf[4 * q] = f.x;
        if (4 * q + 1 < n_attr) cf[4 * q + 1] = f.y;
        if (4 * q + 2 < n_attr) cf[4 * q + 2] = f.z;
        if (4 * q + 3 < n_attr) cf[4 * q + 3] = f.w;
      }
      loaded = idx;
    }
    float c1[n_ch];
    plain_gbuffer_eval<PREV>(cf, (float)(px + i) + 0.5f, (float)py + 0.5f,
                             c1);
#pragma unroll
    for (int c = 0; c < n_ch; ++c) ch[c][i] = c1[c];
  }
#pragma unroll
  for (int c = 0; c < n_ch; ++c) {
    __stcs(dst + c * (plane / 4),
           make_float4(ch[c][0], ch[c][1], ch[c][2], ch[c][3]));
  }
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

// Kernel L: both grids from one call, so the host pays one launch call
extern "C" int attr_resolve_launch(const void* attrs, void* table,
                                   const void* tile_start, const void* vis,
                                   void* gbuf, int n_pairs, int n_tiles_y,
                                   int n_tiles_x, int sub, int prev,
                                   void* stream) {
  const int threads = 256;
  auto round = prev ? attr_round_kernel<true> : attr_round_kernel<false>;
  round<<<(n_pairs + threads - 1) / threads, threads, 0,
          (cudaStream_t)stream>>>((const float*)attrs, (float*)table,
                                  n_pairs);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const int height = n_tiles_y * sub * PLAIN_TILE_H;
  const size_t plane = (size_t)height * n_tiles_x * PLAIN_TILE_W;
  const dim3 grid(n_tiles_x, height / L_ROWS);
  auto resolve = prev ? attr_resolve_kernel<true> : attr_resolve_kernel<false>;
  resolve<<<grid, L_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)table, (const int*)tile_start, (const int*)vis,
      (float*)gbuf, n_pairs, n_tiles_x, sub, plane);
  PLAIN_RETURN_LAUNCH_STATUS();
}
