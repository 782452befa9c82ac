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
// K: coverage is the three edge planes >= 0 at the pixel centre,
// reverse-Z 0 < z <= 1 and the alpha test (common.cuh, plain_alpha_mask
// and plain_alpha_bit); the winner is the integer max of (bits(z) & ~2047)
// | slot, slot counted from the group-aligned floor of the bin's segment
// (a slice's pair p has slot lead + p0 + p). It writes depth with the
// slot bits cleared and vis = slot, or -1 where nothing covers. Every
// multiply and add is rounded on its own, so K equals its plain version
// (ops/raster.py:winner_alpha_plain) on every pixel.
// Design: strip items as kernels E's and B's (depth.cu, gbuffer.cu;
// common.cuh, plain_slice_prefix, plain_strip_item, plain_strip_pairs),
// cut finer. One warp does one item, a 16 x 16 block of a bin against one
// K_CHUNK-pair slice of its pairs, with no block barrier; a warp's first
// item is its index in the grid, the rest come from an atomic counter
// (plain_next_item); bins go heaviest first, bucketed by pairs.
//   1. 32 pairs at a time, one per lane (22 rows each: edges, z, planes
//      4-6, the mask slot), row skip, then the block's exact corner tests
//      of the three edges and of the z range (plain_plane_may_pass,
//      plain_depth_may_pass); passing pairs go to the warp's stash (23
//      floats a pair).
//   2. Per such pair, each lane's 4 row terms once, its 2 column terms,
//      then 8 pixels. The alpha test (mask row picked once per pair; the
//      masks and a row of ones in shared memory) runs on all 8 pixels
//      without a branch, so the 8 tests are independent chains that
//      overlap.
//   3. A block whose bin has one slice splits its maxima into depth and
//      vis itself. A heavier bin's slices merge in vis: the first to
//      finish stores its packed maxima and raises a flag, the others wait
//      for it and atomicMax theirs, and the last of them to merge splits
//      the block (B's merge; its resolve queue is not needed, since the
//      split reads nothing but vis).
// K's ptxas: 80 registers, no spill, no stack, 28,192 B of static shared
// memory (+ 2 ints per bin dynamic): 3 blocks of 8 warps per SM.
// K's times on slice 5's main view (1,788 pairs in all 510 bins, median 2,
// at most 30; 2.89 M pixels of passing 16 x 16 blocks; H100 80GB HBM3,
// 700.00 W; compare_trees.py, each tree in its own process; medians;
// [base / variant] in one call, the base being the design of that moment;
// a lone time had its base in the call before). The previous design (one
// 256-thread block per bin walking all its pairs, no block test): 0.0541
// ms; without its alpha test 0.0207 (the test ran on every covered pixel
// of every pair, as a branch), without its pair walk 0.0064, without its
// staging too 0.0064. This design's steps:
//   half strips (16 x 64), the alpha test behind a branch, K_CHUNK 32
//                                                    [0.0541 / 0.0690]
//   16 x 16 items, 4 blocks/SM                       [0.0568 / 0.0354]
//     16 x 32 items [/ 0.0450]; 5 blocks/SM, spilling [/ 0.0399]; that
//     design without its alpha test 0.0203, without any pair work 0.0177
//   K_CHUNK 16                                       [0.0338 / 0.0300]
//   items only in turn, no counter                   0.0342 (0.0300)
//   the alpha test without a branch                  [0.0301 / 0.0271]
//     at 3 blocks/SM (80 registers, no spill)        [0.0271 / 0.0252]
//   K_CHUNK 8                                        [0.0250 / 0.0262]
//   reading the counter before taking from it        0.0319 (0.0250)
//     and two rounds of items in turn first          [0.0319 / 0.0304]
//   asking the counter for the next item ahead       [0.0254 / 0.0292]
//   counter batches of 2 and 4              [0.0260 / 0.0266, 0.0316]
//   bins' starts in shared memory, the prefix's loads batched
//                                                    [0.0255 / 0.0259]
//   the uv planes' row terms once per pair           [0.0255 / 0.0255]
//   scratch the kernel zeroes itself, no fill launch [0.0251 / 0.0242]
//     (kept out: a buffer cached across calls for 0.001 ms)
//   bins bucketed by pairs, not slices               [0.0254 / 0.0256]
//   4 blocks/SM, columns not unrolled (spilling)     [0.0256 / 0.0358]
//   the alpha test inside the edge and z tests' && (a branch again):
//   0.0300; apart from them (this design) 0.0253 in the next call
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

#define K_CHUNK 16  // pairs per work item
#define K_WARPS 8
#define K_MIN_BLOCKS 3  // blocks of K_WARPS warps per SM
#define K_STRIDE (PLAIN_ROWS_ALPHA + 1)
#define L_REC 32       // floats per pair record: 30 rounded rows, 2 zeros
#define L_REC_PREV 40  // a dynamic scene's: 39 rows, 1 zero
#define L_ROWS 8       // rows per block of kernel L
#define L_THREADS (32 * L_ROWS)

// One pair's packed candidates at the lane's 8 pixels: 4 rows and 2
// columns from (x0, y0) in the item's 16 x 16 block; uvw: the pair's
// planes 4-6 in the stash, mask: its mask row. The alpha test runs on all
// 8 pixels, covered or not, with no branch, so the lane's 8 tests are
// independent chains that overlap.
__device__ __forceinline__ void winner_alpha_pair(int (&acc)[8],
                                                  const float* c,
                                                  const float* uvw,
                                                  const int* mask, int slot,
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
  for (int cc = 0; cc < 2; ++cc) {
    const float x = xb + (float)cc;
    const float a0 = __fmul_rn(c[0], x), a1 = __fmul_rn(c[3], x);
    const float a2 = __fmul_rn(c[6], x), az = __fmul_rn(c[9], x);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float y = yb + (float)r;
      const float z = __fadd_rn(az, br[3][r]);
      // evaluated apart from the edge tests, so it is not a branch
      const bool pass =
          plain_alpha_bit(plain_plane(uvw[0], uvw[1], uvw[2], x, y),
                          plain_plane(uvw[3], uvw[4], uvw[5], x, y),
                          plain_plane(uvw[6], uvw[7], uvw[8], x, y), mask);
      // explicit compares: NaN never covers (as the TPU's min-based test)
      const bool cov = __fadd_rn(a0, br[0][r]) >= 0.0f &&
                       __fadd_rn(a1, br[1][r]) >= 0.0f &&
                       __fadd_rn(a2, br[2][r]) >= 0.0f && z > 0.0f &&
                       z <= 1.0f && pass;
      const int cand = (__float_as_int(z) & ~PLAIN_SLOT_MASK) | slot;
      if (cov) acc[2 * r + cc] = max(acc[2 * r + cc], cand);
    }
  }
}

// The vis contract of the lane's 8 packed maxima at offset o (row stride
// width): depth with the slot bits cleared, vis the slot or -1.
__device__ __forceinline__ void winner_split(const int (&acc)[8],
                                             float* depth, int* vis,
                                             size_t o, int width) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const size_t at = o + (size_t)r * width;
    const int a0 = acc[2 * r], a1 = acc[2 * r + 1];
    *reinterpret_cast<float2*>(depth + at) =
        make_float2(__int_as_float(a0 & ~PLAIN_SLOT_MASK),
                    __int_as_float(a1 & ~PLAIN_SLOT_MASK));
    *reinterpret_cast<int2*>(vis + at) =
        make_int2(a0 != 0 ? (a0 & PLAIN_SLOT_MASK) : -1,
                  a1 != 0 ? (a1 & PLAIN_SLOT_MASK) : -1);
  }
}

// aux: the item counter, per 16 x 16 block a merge counter, a ready
// flag and a merged count, then the global order's scratch
// (plain_strip_launch)
__host__ __device__ __forceinline__ int* winner_alpha_order(int* aux,
                                                            int n_bins,
                                                            int sub) {
  return aux + 1 + 3 * 8 * (size_t)n_bins * sub;
}

template <bool GLOBAL>
__global__ void __launch_bounds__(K_WARPS * 32, K_MIN_BLOCKS)
winner_alpha_kernel(const float* __restrict__ edges,
                    const int* __restrict__ masks,
                    const int* __restrict__ tile_start,
                    const int* __restrict__ tile_count, int* __restrict__ aux,
                    float* __restrict__ depth, int* __restrict__ vis,
                    int n_pairs, int n_masks, int n_tiles_y, int n_tiles_x,
                    int sub, int row_skip) {
  extern __shared__ int s_dyn[];  // ordered bin keys, then slice prefix
  __shared__ float s_coef[K_WARPS][32 * K_STRIDE];
  __shared__ int s_masks[(PLAIN_MAX_ALPHA_MASKS + 1) *
                         PLAIN_ALPHA_MASK_WORDS];
  __shared__ int s_wsum[K_WARPS];
  const int n_bins = n_tiles_y * n_tiles_x;
  const int n_blocks = n_bins * sub * 8;  // 16 x 16 blocks of the screen
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  plain_load_masks(masks, n_masks, s_masks);
  const int* s_key = s_dyn;
  const int* s_end = s_dyn + n_bins;
  if constexpr (GLOBAL) {
    s_key = winner_alpha_order(aux, n_bins, sub);
    s_end = s_key + n_bins;
    __syncthreads();  // publishes s_masks
  } else {
    // its barriers also publish s_masks
    plain_slice_prefix<false, true>(tile_count, n_bins, K_CHUNK, s_dyn,
                                    s_dyn + n_bins, s_wsum);
  }

  int* counter = aux;
  int* done = aux + 1;             // per block: slices finished
  int* ready = done + n_blocks;    // per block: first slice stored
  int* merged = ready + n_blocks;  // per block: slices merged later
  const int n_items = plain_order_end<GLOBAL>(s_end, n_bins - 1) * sub * 8;
  const int width = n_tiles_x * PLAIN_TILE_W;
  const int cx = 2 * (lane & 7);   // the lane's 2 columns in the block
  const int ry = 4 * (lane >> 3);  // its 4 rows
  float* stash = s_coef[warp];

  const int n_warps = gridDim.x * K_WARPS;
  for (int item = blockIdx.x * K_WARPS + warp; item < n_items;
       item = plain_next_item(counter, n_warps, n_items)) {
    const PlainStrip it =
        plain_strip_item<GLOBAL>(s_key, s_end, tile_start, tile_count,
                                 n_bins, K_CHUNK, sub * 8, item);
    const int lead = tile_start[it.bin] % PLAIN_GROUP;
    const int ty = it.bin / n_tiles_x;
    const int tx = it.bin - ty * n_tiles_x;
    const int fine_row = ty * sub + (it.part >> 3);
    const int y0 = fine_row * PLAIN_TILE_H;
    const int x0 = tx * PLAIN_TILE_W + (it.part & 7) * 16;

    int acc[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = 0;

    plain_strip_pairs<PLAIN_ROWS_ALPHA>(
        edges, n_pairs, it.start, it.n, row_skip, (float)fine_row, stash,
        [&](const float* cf) -> unsigned {
          return plain_plane_may_pass(cf[0], cf[1], cf[2], x0, y0, 16, 16) &&
                 plain_plane_may_pass(cf[3], cf[4], cf[5], x0, y0, 16, 16) &&
                 plain_plane_may_pass(cf[6], cf[7], cf[8], x0, y0, 16, 16) &&
                 plain_depth_may_pass(cf[9], cf[10], cf[11], x0, y0, 16, 16);
        },
        [&](const float* c, unsigned, int p) {
          const float* s = stash + (p & 31) * K_STRIDE;
          winner_alpha_pair(
              acc, c, s + 12,
              plain_alpha_mask(s[PLAIN_ROW_SLOT], s_masks, n_masks),
              lead + it.p0 + p, x0 + cx, y0 + ry);
        });

    const int block = it.bin * sub * 8 + it.part;
    const size_t o = (size_t)(y0 + ry) * width + x0 + cx;
    if (it.n_slices == 1) {
      winner_split(acc, depth, vis, o, width);
      continue;
    }
    if (plain_finish_order(done + block, it.n_slices) == 0) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        *reinterpret_cast<int2*>(vis + o + (size_t)r * width) =
            make_int2(acc[2 * r], acc[2 * r + 1]);
      }
      plain_raise_flag(ready + block);
      continue;
    }
    plain_wait_flag(ready + block);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (acc[i] != 0) {
        atomicMax(vis + o + (size_t)(i >> 1) * width + (i & 1), acc[i]);
      }
    }
    __threadfence();
    __syncwarp();
    int last = 0;
    if (lane == 0) last = atomicAdd(merged + block, 1) == it.n_slices - 2;
    if (!__shfl_sync(PLAIN_FULL_MASK, last, 0)) continue;
    __threadfence();  // every slice's maxima are in vis: split them
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int2 v = __ldcg(
          reinterpret_cast<const int2*>(vis + o + (size_t)r * width));
      acc[2 * r] = v.x;
      acc[2 * r + 1] = v.y;
    }
    winner_split(acc, depth, vis, o, width);
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
                                   const void* tile_count, void* aux,
                                   void* depth, void* vis, int n_pairs,
                                   int n_masks, int n_tiles_y, int n_tiles_x,
                                   int sub, int row_skip, void* stream) {
  const int n_bins = n_tiles_y * n_tiles_x;
  if (n_bins < 1 || n_masks < 1 || n_masks > PLAIN_MAX_ALPHA_MASKS) {
    return (int)cudaErrorInvalidValue;
  }
  static PlainGridCache cache;
  const PlainStripLaunch l =
      plain_strip_launch(cache, winner_alpha_kernel<false>,
                         winner_alpha_kernel<true>, K_WARPS * 32, n_bins);
  if (l.global) {
    const int err = plain_order_launch<false, true>(
        tile_count, n_bins, K_CHUNK,
        winner_alpha_order((int*)aux, n_bins, sub), stream);
    if (err != 0) return err;
  }
  auto kernel =
      l.global ? winner_alpha_kernel<true> : winner_alpha_kernel<false>;
  kernel<<<l.grid, K_WARPS * 32, l.smem, (cudaStream_t)stream>>>(
      (const float*)edges, (const int*)masks, (const int*)tile_start,
      (const int*)tile_count, (int*)aux, (float*)depth, (int*)vis, n_pairs,
      n_masks, n_tiles_y, n_tiles_x, sub, row_skip);
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
