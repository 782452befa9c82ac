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
// dynamic scenes: + the previous-frame clip x, y, w planes (rows 30-38;
// pair_attrs then has 40 rows) and previous NDC xy (channels 13-14)
#define PLAIN_NATTR_PREV 39
#define PLAIN_GBUF_CHANNELS_PREV 15

// The raster kernels (gbuffer.cu, depth.cu) stage 14 of a pair's 16 edge
// rows in shared memory: e0, e1, e2, z as (a, b, c) (rows 4p + k), then
// the fine-row extents fy0 (row 3) and fy1 (row 7).
#define PLAIN_N_STAGED 14
__device__ __forceinline__ int plain_staged_row(int r) {
  return r < 12 ? (r / 3) * 4 + r % 3 : (r == 12 ? 3 : 7);
}

// The alpha-tested raster kernels (depth_alpha.cu, gbuffer_alpha.cu) stage
// 24 of the 32 rows: the 14 above, then u/w, v/w, 1/w as (a, b, c) (rows
// 16-26, planes 4-6) and the mask slot (row 30, plane 7's c). Staged row
// 14 + 3 * q + k holds plane 4 + q's coefficient k; staged row 23 the slot.
#define PLAIN_N_STAGED_ALPHA 24
#define PLAIN_STAGED_SLOT 23
__device__ __forceinline__ int plain_staged_row_alpha(int r) {
  return r < PLAIN_N_STAGED ? plain_staged_row(r)
                            : (r == PLAIN_STAGED_SLOT
                                   ? 30
                                   : 16 + ((r - 14) / 3) * 4 + (r - 14) % 3);
}
#define PLAIN_MAX_ALPHA_MASKS 8  // = ops/raster.py:MAX_ALPHA_MASKS
#define PLAIN_ALPHA_MASK_WORDS 128

// A plane at a pixel centre as a*x + (b*y + c), every multiply and add
// rounded on its own (no FMA contraction), as the plain versions evaluate.
__device__ __forceinline__ float plain_plane(float a, float b, float c,
                                             float x, float y) {
  return __fadd_rn(__fmul_rn(a, x), __fadd_rn(__fmul_rn(b, y), c));
}

// raster.py:_kernel_recip: 1/x for x > 0 as rsqrt(x)^2 + one Newton step
__device__ __forceinline__ float plain_kernel_recip(float x) {
  float r = rsqrtf(x);
  r = __fmul_rn(r, r);
  return __fmul_rn(r, __fsub_rn(2.0f, __fmul_rn(x, r)));
}

// The alpha test (raster.py:1393-1416) of a pair with mask slot `slot` at
// a pixel whose planes 4-6 evaluate to uw, vw, iw: the perspective-correct
// uv wrapped into 64x64 texels picks one bit of mask slot - 1 (masks in
// shared memory, n_masks rows of 128 words). Opaque pairs (slot < 0.5) and
// slots that name no mask pass, as the TPU kernel's table default (-1).
__device__ __forceinline__ bool plain_alpha_passes(float uw, float vw,
                                                   float iw, float slot,
                                                   const int* masks,
                                                   int n_masks) {
  if (!(slot >= 0.5f)) return true;
  const float rs = rintf(slot);
  if (!(rs >= 1.0f && rs <= (float)n_masks && fabsf(slot - rs) < 0.5f)) {
    return true;
  }
  const float inv = plain_kernel_recip(iw > 1e-12f ? iw : 1.0f);
  const float u = __fmul_rn(uw, inv);
  const float v = __fmul_rn(vw, inv);
  const float fx = fminf(fmaxf(__fmul_rn(__fsub_rn(u, floorf(u)), 64.0f),
                               0.0f), 63.0f);
  const float fy = fminf(fmaxf(__fmul_rn(__fsub_rn(v, floorf(v)), 64.0f),
                               0.0f), 63.0f);
  const int ix = (int)fx;
  const int iy = (int)fy;
  const int word = masks[((int)rs - 1) * PLAIN_ALPHA_MASK_WORDS + iy * 2 +
                         (ix >= 32 ? 1 : 0)];
  return ((word >> (ix & 31)) & 1) == 1;
}

// round to bf16, nearest even (inf stays, NaN stays quiet)
__device__ __forceinline__ float plain_bf16_round(float f) {
  unsigned u = __float_as_uint(f);
  if ((u & 0x7f800000u) == 0x7f800000u) {
    return (u & 0x007fffffu) ? __uint_as_float((u | 0x00400000u) & 0xffff0000u)
                             : f;
  }
  u += 0x7fffu + ((u >> 16) & 1u);
  return __uint_as_float(u & 0xffff0000u);
}

// the TPU's two-pass bf16 product with an exact one-hot: hi + lo
// (raster.py:1650-1670)
__device__ __forceinline__ float plain_split_round(float a) {
  const float hi = plain_bf16_round(a);
  const float lo = plain_bf16_round(__fsub_rn(a, hi));
  return __fadd_rn(hi, lo);
}

// attribute plane at (x, y): (c0 * x + c1 * y) + c2 (raster.py:1687-1689)
__device__ __forceinline__ float plain_eval_attr(const float* c, float x,
                                                 float y) {
  return __fadd_rn(__fadd_rn(__fmul_rn(c[0], x), __fmul_rn(c[1], y)), c[2]);
}

// The attribute phase of kernels B and L (raster.py:1603 _attr_phase):
// the G-buffer channels at pixel centre (x, y) of the winner whose
// attribute rows are column idx of attrs (n_pairs columns), split-rounded:
// uv, its screen derivatives, normal and tangent normalised, the packed
// material row; with PREV (a dynamic scene's 39 rows) also the previous
// NDC xy of the prev-clip planes, divided by a signed _kernel_recip of
// |prev w| where it exceeds 1e-9, else by 1 (raster.py:1728-1740).
template <bool PREV>
__device__ __forceinline__ void plain_gbuffer_channels(
    const float* __restrict__ attrs, int n_pairs, int idx, float x, float y,
    float* ch) {
  constexpr int n_attr = PREV ? PLAIN_NATTR_PREV : PLAIN_NATTR;
  float cf[n_attr];
#pragma unroll
  for (int k = 0; k < n_attr; ++k) {
    cf[k] = plain_split_round(attrs[(size_t)k * n_pairs + idx]);
  }
  const float w =
      plain_kernel_recip(fmaxf(plain_eval_attr(cf + 0, x, y), 1e-12f));
  const float u = __fmul_rn(plain_eval_attr(cf + 3, x, y), w);
  const float v = __fmul_rn(plain_eval_attr(cf + 6, x, y), w);
  ch[0] = u;
  ch[1] = v;
  // rational derivatives d(U/W)/dx = (Ua - u * Wa) * w
  ch[2] = __fmul_rn(__fsub_rn(cf[3], __fmul_rn(u, cf[0])), w);
  ch[3] = __fmul_rn(__fsub_rn(cf[6], __fmul_rn(v, cf[0])), w);
  ch[4] = __fmul_rn(__fsub_rn(cf[4], __fmul_rn(u, cf[1])), w);
  ch[5] = __fmul_rn(__fsub_rn(cf[7], __fmul_rn(v, cf[1])), w);
#pragma unroll
  for (int vec = 0; vec < 2; ++vec) {
    const float* cv = cf + 9 + 9 * vec;
    const float vx = __fmul_rn(plain_eval_attr(cv + 0, x, y), w);
    const float vy = __fmul_rn(plain_eval_attr(cv + 3, x, y), w);
    const float vz = __fmul_rn(plain_eval_attr(cv + 6, x, y), w);
    const float len2 = __fadd_rn(
        __fadd_rn(__fmul_rn(vx, vx), __fmul_rn(vy, vy)), __fmul_rn(vz, vz));
    const float inv_len = rsqrtf(fmaxf(len2, 1e-20f));
    ch[6 + 3 * vec] = __fmul_rn(vx, inv_len);
    ch[7 + 3 * vec] = __fmul_rn(vy, inv_len);
    ch[8 + 3 * vec] = __fmul_rn(vz, inv_len);
  }
  ch[12] = cf[29];
  if (PREV) {
    const float prev_x = __fmul_rn(plain_eval_attr(cf + 30, x, y), w);
    const float prev_y = __fmul_rn(plain_eval_attr(cf + 33, x, y), w);
    const float prev_w = __fmul_rn(plain_eval_attr(cf + 36, x, y), w);
    float inv_pw = 1.0f;
    if (fabsf(prev_w) > 1e-9f) {
      const float r = plain_kernel_recip(fabsf(prev_w));
      inv_pw = prev_w < 0.0f ? -r : r;
    }
    ch[13] = __fmul_rn(prev_x, inv_pw);
    ch[14] = __fmul_rn(prev_y, inv_pw);
  }
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

// The depth-only kernels' work items (depth.cu, depth_alpha.cu): item i
// is the DEPTH_CHUNK-pair slice k of the first bin with chunk_end > i,
// chunk_end being the inclusive prefix sum of each bin's
// ceil(count / chunk) (ops/raster.py:rasterize_depth). Sets the bin, the
// slice's first pair in the stream and its pair count.
__device__ __forceinline__ void plain_depth_item(
    const int* __restrict__ chunk_end, const int* __restrict__ tile_start,
    const int* __restrict__ tile_count, int n_bins, int chunk, int item,
    int* bin, int* start, int* n) {
  int lo = 0, hi = n_bins - 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (chunk_end[mid] <= item) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  const int count = tile_count[lo];
  const int first_item = chunk_end[lo] - (count + chunk - 1) / chunk;
  const int p0 = (item - first_item) * chunk;
  *bin = lo;
  *n = min(chunk, count - p0);
  *start = tile_start[lo] + p0;
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
