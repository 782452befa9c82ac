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

// The strip kernels load ROWS of a pair's table rows (plain_strip_pairs):
// 12 in kernels E and B (gbuffer.cu, depth.cu), e0, e1, e2, z as (a, b,
// c) at rows 4p + k; 22 in the alpha-tested J and K (depth_alpha.cu,
// gbuffer_alpha.cu), those 12, then u/w, v/w, 1/w as (a, b, c) at rows
// 16-26 (planes 4-6; loaded row 12 + 3q + k holds plane 4 + q's k) and
// the mask slot (row 30, plane 7's c; loaded row 21).
#define PLAIN_ROWS_ALPHA 22
#define PLAIN_ROW_SLOT 21
template <int ROWS>
__device__ __forceinline__ int plain_pair_row(int r) {
  if constexpr (ROWS == PLAIN_ROWS_ALPHA) {
    if (r >= 12) {
      return r == PLAIN_ROW_SLOT ? 30 : 16 + ((r - 12) / 3) * 4 + (r - 12) % 3;
    }
  }
  return (r / 3) * 4 + r % 3;
}
#define PLAIN_MAX_ALPHA_MASKS 8  // = ops/raster.py:MAX_ALPHA_MASKS
#define PLAIN_ALPHA_MASK_WORDS 128

// A plane at a pixel centre as a*x + (b*y + c), every multiply and add
// rounded on its own (no FMA contraction), as the plain versions evaluate.
__device__ __forceinline__ float plain_plane(float a, float b, float c,
                                             float x, float y) {
  return __fadd_rn(__fmul_rn(a, x), __fadd_rn(__fmul_rn(b, y), c));
}

// The exact block test (ops/raster.py:block_may_cover): fl(a*x) is
// monotone in x, fl(fl(b*y) + c) in y and their rounded sum in both, so a
// plane's largest value over the pixel centres of the bw x bh block at
// (x0, y0) is at the corner the signs of a and b pick. False when that
// value is < 0 or NaN: then no pixel of the block has the plane >= 0.
__device__ __forceinline__ bool plain_plane_may_pass(float a, float b,
                                                     float c, int x0, int y0,
                                                     int bw, int bh) {
  const float x = (float)(a > 0.0f ? x0 + bw - 1 : x0) + 0.5f;
  const float y = (float)(b > 0.0f ? y0 + bh - 1 : y0) + 0.5f;
  return plain_plane(a, b, c, x, y) >= 0.0f;
}

// The reverse-Z test of the same block (kernel B): some pixel can have
// 0 < z <= 1 only if the largest corner value is > 0 and the smallest
// (the opposite corner) is <= 1; a NaN at either corner fails too.
__device__ __forceinline__ bool plain_depth_may_pass(float a, float b,
                                                     float c, int x0, int y0,
                                                     int bw, int bh) {
  const bool ax = a > 0.0f, by = b > 0.0f;
  const float xh = (float)(ax ? x0 + bw - 1 : x0) + 0.5f;
  const float yh = (float)(by ? y0 + bh - 1 : y0) + 0.5f;
  const float xl = (float)(ax ? x0 : x0 + bw - 1) + 0.5f;
  const float yl = (float)(by ? y0 : y0 + bh - 1) + 0.5f;
  return plain_plane(a, b, c, xh, yh) > 0.0f &&
         plain_plane(a, b, c, xl, yl) <= 1.0f;
}

// raster.py:_kernel_recip: 1/x for x > 0 as rsqrt(x)^2 + one Newton step
__device__ __forceinline__ float plain_kernel_recip(float x) {
  float r = rsqrtf(x);
  r = __fmul_rn(r, r);
  return __fmul_rn(r, __fsub_rn(2.0f, __fmul_rn(x, r)));
}

// The alpha test (raster.py:1393-1416), in two steps. The masks sit in
// shared memory (plain_load_masks): n_masks rows of 128 words, then a row
// of ones, the TPU kernel's table default (-1). plain_alpha_mask, once per
// pair: the row that mask slot `slot` names, or the row of ones for
// opaque pairs (slot < 0.5) and slots that name no mask.
__device__ __forceinline__ void plain_load_masks(
    const int* __restrict__ masks, int n_masks, int* s_masks) {
  for (int i = threadIdx.x; i < (n_masks + 1) * PLAIN_ALPHA_MASK_WORDS;
       i += blockDim.x) {
    s_masks[i] = i < n_masks * PLAIN_ALPHA_MASK_WORDS ? masks[i] : -1;
  }
}

__device__ __forceinline__ const int* plain_alpha_mask(float slot,
                                                       const int* s_masks,
                                                       int n_masks) {
  const float rs = rintf(slot);
  const bool named = slot >= 0.5f && rs >= 1.0f && rs <= (float)n_masks &&
                     fabsf(slot - rs) < 0.5f;
  return s_masks + (named ? (int)rs - 1 : n_masks) * PLAIN_ALPHA_MASK_WORDS;
}

// plain_alpha_bit, per pixel whose planes 4-6 evaluate to uw, vw, iw: the
// perspective-correct uv wrapped into 64x64 texels picks one bit of the
// mask row.
__device__ __forceinline__ bool plain_alpha_bit(float uw, float vw, float iw,
                                                const int* mask) {
  const float inv = plain_kernel_recip(iw > 1e-12f ? iw : 1.0f);
  const float u = __fmul_rn(uw, inv);
  const float v = __fmul_rn(vw, inv);
  const float fx = fminf(fmaxf(__fmul_rn(__fsub_rn(u, floorf(u)), 64.0f),
                               0.0f), 63.0f);
  const float fy = fminf(fmaxf(__fmul_rn(__fsub_rn(v, floorf(v)), 64.0f),
                               0.0f), 63.0f);
  const int ix = (int)fx;
  const int iy = (int)fy;
  const int word = mask[iy * 2 + (ix >= 32 ? 1 : 0)];
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
// the G-buffer channels at pixel centre (x, y) of a winner from its
// attribute rows, split-rounded (both kernels round each pair's rows once
// into a table): uv, its screen derivatives, normal and tangent
// normalised, the packed material row; with PREV (a dynamic scene's 39
// rows) also the previous NDC xy of the prev-clip planes, divided by a
// signed _kernel_recip of |prev w| where it exceeds 1e-9, else by 1
// (raster.py:1728-1740).
template <bool PREV>
__device__ __forceinline__ void plain_gbuffer_eval(
    const float (&cf)[PREV ? PLAIN_NATTR_PREV : PLAIN_NATTR], float x,
    float y, float* ch) {
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
  if constexpr (PREV) {
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

// K independent reductions of the block's 256 threads at once, in the
// same halving tree as plain_tile_reduce (so float sums stay bit-identical
// to ops/texture.py:tile_sum) with two barriers in all: every thread
// stores its K values (red holds K * 256), then warp k % 8 reduces value
// k: lane i takes the steps s = 128, 64, 32 from shared memory in the
// tree's own pairing, v[i] op v[i + s], and s = 16 .. 1 with
// __shfl_down_sync, which pairs the same lanes. op(k, a, b) gives value
// k's operation. The results land in res[k] and in v[k] of every thread.
template <int K, typename T, typename Op>
__device__ __forceinline__ void plain_tile_reduce_n(T (&v)[K], T* red,
                                                    T* res, Op op) {
  const int t = threadIdx.x, lane = t & 31;
#pragma unroll
  for (int k = 0; k < K; ++k) red[k * PLAIN_TILE_THREADS + t] = v[k];
  __syncthreads();
  for (int k = t >> 5; k < K; k += PLAIN_TILE_THREADS / 32) {
    const T* r = red + k * PLAIN_TILE_THREADS + lane;
    const T lo = op(k, op(k, r[0], r[128]), op(k, r[64], r[192]));
    const T hi = op(k, op(k, r[32], r[160]), op(k, r[96], r[224]));
    T x = op(k, lo, hi);
#pragma unroll
    for (int s = 16; s >= 1; s >>= 1) {
      x = op(k, x, __shfl_down_sync(0xffffffffu, x, s));
    }
    if (lane == 0) res[k] = x;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = res[k];
}

// op(k, a, b) forms of the tree's operations (plain_tile_reduce_n)
struct PlainAddFK {
  __device__ float operator()(int, float a, float b) const {
    return __fadd_rn(a, b);
  }
};
struct PlainMinFK {
  __device__ float operator()(int, float a, float b) const {
    return fminf(a, b);
  }
};
struct PlainAddIK {
  __device__ int operator()(int, int a, int b) const { return a + b; }
};

// (int)rintf(x), round half to even, without the conversion unit for
// |x| < 2^22: x + 1.5 * 2^23 rounds x to an integer in the low mantissa
// bits. Larger or non-finite x take rintf.
__device__ __forceinline__ int plain_rint_small(float x) {  // |x| < 2^22
  return __float_as_int(__fadd_rn(x, 12582912.0f)) - 0x4B400000;
}
__device__ __forceinline__ int plain_rint_int(float x) {
  return fabsf(x) < 4194304.0f ? plain_rint_small(x) : (int)rintf(x);
}

// floor(x) as an int and as a float (exact), without the conversion unit
// for |x| < 2^22: rint(x) as above, minus 1 where it rounded up.
// Larger or non-finite x take floorf, as (int)floorf(x) and
// (float)(int)floorf(x).
__device__ __forceinline__ int plain_floor_int(float x, float* xf) {
  if (fabsf(x) < 4194304.0f) {
    const float r = __fadd_rn(x, 12582912.0f);
    const float rf = __fsub_rn(r, 12582912.0f);
    const int up = rf > x ? 1 : 0;
    *xf = __fsub_rn(rf, (float)up);
    return __float_as_int(r) - 0x4B400000 - up;
  }
  const int i = (int)floorf(x);
  *xf = (float)i;
  return i;
}

#define PLAIN_FULL_MASK 0xffffffffu

// The strip kernels' work items (E, B, J, K): a slice is a chunk-pair
// piece of one bin's segment (an empty bin has one empty slice, so every
// strip is written, unless SKIP_EMPTY: kernel J merges into its atlas and
// has nothing to write there), and item i is part i % parts of slice i /
// parts (kernel B: parts = sub 16-row strips; E: 2 * sub half strips; J
// and K: 8 * sub 16 x 16 blocks). The bins go heaviest first, so the
// heavy bins' many items are handed out before the light bins' short
// ones, which fill the end: bucket k holds the bins of 2^(7-k-1) < slices
// <= 2^(7-k) (bucket 0: more than 64, bucket 7: one), each bucket in bin
// order; BY_PAIRS (J and K, whose bins are mostly one slice) buckets by
// pairs instead of slices. Every block computes the same order, by block
// scans (a full sort of the bins cost more than it saved). Every thread
// of the block calls plain_slice_prefix once: s_key[j] = (count << 13) |
// bin of the j-th bin in that order, s_end[j] the inclusive prefix of the
// slice counts up to it; s_wsum holds one int per warp. Where the bins
// do not fit that key or the block's shared memory (plain_strip_launch),
// the order goes to a global scratch instead, computed once by
// plain_order_kernel with WIDE keys (the bin alone; its count is read
// from tile_count) and read through __ldg by the kernel's GLOBAL
// instance (plain_order_bin, plain_order_end, plain_strip_item).
#define PLAIN_BIN_BITS 13  // bins < 2^13 and pairs per bin < 2^18
#define PLAIN_BUCKETS 8

// exclusive block-wide prefix of v (every thread calls it); the total in
// *total
__device__ __forceinline__ int plain_block_scan(int v, int* s_wsum,
                                                int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(PLAIN_FULL_MASK, incl, o);
    if (lane >= o) incl += u;
  }
  if (lane == 31) s_wsum[warp] = incl;
  __syncthreads();
  int before = incl - v, all = 0;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
    if (w < warp) before += s_wsum[w];
    all += s_wsum[w];
  }
  __syncthreads();  // s_wsum is read before the next scan writes it
  *total = all;
  return before;
}

__device__ __forceinline__ int plain_slices(int count, int chunk) {
  return max(1, (count + chunk - 1) / chunk);
}

__device__ __forceinline__ int plain_bucket(int slices) {
  return PLAIN_BUCKETS - 1 - min(32 - __clz(slices - 1), PLAIN_BUCKETS - 1);
}

template <bool SKIP_EMPTY = false, bool BY_PAIRS = false, bool WIDE = false>
__device__ __forceinline__ void plain_slice_prefix(
    const int* __restrict__ tile_count, int n_bins, int chunk, int* s_key,
    int* s_end, int* s_wsum) {
  const int per = (n_bins + blockDim.x - 1) / blockDim.x;
  const int b0 = min((int)threadIdx.x * per, n_bins);
  const int b1 = min(b0 + per, n_bins);
  // this thread's bins per bucket, two buckets per int (counts < 2^16);
  // WIDE: one bucket per int
  constexpr int NQ = WIDE ? PLAIN_BUCKETS : PLAIN_BUCKETS / 2;
  int packed[NQ] = {};
  for (int b = b0; b < b1; ++b) {
    const int k = plain_bucket(BY_PAIRS ? max(1, tile_count[b])
                                        : plain_slices(tile_count[b], chunk));
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      if constexpr (WIDE) {
        if (k == q) ++packed[q];
      } else if (k >> 1 == q) {
        packed[q] += (k & 1) ? 1 : 1 << 16;
      }
    }
  }
  int pos[PLAIN_BUCKETS];  // where this thread's next bin of each goes
  int base = 0;
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    int total;
    const int before = plain_block_scan(packed[q], s_wsum, &total);
    if constexpr (WIDE) {
      pos[q] = base + before;
      base += total;
    } else {
      pos[2 * q] = base + (before >> 16);
      base += total >> 16;
      pos[2 * q + 1] = base + (before & 0xffff);
      base += total & 0xffff;
    }
  }
  for (int b = b0; b < b1; ++b) {
    const int c = tile_count[b];
    const int k =
        plain_bucket(BY_PAIRS ? max(1, c) : plain_slices(c, chunk));
#pragma unroll
    for (int q = 0; q < PLAIN_BUCKETS; ++q) {
      if (k == q) s_key[pos[q]++] = WIDE ? b : (c << PLAIN_BIN_BITS) | b;
    }
  }
  __syncthreads();
  int local = 0;
  for (int j = b0; j < b1; ++j) {
    const int c = WIDE ? tile_count[s_key[j]] : s_key[j] >> PLAIN_BIN_BITS;
    local += SKIP_EMPTY ? (c + chunk - 1) / chunk : plain_slices(c, chunk);
    s_end[j] = local;
  }
  int total;
  const int offset = plain_block_scan(local, s_wsum, &total);
  for (int j = b0; j < b1; ++j) s_end[j] += offset;
  __syncthreads();
}

// The bin order of plain_slice_prefix once for a whole launch, into the
// global scratch `order` (n_bins WIDE keys, then n_bins prefix ends): one
// block, enqueued before a strip kernel's GLOBAL instance, which reads it.
#define PLAIN_ORDER_THREADS 1024
template <bool SKIP_EMPTY, bool BY_PAIRS>
__global__ void __launch_bounds__(PLAIN_ORDER_THREADS)
plain_order_kernel(const int* __restrict__ tile_count, int n_bins, int chunk,
                   int* __restrict__ order) {
  __shared__ int s_wsum[PLAIN_ORDER_THREADS / 32];
  plain_slice_prefix<SKIP_EMPTY, BY_PAIRS, true>(tile_count, n_bins, chunk,
                                                  order, order + n_bins,
                                                  s_wsum);
}

// The j-th bin of the order and its prefix end: from shared memory
// (packed keys), or GLOBAL from plain_order_kernel's scratch
template <bool GLOBAL>
__device__ __forceinline__ int plain_order_bin(const int* key, int j) {
  if constexpr (GLOBAL) {
    return __ldg(key + j);
  } else {
    return key[j] & ((1 << PLAIN_BIN_BITS) - 1);
  }
}

template <bool GLOBAL>
__device__ __forceinline__ int plain_order_end(const int* end, int j) {
  if constexpr (GLOBAL) {
    return __ldg(end + j);
  } else {
    return end[j];
  }
}

// The next item of a persistent warp whose first item was its index in
// the grid (kernels J and K): the counter hands out n_warps, n_warps + 1,
// ...; when every item was some warp's first, none asks it.
__device__ __forceinline__ int plain_next_item(int* counter, int n_warps,
                                               int n_items) {
  if (n_warps >= n_items) return n_items;
  int next = 0;
  if ((threadIdx.x & 31) == 0) next = n_warps + atomicAdd(counter, 1);
  return __shfl_sync(PLAIN_FULL_MASK, next, 0);
}

struct PlainStrip {
  int bin, part, n_slices, p0, n, start;
};

// item -> its bin, part (0 .. parts - 1), the bin's slice count, the
// slice's first pair in the bin (p0), its pair count and stream offset;
// key and end: the order (plain_slice_prefix), GLOBAL as plain_order_bin
template <bool GLOBAL = false>
__device__ __forceinline__ PlainStrip plain_strip_item(
    const int* key, const int* end, const int* __restrict__ tile_start,
    const int* __restrict__ tile_count, int n_bins, int chunk, int parts,
    int item) {
  const int slice = item / parts;
  int lo = 0, hi = n_bins - 1;  // the first bin in order whose prefix exceeds
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (plain_order_end<GLOBAL>(end, mid) <= slice) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  PlainStrip it;
  it.bin = plain_order_bin<GLOBAL>(key, lo);
  it.part = item - slice * parts;
  const int first = lo > 0 ? plain_order_end<GLOBAL>(end, lo - 1) : 0;
  it.n_slices = plain_order_end<GLOBAL>(end, lo) - first;
  it.p0 = (slice - first) * chunk;
  const int count = GLOBAL ? __ldg(tile_count + it.bin)
                           : key[lo] >> PLAIN_BIN_BITS;
  it.n = min(chunk, count - it.p0);
  it.start = tile_start[it.bin] + it.p0;
  return it;
}

// The pairs of one strip item, 32 at a time: lane p takes pair p of the
// slice (pairs start .. start + n - 1 of the stream), and, if its row
// extent holds the strip's fine row frow (row_skip), its ROWS table rows
// (plain_pair_row: 12 in kernels E and B, 22 in J and K); test(cf)
// returns its mask of 16 x 16 blocks the pair may cover (plus any flag
// bits), and a pair with a nonzero mask goes to the warp's stash (32 x
// (ROWS + 1) floats: the odd stride keeps the lanes' stores off each
// other's banks). Then the warp visits each such pair in lane order:
// visit(c, mask, p), c its first 12 rows; all ROWS stay at stash + (p %
// 32) * (ROWS + 1) during the visit.
template <int ROWS = 12, typename Test, typename Visit>
__device__ __forceinline__ void plain_strip_pairs(
    const float* __restrict__ edges, int n_pairs, int start, int n,
    int row_skip, float frow, float* stash, Test test, Visit visit) {
  const int lane = threadIdx.x & 31;
  for (int g = 0; g < n; g += 32) {
    const int p = g + lane;
    unsigned mask = 0;
    if (p < n) {
      const size_t col = (size_t)start + p;
      if (!row_skip || (edges[3 * (size_t)n_pairs + col] <= frow &&
                        frow <= edges[7 * (size_t)n_pairs + col])) {
        float cf[ROWS];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          cf[r] = edges[(size_t)plain_pair_row<ROWS>(r) * n_pairs + col];
        }
        mask = test(cf);
        if (mask) {
#pragma unroll
          for (int r = 0; r < ROWS; ++r) stash[lane * (ROWS + 1) + r] = cf[r];
        }
      }
    }
    __syncwarp();
    unsigned live = __ballot_sync(PLAIN_FULL_MASK, mask != 0);
    while (live) {
      const int src = __ffs(live) - 1;
      live &= live - 1;
      const unsigned m = __shfl_sync(PLAIN_FULL_MASK, mask, src);
      float c[12];
#pragma unroll
      for (int r = 0; r < 12; ++r) c[r] = stash[src * (ROWS + 1) + r];
      visit(c, m, g + src);
    }
    __syncwarp();  // the stash is read before the next 32 pairs land
  }
}

// The launch of a persistent strip kernel (E, B, J and K) at n_bins.
// Its order of the bins (2 ints per bin) goes to dynamic shared memory
// beside the kernel's static shared memory while both fit the device's
// cudaDevAttrMaxSharedMemoryPerBlockOptin and every bin fits the packed
// key's PLAIN_BIN_BITS; above the default 48 KB per block the launch opts
// in with cudaFuncSetAttribute. Otherwise (global) the GLOBAL instance
// runs with no dynamic shared memory, after plain_order_kernel has
// written the order into the wrapper's scratch. The grid is the SMs times
// the blocks of `threads` threads that fit on one. The lookups take
// microseconds, so each launcher keeps the last answer per device in
// `cache` and asks again only when n_bins changes.
#define PLAIN_MAX_DEVICES 16
#define PLAIN_DEFAULT_SMEM 49152
struct PlainStripLaunch {
  int grid;
  size_t smem;
  bool global;
};
struct PlainGridCache {  // zero-initialised as a static
  int n_bins[PLAIN_MAX_DEVICES];
  PlainStripLaunch launch[PLAIN_MAX_DEVICES];
};

template <typename Shared, typename Global>
inline PlainStripLaunch plain_strip_launch(PlainGridCache& cache,
                                           Shared shared, Global global,
                                           int threads, int n_bins) {
  int dev = 0;
  cudaGetDevice(&dev);
  const bool kept = dev >= 0 && dev < PLAIN_MAX_DEVICES;
  if (kept && cache.launch[dev].grid != 0 && cache.n_bins[dev] == n_bins) {
    return cache.launch[dev];
  }
  cudaFuncAttributes attr;
  cudaFuncGetAttributes(&attr, shared);
  int optin = 0, sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  PlainStripLaunch l;
  l.smem = 2 * (size_t)n_bins * sizeof(int);
  l.global = n_bins > (1 << PLAIN_BIN_BITS) ||
             attr.sharedSizeBytes + l.smem > (size_t)optin;
  if (l.global) {
    l.smem = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, global, threads,
                                                  0);
  } else {
    if (attr.sharedSizeBytes + l.smem > PLAIN_DEFAULT_SMEM) {
      cudaFuncSetAttribute(shared, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)l.smem);
    }
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, shared, threads,
                                                  l.smem);
  }
  l.grid = sms * (per_sm > 1 ? per_sm : 1);
  if (kept) {
    cache.n_bins[dev] = n_bins;
    cache.launch[dev] = l;
  }
  return l;
}

// plain_strip_launch's global case: the order into `order` (2 * n_bins
// ints of the wrapper's scratch) on the stream, before the kernel
template <bool SKIP_EMPTY = false, bool BY_PAIRS = false>
inline int plain_order_launch(const void* tile_count, int n_bins, int chunk,
                              int* order, void* stream) {
  plain_order_kernel<SKIP_EMPTY, BY_PAIRS>
      <<<1, PLAIN_ORDER_THREADS, 0, (cudaStream_t)stream>>>(
          (const int*)tile_count, n_bins, chunk, order);
  return (int)cudaGetLastError();
}

// The merge of a strip's slices. plain_finish_order: 0 for the first
// slice to finish (or the only one), which stores its values and then
// plain_raise_flag; the others plain_wait_flag, then merge by atomicMax.
// The first finisher waits on nothing, so every waiter's wait ends.
__device__ __forceinline__ int plain_finish_order(int* done, int n_slices) {
  int order = 0;
  if (n_slices > 1) {
    if ((threadIdx.x & 31) == 0) order = atomicAdd(done, 1);
    order = __shfl_sync(PLAIN_FULL_MASK, order, 0);
  }
  return order;
}

__device__ __forceinline__ void plain_raise_flag(int* flag) {
  __threadfence();
  __syncwarp();
  if ((threadIdx.x & 31) == 0) atomicExch(flag, 1);
}

__device__ __forceinline__ void plain_wait_flag(int* flag) {
  if ((threadIdx.x & 31) == 0) {
    while (*(volatile int*)flag == 0) __nanosleep(64);
  }
  __syncwarp();
  __threadfence();
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
