// Kernel I: K bilinear taps of the R11G11B10-packed TAA history at
// per-pixel absolute source coords (the history fetch of the temporal
// filter; tech 4, the default, takes K = 1, tech 1 K = 16).
//
// Replaces plainrenderer_tpu/ops/taa.py:_history_tap_kernel (:134).
// One block of 256 threads per 16x128 tile of the (halo-extended) plane
// (thread t: column t % 128, rows (t / 128) * 8 .. + 8). Per tile:
//   1. the mean of tap 0's x over all 2048 pixels, summed in
//      plain_tile_reduce's fixed order (plain_tile_reduce_n, the same
//      tree in two barriers) and scaled by 1/2048, places a win_h x win_w
//      window (32 x 256, clipped to the plane): bx = ((int)mean_x -
//      win_w / 2) floor-divided by 128, times 128, clamped; by
//      tile-anchored, clip(ty * 16 - (win_h - 16) / 2, 0, h - win_h)
//      (taa.py:143-153);
//   2. per pixel, the in-window flag from tap 0 with a 2.5-texel margin,
//      then per tap the 2x2 footprint at floor(s - 0.5) clamped into the
//      window, its four words decoded by integer math
//      (color_packing._from_unsigned_float) and blended c00 (1-fx)(1-fy)
//      + c01 fx (1-fy) + c10 (1-fx) fy + c11 fx fy in the reference's
//      order, every product and sum rounded (__fmul_rn, __fadd_rn) as the
//      plain version's PyTorch ops are.
// Output (3K + 1, H, W) f32: rgb per tap, then ok (1 / 0).
//
// Bound on the H100: per pixel it reads 8K bytes of coords and writes
// 12K + 4 bytes, plus 4 bytes of history (each word once): at 1080p with
// the 16-row halos (1120 x 1920 = 2,150,400 pixels) and K = 1, 60 MB,
// ~0.018 ms at 3.35 TB/s.
//
// Design (since PR 11). The window is only a clamp rule on the footprint
// relative to (bx, by), so the taps read the history plane itself through
// the read-only path (__ldg): neighbouring pixels' footprints overlap and
// hit L1. PR 4's design staged the whole 32 KB window in shared memory
// first, 34 MB of L2 reads per frame for an 8.6 MB plane, behind a
// barrier, with 33 KB of shared memory per block (6 blocks per SM, so
// 1,050 tiles took 1.3 waves of 792 blocks). Now a block holds 1 KB of
// shared memory and passes two barriers; tap 0's coords are loaded once,
// summed and kept in registers for the taps; the 3K + 1 output planes are
// streaming stores (__stcs), written once and read by the next pass.
#include "common.cuh"

#define HT_WIN_H 32
#define HT_WIN_W 256
#define HT_MAX_TAPS 16
#define HT_MIN_BLOCKS 4  // blocks of 256 threads per SM

__device__ __forceinline__ float decode_ufloat(int u, int mantissa_bits) {
  u &= (1 << (5 + mantissa_bits)) - 1;
  const float v = __int_as_float((u << (23 - mantissa_bits)) + ((127 - 15) << 23));
  return u == 0 ? 0.0f : v;
}

__device__ __forceinline__ float3 decode_r11g11b10(int p) {
  return make_float3(decode_ufloat(p & 0x7FF, 6),
                     decode_ufloat((p >> 11) & 0x7FF, 6),
                     decode_ufloat((p >> 22) & 0x3FF, 5));
}

// ((a * b) * c): the reference's left-to-right product of a tap's value
// and its two weights
__device__ __forceinline__ float mul3(float a, float b, float c) {
  return __fmul_rn(__fmul_rn(a, b), c);
}

__global__ void __launch_bounds__(PLAIN_TILE_THREADS, HT_MIN_BLOCKS)
history_taps_kernel(const int* __restrict__ history,
                    const float* __restrict__ coords,
                    float* __restrict__ out, int n_taps, int h, int w) {
  __shared__ float red[PLAIN_TILE_THREADS];
  __shared__ float res[1];
  const int ntx = w / PLAIN_TILE_W;
  const int ty = blockIdx.x / ntx, tx = blockIdx.x - ty * ntx;
  const int x = tx * PLAIN_TILE_W + (threadIdx.x % PLAIN_TILE_W);
  const int y0 = ty * PLAIN_TILE_H +
                 (threadIdx.x / PLAIN_TILE_W) * PLAIN_ROWS_PER_THREAD;
  const size_t plane = (size_t)h * w;
  const size_t o0 = (size_t)y0 * w + x;
  const int win_h = min(HT_WIN_H, h), win_w = min(HT_WIN_W, w);

  float cx0[PLAIN_ROWS_PER_THREAD], cy0[PLAIN_ROWS_PER_THREAD];  // tap 0
#pragma unroll
  for (int r = 0; r < PLAIN_ROWS_PER_THREAD; ++r) {
    cx0[r] = __ldg(coords + o0 + (size_t)r * w);
    cy0[r] = __ldg(coords + plane + o0 + (size_t)r * w);
  }
  float sum[1] = {0.0f};
#pragma unroll
  for (int r = 0; r < PLAIN_ROWS_PER_THREAD; ++r) {
    sum[0] = __fadd_rn(sum[0], cx0[r]);
  }
  plain_tile_reduce_n<1>(sum, red, res, PlainAddFK());
  const float mean_x = __fmul_rn(sum[0], 1.0f / (PLAIN_TILE_H * PLAIN_TILE_W));
  const int by =
      min(max(ty * PLAIN_TILE_H - (win_h - PLAIN_TILE_H) / 2, 0), h - win_h);
  const int bx = min(
      max(plain_floordiv(__float2int_rz(mean_x) - win_w / 2, 128) * 128, 0),
      w - win_w);
  const int* window = history + (size_t)by * w + bx;

  const float bxf = (float)bx, byf = (float)by;
  const float margin = 2.5f;
#pragma unroll
  for (int r = 0; r < PLAIN_ROWS_PER_THREAD; ++r) {
    const float sx0 = __fsub_rn(cx0[r], bxf);
    const float sy0 = __fsub_rn(cy0[r], byf);
    const bool in_window = sx0 >= margin && sx0 <= win_w - margin &&
                           sy0 >= margin && sy0 <= win_h - margin;
    __stcs(out + 3 * n_taps * plane + o0 + (size_t)r * w,
           in_window ? 1.0f : 0.0f);
  }
  for (int k = 0; k < n_taps; ++k) {
#pragma unroll
    for (int r = 0; r < PLAIN_ROWS_PER_THREAD; ++r) {
      const size_t o = o0 + (size_t)r * w;
      const float cx = k == 0 ? cx0[r] : __ldg(coords + 2 * k * plane + o);
      const float cy =
          k == 0 ? cy0[r] : __ldg(coords + (2 * k + 1) * plane + o);
      const float sx = __fsub_rn(cx, bxf);
      const float sy = __fsub_rn(cy, byf);
      const float x0f =
          fminf(fmaxf(floorf(__fsub_rn(sx, 0.5f)), 0.0f), (float)(win_w - 2));
      const float y0f =
          fminf(fmaxf(floorf(__fsub_rn(sy, 0.5f)), 0.0f), (float)(win_h - 2));
      const float fx =
          fminf(fmaxf(__fsub_rn(__fsub_rn(sx, 0.5f), x0f), 0.0f), 1.0f);
      const float fy =
          fminf(fmaxf(__fsub_rn(__fsub_rn(sy, 0.5f), y0f), 0.0f), 1.0f);
      const float gx = __fsub_rn(1.0f, fx), gy = __fsub_rn(1.0f, fy);
      const int* tap = window + (size_t)(int)y0f * w + (int)x0f;
      const float3 c00 = decode_r11g11b10(__ldg(tap));
      const float3 c01 = decode_r11g11b10(__ldg(tap + 1));
      const float3 c10 = decode_r11g11b10(__ldg(tap + w));
      const float3 c11 = decode_r11g11b10(__ldg(tap + w + 1));
      const float v[3] = {
          __fadd_rn(__fadd_rn(__fadd_rn(mul3(c00.x, gx, gy), mul3(c01.x, fx, gy)),
                              mul3(c10.x, gx, fy)),
                    mul3(c11.x, fx, fy)),
          __fadd_rn(__fadd_rn(__fadd_rn(mul3(c00.y, gx, gy), mul3(c01.y, fx, gy)),
                              mul3(c10.y, gx, fy)),
                    mul3(c11.y, fx, fy)),
          __fadd_rn(__fadd_rn(__fadd_rn(mul3(c00.z, gx, gy), mul3(c01.z, fx, gy)),
                              mul3(c10.z, gx, fy)),
                    mul3(c11.z, fx, fy))};
#pragma unroll
      for (int c = 0; c < 3; ++c) __stcs(out + (3 * k + c) * plane + o, v[c]);
    }
  }
}

extern "C" int history_taps_launch(const void* history, const void* coords,
                                   void* out, int n_taps, int h, int w,
                                   void* stream) {
  if (n_taps < 1 || n_taps > HT_MAX_TAPS) return (int)cudaErrorInvalidValue;
  const int blocks = (h / PLAIN_TILE_H) * (w / PLAIN_TILE_W);
  history_taps_kernel<<<blocks, PLAIN_TILE_THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)history, (const float*)coords, (float*)out, n_taps, h, w);
  PLAIN_RETURN_LAUNCH_STATUS();
}
