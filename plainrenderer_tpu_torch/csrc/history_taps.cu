// Kernel I: K bilinear taps of the R11G11B10-packed TAA history at
// per-pixel absolute source coords (the history fetch of the temporal
// filter; tech 4, the default, takes K = 1, tech 1 K = 16).
//
// Replaces plainrenderer_tpu/ops/taa.py:_history_tap_kernel (:134).
// One block of 256 threads per 16x128 tile of the (halo-extended) plane
// (thread t: column t % 128, rows (t / 128) * 8 .. + 8). Per tile:
//   1. the mean of tap 0's x over all 2048 pixels, summed in
//      plain_tile_reduce's fixed order and scaled by 1/2048, places a
//      win_h x win_w window (32 x 256, clipped to the plane): bx =
//      ((int)mean_x - win_w / 2) floor-divided by 128, times 128, clamped;
//      by tile-anchored, clip(ty * 16 - (win_h - 16) / 2, 0, h - win_h)
//      (taa.py:143-153);
//   2. the window's packed words are staged in shared memory (32 KB),
//      loaded by the whole block along rows (coalesced);
//   3. per pixel, the in-window flag from tap 0 with a 2.5-texel margin,
//      then per tap the clamped 2x2 footprint at floor(s - 0.5), its four
//      words decoded by integer math (color_packing._from_unsigned_float)
//      and blended c00 (1-fx)(1-fy) + c01 fx (1-fy) + c10 (1-fx) fy +
//      c11 fx fy in the reference's order, every product and sum rounded
//      (__fmul_rn, __fadd_rn) as the plain version's PyTorch ops are.
// Output (3K + 1, H, W) f32: rgb per tap, then ok (1 / 0).
//
// Bound on the H100: per pixel it reads 8K bytes of coords and writes
// 12K + 4 bytes, plus 4 bytes of history (each word once): at 1080p with
// the 16-row halos (1120 x 1920 = 2,150,400 pixels) and K = 1, 60 MB,
// ~0.018 ms at 3.35 TB/s. Design: one coalesced window load per tile
// replaces the four scattered device-memory taps per pixel and tap; the
// window is re-read by neighbouring tiles from L2.
#include "common.cuh"

#define HT_WIN_H 32
#define HT_WIN_W 256
#define HT_MAX_TAPS 16

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

__global__ void __launch_bounds__(PLAIN_TILE_THREADS)
history_taps_kernel(const int* __restrict__ history,
                    const float* __restrict__ coords,
                    float* __restrict__ out, int n_taps, int h, int w) {
  __shared__ float red[PLAIN_TILE_THREADS];
  __shared__ int window[HT_WIN_H * HT_WIN_W];
  const int ntx = w / PLAIN_TILE_W;
  const int ty = blockIdx.x / ntx, tx = blockIdx.x - ty * ntx;
  const int x = tx * PLAIN_TILE_W + (threadIdx.x % PLAIN_TILE_W);
  const int y0 = ty * PLAIN_TILE_H +
                 (threadIdx.x / PLAIN_TILE_W) * PLAIN_ROWS_PER_THREAD;
  const size_t plane = (size_t)h * w;
  const int win_h = min(HT_WIN_H, h), win_w = min(HT_WIN_W, w);

  float sum = 0.0f;
#pragma unroll
  for (int r = 0; r < PLAIN_ROWS_PER_THREAD; ++r) {
    sum = __fadd_rn(sum, coords[(size_t)(y0 + r) * w + x]);
  }
  const float mean_x = __fmul_rn(plain_tile_reduce(sum, red, PlainAddF()),
                                 1.0f / (PLAIN_TILE_H * PLAIN_TILE_W));
  const int by =
      min(max(ty * PLAIN_TILE_H - (win_h - PLAIN_TILE_H) / 2, 0), h - win_h);
  const int bx = min(
      max(plain_floordiv(__float2int_rz(mean_x) - win_w / 2, 128) * 128, 0),
      w - win_w);

  // stage the window: consecutive threads read consecutive words of a row
  for (int i = threadIdx.x; i < win_h * win_w; i += PLAIN_TILE_THREADS) {
    const int wy = i / win_w, wx = i - wy * win_w;
    window[i] = __ldg(history + (size_t)(by + wy) * w + bx + wx);
  }
  __syncthreads();

  const float bxf = (float)bx, byf = (float)by;
  const float margin = 2.5f;
#pragma unroll 1
  for (int r = 0; r < PLAIN_ROWS_PER_THREAD; ++r) {
    const size_t o = (size_t)(y0 + r) * w + x;
    const float sx0 = __fsub_rn(coords[o], bxf);
    const float sy0 = __fsub_rn(coords[plane + o], byf);
    const bool in_window = sx0 >= margin && sx0 <= win_w - margin &&
                           sy0 >= margin && sy0 <= win_h - margin;
    for (int k = 0; k < n_taps; ++k) {
      const float sx = __fsub_rn(coords[2 * k * plane + o], bxf);
      const float sy = __fsub_rn(coords[(2 * k + 1) * plane + o], byf);
      const float x0f =
          fminf(fmaxf(floorf(__fsub_rn(sx, 0.5f)), 0.0f), (float)(win_w - 2));
      const float y0f =
          fminf(fmaxf(floorf(__fsub_rn(sy, 0.5f)), 0.0f), (float)(win_h - 2));
      const float fx =
          fminf(fmaxf(__fsub_rn(__fsub_rn(sx, 0.5f), x0f), 0.0f), 1.0f);
      const float fy =
          fminf(fmaxf(__fsub_rn(__fsub_rn(sy, 0.5f), y0f), 0.0f), 1.0f);
      const float gx = __fsub_rn(1.0f, fx), gy = __fsub_rn(1.0f, fy);
      const int* tap = window + (int)y0f * win_w + (int)x0f;
      const float3 c00 = decode_r11g11b10(tap[0]);
      const float3 c01 = decode_r11g11b10(tap[1]);
      const float3 c10 = decode_r11g11b10(tap[win_w]);
      const float3 c11 = decode_r11g11b10(tap[win_w + 1]);
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
      for (int c = 0; c < 3; ++c) out[(3 * k + c) * plane + o] = v[c];
    }
    out[3 * n_taps * plane + o] = in_window ? 1.0f : 0.0f;
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
