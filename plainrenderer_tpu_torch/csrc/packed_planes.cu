// Kernel H: motion-offset bilinear resample of f16-pair-packed planes (the
// GI history of the temporal filter).
//
// Replaces plainrenderer_tpu/ops/taa.py:_packed_planes_tap_kernel (:277).
// One block of 256 threads per 16x128 tile of the (halo-extended) planes
// (thread t: column t % 128, rows (t / 128) * 8 .. + 8). Per tile:
//   1. the mean reprojected x over all 2048 pixels (unmasked), summed in
//      plain_tile_reduce's fixed order and scaled by 1/2048, places a
//      win_h x win_w window: bx = ((int)mean_x - win_w / 2) floor-divided
//      by 128, times 128, clamped; by is tile-anchored,
//      clip(ty * 16 - (win_h - 16) / 2, 0, h - win_h) (taa.py:287-293);
//   2. per pixel, the window-local coords, the in-window flag and the
//      clamped 2x2 footprint with weights w00, w01, w10, w11 in the
//      reference's order (taa.py:297-322); each tap word decodes both
//      halves with the reference's in-kernel rule (exponent rebias by
//      integer math, f16 subnormals flushed to zero, taa.py:262-274).
// The TPU kernel DMAs the window into VMEM; here the taps read the planes
// from device memory, and the window clamp decides what an edge tap
// reads. Every product and sum is separately rounded (__fmul_rn,
// __fadd_rn), as the plain version's PyTorch ops are.
//
// Bound on the H100: per pixel it reads 3 i32 planes and 2 f32 coords and
// writes 7 f32 (48 B); at the GI history's 640x1024 (half-res 1080p with
// its 48-row halos), 31.5 MB: ~0.0094 ms at 3.35 TB/s. Taps hit
// neighbouring words, mostly from L1/L2. Design: one tile reduction, then
// independent per-pixel gathers; no shared staging.
#include "common.cuh"

__device__ __forceinline__ float decode_f16_flush(int bits16) {
  const int em = bits16 & 0x7FFF;
  const float mag = __int_as_float((em << 13) + ((127 - 15) << 23));
  const float val = em >= 0x0400 ? mag : 0.0f;
  return (bits16 & 0x8000) != 0 ? -val : val;
}

__global__ void __launch_bounds__(PLAIN_TILE_THREADS)
packed_planes_kernel(const int* __restrict__ planes,
                     const float* __restrict__ coords,
                     float* __restrict__ out, int n_planes, int h, int w) {
  __shared__ float red[PLAIN_TILE_THREADS];
  const int ntx = w / PLAIN_TILE_W;
  const int ty = blockIdx.x / ntx, tx = blockIdx.x - ty * ntx;
  const int x = tx * PLAIN_TILE_W + (threadIdx.x % PLAIN_TILE_W);
  const int y0 = ty * PLAIN_TILE_H +
                 (threadIdx.x / PLAIN_TILE_W) * PLAIN_ROWS_PER_THREAD;
  const size_t plane = (size_t)h * w;
  const int win_h = min(32, h), win_w = min(256, w);

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

#pragma unroll
  for (int r = 0; r < PLAIN_ROWS_PER_THREAD; ++r) {
    const size_t o = (size_t)(y0 + r) * w + x;
    const float sx = __fsub_rn(coords[o], (float)bx);
    const float sy = __fsub_rn(coords[plane + o], (float)by);
    const bool in_window = sx >= 0.5f && sx <= win_w - 1.5f && sy >= 0.5f &&
                           sy <= win_h - 1.5f;
    const float x0f =
        fminf(fmaxf(floorf(__fsub_rn(sx, 0.5f)), 0.0f), (float)(win_w - 2));
    const float y0f =
        fminf(fmaxf(floorf(__fsub_rn(sy, 0.5f)), 0.0f), (float)(win_h - 2));
    const int xi = (int)x0f, yi = (int)y0f;
    const float fx =
        fminf(fmaxf(__fsub_rn(__fsub_rn(sx, 0.5f), x0f), 0.0f), 1.0f);
    const float fy =
        fminf(fmaxf(__fsub_rn(__fsub_rn(sy, 0.5f), y0f), 0.0f), 1.0f);
    const float gx = __fsub_rn(1.0f, fx), gy = __fsub_rn(1.0f, fy);
    const float w00 = __fmul_rn(gx, gy);
    const float w01 = __fmul_rn(fx, gy);
    const float w10 = __fmul_rn(gx, fy);
    const float w11 = __fmul_rn(fx, fy);
    const size_t base = (size_t)(by + yi) * w + bx + xi;
    for (int p = 0; p < n_planes; ++p) {
      const int* pl = planes + p * plane + base;
      const int t00 = __ldg(pl), t01 = __ldg(pl + 1);
      const int t10 = __ldg(pl + w), t11 = __ldg(pl + w + 1);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int s = 16 * half;
        const float a00 = decode_f16_flush((t00 >> s) & 0xFFFF);
        const float a01 = decode_f16_flush((t01 >> s) & 0xFFFF);
        const float a10 = decode_f16_flush((t10 >> s) & 0xFFFF);
        const float a11 = decode_f16_flush((t11 >> s) & 0xFFFF);
        const float v = __fadd_rn(
            __fadd_rn(__fadd_rn(__fmul_rn(a00, w00), __fmul_rn(a01, w01)),
                      __fmul_rn(a10, w10)),
            __fmul_rn(a11, w11));
        out[(2 * p + half) * plane + o] = v;
      }
    }
    out[2 * n_planes * plane + o] = in_window ? 1.0f : 0.0f;
  }
}

extern "C" int packed_planes_launch(const void* planes, const void* coords,
                                    void* out, int n_planes, int h, int w,
                                    void* stream) {
  const int blocks = (h / PLAIN_TILE_H) * (w / PLAIN_TILE_W);
  packed_planes_kernel<<<blocks, PLAIN_TILE_THREADS, 0,
                         (cudaStream_t)stream>>>(
      (const int*)planes, (const float*)coords, (float*)out, n_planes, h, w);
  PLAIN_RETURN_LAUNCH_STATUS();
}
