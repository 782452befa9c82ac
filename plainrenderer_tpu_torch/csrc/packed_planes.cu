// Kernel H: motion-offset bilinear resample of f16-pair-packed planes (the
// GI history of the temporal filter).
//
// Replaces plainrenderer_tpu/ops/taa.py:_packed_planes_tap_kernel (:277).
// One block of 256 threads per 16x128 tile of the (halo-extended) planes
// (thread t: column t % 128, rows (t / 128) * 8 .. + 8). Per tile:
//   1. the mean reprojected x over all 2048 pixels (unmasked), summed in
//      plain_tile_reduce's fixed order (each thread its 8 rows in order,
//      then the halving tree of plain_tile_reduce_n) and scaled by 1/2048,
//      places a win_h x win_w window: bx = ((int)mean_x - win_w / 2)
//      floor-divided by 128, times 128, clamped; by is tile-anchored,
//      clip(ty * 16 - (win_h - 16) / 2, 0, h - win_h) (taa.py:287-293);
//   2. per pixel, the window-local coords, the in-window flag and the
//      clamped 2x2 footprint with weights w00, w01, w10, w11 in the
//      reference's order (taa.py:297-322); each tap word decodes both
//      halves with the reference's in-kernel rule (exponent rebias by
//      integer math, f16 subnormals flushed to zero, taa.py:262-274).
// The TPU kernel DMAs the window into VMEM; here the taps read the planes
// from device memory through the read-only path (__ldg), and the window
// clamp decides what an edge tap reads. Every product and sum is
// separately rounded (__fmul_rn, __fadd_rn), as the plain version's
// PyTorch ops are, so the output equals packed_planes_plain bit for bit.
//
// Bound on the H100: per pixel it reads P i32 planes and 2 f32 coords and
// writes 2P + 1 f32; at the GI history's 640x1024 (half-res 1080p with
// its 48-row halos) and P = 3, 48 B a pixel, 31.5 MB: ~0.0094 ms at 3.35
// TB/s. Taps hit neighbouring words, mostly from L1/L2.
//
// Design. The earlier design also read the planes through __ldg (it never
// staged the window), but loaded each pixel's coords twice, summed the
// tile in plain_tile_reduce's ten barriers, and walked the planes in a
// run-time loop, so a pixel's 4 loads a plane issued plane by plane. Now
// the plane count is a template parameter (1-3): a row's 4P tap loads
// issue together; the 8 pixels' coords are loaded once, summed and kept
// in registers for the taps; the tree takes two barriers
// (plain_tile_reduce_n<1>); the 2P + 1 output planes are streaming stores
// (__stcs), written once and read by the next pass. ptxas: 80 registers,
// no spill, 3 blocks of 256 threads per SM (__launch_bounds__), so the
// frame's 320 tiles run in one wave. Forks timed with compare_trees.py on
// frame 1's GI history of bench.py's scene (3 x 640 x 1024; H100 80GB
// HBM3, 700 W; alternated, medians; every fork bit-equal): the earlier
// design 0.0187 ms; one block per (tile, plane), 960 blocks of 56
// registers, each forming the tile's mean itself from the coords, 0.0167
// ms (capped at 40 registers, 6 blocks per SM: 0.0166); this design
// 0.0142; its rows issued in two chunks of 4 (48 tap loads before any
// use; a 32 B spill at P = 3) 0.0146, and at 2 blocks per SM (109-128
// registers) 0.0149.
#include "common.cuh"

#define PP_MIN_BLOCKS 3  // blocks of 256 threads per SM

__device__ __forceinline__ float decode_f16_flush(int bits16) {
  const int em = bits16 & 0x7FFF;
  const float mag = __int_as_float((em << 13) + ((127 - 15) << 23));
  const float val = em >= 0x0400 ? mag : 0.0f;
  return (bits16 & 0x8000) != 0 ? -val : val;
}

// a00 w00 + a01 w01 + a10 w10 + a11 w11 of one half of the 4 tap words,
// left to right, each step rounded
__device__ __forceinline__ float blend(const int (&t)[4], int shift,
                                       float w00, float w01, float w10,
                                       float w11) {
  return __fadd_rn(
      __fadd_rn(
          __fadd_rn(__fmul_rn(decode_f16_flush((t[0] >> shift) & 0xFFFF),
                              w00),
                    __fmul_rn(decode_f16_flush((t[1] >> shift) & 0xFFFF),
                              w01)),
          __fmul_rn(decode_f16_flush((t[2] >> shift) & 0xFFFF), w10)),
      __fmul_rn(decode_f16_flush((t[3] >> shift) & 0xFFFF), w11));
}

template <int P>
__global__ void __launch_bounds__(PLAIN_TILE_THREADS, PP_MIN_BLOCKS)
packed_planes_kernel(const int* __restrict__ planes,
                     const float* __restrict__ coords,
                     float* __restrict__ out, int h, int w) {
  __shared__ float red[PLAIN_TILE_THREADS];
  __shared__ float res[1];
  const int ntx = w / PLAIN_TILE_W;
  const int ty = blockIdx.x / ntx, tx = blockIdx.x - ty * ntx;
  const int x = tx * PLAIN_TILE_W + (threadIdx.x % PLAIN_TILE_W);
  const int y0 = ty * PLAIN_TILE_H +
                 (threadIdx.x / PLAIN_TILE_W) * PLAIN_ROWS_PER_THREAD;
  const size_t plane = (size_t)h * w;
  const size_t o0 = (size_t)y0 * w + x;
  const int win_h = min(32, h), win_w = min(256, w);

  float cx[PLAIN_ROWS_PER_THREAD], cy[PLAIN_ROWS_PER_THREAD];
#pragma unroll
  for (int r = 0; r < PLAIN_ROWS_PER_THREAD; ++r) {
    cx[r] = __ldg(coords + o0 + (size_t)r * w);
    cy[r] = __ldg(coords + plane + o0 + (size_t)r * w);
  }
  float sum[1] = {0.0f};
#pragma unroll
  for (int r = 0; r < PLAIN_ROWS_PER_THREAD; ++r) {
    sum[0] = __fadd_rn(sum[0], cx[r]);
  }
  plain_tile_reduce_n<1>(sum, red, res, PlainAddFK());
  const float mean_x = __fmul_rn(sum[0], 1.0f / (PLAIN_TILE_H * PLAIN_TILE_W));
  const int by =
      min(max(ty * PLAIN_TILE_H - (win_h - PLAIN_TILE_H) / 2, 0), h - win_h);
  const int bx = min(
      max(plain_floordiv(__float2int_rz(mean_x) - win_w / 2, 128) * 128, 0),
      w - win_w);
  const int* window = planes + (size_t)by * w + bx;
  const float bxf = (float)bx, byf = (float)by;

#pragma unroll
  for (int r = 0; r < PLAIN_ROWS_PER_THREAD; ++r) {
    const float sx = __fsub_rn(cx[r], bxf);
    const float sy = __fsub_rn(cy[r], byf);
    const float x0f =
        fminf(fmaxf(floorf(__fsub_rn(sx, 0.5f)), 0.0f), (float)(win_w - 2));
    const float y0f =
        fminf(fmaxf(floorf(__fsub_rn(sy, 0.5f)), 0.0f), (float)(win_h - 2));
    const float fx =
        fminf(fmaxf(__fsub_rn(__fsub_rn(sx, 0.5f), x0f), 0.0f), 1.0f);
    const float fy =
        fminf(fmaxf(__fsub_rn(__fsub_rn(sy, 0.5f), y0f), 0.0f), 1.0f);
    const float gx = __fsub_rn(1.0f, fx), gy = __fsub_rn(1.0f, fy);
    const float w00 = __fmul_rn(gx, gy);
    const float w01 = __fmul_rn(fx, gy);
    const float w10 = __fmul_rn(gx, fy);
    const float w11 = __fmul_rn(fx, fy);
    const int* tap = window + (size_t)(int)y0f * w + (int)x0f;
    int t[P][4];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      t[p][0] = __ldg(tap + p * plane);
      t[p][1] = __ldg(tap + p * plane + 1);
      t[p][2] = __ldg(tap + p * plane + w);
      t[p][3] = __ldg(tap + p * plane + w + 1);
    }
    const size_t o = o0 + (size_t)r * w;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      __stcs(out + 2 * p * plane + o, blend(t[p], 0, w00, w01, w10, w11));
      __stcs(out + (2 * p + 1) * plane + o,
             blend(t[p], 16, w00, w01, w10, w11));
    }
    const bool in_window = sx >= 0.5f && sx <= win_w - 1.5f &&
                           sy >= 0.5f && sy <= win_h - 1.5f;
    __stcs(out + 2 * P * plane + o, in_window ? 1.0f : 0.0f);
  }
}

extern "C" int packed_planes_launch(const void* planes, const void* coords,
                                    void* out, int n_planes, int h, int w,
                                    void* stream) {
  const int tiles = (h / PLAIN_TILE_H) * (w / PLAIN_TILE_W);
  const int* pl = (const int*)planes;
  const float* co = (const float*)coords;
  float* o = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (n_planes) {
    case 1:
      packed_planes_kernel<1><<<tiles, PLAIN_TILE_THREADS, 0, st>>>(pl, co, o,
                                                                    h, w);
      break;
    case 2:
      packed_planes_kernel<2><<<tiles, PLAIN_TILE_THREADS, 0, st>>>(pl, co, o,
                                                                    h, w);
      break;
    case 3:
      packed_planes_kernel<3><<<tiles, PLAIN_TILE_THREADS, 0, st>>>(pl, co, o,
                                                                    h, w);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  PLAIN_RETURN_LAUNCH_STATUS();
}
