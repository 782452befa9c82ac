// Kernel F: sun-shadow PCF resolve against the cascade atlas.
//
// Replaces plainrenderer_tpu/ops/shadow.py:_shadow_resolve_kernel (:167).
// One block of 256 threads per 16x128 screen tile (thread t: column
// t % 128, rows (t / 128) * 8 .. + 8). Per tile:
//   1. each valid pixel (linear depth > 0) picks its cascade by the splits
//      (shadow.py:183-186);
//   2. for each cascade in use, the pixels' light-space texel coords and
//      a 32x256 window origin from their masked mean, snapped to (16, 128)
//      and clamped to the map (shadow.py:199-229);
//   3. 12 spiral taps per pixel rotated by the blue noise with the
//      angle-addition split (cos/sin once per pixel, shadow.py:268-291),
//      each rounded half-to-even (rintf, as jnp.round / torch.round),
//      clamped into the window, read as a u16 half of the packed word and
//      compared with the receiver (reverse-Z GreaterEqual); taps outside
//      the map count as lit (black border).
// The result is the lit fraction; invalid pixels get 1.
//
// The TPU kernel DMAs the window into VMEM; here the taps read the packed
// map (MAX_CASCADES, S / 2, S) int32 straight from device memory, but keep
// the window clamp, which decides what a tap outside the window reads.
// Tile means use plain_tile_reduce's fixed order and every product and sum
// is separately rounded, so the window origins equal
// ops/shadow.py:shadow_resolve_plain's; cosf / sinf / sqrtf are the
// accurate CUDA functions (no fast math), torch's on the card.
//
// Bound on the H100: per pixel it reads world position, linear depth and
// noise (20 B) and writes 4 B, 50 MB at 1080p, plus the packed maps once
// (25 MB for 3 x 2048^2): ~0.022 ms at 3.35 TB/s. Taps hit neighbouring
// words, so most come from L1/L2. Design: per-tile reductions in shared
// memory, gather taps from global memory; no tensor cores.
#include "common.cuh"

__global__ void __launch_bounds__(PLAIN_TILE_THREADS)
shadow_kernel(const float* __restrict__ world_pos,
              const float* __restrict__ lin_depth,
              const float* __restrict__ noise, const int* __restrict__ maps,
              const float* __restrict__ rows, const float* __restrict__ spiral,
              float* __restrict__ out, int h, int w, int map_size,
              int cascade_count, int taps, float sample_radius,
              float inv_taps) {
  __shared__ float red_f[PLAIN_TILE_THREADS];
  __shared__ int red_i[PLAIN_TILE_THREADS];
  const int ntx = w / PLAIN_TILE_W;
  const int ty = blockIdx.x / ntx, tx = blockIdx.x - ty * ntx;
  const int x = tx * PLAIN_TILE_W + (threadIdx.x % PLAIN_TILE_W);
  const int y0 = ty * PLAIN_TILE_H +
                 (threadIdx.x / PLAIN_TILE_W) * PLAIN_ROWS_PER_THREAD;
  const size_t plane = (size_t)h * w;
  const int win_h = min(32, map_size), win_w = min(256, map_size);
  const float two_pi = 6.28318530717958647692f;  // f32(2 pi)
  const float inv_65535 = (float)(1.0 / 65535.0);

  float wx[PLAIN_ROWS_PER_THREAD], wy[PLAIN_ROWS_PER_THREAD];
  float wz[PLAIN_ROWS_PER_THREAD], nz[PLAIN_ROWS_PER_THREAD];
  float res[PLAIN_ROWS_PER_THREAD];
  int cas[PLAIN_ROWS_PER_THREAD];
#pragma unroll
  for (int r = 0; r < PLAIN_ROWS_PER_THREAD; ++r) {
    const size_t o = (size_t)(y0 + r) * w + x;
    wx[r] = world_pos[o];
    wy[r] = world_pos[plane + o];
    wz[r] = world_pos[2 * plane + o];
    nz[r] = noise[o];
    const float lin = lin_depth[o];
    int c = -1;  // invalid (sky): no cascade
    if (lin > 0.0f) {
      c = 0;
      for (int k = 0; k < cascade_count - 1; ++k) {
        c += lin >= rows[k * 32 + 18] ? 1 : 0;
      }
    }
    cas[r] = c;
    res[r] = 1.0f;
  }

  for (int c = 0; c < cascade_count; ++c) {
    const float* m = rows + c * 32;
    float u[PLAIN_ROWS_PER_THREAD], v[PLAIN_ROWS_PER_THREAD];
    float lz[PLAIN_ROWS_PER_THREAD];
    float su = 0.0f, sv = 0.0f;
    int cnt = 0;
#pragma unroll
    for (int r = 0; r < PLAIN_ROWS_PER_THREAD; ++r) {
      const float lx = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(m[0], wx[r]),
                                                     __fmul_rn(m[1], wy[r])),
                                           __fmul_rn(m[2], wz[r])),
                                 m[3]);
      const float ly = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(m[4], wx[r]),
                                                     __fmul_rn(m[5], wy[r])),
                                           __fmul_rn(m[6], wz[r])),
                                 m[7]);
      lz[r] = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(m[8], wx[r]),
                                            __fmul_rn(m[9], wy[r])),
                                  __fmul_rn(m[10], wz[r])),
                        m[11]);
      u[r] = __fmul_rn(__fadd_rn(__fmul_rn(lx, 0.5f), 0.5f), (float)map_size);
      v[r] = __fmul_rn(__fadd_rn(__fmul_rn(ly, 0.5f), 0.5f), (float)map_size);
      const bool in = cas[r] == c;
      cnt += in ? 1 : 0;
      su = __fadd_rn(su, in ? u[r] : 0.0f);
      sv = __fadd_rn(sv, in ? v[r] : 0.0f);
    }
    const int n_in = plain_tile_reduce(cnt, red_i, PlainAddI());
    const float count = fmaxf((float)n_in, 1.0f);
    const float mean_u =
        __fdiv_rn(plain_tile_reduce(su, red_f, PlainAddF()), count);
    const float mean_v =
        __fdiv_rn(plain_tile_reduce(sv, red_f, PlainAddF()), count);
    if (n_in == 0) continue;  // tile-uniform
    const int bx =
        min(max(plain_floordiv(__float2int_rz(mean_u) - win_w / 4, 128) * 128,
                0),
            map_size - win_w);
    const int byw =
        min(max(plain_floordiv(__float2int_rz(mean_v) - win_h / 2, 16) * 8,
                0),
            (map_size - win_h) / 2);
    const int by = byw * 2;
    const float off_u = __fmul_rn(
        __fmul_rn(__fmul_rn(sample_radius, m[16]), 0.5f), (float)map_size);
    const float off_v = __fmul_rn(
        __fmul_rn(__fmul_rn(sample_radius, m[17]), 0.5f), (float)map_size);
    const int* map_c = maps + (size_t)c * (map_size / 2) * map_size;
#pragma unroll
    for (int r = 0; r < PLAIN_ROWS_PER_THREAD; ++r) {
      if (cas[r] != c) continue;
      const float receiver = fminf(fmaxf(lz[r], 0.0f), 1.0f);
      const float lu = __fsub_rn(u[r], (float)bx);
      const float lv = __fsub_rn(v[r], (float)by);
      const float ang = __fmul_rn(nz[r], two_pi);
      const float cn = cosf(ang), sn = sinf(ang);
      const float half_noise = __fmul_rn(0.5f, nz[r]);
      float acc = 0.0f;
      for (int i = 0; i < taps; ++i) {
        const float d =
            sqrtf(__fmul_rn(__fadd_rn((float)i, half_noise), inv_taps));
        const float cb = spiral[i], sb = spiral[taps + i];
        const float du = __fmul_rn(
            __fmul_rn(__fsub_rn(__fmul_rn(cn, cb), __fmul_rn(sn, sb)), d),
            off_u);
        const float dv = __fmul_rn(
            __fmul_rn(__fadd_rn(__fmul_rn(sn, cb), __fmul_rn(cn, sb)), d),
            off_v);
        const int sx = (int)rintf(__fadd_rn(lu, du));
        const int sy = (int)rintf(__fadd_rn(lv, dv));
        const int sxc = min(max(sx, 0), win_w - 1);
        const int syc = min(max(sy, 0), win_h - 1);
        const int word =
            __ldg(map_c + (size_t)(byw + (syc >> 1)) * map_size + bx + sxc);
        const int half = (word >> ((syc & 1) * 16)) & 0xFFFF;
        const float texel = __fmul_rn((float)half, inv_65535);
        const bool inside = sx >= -bx && sy >= -by && sx < map_size - bx &&
                            sy < map_size - by;
        const float lit = receiver >= texel ? 1.0f : 0.0f;
        acc = __fadd_rn(acc, inside ? lit : 1.0f);
      }
      res[r] = __fmul_rn(acc, inv_taps);
    }
  }
#pragma unroll
  for (int r = 0; r < PLAIN_ROWS_PER_THREAD; ++r) {
    out[(size_t)(y0 + r) * w + x] = res[r];
  }
}

extern "C" int shadow_launch(const void* world_pos, const void* lin_depth,
                             const void* noise, const void* maps,
                             const void* rows, const void* spiral, void* out,
                             int h, int w, int map_size, int cascade_count,
                             int taps, float sample_radius, float inv_taps,
                             void* stream) {
  const int blocks = (h / PLAIN_TILE_H) * (w / PLAIN_TILE_W);
  shadow_kernel<<<blocks, PLAIN_TILE_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)world_pos, (const float*)lin_depth, (const float*)noise,
      (const int*)maps, (const float*)rows, (const float*)spiral, (float*)out,
      h, w, map_size, cascade_count, taps, sample_radius, inv_taps);
  PLAIN_RETURN_LAUNCH_STATUS();
}
