// Kernel F: sun-shadow PCF resolve against the cascade atlas.
//
// Replaces plainrenderer_tpu/ops/shadow.py:_shadow_resolve_kernel (:167).
// One block of 256 threads per 16x128 screen tile. Per tile:
//   1. each valid pixel (linear depth > 0) picks its cascade by the splits
//      (shadow.py:183-186);
//   2. for each cascade in use, the pixels' light-space texel coords and
//      a 32x256 window origin from their masked mean, snapped to (16, 128)
//      and clamped to the map (shadow.py:199-229);
//   3. `taps` spiral taps per pixel rotated by the blue noise with the
//      angle-addition split (cos/sin once per pixel, shadow.py:268-291),
//      each rounded half-to-even (as jnp.round / torch.round), clamped
//      into the window, read as a u16 half of the packed word and compared
//      with the receiver (reverse-Z GreaterEqual); taps outside the map
//      count as lit (black border).
// The result is the lit fraction; invalid pixels get 1.
//
// The TPU kernel DMAs the window into VMEM; here the taps read the packed
// map (MAX_CASCADES, S / 2, S) int32 straight from device memory, but keep
// the window clamp, which decides what a tap outside the window reads.
// Tile means keep the plain version's order (each thread sums its 8 rows,
// thread = (row / 8) * 128 + column, then the halving tree) and every
// product and sum is separately rounded, so the window origins equal
// ops/shadow.py:shadow_resolve_plain's; cosf / sinf / sqrtf are the
// accurate CUDA functions (no fast math), torch's on the card.
//
// Bound on the H100: per pixel it reads world position, linear depth and
// noise (20 B) and writes 4 B, 50 MB at 1080p, plus the distinct map words
// its taps read: ~0.02 ms at 3.35 TB/s. Taps hit neighbouring words, so
// most come from L1/L2.
//
// Design (the previous one, git 58c782b, ran three tile
// reductions for every cascade, used or not, transformed every pixel into
// all cascades, read the cascade rows from device memory and ran the taps,
// a runtime count, inside the loop over cascades):
//   - each pixel transforms into its own cascade only, with the rows in
//     shared memory, and the (count, sum u, sum v) of every cascade are
//     one batched reduction (plain_tile_reduce_n): a sum that skips an add
//     of +0.0 has the same bits, since it starts at +0 and never becomes
//     -0. Then a barrier for the window table and one for the staged
//     window: 5 barriers per tile;
//   - the window of the tile's most used cascade (16 word rows x 256) is
//     copied to shared memory with 16-byte loads, and its pixels' taps
//     read it there; a pixel of another cascade (a tile rarely spans two)
//     reads its words from device memory;
//   - the tap phase has no loop over cascades: a pixel reads its own
//     cascade's window from shared memory; the kernel is specialised on
//     12 taps (the default), whose 12 words are loaded before any compare
//     (other counts run the same kernel with the count at run time);
//   - the compare fl(half / 65535) <= receiver is, since the product is
//     monotone in half, half <= H with H found once per pixel, so a tap
//     converts nothing; rint uses the 1.5 * 2^23 trick (plain_rint_small)
//     with its range tested once per pixel; the lit count is an integer
//     (a sum of 0s and 1s is exact);
//   - 5 blocks per SM (48 registers): -1.2% against 4 on bench.py's scene
//     (H100 80GB HBM3 at 700 W, compare_trees.py). Staging the window as
//     packed words alone, before the u16 texels, the spiral by value and
//     the per-pixel tests, measured no gain: the kernel is bound by its
//     instruction count, not by its loads;
//   - the per-pixel fast path and the spiral by value, each taken out
//     alone (compare_trees.py on bench.py's scene, H100 80GB HBM3 at
//     700 W, two alternated runs each): as kept 0.0807 / 0.0810 ms; every
//     pixel on the general path 0.0967 / 0.0971 (+20%); the spiral read
//     through __ldg 0.0842 / 0.0841 (+4%, and 8 B of spill); both
//     0.0997 / 0.0996.
#include "common.cuh"

#define SHADOW_MAX_CASCADES 4  // = ops/shadow.py:MAX_CASCADES
#define SHADOW_ROW 32          // floats per cascade row in device memory
#define SHADOW_ROW_S 33        // in shared memory (rows on other banks)

struct ShadowWindow {
  int bx, byw, by;
  float off_u, off_v;
  float ru, rv;  // a bound on |du| and |dv|, plus a texel of margin
};

#define SHADOW_WIN_ROWS 32     // texel rows of a 32x256-texel window
#define SHADOW_STAGE_W 258     // u16 texels per staged row (odd in words,
                               // so neighbouring rows start on new banks)
#define SHADOW_PARAM_TAPS 12   // the default count: spiral in the params

struct ShadowShared {
  float rows[SHADOW_MAX_CASCADES * SHADOW_ROW_S];
  float u[PLAIN_TILE_H * PLAIN_TILE_W], v[PLAIN_TILE_H * PLAIN_TILE_W];
  int lit_max[PLAIN_TILE_H * PLAIN_TILE_W];  // lit_threshold of the pixel
  signed char cas[PLAIN_TILE_H * PLAIN_TILE_W];  // -1: invalid
  union {  // the reduction's scratch, then the staged window's u16 texels
    float red[3 * SHADOW_MAX_CASCADES * PLAIN_TILE_THREADS];
    unsigned stage[SHADOW_WIN_ROWS * SHADOW_STAGE_W / 2];
  };
  float res[3 * SHADOW_MAX_CASCADES];
  ShadowWindow win[SHADOW_MAX_CASCADES];
};

// the spiral's cos / sin of the 12-tap kernel, passed by value, so each
// tap reads them as constant operands
struct ShadowSpiral {
  float c[SHADOW_PARAM_TAPS], s[SHADOW_PARAM_TAPS];
};

// the largest h with fl(h * inv_65535) <= receiver (receiver in [0, 1]):
// the texel of a u16 half h lights the pixel iff h <= it
__device__ __forceinline__ int lit_threshold(float receiver,
                                             float inv_65535) {
  int h = min(__float2int_rz(__fmul_rn(receiver, 65535.0f)) + 2, 65535);
  while (h >= 0 && __fmul_rn((float)h, inv_65535) > receiver) --h;
  return h;
}

struct TapArgs {
  float lu, lv, cn, sn, half_noise, inv_taps, off_u, off_v;
  int bx, by, map_size, win_w, win_h, lit_max;
};

// The lit taps of one pixel at window coords (lu, lv): all TAPS (4 at a
// time when the count is a run-time value) are fetched before any
// compare; half(syc, sxc) reads the u16 texel at window row syc, column
// sxc. FAST: the pixel is far enough inside the map that every tap is
// inside it and below 2^22, so neither is tested per tap.
template <int TAPS, bool FAST, typename Half>
__device__ __forceinline__ int count_lit(const TapArgs& a,
                                         const ShadowSpiral& sp,
                                         const float* spiral, int taps_rt,
                                         Half half) {
  constexpr int B = TAPS ? TAPS : 4;
  const int taps = TAPS ? TAPS : taps_rt;
  int lit = 0;
  for (int i0 = 0; i0 < taps; i0 += B) {
    int hv[B];
    bool inside[B];
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const int i = i0 + b;
      inside[b] = false;
      hv[b] = 0;
      if (TAPS || i < taps) {
        const float d = sqrtf(
            __fmul_rn(__fadd_rn((float)i, a.half_noise), a.inv_taps));
        // TAPS: one batch, so i == b
        const float cb = TAPS ? sp.c[b] : __ldg(spiral + i);
        const float sb = TAPS ? sp.s[b] : __ldg(spiral + taps + i);
        const float du = __fmul_rn(
            __fmul_rn(__fsub_rn(__fmul_rn(a.cn, cb), __fmul_rn(a.sn, sb)), d),
            a.off_u);
        const float dv = __fmul_rn(
            __fmul_rn(__fadd_rn(__fmul_rn(a.sn, cb), __fmul_rn(a.cn, sb)), d),
            a.off_v);
        const float fx = __fadd_rn(a.lu, du), fy = __fadd_rn(a.lv, dv);
        const int sx = FAST ? plain_rint_small(fx) : plain_rint_int(fx);
        const int sy = FAST ? plain_rint_small(fy) : plain_rint_int(fy);
        // in the map: 0 <= bx + sx < S and 0 <= by + sy < S (unsigned)
        inside[b] =
            FAST || ((unsigned)sx + (unsigned)a.bx < (unsigned)a.map_size &&
                     (unsigned)sy + (unsigned)a.by < (unsigned)a.map_size);
        if (inside[b]) {
          hv[b] = half(min(max(sy, 0), a.win_h - 1),
                       min(max(sx, 0), a.win_w - 1));
        } else {
          lit += 1;  // a tap outside the map is lit
        }
      }
    }
#pragma unroll
    for (int b = 0; b < B; ++b) {
      if (inside[b]) lit += hv[b] <= a.lit_max;
    }
  }
  return lit;
}

// 5 blocks per SM: 48 registers, no spill
template <int TAPS>  // 0: the tap count at run time
__global__ void __launch_bounds__(PLAIN_TILE_THREADS, 5)
shadow_kernel(const float* __restrict__ world_pos,
              const float* __restrict__ lin_depth,
              const float* __restrict__ noise, const int* __restrict__ maps,
              const float* __restrict__ rows, const float* __restrict__ spiral,
              float* __restrict__ out, int h, int w, int map_size,
              int cascade_count, int taps_rt, float sample_radius,
              float inv_taps, ShadowSpiral sp) {
  __shared__ ShadowShared sh;
  const int t = threadIdx.x;
  const int ntx = w / PLAIN_TILE_W;
  const int ty = blockIdx.x / ntx, tx = blockIdx.x - ty * ntx;
  const size_t tile_o = (size_t)(ty * PLAIN_TILE_H) * w + tx * PLAIN_TILE_W;
  const size_t plane = (size_t)h * w;
  const int win_h = min(32, map_size), win_w = min(256, map_size);
  const float two_pi = 6.28318530717958647692f;  // f32(2 pi)
  const float inv_65535 = (float)(1.0 / 65535.0);
  const float s_f = (float)map_size;
  if (t < SHADOW_MAX_CASCADES * 19) {  // matrix 0-15, scale 16-17, split 18
    sh.rows[(t / 19) * SHADOW_ROW_S + t % 19] =
        rows[(t / 19) * SHADOW_ROW + t % 19];
  }
  __syncthreads();

  // thread t owns column t % 128, rows (t / 128) * 8 .. + 8
  const int col = t % PLAIN_TILE_W;
  const int row0 = (t / PLAIN_TILE_W) * PLAIN_ROWS_PER_THREAD;
  float acc[3 * SHADOW_MAX_CASCADES];  // count, sum u, sum v per cascade
#pragma unroll
  for (int k = 0; k < 3 * SHADOW_MAX_CASCADES; ++k) acc[k] = 0.0f;
#pragma unroll
  for (int r = 0; r < PLAIN_ROWS_PER_THREAD; ++r) {
    const int p = (row0 + r) * PLAIN_TILE_W + col;
    const size_t o = tile_o + (size_t)(row0 + r) * w + col;
    const float lin = lin_depth[o];
    int c = -1;  // invalid (sky): no cascade
    if (lin > 0.0f) {
      c = 0;
      for (int k = 0; k < cascade_count - 1; ++k) {
        c += lin >= sh.rows[k * SHADOW_ROW_S + 18] ? 1 : 0;
      }
      const float wx = world_pos[o], wy = world_pos[plane + o];
      const float wz = world_pos[2 * plane + o];
      const float* m = sh.rows + c * SHADOW_ROW_S;
      const float lx = __fadd_rn(
          __fadd_rn(__fadd_rn(__fmul_rn(m[0], wx), __fmul_rn(m[1], wy)),
                    __fmul_rn(m[2], wz)),
          m[3]);
      const float ly = __fadd_rn(
          __fadd_rn(__fadd_rn(__fmul_rn(m[4], wx), __fmul_rn(m[5], wy)),
                    __fmul_rn(m[6], wz)),
          m[7]);
      const float lz = __fadd_rn(
          __fadd_rn(__fadd_rn(__fmul_rn(m[8], wx), __fmul_rn(m[9], wy)),
                    __fmul_rn(m[10], wz)),
          m[11]);
      const float pu = __fmul_rn(__fadd_rn(__fmul_rn(lx, 0.5f), 0.5f), s_f);
      const float pv = __fmul_rn(__fadd_rn(__fmul_rn(ly, 0.5f), 0.5f), s_f);
#pragma unroll
      for (int k = 0; k < SHADOW_MAX_CASCADES; ++k) {
        if (c == k) {
          acc[k] = __fadd_rn(acc[k], 1.0f);
          acc[SHADOW_MAX_CASCADES + k] =
              __fadd_rn(acc[SHADOW_MAX_CASCADES + k], pu);
          acc[2 * SHADOW_MAX_CASCADES + k] =
              __fadd_rn(acc[2 * SHADOW_MAX_CASCADES + k], pv);
        }
      }
      sh.u[p] = pu;
      sh.v[p] = pv;
      sh.lit_max[p] = lit_threshold(fminf(fmaxf(lz, 0.0f), 1.0f), inv_65535);
    }
    sh.cas[p] = (signed char)c;
  }
  plain_tile_reduce_n<3 * SHADOW_MAX_CASCADES>(acc, sh.red, sh.res,
                                               PlainAddFK());
  if (t < cascade_count) {  // the sums from shared memory (no stack)
    const float count = fmaxf(sh.res[t], 1.0f);
    const float mean_u = __fdiv_rn(sh.res[SHADOW_MAX_CASCADES + t], count);
    const float mean_v =
        __fdiv_rn(sh.res[2 * SHADOW_MAX_CASCADES + t], count);
    const float* m = sh.rows + t * SHADOW_ROW_S;
    ShadowWindow& W = sh.win[t];
    W.bx = min(
        max(plain_floordiv(__float2int_rz(mean_u) - win_w / 4, 128) * 128, 0),
        map_size - win_w);
    W.byw = min(
        max(plain_floordiv(__float2int_rz(mean_v) - win_h / 2, 16) * 8, 0),
        (map_size - win_h) / 2);
    W.by = W.byw * 2;
    W.off_u = __fmul_rn(__fmul_rn(__fmul_rn(sample_radius, m[16]), 0.5f), s_f);
    W.off_v = __fmul_rn(__fmul_rn(__fmul_rn(sample_radius, m[17]), 0.5f), s_f);
    // |du| <= |off_u| (1 + 1e-6): |cos| and d below 1, 3 roundings; maps
    // over 2^20 texels never take the fast path
    const bool huge = map_size > (1 << 20);
    const float inf = __int_as_float(0x7f800000);
    W.ru = huge ? inf : __fadd_rn(__fmul_rn(fabsf(W.off_u), 1.001f), 1.0f);
    W.rv = huge ? inf : __fadd_rn(__fmul_rn(fabsf(W.off_v), 1.001f), 1.0f);
  }
  __syncthreads();

  // the window of the tile's most used cascade goes to shared memory (a
  // tile rarely spans two cascades; the others' taps read device memory)
  int staged = -1;
  float most = 0.0f;
  for (int c = 0; c < cascade_count; ++c) {
    if (sh.res[c] > most) {
      most = sh.res[c];
      staged = c;
    }
  }
  if (staged < 0) {  // tile-uniform: no valid pixel
    for (int p = t; p < PLAIN_TILE_H * PLAIN_TILE_W; p += PLAIN_TILE_THREADS) {
      out[tile_o + (size_t)(p / PLAIN_TILE_W) * w + p % PLAIN_TILE_W] = 1.0f;
    }
    return;
  }
  {  // texel rows 2r and 2r + 1 of window word row r, as u16
    const ShadowWindow W = sh.win[staged];
    const int* src = maps + (size_t)staged * (map_size / 2) * map_size +
                     (size_t)W.byw * map_size + W.bx;
    const int rows_w = win_h / 2, quads = win_w / 4;
    for (int q = t; q < rows_w * quads; q += PLAIN_TILE_THREADS) {
      const int r = q / quads, x4 = q - r * quads;
      const int4 wd = __ldg((const int4*)(src + (size_t)r * map_size) + x4);
      unsigned* lo = sh.stage + (2 * r * SHADOW_STAGE_W + 4 * x4) / 2;
      unsigned* hi = lo + SHADOW_STAGE_W / 2;
      lo[0] = __byte_perm(wd.x, wd.y, 0x5410);
      lo[1] = __byte_perm(wd.z, wd.w, 0x5410);
      hi[0] = __byte_perm(wd.x, wd.y, 0x7632);
      hi[1] = __byte_perm(wd.z, wd.w, 0x7632);
    }
  }
  __syncthreads();
  const unsigned short* stage = (const unsigned short*)sh.stage;

  // tap phase: pixel p = i * 256 + t, row p / 128, column p % 128
  for (int p = t; p < PLAIN_TILE_H * PLAIN_TILE_W; p += PLAIN_TILE_THREADS) {
    const size_t o = tile_o + (size_t)(p / PLAIN_TILE_W) * w + p % PLAIN_TILE_W;
    const int c = sh.cas[p];
    float result = 1.0f;
    if (c >= 0) {
      const ShadowWindow W = sh.win[c];
      const float nz = noise[o];
      const float pu = sh.u[p], pv = sh.v[p];
      const float ang = __fmul_rn(nz, two_pi);
      float sn, cn;
      sincosf(ang, &sn, &cn);
      const TapArgs a{__fsub_rn(pu, (float)W.bx), __fsub_rn(pv, (float)W.by),
                      cn, sn, __fmul_rn(0.5f, nz), inv_taps, W.off_u,
                      W.off_v, W.bx, W.by, map_size, win_w, win_h,
                      sh.lit_max[p]};
      // every tap at least a texel inside the map (and below 2^22)
      const bool fast = pu >= __fadd_rn(W.ru, 1.0f) &&
                        pu <= __fsub_rn(__fsub_rn(s_f, 1.0f), W.ru) &&
                        pv >= __fadd_rn(W.rv, 1.0f) &&
                        pv <= __fsub_rn(__fsub_rn(s_f, 1.0f), W.rv);
      int lit;
      if (c == staged) {
        const auto half = [&](int syc, int sxc) {
          return (int)stage[syc * SHADOW_STAGE_W + sxc];
        };
        lit = fast ? count_lit<TAPS, true>(a, sp, spiral, taps_rt, half)
                   : count_lit<TAPS, false>(a, sp, spiral, taps_rt, half);
      } else {
        const int* base = maps + (size_t)c * (map_size / 2) * map_size +
                          (size_t)W.byw * map_size + W.bx;
        const auto half = [&](int syc, int sxc) {
          return (int)(((unsigned)__ldg(base + (syc >> 1) * map_size + sxc) >>
                        ((syc & 1) * 16)) & 0xFFFFu);
        };
        lit = fast ? count_lit<TAPS, true>(a, sp, spiral, taps_rt, half)
                   : count_lit<TAPS, false>(a, sp, spiral, taps_rt, half);
      }
      result = __fmul_rn((float)lit, inv_taps);
    }
    out[o] = result;
  }
}

// spiral: the (2, taps) cos / sin table in device memory; spiral_host:
// the same table in host memory, read here for the 12-tap kernel's params
// (the table's bits are ops/shadow.py:_spiral's, the plain version's, so
// they are passed in rather than recomputed with another libm)
extern "C" int shadow_launch(const void* world_pos, const void* lin_depth,
                             const void* noise, const void* maps,
                             const void* rows, const void* spiral,
                             const void* spiral_host, void* out, int h, int w,
                             int map_size, int cascade_count, int taps,
                             float sample_radius, float inv_taps,
                             void* stream) {
  const int blocks = (h / PLAIN_TILE_H) * (w / PLAIN_TILE_W);
  const cudaStream_t s = (cudaStream_t)stream;
  const float* wp = (const float*)world_pos;
  const float* lin = (const float*)lin_depth;
  const float* nz = (const float*)noise;
  const int* mp = (const int*)maps;
  const float* rw = (const float*)rows;
  const float* sp = (const float*)spiral;
  float* o = (float*)out;
  ShadowSpiral params = {};
  if (taps == SHADOW_PARAM_TAPS) {  // the default, ShadowSettings.pcf_taps
    const float* host = (const float*)spiral_host;
    for (int i = 0; i < SHADOW_PARAM_TAPS; ++i) {
      params.c[i] = host[i];
      params.s[i] = host[SHADOW_PARAM_TAPS + i];
    }
    shadow_kernel<SHADOW_PARAM_TAPS><<<blocks, PLAIN_TILE_THREADS, 0, s>>>(
        wp, lin, nz, mp, rw, sp, o, h, w, map_size, cascade_count, taps,
        sample_radius, inv_taps, params);
  } else {
    shadow_kernel<0><<<blocks, PLAIN_TILE_THREADS, 0, s>>>(
        wp, lin, nz, mp, rw, sp, o, h, w, map_size, cascade_count, taps,
        sample_radius, inv_taps, params);
  }
  PLAIN_RETURN_LAUNCH_STATUS();
}
