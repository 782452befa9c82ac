// Kernel G: SDF-traced diffuse GI, one ray per (half-res) pixel.
//
// Replaces plainrenderer_tpu/ops/sdfgi.py:_trace_kernel (:112). What a ray
// sees is the TPU kernel's:
//   1. per 16x128 tile, the masked mean surface point picks the base brick
//      of a 2x2x2-brick (32^3-voxel) window (sdfgi.py:139-158);
//   2. the fine sphere trace from wpos + 0.2 n samples only that window
//      (clamped), with hits gated on `inside` and the clamp-`excess` step
//      rule (:192-291), Claybook refinement (:295-303), albedo at the hit
//      and an 8-step SDF sun-shadow march (:321-339); rays that left the
//      window continue in the coarse whole-scene volume (24 steps, its own
//      albedo and a 6-step shadow, :341-439); misses read the low-res sky
//      through the polynomial acos / atan2 (:450-467);
//   3. the result is Y * SH_L1(dir) (4), CoCg (2) and `escaped` (1).
//
// Per-ray loops. The TPU kernel runs each loop while ANY ray of its tile
// is alive; a dead ray never changes state and every live ray advances
// once per iteration, so a per-ray loop with the same bound (steps, 8, 24,
// 6) gives the same result. The fine loop carries d_prev for every ray,
// but only dprev_hit, captured at the hit, is read afterwards.
//
// Numbers. Every product, sum and quotient is separately rounded
// (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn), as the plain version's
// PyTorch ops are; 1 / voxel arrives precomputed (meta[4]); sqrtf is the
// correctly rounded one; powf and rsqrtf may differ from torch.pow /
// torch.rsqrt by an ulp. Window-local distances are s8 / 8 voxels,
// sign-extended after & 0xFF; s8 * 0.125 is that quotient exactly. Voxel
// indices of clamped, non-negative coordinates truncate by one add in
// round-toward-zero (trunc_small), the value the conversion gives.
//
// Bound on the H100: every ray reads its valid flag (1 B) and writes 7
// f32; a valid ray also reads 9 f32 (position, normal, direction), so 37 B
// in + 28 B out per valid ray and 1 B + 28 B per invalid one, plus the
// brick volume, the coarse tables and the sky; chip_smoke.py counts them
// from each run's inputs. Per ray the work is a chain of dependent
// samples (each step's position depends on the last sample), so the time
// is latency and idle lanes, not bytes or arithmetic.
//
// Design (Hopper). PR 8's kernel took 0.1075 ms on slice 5's trace
// (544 x 1024 rays, 520,355 on surfaces; H100 80GB HBM3, 700 W): one
// block of 256 threads per 16x128 tile, 8 rays per thread in turn. The
// frame's rays need 6.7 fine steps on average (29 at most) and 75% of all
// steps are shadow and coarse steps, so divergence is small (a warp of
// one ray per lane keeps 84% of its lanes busy; refilling lanes from a
// pool could save <= 15%). What cost the time was work per step and per
// ray, and each block's start. Now:
//   - GI_PARTS = 4 blocks of 256 threads per tile, 2 rays per thread
//     (rows part * 4 + t / 128 and + 2, column t % 128: a warp's 32 rays
//     are 32 neighbouring pixels of one row);
//   - every block sums the whole tile itself (thread t: column t % 128
//     over rows (t / 128) * 8 .. + 8 in order, then tile_sum's tree,
//     common.cuh plain_tile_reduce_n), so every block picks the window
//     ops/sdfgi.py:window_bricks picks, and loads the window's 8 bricks
//     (32 KB, one int4 per thread each) from L2 into shared memory as
//     a linear 32^3 byte volume (one byte load per sample, no brick
//     arithmetic);
//   - the coarse SDF table is read a byte at a time through __ldg (5.4
//     KB on slice 5, <= 11 KB for any table coarse_factor_for gives below
//     its factor cap; L1 holds it);
//   - per step no division and no conversion (s8 * 0.125, trunc_small),
//     `inside` from the clamp excess; per ray pow(b / 255, 2.2) from a
//     256-entry table (the same powf of the same byte); the shadow
//     marches stop at the first occluder (lit stays 0 from there on);
//     outputs are streaming stores.
// ptxas: 64 registers, 33.8 KB of static shared memory, no spill, no
// stack: 4 blocks of 8 warps per SM (32 resident warps; the previous
// design had ~16).
//
// Forks measured (device ms on slice 5's trace, H100 80GB HBM3, 700 W;
// compare_trees.py and variant trees timed in one call each, the output
// bit-equal in every variant):
//   - 8 blocks per tile in a cluster, one ray per thread, tile sums across
//     the cluster through DSMEM and each block's brick stored into all 8
//     windows: 0.0905; the coarse phase over a block-local queue of the
//     escaped rays instead of each thread's own: 0.0920 (dropped). The
//     window broadcast alone cost 0.031 of the 0.057 the cluster's start
//     took (8 DSMEM int4 stores per thread).
//   - each block loading its own window from L2, cluster kept for the
//     sums: 0.0692 (1 ray per thread), 0.0584 (2); no cluster, every
//     block summing the tile: 0.0615 (1), 0.0567 (2), 0.0589 (4), 0.0646
//     (8, PR 8's shape with the new steps; PR 8: 0.1075).
//   - kept design 0.0566 -> 0.0553 with streaming stores; 5 blocks per SM
//     (48 registers) 0.0567; the window bases from a launch of their own
//     0.0569 (against 0.0556); 4 rays per thread at 5 blocks per SM
//     0.0582; a thread's two rays marched together 0.0583 (64
//     registers).
//   - the coarse table staged in shared memory beside the window (a
//     second instance for tables past 16 KB): 0.0558 / 0.0558 / 0.0562
//     against 0.0552 / 0.0554 / 0.0556 for this design, alternated in one
//     call (56 registers there); dropped.
//   - where the time goes (phases removed one at a time): the block start
//     and zero stores 0.020, the fine march 0.027, the shadow marches
//     0.011, the coarse march 0.007.
#include "common.cuh"

#define GI_WINDOW 32
#define GI_BRICK 16
#define GI_BRICK_WORDS 1024  // s8 SDF words per brick (16^3 / 4)
#define GI_ALB_WORDS 4096    // rgb8 albedo words per brick
#define GI_RAYS 2  // rays per thread
#define GI_PARTS (8 / GI_RAYS)  // blocks per 16 x 128 tile
#define GI_MIN_BLOCKS 4  // blocks per SM the register budget is sized for

namespace {

constexpr float kPi = 3.14159265358979323846f;
constexpr float kHalfPi = 1.57079632679489661923f;
constexpr float kTwoPi = 6.28318530717958647692f;
constexpr float kInv2SqrtPi = 0.28209479177387814347f;
constexpr float kSqrt3 = 1.73205080756887729353f;

__device__ __forceinline__ float fmul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float fadd(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float fsub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float fdiv(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// (int)x for 0 <= x < 2^23: x + 2^23 rounded toward zero is 2^23 +
// trunc(x), so its low mantissa bits are the integer (no conversion unit)
__device__ __forceinline__ int trunc_small(float x) {
  return __float_as_int(__fadd_rz(x, 8388608.0f)) - 0x4B000000;
}

// a stored s8 distance / 8 (sdfgi.py:85-87): the product by 0.125 is the
// quotient, exactly
__device__ __forceinline__ float s8_voxels(signed char b) {
  return (float)b * 0.125f;
}

__device__ __forceinline__ float signf(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

// Abramowitz-Stegun 4.4.45 polynomial acos (sdfgi.py:90)
__device__ float acos_approx(float x) {
  const float ax = fabsf(x);
  const float poly = fadd(
      1.5707288f,
      fmul(ax, fadd(-0.2121144f,
                    fmul(ax, fsub(0.0742610f, fmul(0.0187293f, ax))))));
  const float r = fmul(sqrtf(fmaxf(fsub(1.0f, ax), 0.0f)), poly);
  return x < 0.0f ? fsub(kPi, r) : r;
}

// octant-folded A&S 4.4.49 polynomial atan2 (sdfgi.py:99)
__device__ float atan2_approx(float y, float x) {
  const float ax = fabsf(x), ay = fabsf(y);
  const float t = fdiv(fminf(ax, ay), fmaxf(fmaxf(ax, ay), 1e-20f));
  const float t2 = fmul(t, t);
  float a = fmul(
      t, fadd(0.9998660f,
              fmul(t2, fadd(-0.3302995f,
                            fmul(t2, fadd(0.1801410f,
                                          fmul(t2, fadd(-0.0851330f,
                                                        fmul(t2, 0.0208351f)))))))));
  a = ay > ax ? fsub(kHalfPi, a) : a;
  a = x < 0.0f ? fsub(kPi, a) : a;
  return y < 0.0f ? -a : a;
}

struct Scene {
  float ox, oy, oz, voxel, inv_voxel;
  float wx0, wy0, wz0;  // window origin in voxels
  int bx0, by0, bz0, nbx, nby;
};

struct Voxel {
  int ix, iy, iz;  // window voxel, 0..31 each
  float excess;    // inside (sdfgi.py:206-209) iff excess <= 0.5
};

// window_coords (sdfgi.py:192-222): clamped window voxel of a world point.
// For finite coordinates g in window voxels, -0.5 <= g <= 31.5 iff
// |g - clamp(g, 0, 31)| <= 0.5 (the difference is exact there), so
// `inside` is excess <= 0.5.
__device__ __forceinline__ Voxel window_voxel(const Scene& s, float px,
                                              float py, float pz) {
  const float gxr = fsub(fmul(fsub(px, s.ox), s.inv_voxel), s.wx0);
  const float gyr = fsub(fmul(fsub(py, s.oy), s.inv_voxel), s.wy0);
  const float gzr = fsub(fmul(fsub(pz, s.oz), s.inv_voxel), s.wz0);
  const float gx = clampf(gxr, 0.0f, GI_WINDOW - 1.0f);
  const float gy = clampf(gyr, 0.0f, GI_WINDOW - 1.0f);
  const float gz = clampf(gzr, 0.0f, GI_WINDOW - 1.0f);
  Voxel v;
  v.ix = trunc_small(gx);
  v.iy = trunc_small(gy);
  v.iz = trunc_small(gz);
  v.excess = fmaxf(fmaxf(fabsf(fsub(gxr, gx)), fabsf(fsub(gyr, gy))),
                   fabsf(fsub(gzr, gz)));
  return v;
}

// world distance at a window voxel (sample_sdf, sdfgi.py:224-238); the
// window holds voxel (x, y, z) at byte (z * 32 + y) * 32 + x
__device__ __forceinline__ float window_distance(const signed char* win,
                                                 const Scene& s,
                                                 const Voxel& v) {
  return fmul(s8_voxels(win[(v.iz * GI_WINDOW + v.iy) * GI_WINDOW + v.ix]),
              s.voxel);
}

struct Coarse {
  float inv_voxel_c, voxel_c;
  int cd, ch, cw, cw_words;
};

// sample_coarse (sdfgi.py:356-374): distance and albedo index
__device__ __forceinline__ float coarse_distance(
    const signed char* __restrict__ csdf, const Scene& s, const Coarse& c,
    float px, float py, float pz, int* aidx) {
  const float gx =
      clampf(fmul(fsub(px, s.ox), c.inv_voxel_c), 0.0f, c.cw - 1.0f);
  const float gy =
      clampf(fmul(fsub(py, s.oy), c.inv_voxel_c), 0.0f, c.ch - 1.0f);
  const float gz =
      clampf(fmul(fsub(pz, s.oz), c.inv_voxel_c), 0.0f, c.cd - 1.0f);
  const int ix = trunc_small(gx), iy = trunc_small(gy), iz = trunc_small(gz);
  const int row = iz * c.ch + iy;  // byte ix of the row's words
  const int bidx = row * (4 * c.cw_words) + ix;
  const signed char b = __ldg(csdf + bidx);
  *aidx = row * c.cw + ix;
  return fmul(s8_voxels(b), c.voxel_c);
}

// The coarse fallback march of an escaped ray from t up to the full
// influence (sdfgi.py:376-393), then, on a hit, the coarse albedo word and
// the 6-step coarse shadow (:395-439). True on a hit, with the albedo
// word, lit and the hit distance.
__device__ __forceinline__ bool coarse_trace(
    const signed char* __restrict__ ctab, const int* __restrict__ calb,
    const Scene& s, const float* __restrict__ meta, int cd, int ch, int cw,
    int coarse_f, float px, float py, float pz, float dx, float dy, float dz,
    float t, int* caw, float* lit, float* t_hit) {
  Coarse co;
  co.voxel_c = fmul(s.voxel, (float)coarse_f);
  co.inv_voxel_c = fmul(s.inv_voxel, 1.0f / (float)coarse_f);
  co.cd = cd;
  co.ch = ch;
  co.cw = cw;
  co.cw_words = (cw + 3) / 4;
  const float infl_far = meta[6];
  const float thr_c = fmul(co.voxel_c, 0.6f);
  const float min_step_c = fmul(co.voxel_c, 0.5f);
  float t2 = t;
  bool hitc = false, alive2 = true;
  int aidx = 0;
  for (int i = 0; i < 24 && alive2; ++i) {
    const float dc = coarse_distance(
        ctab, s, co, fadd(px, fmul(dx, t2)), fadd(py, fmul(dy, t2)),
        fadd(pz, fmul(dz, t2)), &aidx);
    const bool new_hit = dc < thr_c;
    hitc = hitc || new_hit;
    alive2 = !new_hit && t2 < infl_far;
    if (alive2) t2 = fadd(t2, fmaxf(fmul(fabsf(dc), 0.8f), min_step_c));
  }
  if (!hitc) return false;
  const float cx = fadd(px, fmul(dx, t2));
  const float cy = fadd(py, fmul(dy, t2));
  const float cz = fadd(pz, fmul(dz, t2));
  coarse_distance(ctab, s, co, cx, cy, cz, &aidx);
  *caw = __ldg(calb + aidx);
  const float sdx = meta[7], sdy = meta[8], sdz = meta[9];
  float st = fmul(co.voxel_c, 1.5f);
  const float thr_s = fmul(thr_c, 0.8f);
  float l = 1.0f;
  for (int i = 0; i < 6 && l != 0.0f; ++i) {  // lit stays 0 once shadowed
    int unused;
    const float ds = coarse_distance(
        ctab, s, co, fadd(cx, fmul(sdx, st)), fadd(cy, fmul(sdy, st)),
        fadd(cz, fmul(sdz, st)), &unused);
    if (ds < thr_s) l = 0.0f;
    st = fadd(st, fmaxf(fabsf(ds), co.voxel_c));
  }
  *lit = l;
  *t_hit = t2;
  return true;
}

// The window's base brick on one axis from the tile's mean (sdfgi.py:150)
__device__ __forceinline__ int window_base(float mean, float o, float voxel,
                                           int nb) {
  const float c = fdiv(fsub(mean, o), voxel);
  const int b = __float2int_rz(floorf(fdiv(fsub(c, 8.0f), 16.0f)));
  return min(max(b, 0), max(nb - 2, 0));
}

}  // namespace

__global__ void __launch_bounds__(PLAIN_TILE_THREADS, GI_MIN_BLOCKS)
sdfgi_trace_kernel(const float* __restrict__ wpos,
                   const float* __restrict__ normal,
                   const float* __restrict__ dirs,
                   const unsigned char* __restrict__ valid,
                   const float* __restrict__ sky, const int* __restrict__ sdf,
                   const int* __restrict__ alb, const int* __restrict__ csdf,
                   const int* __restrict__ calb,
                   const float* __restrict__ meta, float* __restrict__ out,
                   int h, int w, int vd, int vh, int vw, int cd, int ch,
                   int cw, int coarse_f, int steps, int strict,
                   int use_coarse, int sky_h, int sky_w) {
  // the tile's 8 SDF bricks, voxel (x, y, z) at byte (z * 32 + y) * 32 + x;
  // until the window is loaded its first 4 KB hold the tile sums' tree
  __shared__ __align__(16) int win[8 * GI_BRICK_WORDS];
  __shared__ float sums[4];
  __shared__ float alb_pow[256];  // powf(b / 255, 2.2) (sdfgi.py:470)
  const int part = blockIdx.x % GI_PARTS;
  const int tile = blockIdx.x / GI_PARTS;
  const int ntx = w / PLAIN_TILE_W;
  const int ty = tile / ntx, tx = tile - ty * ntx;
  const int col = threadIdx.x % PLAIN_TILE_W;
  const size_t plane = (size_t)h * w;
  const size_t tile0 = (size_t)(ty * PLAIN_TILE_H) * w + tx * PLAIN_TILE_W;

  Scene s;
  s.ox = meta[0];
  s.oy = meta[1];
  s.oz = meta[2];
  s.voxel = meta[3];
  s.inv_voxel = meta[4];
  s.nbx = vw / GI_BRICK;
  s.nby = vh / GI_BRICK;
  const int nbz = vd / GI_BRICK;

  // the table that does not depend on the window, first (its powf
  // overlaps the sums below)
  alb_pow[threadIdx.x] = powf(fdiv((float)threadIdx.x, 255.0f), 2.2f);

  // --- 1. window origin from the masked tile means (sdfgi.py:139-158):
  // every block of the tile sums all of it, thread t its column t % 128
  // over rows (t / 128) * 8 .. + 8 in order, then tile_sum's tree ---
  float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  {
    const size_t r0 = tile0 + (size_t)((threadIdx.x / PLAIN_TILE_W) *
                                       PLAIN_ROWS_PER_THREAD) * w + col;
#pragma unroll
    for (int r = 0; r < PLAIN_ROWS_PER_THREAD; ++r) {
      const size_t o = r0 + (size_t)r * w;
      const bool ok = valid[o] != 0;
      v[0] = fadd(v[0], ok ? 1.0f : 0.0f);
      v[1] = fadd(v[1], ok ? wpos[o] : 0.0f);
      v[2] = fadd(v[2], ok ? wpos[plane + o] : 0.0f);
      v[3] = fadd(v[3], ok ? wpos[2 * plane + o] : 0.0f);
    }
  }
  plain_tile_reduce_n<4>(v, reinterpret_cast<float*>(win), sums,
                         PlainAddFK());
  // this block's rays: rows part * 2 GI_RAYS + t / 128 + 2 j of the tile
  const size_t o0 = tile0 +
                    (size_t)(part * 2 * GI_RAYS + threadIdx.x / PLAIN_TILE_W) *
                        w +
                    col;
  const float n_valid = v[0];
  if (n_valid == 0.0f) {  // all-sky tile: zeros
#pragma unroll
    for (int j = 0; j < GI_RAYS; ++j) {
#pragma unroll
      for (int c = 0; c < 7; ++c) {
        __stcs(out + c * plane + o0 + (size_t)(2 * j) * w, 0.0f);
      }
    }
    return;
  }
  const float count = fmaxf(n_valid, 1.0f);
  s.bx0 = window_base(fdiv(v[1], count), s.ox, s.voxel, s.nbx);
  s.by0 = window_base(fdiv(v[2], count), s.oy, s.voxel, s.nby);
  s.bz0 = window_base(fdiv(v[3], count), s.oz, s.voxel, nbz);
  s.wx0 = (float)(s.bx0 * GI_BRICK);
  s.wy0 = (float)(s.by0 * GI_BRICK);
  s.wz0 = (float)(s.bz0 * GI_BRICK);

  // --- 2. the window ---
  {
    // thread t takes row (lz, ly) = (t / 16, t % 16) of each brick: 16
    // bytes of window row (z, y)
    int4 words[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int bidx =
          ((s.bz0 + (k >> 2)) * s.nby + (s.by0 + ((k >> 1) & 1))) * s.nbx +
          s.bx0 + (k & 1);
      words[k] = __ldg(reinterpret_cast<const int4*>(
                           sdf + (size_t)bidx * GI_BRICK_WORDS) +
                       threadIdx.x);
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int z = (k >> 2) * GI_BRICK + (threadIdx.x >> 4);
      const int yw = ((k >> 1) & 1) * GI_BRICK + (threadIdx.x & 15);
      reinterpret_cast<int4*>(win)[(z * GI_WINDOW + yw) * 2 + (k & 1)] =
          words[k];
    }
  }
  __syncthreads();
  const signed char* ctab = reinterpret_cast<const signed char*>(csdf);
  const signed char* win8 = reinterpret_cast<const signed char*>(win);
  const float infl_eff = meta[5];
  const float threshold = fmul(s.voxel, 0.43f);
  const float min_step = fmul(s.voxel, 0.5f);
  const float sdx = meta[7], sdy = meta[8], sdz = meta[9];

  // --- 3. the rays ---
#pragma unroll 1
  for (int j = 0; j < GI_RAYS; ++j) {
    const size_t o = o0 + (size_t)(2 * j) * w;
    if (valid[o] == 0) {  // no surface: zeros
#pragma unroll
      for (int c = 0; c < 7; ++c) __stcs(out + c * plane + o, 0.0f);
      continue;
    }
    const float nx = normal[o], ny = normal[plane + o],
                nz = normal[2 * plane + o];
    const float dx = dirs[o], dy = dirs[plane + o], dz = dirs[2 * plane + o];
    // ray origin offset along the normal (sdfDiffuseTrace.comp:152)
    const float px = fadd(wpos[o], fmul(nx, 0.2f));
    const float py = fadd(wpos[plane + o], fmul(ny, 0.2f));
    const float pz = fadd(wpos[2 * plane + o], fmul(nz, 0.2f));

    // fine march
    float t = 0.0f, d_prev = 0.0f, d_hit = 0.0f, dprev_hit = 0.0f;
    bool hit = false, exited = false, alive = true;
    for (int i = 0; i < steps && alive; ++i) {
      const Voxel v = window_voxel(s, fadd(px, fmul(dx, t)),
                                   fadd(py, fmul(dy, t)),
                                   fadd(pz, fmul(dz, t)));
      const float d = window_distance(win8, s, v);
      const float ex = fmul(v.excess, s.voxel);
      const bool inside = v.excess <= 0.5f;
      const bool new_hit = inside && d < threshold;
      const bool exit_now = !inside && fadd(t, ex) >= infl_eff;
      if (new_hit) {
        d_hit = d;
        dprev_hit = d_prev;
        hit = true;
      }
      exited = exited || exit_now;
      alive = !new_hit && !exit_now && t < infl_eff;
      if (alive) t = fadd(t, fmaxf(fmaxf(fabsf(d), ex), min_step));
      d_prev = d;
    }
    // Claybook planar refinement (SDF.inc:160-168)
    const float refine =
        fdiv(d_hit, fmaxf(fsub(1.0f, fsub(d_hit, dprev_hit)), 1e-3f));
    float t_hit = fadd(t, hit ? refine : 0.0f);
    if (strict) hit = hit && t_hit <= infl_eff;
    const bool escaped =
        !hit && (t >= fsub(infl_eff, fmul(s.voxel, 0.25f)) || exited);

    int aw = 0;  // rgb8 albedo word of the hit
    float lit = 1.0f;
    if (hit) {
      const float hx = fadd(px, fmul(dx, t_hit));
      const float hy = fadd(py, fmul(dy, t_hit));
      const float hz = fadd(pz, fmul(dz, t_hit));
      const Voxel v = window_voxel(s, hx, hy, hz);
      const int pool =
          ((s.bz0 + (v.iz >> 4)) * s.nby + s.by0 + (v.iy >> 4)) * s.nbx +
          s.bx0 + (v.ix >> 4);
      aw = __ldg(alb + (size_t)pool * GI_ALB_WORDS +
                 ((v.iz & 15) * GI_BRICK + (v.iy & 15)) * GI_BRICK +
                 (v.ix & 15));
      // sun visibility: 8-step SDF shadow march (sdfgi.py:321-339)
      float st = fmul(s.voxel, 1.5f);
      const float thr_s = fmul(threshold, 0.8f);
      for (int i = 0; i < 8 && lit != 0.0f; ++i) {  // 0 stays 0
        const Voxel u = window_voxel(s, fadd(hx, fmul(sdx, st)),
                                     fadd(hy, fmul(sdy, st)),
                                     fadd(hz, fmul(sdz, st)));
        const float ds = window_distance(win8, s, u);
        if (ds < thr_s) lit = 0.0f;
        st = fadd(st, fmaxf(fabsf(ds), s.voxel));
      }
    }
    if (use_coarse && escaped) {  // escaped rays have no fine hit
      hit = coarse_trace(ctab, calb, s, meta, cd, ch, cw, coarse_f, px, py,
                         pz, dx, dy, dz, t, &aw, &lit, &t_hit);
    }

    // hit: meanAlbedo^2.2 * sun * lit; miss: the low-res sky
    float cr, cg_, cb;
    if (hit) {
      cr = fmul(fmul(alb_pow[aw & 0xFF], meta[10]), lit);
      cg_ = fmul(fmul(alb_pow[(aw >> 8) & 0xFF], meta[11]), lit);
      cb = fmul(fmul(alb_pow[(aw >> 16) & 0xFF], meta[12]), lit);
      if (t_hit < 1e-4f) cr = cg_ = cb = 0.0f;  // self-intersection
    } else {
      const float theta = acos_approx(clampf(-dy, -1.0f, 1.0f));
      float ylut = fsub(fmul(fdiv(theta, kPi), 2.0f), 1.0f);
      ylut = fadd(fmul(fmul(signf(ylut), sqrtf(fabsf(ylut))), 0.5f), 0.5f);
      const float phi = -atan2_approx(dz, dx);
      const float xlut = fadd(fdiv(phi, kTwoPi), 0.5f);
      const int sxi =
          (int)clampf(fmul(xlut, (float)sky_w), 0.0f, sky_w - 1.0f);
      const int syi =
          (int)clampf(fmul(ylut, (float)sky_h), 0.0f, sky_h - 1.0f);
      const int sidx = syi * sky_w + sxi;
      const int sky_plane = sky_h * sky_w;
      cr = __ldg(sky + sidx);
      cg_ = __ldg(sky + sky_plane + sidx);
      cb = __ldg(sky + 2 * sky_plane + sidx);
    }

    // YCoCg + SH_L1(L) projection (sdfDiffuseTrace.comp:205-209)
    const float yl = fadd(fadd(fmul(0.25f, cr), fmul(0.5f, cg_)),
                          fmul(0.25f, cb));
    const float co_ = fsub(fmul(0.5f, cr), fmul(0.5f, cb));
    const float cgv = fsub(fadd(fmul(-0.25f, cr), fmul(0.5f, cg_)),
                           fmul(0.25f, cb));
    const float sh0 = kInv2SqrtPi;
    const float sh1 = fmul(fmul(-kSqrt3, dy), kInv2SqrtPi);
    const float sh2 = fmul(fmul(kSqrt3, dz), kInv2SqrtPi);
    const float sh3 = fmul(fmul(-kSqrt3, dx), kInv2SqrtPi);
    const float norm = rsqrtf(fadd(
        fadd(fadd(fadd(fmul(sh0, sh0), fmul(sh1, sh1)), fmul(sh2, sh2)),
             fmul(sh3, sh3)),
        1e-20f));
    __stcs(out + o, fmul(fmul(yl, sh0), norm));
    __stcs(out + plane + o, fmul(fmul(yl, sh1), norm));
    __stcs(out + 2 * plane + o, fmul(fmul(yl, sh2), norm));
    __stcs(out + 3 * plane + o, fmul(fmul(yl, sh3), norm));
    __stcs(out + 4 * plane + o, co_);
    __stcs(out + 5 * plane + o, cgv);
    __stcs(out + 6 * plane + o, escaped ? 1.0f : 0.0f);
  }
}

extern "C" int sdfgi_trace_launch(
    const void* wpos, const void* normal, const void* dirs, const void* valid,
    const void* sky, const void* sdf, const void* alb, const void* csdf,
    const void* calb, const void* meta, void* out, int h, int w, int vd,
    int vh, int vw, int cd, int ch, int cw, int coarse_f, int steps,
    int strict, int use_coarse, int sky_h, int sky_w, void* stream) {
  const int blocks = (h / PLAIN_TILE_H) * (w / PLAIN_TILE_W) * GI_PARTS;
  sdfgi_trace_kernel<<<blocks, PLAIN_TILE_THREADS, 0,
                       (cudaStream_t)stream>>>(
      (const float*)wpos, (const float*)normal, (const float*)dirs,
      (const unsigned char*)valid, (const float*)sky, (const int*)sdf,
      (const int*)alb, (const int*)csdf, (const int*)calb,
      (const float*)meta, (float*)out, h, w, vd, vh, vw, cd, ch, cw,
      coarse_f, steps, strict, use_coarse, sky_h, sky_w);
  PLAIN_RETURN_LAUNCH_STATUS();
}
