// Kernel G: SDF-traced diffuse GI, one ray per (half-res) pixel.
//
// Replaces plainrenderer_tpu/ops/sdfgi.py:_trace_kernel (:112). One block
// of 256 threads per 16x128 tile (thread t: column t % 128, rows
// (t / 128) * 8 .. + 8). Per tile:
//   1. the masked mean surface point (plain_tile_reduce's fixed order, so
//      the origin equals ops/sdfgi.py:trace_plain's) picks the base brick
//      of a 2x2x2-brick (32^3-voxel) window (sdfgi.py:139-158); its 8 SDF
//      bricks (32 KB of s8 words) are staged in shared memory;
//   2. each thread then traces its 8 rays one after the other: the fine
//      sphere trace from wpos + 0.2 n with hits gated on `inside` and the
//      clamp-`excess` step rule (:192-291), Claybook refinement (:295-303),
//      albedo at the hit, an 8-step SDF sun-shadow march (:321-339); rays
//      that left the window continue in the coarse whole-scene volume (24
//      steps, its own albedo and a 6-step shadow, :341-439); misses read
//      the low-res sky through the polynomial acos / atan2 (:450-467);
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
// sign-extended after & 0xFF.
//
// Bound on the H100: every ray reads its valid flag (1 B) and writes 7
// f32; a valid ray also reads 9 f32 (position, normal, direction), so 37 B
// in + 28 B out per valid ray and 1 B + 28 B per invalid one, plus the
// brick volume, the coarse tables and the sky; chip_smoke.py counts them
// from each run's inputs.
// The work is a chain of dependent gathers per ray (each step's position
// depends on the last sample), so it is latency-bound; design: shared-
// memory window, one ray in flight per thread, no tensor cores.
#include "common.cuh"

#define GI_WINDOW 32
#define GI_BRICK 16
#define GI_BRICK_WORDS 1024  // s8 SDF words per brick (16^3 / 4)
#define GI_ALB_WORDS 4096    // rgb8 albedo words per brick

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

// signed byte `byte` of `word`, / 8 (sdfgi.py:85-87)
__device__ __forceinline__ float unpack_s8(int word, int byte) {
  int v = (word >> (8 * byte)) & 0xFF;
  v = v > 127 ? v - 256 : v;
  return fdiv((float)v, 8.0f);
}

__device__ __forceinline__ float unpack_u8(int word, int shift) {
  return fdiv((float)((word >> shift) & 0xFF), 255.0f);
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
  int brick, lx, ly, lz;  // window brick 0..7, in-brick voxel
  bool inside;
  float excess;
};

// window_coords (sdfgi.py:192-222): clamped window voxel of a world point
__device__ Voxel window_voxel(const Scene& s, float px, float py, float pz) {
  const float gxr = fsub(fmul(fsub(px, s.ox), s.inv_voxel), s.wx0);
  const float gyr = fsub(fmul(fsub(py, s.oy), s.inv_voxel), s.wy0);
  const float gzr = fsub(fmul(fsub(pz, s.oz), s.inv_voxel), s.wz0);
  const float gx = clampf(gxr, 0.0f, GI_WINDOW - 1.0f);
  const float gy = clampf(gyr, 0.0f, GI_WINDOW - 1.0f);
  const float gz = clampf(gzr, 0.0f, GI_WINDOW - 1.0f);
  const int ix = (int)gx, iy = (int)gy, iz = (int)gz;
  Voxel v;
  v.brick = ((iz >> 4) << 2) | ((iy >> 4) << 1) | (ix >> 4);
  v.lx = ix & 15;
  v.ly = iy & 15;
  v.lz = iz & 15;
  const float lo = -0.5f, hi = GI_WINDOW - 0.5f;
  v.inside = gxr >= lo && gxr <= hi && gyr >= lo && gyr <= hi && gzr >= lo &&
             gzr <= hi;
  v.excess = fmaxf(fmaxf(fabsf(fsub(gxr, gx)), fabsf(fsub(gyr, gy))),
                   fabsf(fsub(gzr, gz)));
  return v;
}

// world distance at a window voxel (sample_sdf, sdfgi.py:224-238)
__device__ __forceinline__ float window_distance(const int* win,
                                                 const Scene& s,
                                                 const Voxel& v) {
  const int word = win[v.brick * GI_BRICK_WORDS +
                       (v.lz * GI_BRICK + v.ly) * 4 + (v.lx >> 2)];
  return fmul(unpack_s8(word, v.lx & 3), s.voxel);
}

struct Coarse {
  float inv_voxel_c, voxel_c;
  int cd, ch, cw, cw_words;
};

// sample_coarse (sdfgi.py:356-374): distance and albedo index
__device__ float coarse_distance(const int* __restrict__ csdf, const Scene& s,
                                 const Coarse& c, float px, float py,
                                 float pz, int* aidx) {
  const float gx =
      clampf(fmul(fsub(px, s.ox), c.inv_voxel_c), 0.0f, c.cw - 1.0f);
  const float gy =
      clampf(fmul(fsub(py, s.oy), c.inv_voxel_c), 0.0f, c.ch - 1.0f);
  const float gz =
      clampf(fmul(fsub(pz, s.oz), c.inv_voxel_c), 0.0f, c.cd - 1.0f);
  const int ix = (int)gx, iy = (int)gy, iz = (int)gz;
  const int word = __ldg(csdf + (iz * c.ch + iy) * c.cw_words + (ix >> 2));
  *aidx = (iz * c.ch + iy) * c.cw + ix;
  return fmul(unpack_s8(word, ix & 3), c.voxel_c);
}

}  // namespace

__global__ void __launch_bounds__(PLAIN_TILE_THREADS)
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
  __shared__ int win[8 * GI_BRICK_WORDS];  // the tile's 8 SDF bricks
  __shared__ float red[PLAIN_TILE_THREADS];
  const int ntx = w / PLAIN_TILE_W;
  const int ty = blockIdx.x / ntx, tx = blockIdx.x - ty * ntx;
  const int x = tx * PLAIN_TILE_W + (threadIdx.x % PLAIN_TILE_W);
  const int y0 = ty * PLAIN_TILE_H +
                 (threadIdx.x / PLAIN_TILE_W) * PLAIN_ROWS_PER_THREAD;
  const size_t plane = (size_t)h * w;

  Scene s;
  s.ox = meta[0];
  s.oy = meta[1];
  s.oz = meta[2];
  s.voxel = meta[3];
  s.inv_voxel = meta[4];
  const float infl_eff = meta[5], infl_far = meta[6];
  const float sdx = meta[7], sdy = meta[8], sdz = meta[9];
  const float sun_r = meta[10], sun_g = meta[11], sun_b = meta[12];
  s.nbx = vw / GI_BRICK;
  s.nby = vh / GI_BRICK;
  const int nbz = vd / GI_BRICK;

  // --- window origin from the masked tile means (sdfgi.py:139-158) ---
  float cnt = 0.0f, sx = 0.0f, sy = 0.0f, sz = 0.0f;
#pragma unroll
  for (int r = 0; r < PLAIN_ROWS_PER_THREAD; ++r) {
    const size_t o = (size_t)(y0 + r) * w + x;
    const bool v = valid[o] != 0;
    cnt = fadd(cnt, v ? 1.0f : 0.0f);
    sx = fadd(sx, v ? wpos[o] : 0.0f);
    sy = fadd(sy, v ? wpos[plane + o] : 0.0f);
    sz = fadd(sz, v ? wpos[2 * plane + o] : 0.0f);
  }
  const float n_valid = plain_tile_reduce(cnt, red, PlainAddF());
  const float count = fmaxf(n_valid, 1.0f);
  const float mx = fdiv(plain_tile_reduce(sx, red, PlainAddF()), count);
  const float my = fdiv(plain_tile_reduce(sy, red, PlainAddF()), count);
  const float mz = fdiv(plain_tile_reduce(sz, red, PlainAddF()), count);
  auto base = [&](float mean, float o, int nb) {
    const float c = fdiv(fsub(mean, o), s.voxel);
    const int b = __float2int_rz(floorf(fdiv(fsub(c, 8.0f), 16.0f)));
    return min(max(b, 0), max(nb - 2, 0));
  };
  s.bx0 = base(mx, s.ox, s.nbx);
  s.by0 = base(my, s.oy, s.nby);
  s.bz0 = base(mz, s.oz, nbz);
  s.wx0 = (float)(s.bx0 * GI_BRICK);
  s.wy0 = (float)(s.by0 * GI_BRICK);
  s.wz0 = (float)(s.bz0 * GI_BRICK);

  if (n_valid == 0.0f) {  // all-sky tile: every output is 0
#pragma unroll
    for (int r = 0; r < PLAIN_ROWS_PER_THREAD; ++r) {
      const size_t o = (size_t)(y0 + r) * w + x;
      for (int c = 0; c < 7; ++c) out[c * plane + o] = 0.0f;
    }
    return;  // block-uniform
  }

  // --- stage the 8 window bricks (one int4 per thread per brick) ---
  for (int k = 0; k < 8; ++k) {
    const int bidx = ((s.bz0 + (k >> 2)) * s.nby + (s.by0 + ((k >> 1) & 1))) *
                         s.nbx +
                     s.bx0 + (k & 1);
    const int4* src =
        reinterpret_cast<const int4*>(sdf + (size_t)bidx * GI_BRICK_WORDS);
    reinterpret_cast<int4*>(win + k * GI_BRICK_WORDS)[threadIdx.x] =
        __ldg(src + threadIdx.x);
  }
  __syncthreads();

  Coarse co;
  co.voxel_c = fmul(s.voxel, (float)coarse_f);
  co.inv_voxel_c = fmul(s.inv_voxel, 1.0f / (float)coarse_f);
  co.cd = cd;
  co.ch = ch;
  co.cw = cw;
  co.cw_words = (cw + 3) / 4;
  const float threshold = fmul(s.voxel, 0.43f);
  const float thr_c = fmul(co.voxel_c, 0.6f);

  for (int r = 0; r < PLAIN_ROWS_PER_THREAD; ++r) {
    const size_t o = (size_t)(y0 + r) * w + x;
    if (valid[o] == 0) {
      for (int c = 0; c < 7; ++c) out[c * plane + o] = 0.0f;
      continue;
    }
    const float nx = normal[o], ny = normal[plane + o],
                nz = normal[2 * plane + o];
    const float dx = dirs[o], dy = dirs[plane + o], dz = dirs[2 * plane + o];
    // ray origin offset along the normal (sdfDiffuseTrace.comp:152)
    const float px = fadd(wpos[o], fmul(nx, 0.2f));
    const float py = fadd(wpos[plane + o], fmul(ny, 0.2f));
    const float pz = fadd(wpos[2 * plane + o], fmul(nz, 0.2f));

    // --- fine march ---
    float t = 0.0f, d_prev = 0.0f, d_hit = 0.0f, dprev_hit = 0.0f;
    bool hit = false, exited = false, alive = true;
    for (int i = 0; i < steps && alive; ++i) {
      const Voxel v = window_voxel(s, fadd(px, fmul(dx, t)),
                                   fadd(py, fmul(dy, t)),
                                   fadd(pz, fmul(dz, t)));
      const float d = window_distance(win, s, v);
      const bool new_hit = v.inside && d < threshold;
      const bool exit_now =
          !v.inside && fadd(t, fmul(v.excess, s.voxel)) >= infl_eff;
      if (new_hit) {
        d_hit = d;
        dprev_hit = d_prev;
        hit = true;
      }
      exited = exited || exit_now;
      alive = !new_hit && !exit_now && t < infl_eff;
      const float step = fmaxf(fmaxf(fabsf(d), fmul(v.excess, s.voxel)),
                               fmul(s.voxel, 0.5f));
      if (alive) t = fadd(t, step);
      d_prev = d;
    }
    // Claybook planar refinement (SDF.inc:160-168)
    const float refine =
        fdiv(d_hit, fmaxf(fsub(1.0f, fsub(d_hit, dprev_hit)), 1e-3f));
    float t_hit = fadd(t, hit ? refine : 0.0f);
    if (strict) hit = hit && t_hit <= infl_eff;
    const float hx = fadd(px, fmul(dx, t_hit));
    const float hy = fadd(py, fmul(dy, t_hit));
    const float hz = fadd(pz, fmul(dz, t_hit));
    const bool escaped =
        !hit && (t >= fsub(infl_eff, fmul(s.voxel, 0.25f)) || exited);

    float ar = 0.0f, ag = 0.0f, ab = 0.0f, lit = 1.0f;
    if (hit) {
      const Voxel v = window_voxel(s, hx, hy, hz);
      const int pool =
          ((s.bz0 + (v.brick >> 2)) * s.nby + s.by0 + ((v.brick >> 1) & 1)) *
              s.nbx +
          s.bx0 + (v.brick & 1);
      const int aw = __ldg(alb + (size_t)pool * GI_ALB_WORDS +
                           (v.lz * GI_BRICK + v.ly) * GI_BRICK + v.lx);
      ar = unpack_u8(aw, 0);
      ag = unpack_u8(aw, 8);
      ab = unpack_u8(aw, 16);
      // sun visibility: 8-step SDF shadow march (sdfgi.py:321-339)
      float st = fmul(s.voxel, 1.5f);
      const float thr_s = fmul(threshold, 0.8f);
      for (int i = 0; i < 8; ++i) {
        const Voxel u = window_voxel(s, fadd(hx, fmul(sdx, st)),
                                     fadd(hy, fmul(sdy, st)),
                                     fadd(hz, fmul(sdz, st)));
        const float ds = window_distance(win, s, u);
        if (ds < thr_s) lit = 0.0f;
        st = fadd(st, fmaxf(fabsf(ds), s.voxel));
      }
    }

    if (use_coarse && escaped) {
      // coarse fallback march up to the full influence (sdfgi.py:376-393)
      float t2 = t;
      bool hitc = false, alive2 = true;
      int aidx = 0;
      for (int i = 0; i < 24 && alive2; ++i) {
        const float dc =
            coarse_distance(csdf, s, co, fadd(px, fmul(dx, t2)),
                            fadd(py, fmul(dy, t2)), fadd(pz, fmul(dz, t2)),
                            &aidx);
        const bool new_hit = dc < thr_c;
        hitc = hitc || new_hit;
        alive2 = !new_hit && t2 < infl_far;
        const float step =
            fmaxf(fmul(fabsf(dc), 0.8f), fmul(co.voxel_c, 0.5f));
        if (alive2) t2 = fadd(t2, step);
      }
      if (hitc) {  // escaped rays have no fine hit: hit_c == hitc
        const float cx = fadd(px, fmul(dx, t2));
        const float cy = fadd(py, fmul(dy, t2));
        const float cz = fadd(pz, fmul(dz, t2));
        coarse_distance(csdf, s, co, cx, cy, cz, &aidx);
        const int caw = __ldg(calb + aidx);
        ar = unpack_u8(caw, 0);
        ag = unpack_u8(caw, 8);
        ab = unpack_u8(caw, 16);
        float st = fmul(co.voxel_c, 1.5f);
        const float thr_s = fmul(thr_c, 0.8f);
        lit = 1.0f;
        for (int i = 0; i < 6; ++i) {
          int unused;
          const float ds = coarse_distance(
              csdf, s, co, fadd(cx, fmul(sdx, st)), fadd(cy, fmul(sdy, st)),
              fadd(cz, fmul(sdz, st)), &unused);
          if (ds < thr_s) lit = 0.0f;
          st = fadd(st, fmaxf(fabsf(ds), co.voxel_c));
        }
        t_hit = t2;
        hit = true;
      }
    }

    // hit: meanAlbedo^2.2 * sun * lit; miss: the low-res sky
    float cr, cg_, cb;
    if (hit) {
      cr = fmul(fmul(powf(ar, 2.2f), sun_r), lit);
      cg_ = fmul(fmul(powf(ag, 2.2f), sun_g), lit);
      cb = fmul(fmul(powf(ab, 2.2f), sun_b), lit);
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
    const float y = fadd(fadd(fmul(0.25f, cr), fmul(0.5f, cg_)),
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
    out[o] = fmul(fmul(y, sh0), norm);
    out[plane + o] = fmul(fmul(y, sh1), norm);
    out[2 * plane + o] = fmul(fmul(y, sh2), norm);
    out[3 * plane + o] = fmul(fmul(y, sh3), norm);
    out[4 * plane + o] = co_;
    out[5 * plane + o] = cgv;
    out[6 * plane + o] = escaped ? 1.0f : 0.0f;
  }
}

extern "C" int sdfgi_trace_launch(
    const void* wpos, const void* normal, const void* dirs, const void* valid,
    const void* sky, const void* sdf, const void* alb, const void* csdf,
    const void* calb, const void* meta, void* out, int h, int w, int vd,
    int vh, int vw, int cd, int ch, int cw, int coarse_f, int steps,
    int strict, int use_coarse, int sky_h, int sky_w, void* stream) {
  const int blocks = (h / PLAIN_TILE_H) * (w / PLAIN_TILE_W);
  sdfgi_trace_kernel<<<blocks, PLAIN_TILE_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)wpos, (const float*)normal, (const float*)dirs,
      (const unsigned char*)valid, (const float*)sky, (const int*)sdf,
      (const int*)alb, (const int*)csdf, (const int*)calb,
      (const float*)meta, (float*)out, h, w, vd, vh, vw, cd, ch, cw,
      coarse_f, steps, strict, use_coarse, sky_h, sky_w);
  PLAIN_RETURN_LAUNCH_STATUS();
}
