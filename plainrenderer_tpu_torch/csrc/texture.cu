// Kernel D: per-tile windowed material texture sampling.
//
// Replaces plainrenderer_tpu/ops/texture.py:_sample_kernel (:47) in all its
// variants: bilinear (the frame's default, texture_filter 0), trilinear
// (texture_filter >= 1) and anisotropic (texture_filter >= 2), each with or
// without two_mat. One block of 256 threads per 16x128 screen tile. Per
// tile it:
//   1. finds the two extreme materials of the valid pixels and the more
//      frequent one, dom (texture.py:68-74);
//   2. takes one mip from the mean footprint rho of dom's pixels
//      (texture.py:91-111): the larger axis in the bilinear variant; under
//      aniso the minor axis, floored at a third of the major;
//   3. places a 24x256-texel window on the level's torus around the
//      circular mean texel of dom's pixels (texture.py:136-149);
//   4. samples both packed words bilinearly with wrapping taps
//      (texture.py:197-250); aniso takes 3 such taps at -1/3, 0 and 1/3 of
//      the major footprint axis in this level's texel units and averages
//      them (texture.py:252-271); a pixel is ok when it is dom's, the
//      material is textured and every tap stays in the window;
//   5. trilinear: repeats 3-4 at mip + 1 (clamped) and lerps the raw
//      blends by the per-pixel lod fraction clip(log2(rho) + bias - mip,
//      0, 1), ok only where both windows hold the taps (texture.py:272-285);
//   6. without trilinear, repeats 2-4 for the second material when the
//      tile mixes two textured materials (two_mat, texture.py:301-322).
// Value channels are written 0 where ok is 0, as in the plain version. The
// variants are template instances, so the bilinear one keeps its code.
//
// The window is a cache on the TPU but part of the semantics here: the
// in-window rule decides ok. So the taps read the brick pool straight from
// device memory with the window's own addressing. Tile sums (rho, texel
// offsets) keep the plain version's order (each thread sums its 8 rows,
// thread = (row / 8) * 128 + column, then the halving tree) with
// __fadd_rn / __fmul_rn everywhere (no FMA contraction), so each tile's
// mip and window origin equal ops/texture.py:sample_plain's. Integer >> is
// arithmetic, so every byte extract masks with & 0xFF.
//
// Bound on the H100: it reads uv, 4 derivatives, the material id and the
// valid byte and writes 9 f32 channels, 65 B per pixel (136 MB at 1080p,
// ~0.04 ms at 3.35 TB/s), plus the distinct texel words its taps read
// (8 B each), mostly L2 hits because neighbouring pixels share texels.
//
// Design (the previous one, git 58c782b, ran up to ~170
// block barriers per tile, an IEEE division per unpacked byte, two integer
// modulos per tap and kept every window's fields in registers, with
// spills):
//   - a tile has at most two windows (dom's mip and mip + 1 under
//     trilinear, else dom's and the second material's), so its reductions
//     run as five batched passes of plain_tile_reduce_n, two barriers
//     each: (valid count, min, max material); the counts of both extreme
//     materials (dom, the second and their pixel counts); both windows'
//     rho sums; their texel minima; their offset sums. Then one barrier
//     for the window table: 11 in all;
//   - the bytes unpack through a 256-entry table of the correctly rounded
//     b / 255 in shared memory (ops/texture.byte_table), the same bits as
//     the division;
//   - each window's 6 pool bricks are computed once per tile
//     (ops/texture.window_bricks), so a tap's word is
//     brick[(yi >> 3) * 2 + (xi >> 7)] + (yi & 7) * 128 + (xi & 127);
//   - windows, the per-pixel uv and each pixel's window set live in shared
//     memory; the sampling walks the tile's 2048 pixels row-major (a warp
//     takes 32 columns of one row) and issues a sample's 8 tap words (24
//     under aniso) before it unpacks any;
//   - floor and rint of small values use the 1.5 * 2^23 trick instead of
//     the conversion unit (common.cuh: plain_floor_int);
//   - the 9 output planes go out as streaming stores (-3% on bench.py's
//     scene, H100 80GB HBM3 at 700 W, compare_trees.py). Measured and not
//     kept: 5 blocks per SM for the bilinear instance (51 registers, 132 B
//     of spill, +28%); word1's bytes by an FMA-corrected multiply in place
//     of the table (+1.4%).
#include "common.cuh"

// fmodf fast paths for |x| < 2y (y > 0): the exact remainder, as fmodf
__device__ __forceinline__ float jnp_mod(float x, float y) {
  const float ax = fabsf(x);
  float r;
  if (ax < y) {
    r = x;
  } else if (ax < __fmul_rn(2.0f, y)) {
    r = x > 0.0f ? __fsub_rn(x, y) : __fadd_rn(x, y);
  } else {
    r = fmodf(x, y);
  }
  if (r != 0.0f && ((r < 0.0f) != (y < 0.0f))) r = __fadd_rn(r, y);
  return r;
}

struct TileInputs {
  const float* uv;
  const float* duv;
  const int* mat_tex;
  const int* info;
  const int* word0;
  const int* word1;
  float* out;
  size_t plane;
  int w;
  int n_mips;
  float mip_bias;
};

// one (texture, mip) window of one material's pixels in a tile, in shared
// memory
struct TexWindow {
  int brick[6];  // pool word of window brick (yi >> 3) * 2 + (xi >> 7)
  int lw, lh;
  float lwf, lhf, bxf, byf;
  int fits_x, fits_y;
};

#define TEX_PIXELS (PLAIN_TILE_H * PLAIN_TILE_W)

struct TexShared {
  float byte[256];  // b / 255, correctly rounded
  float u[TEX_PIXELS], v[TEX_PIXELS];  // row-major in the tile
  signed char set[TEX_PIXELS];  // window set of the pixel, -1: not sampled
  float red_f[4 * PLAIN_TILE_THREADS];
  int red_i[3 * PLAIN_TILE_THREADS];
  float res_f[4];
  int res_i[3];
  TexWindow win[2];
  float lw0[2], lh0[2];  // mip-0 size of each set's texture
  float mip;  // window 0's mip (the trilinear lerp)
};

__device__ __forceinline__ bool in_window(const TexWindow& W, float tx,
                                          float ty) {
  return (W.fits_x || (tx >= 0.5f && tx <= 254.5f)) &&
         (W.fits_y || (ty >= 0.5f && ty <= 22.5f));
}

// The pool words and weights of the 4 taps of a bilinear sample at window
// coords (tx, ty), taps wrapped on the level's torus.
__device__ __forceinline__ void bilinear_taps(const TexWindow& W, float tx,
                                              float ty, int* off,
                                              float* wts) {
  const float tx5 = __fsub_rn(tx, 0.5f), ty5 = __fsub_rn(ty, 0.5f);
  float x0f, y0f;
  const int x0 = plain_floor_int(tx5, &x0f);
  const int yb = plain_floor_int(ty5, &y0f);
  const float fx = fminf(fmaxf(__fsub_rn(tx5, x0f), 0.0f), 1.0f);
  const float fy = fminf(fmaxf(__fsub_rn(ty5, y0f), 0.0f), 1.0f);
  wts[0] = __fmul_rn(__fsub_rn(1.0f, fx), __fsub_rn(1.0f, fy));
  wts[1] = __fmul_rn(fx, __fsub_rn(1.0f, fy));
  wts[2] = __fmul_rn(__fsub_rn(1.0f, fx), fy);
  wts[3] = __fmul_rn(fx, fy);
  const int lw = W.lw, lh = W.lh;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    int xi = x0 + (k & 1), yi = yb + (k >> 1);
    if (xi >= lw) xi -= lw;
    if (xi < 0) xi += lw;
    if (yi >= lh) yi -= lh;
    if (yi < 0) yi += lh;
    xi = min(max(xi, 0), 255);
    yi = min(max(yi, 0), 23);
    off[k] = W.brick[(yi >> 3) * 2 + (xi >> 7)] + (yi & 7) * 128 +
             (xi & 127);
  }
}

// the 8 bilinear blends (4 bytes of each packed word) of one sample
__device__ __forceinline__ void blend8(const float* byte, const int* w0,
                                       const int* w1, const float* wts,
                                       float raw[8]) {
#pragma unroll
  for (int ch = 0; ch < 4; ++ch) {
    const int s = 8 * ch;
    float a = __fmul_rn(byte[(w0[0] >> s) & 0xFF], wts[0]);
    float b = __fmul_rn(byte[(w1[0] >> s) & 0xFF], wts[0]);
#pragma unroll
    for (int k = 1; k < 4; ++k) {
      a = __fadd_rn(a, __fmul_rn(byte[(w0[k] >> s) & 0xFF], wts[k]));
      b = __fadd_rn(b, __fmul_rn(byte[(w1[k] >> s) & 0xFF], wts[k]));
    }
    raw[ch] = a;
    raw[4 + ch] = b;
  }
}

// One window's sample of a selected pixel with level coords (uf, vf):
// false when a tap leaves the window (raw is then not written). ANISO takes
// 3 bilinear samples along (mvx, mvy), the major axis in mip-0 uv units per
// pixel, and averages them. All tap words are loaded before any unpacks.
template <bool ANISO>
__device__ __forceinline__ bool sample_window(const TileInputs& in,
                                              const TexWindow& W,
                                              const float* byte, float uf,
                                              float vf, float mvx, float mvy,
                                              float raw[8]) {
  const float tx = jnp_mod(__fsub_rn(uf, W.bxf), W.lwf);
  const float ty = jnp_mod(__fsub_rn(vf, W.byf), W.lhf);
  constexpr int NS = ANISO ? 3 : 1;
  float txo[NS], tyo[NS];
  if (!ANISO) {
    txo[0] = tx;
    tyo[0] = ty;
    if (!in_window(W, tx, ty)) return false;
  } else {
    const float ax = __fmul_rn(mvx, W.lwf), ay = __fmul_rn(mvy, W.lhf);
    const float offs[3] = {-(1.0f / 3.0f), 0.0f, 1.0f / 3.0f};
    bool inside = true;
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      txo[k] = __fadd_rn(tx, __fmul_rn(ax, offs[k]));
      tyo[k] = __fadd_rn(ty, __fmul_rn(ay, offs[k]));
      inside = inside && in_window(W, txo[k], tyo[k]);
    }
    if (!inside) return false;
  }
  int off[4 * NS], w0[4 * NS], w1[4 * NS];
  float wts[4 * NS];
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    bilinear_taps(W, txo[k], tyo[k], off + 4 * k, wts + 4 * k);
  }
#pragma unroll
  for (int k = 0; k < 4 * NS; ++k) {
    w0[k] = __ldg(in.word0 + off[k]);
    w1[k] = __ldg(in.word1 + off[k]);
  }
  blend8(byte, w0, w1, wts, raw);
  if (ANISO) {
#pragma unroll
    for (int k = 1; k < NS; ++k) {
      float tap[8];
      blend8(byte, w0 + 4 * k, w1 + 4 * k, wts + 4 * k, tap);
#pragma unroll
      for (int c = 0; c < 8; ++c) raw[c] = __fadd_rn(raw[c], tap[c]);
    }
#pragma unroll
    for (int c = 0; c < 8; ++c) raw[c] = __fmul_rn(raw[c], 1.0f / 3.0f);
  }
  return true;
}

// The footprint of pixel o in mip-0 texel units (texture.py:91-111): rho,
// and under ANISO the major axis (mvx, mvy) in uv units per pixel.
template <bool ANISO>
__device__ __forceinline__ float footprint(const TileInputs& in, size_t o,
                                           float lw0, float lh0, float* mvx,
                                           float* mvy) {
  const float d0 = in.duv[o], d1 = in.duv[in.plane + o];
  const float d2 = in.duv[2 * in.plane + o];
  const float d3 = in.duv[3 * in.plane + o];
  if (!ANISO) {
    return fmaxf(fmaxf(__fmul_rn(fabsf(d0), lw0), __fmul_rn(fabsf(d1), lh0)),
                 fmaxf(__fmul_rn(fabsf(d2), lw0), __fmul_rn(fabsf(d3), lh0)));
  }
  const float x0 = __fmul_rn(d0, lw0), x1 = __fmul_rn(d1, lh0);
  const float y0 = __fmul_rn(d2, lw0), y1 = __fmul_rn(d3, lh0);
  const float ex = __fsqrt_rn(__fadd_rn(__fmul_rn(x0, x0), __fmul_rn(x1, x1)));
  const float ey = __fsqrt_rn(__fadd_rn(__fmul_rn(y0, y0), __fmul_rn(y1, y1)));
  const bool use_ex = ex >= ey;
  *mvx = use_ex ? d0 : d2;
  *mvy = use_ex ? d1 : d3;
  return fmaxf(fminf(ex, ey), __fmul_rn(fmaxf(ex, ey), 1.0f / 3.0f));
}

// (valid count, min material, max material)
struct TexMaterialOps {
  __device__ int operator()(int k, int a, int b) const {
    return k == 0 ? a + b : (k == 1 ? min(a, b) : max(a, b));
  }
};

template <bool TRI, bool ANISO>
__global__ void __launch_bounds__(PLAIN_TILE_THREADS, (TRI || ANISO) ? 3 : 4)
texture_kernel(TileInputs in, const float* __restrict__ mat_id,
               const unsigned char* __restrict__ valid, int n_mat,
               int two_mat) {
  __shared__ TexShared sh;
  const int t = threadIdx.x;
  sh.byte[t] = __fdiv_rn((float)t, 255.0f);
  const int ntx = in.w / PLAIN_TILE_W;
  const int ty = blockIdx.x / ntx, tx = blockIdx.x - ty * ntx;
  const size_t tile_o =
      (size_t)(ty * PLAIN_TILE_H) * in.w + tx * PLAIN_TILE_W;
  // reduction phase: thread t owns column t % 128, rows (t / 128) * 8 .. + 8
  const int col = t % PLAIN_TILE_W;
  const int row0 = (t / PLAIN_TILE_W) * PLAIN_ROWS_PER_THREAD;

  float u[PLAIN_ROWS_PER_THREAD], v[PLAIN_ROWS_PER_THREAD];
  int mat[PLAIN_ROWS_PER_THREAD];
  unsigned vbits = 0;
  int m3[3] = {0, 1 << 20, -1};  // valid count, min, max material
#pragma unroll
  for (int r = 0; r < PLAIN_ROWS_PER_THREAD; ++r) {
    const size_t o = tile_o + (size_t)(row0 + r) * in.w + col;
    u[r] = in.uv[o];
    v[r] = in.uv[in.plane + o];
    mat[r] = __float2int_rz(mat_id[o]);
    sh.u[(row0 + r) * PLAIN_TILE_W + col] = u[r];
    sh.v[(row0 + r) * PLAIN_TILE_W + col] = v[r];
    if (valid[o] != 0) {
      vbits |= 1u << r;
      ++m3[0];
      m3[1] = min(m3[1], mat[r]);
      m3[2] = max(m3[2], mat[r]);
    }
  }
  plain_tile_reduce_n<3>(m3, sh.red_i, sh.res_i, TexMaterialOps());
  const int n_valid = m3[0];
  const int m_min = min(max(m3[1], 0), n_mat - 1);
  const int m_max = min(max(m3[2], 0), n_mat - 1);
  int cnt[2] = {0, 0};
#pragma unroll
  for (int r = 0; r < PLAIN_ROWS_PER_THREAD; ++r) {
    if ((vbits >> r) & 1u) {
      cnt[0] += mat[r] == m_min ? 1 : 0;
      cnt[1] += mat[r] == m_max ? 1 : 0;
    }
  }
  plain_tile_reduce_n<2>(cnt, sh.red_i, sh.res_i, PlainAddIK());
  const int dom = 2 * cnt[0] >= n_valid ? m_min : m_max;
  const int second = dom == m_min ? m_max : m_min;
  const int n_dom = dom == m_min ? cnt[0] : cnt[1];
  const int n_sec = second == m_min ? cnt[0] : cnt[1];
  const bool textured = in.mat_tex[dom] >= 0 && n_valid > 0;
  const bool pass2 = !TRI && two_mat && second != dom && n_sec > 0 &&
                     in.mat_tex[second] >= 0;
  if (!textured && !pass2) {  // tile-uniform: nothing is sampled
    for (int p = t; p < TEX_PIXELS; p += PLAIN_TILE_THREADS) {
      const size_t o = tile_o + (size_t)(p / PLAIN_TILE_W) * in.w +
                       p % PLAIN_TILE_W;
#pragma unroll
      for (int k = 0; k < 9; ++k) in.out[k * in.plane + o] = 0.0f;
    }
    return;
  }

  // window sets: 0 = dom; 1 = dom again (trilinear's mip + 1) or second
  unsigned sel0 = 0, sel1 = 0;
#pragma unroll
  for (int r = 0; r < PLAIN_ROWS_PER_THREAD; ++r) {
    const bool vr = (vbits >> r) & 1u;
    if (vr && mat[r] == dom) sel0 |= 1u << r;
    if (vr && mat[r] == second && second != dom) sel1 |= 1u << r;
    sh.set[(row0 + r) * PLAIN_TILE_W + col] =
        (vr && mat[r] == dom && textured) ? 0
        : ((pass2 && vr && mat[r] == second) ? 1 : -1);
  }
  if (TRI) sel1 = sel0;
  const int texc0 = max(in.mat_tex[dom], 0);
  const int texc1 = TRI ? texc0 : max(in.mat_tex[second], 0);
  const float lw00 = (float)__ldg(in.info + texc0 * in.n_mips * 4 + 2);
  const float lh00 = (float)__ldg(in.info + texc0 * in.n_mips * 4 + 3);
  const float lw01 = (float)__ldg(in.info + texc1 * in.n_mips * 4 + 2);
  const float lh01 = (float)__ldg(in.info + texc1 * in.n_mips * 4 + 3);

  // the mean footprint of each set's pixels -> its mip
  float srho[2] = {0.0f, 0.0f};
#pragma unroll
  for (int r = 0; r < PLAIN_ROWS_PER_THREAD; ++r) {
    const bool s0 = (sel0 >> r) & 1u, s1 = !TRI && ((sel1 >> r) & 1u);
    if (s0 || s1) {
      float mvx, mvy;
      const float rho = footprint<ANISO>(
          in, tile_o + (size_t)(row0 + r) * in.w + col, s0 ? lw00 : lw01,
          s0 ? lh00 : lh01, &mvx, &mvy);
      if (s0) srho[0] = __fadd_rn(srho[0], rho);
      if (s1) srho[1] = __fadd_rn(srho[1], rho);
    }
  }
  plain_tile_reduce_n<2>(srho, sh.red_f, sh.res_f, PlainAddFK());
  const float n_sel0 = fmaxf((float)n_dom, 1.0f);
  const float n_sel1 = TRI ? n_sel0 : fmaxf((float)n_sec, 1.0f);
  int mip[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float mean_rho = __fdiv_rn(srho[j], j ? n_sel1 : n_sel0);
    const float lam = __fadd_rn(log2f(fmaxf(mean_rho, 1e-6f)), in.mip_bias);
    mip[j] = min(max(__float2int_rz(lam), 0), in.n_mips - 1);
  }
  if (TRI) mip[1] = min(mip[0] + 1, in.n_mips - 1);

  // the windows: level size, then the circular mean texel of the set's
  // pixels (anchor at their minimum, offsets wrapped into [-L/4, 3L/4))
  int base[2], nbx[2], lw[2], lh[2];
  float lwf[2], lhf[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int row = ((j ? texc1 : texc0) * in.n_mips + mip[j]) * 4;
    base[j] = __ldg(in.info + row);
    nbx[j] = __ldg(in.info + row + 1);
    lw[j] = __ldg(in.info + row + 2);
    lh[j] = __ldg(in.info + row + 3);
    lwf[j] = (float)lw[j];
    lhf[j] = (float)lh[j];
  }
  float amin[4] = {1e9f, 1e9f, 1e9f, 1e9f};  // a_u0, a_v0, a_u1, a_v1
#pragma unroll
  for (int r = 0; r < PLAIN_ROWS_PER_THREAD; ++r) {
    const float fu = __fsub_rn(u[r], floorf(u[r]));
    const float fv = __fsub_rn(v[r], floorf(v[r]));
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if ((((j ? sel1 : sel0) >> r) & 1u)) {
        amin[2 * j] = fminf(amin[2 * j], __fmul_rn(fu, lwf[j]));
        amin[2 * j + 1] = fminf(amin[2 * j + 1], __fmul_rn(fv, lhf[j]));
      }
    }
  }
  plain_tile_reduce_n<4>(amin, sh.red_f, sh.res_f, PlainMinFK());
  float sums[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // su0, sv0, su1, sv1
#pragma unroll
  for (int r = 0; r < PLAIN_ROWS_PER_THREAD; ++r) {
    const float fu = __fsub_rn(u[r], floorf(u[r]));
    const float fv = __fsub_rn(v[r], floorf(v[r]));
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if ((((j ? sel1 : sel0) >> r) & 1u)) {
        float ru = __fsub_rn(__fmul_rn(fu, lwf[j]), amin[2 * j]);
        ru = __fsub_rn(ru, __fmul_rn(floorf(__fadd_rn(
                                         __fdiv_rn(ru, lwf[j]), 0.25f)),
                                     lwf[j]));
        float rv = __fsub_rn(__fmul_rn(fv, lhf[j]), amin[2 * j + 1]);
        rv = __fsub_rn(rv, __fmul_rn(floorf(__fadd_rn(
                                         __fdiv_rn(rv, lhf[j]), 0.25f)),
                                     lhf[j]));
        sums[2 * j] = __fadd_rn(sums[2 * j], ru);
        sums[2 * j + 1] = __fadd_rn(sums[2 * j + 1], rv);
      }
    }
  }
  plain_tile_reduce_n<4>(sums, sh.red_f, sh.res_f, PlainAddFK());
  if (t < 14) {  // the window table; selects, not indexing (no stack)
    const int j = t < 12 ? t / 6 : t - 12;
    const float n_sel = j ? n_sel1 : n_sel0;
    const float mean_u = __fadd_rn(j ? amin[2] : amin[0],
                                   __fdiv_rn(j ? sums[2] : sums[0], n_sel));
    const float mean_v = __fadd_rn(j ? amin[3] : amin[1],
                                   __fdiv_rn(j ? sums[3] : sums[1], n_sel));
    const int bx0 =
        plain_floordiv(__float2int_rz(__fsub_rn(mean_u, 128.0f)), 128);
    const int by0 =
        plain_floordiv(__float2int_rz(__fsub_rn(mean_v, 12.0f)), 8);
    const int lw_j = j ? lw[1] : lw[0], lh_j = j ? lh[1] : lh[0];
    const int nbx_j = j ? nbx[1] : nbx[0];
    TexWindow& W = sh.win[j];
    if (t < 12) {  // brick i of window j (ops/texture.window_bricks)
      const int i = t - 6 * j;
      const int nby1 = max(plain_floordiv(lh_j + 7, 8), 1);
      const int by = plain_floormod(by0 + i / 2, nby1);
      const int bx = plain_floormod(bx0 + i % 2, max(nbx_j, 1));
      W.brick[i] = ((j ? base[1] : base[0]) + by * nbx_j + bx) * 1024;
    } else {
      W.lw = lw_j;
      W.lh = lh_j;
      W.lwf = j ? lwf[1] : lwf[0];
      W.lhf = j ? lhf[1] : lhf[0];
      W.bxf = (float)(bx0 * 128);
      W.byf = (float)(by0 * 8);
      W.fits_x = lw_j <= 256;
      W.fits_y = lh_j <= 24;
      sh.lw0[j] = j ? lw01 : lw00;
      sh.lh0[j] = j ? lh01 : lh00;
      if (j == 0) sh.mip = (float)mip[0];
    }
  }
  __syncthreads();

  // sampling phase: pixel p = i * 256 + t, row p / 128, column p % 128
  for (int p = t; p < TEX_PIXELS; p += PLAIN_TILE_THREADS) {
    const size_t o =
        tile_o + (size_t)(p / PLAIN_TILE_W) * in.w + p % PLAIN_TILE_W;
    const int set = sh.set[p];
    float vals[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) vals[k] = 0.0f;
    bool ok = false;
    if (set >= 0) {
      const float pu = sh.u[p], pv = sh.v[p];
      const float fu = __fsub_rn(pu, floorf(pu));
      const float fv = __fsub_rn(pv, floorf(pv));
      float mvx = 0.0f, mvy = 0.0f, rho = 0.0f;
      if (TRI || ANISO) {
        rho = footprint<ANISO>(in, o, sh.lw0[set], sh.lh0[set], &mvx, &mvy);
      }
      const TexWindow& W0 = sh.win[TRI ? 0 : set];
      ok = sample_window<ANISO>(in, W0, sh.byte, __fmul_rn(fu, W0.lwf),
                                __fmul_rn(fv, W0.lhf), mvx, mvy, vals);
      if (TRI && ok) {
        const TexWindow& W1 = sh.win[1];
        float hi[8];
        ok = sample_window<ANISO>(in, W1, sh.byte, __fmul_rn(fu, W1.lwf),
                                  __fmul_rn(fv, W1.lhf), mvx, mvy, hi);
        if (ok) {
          const float lam_px =
              __fadd_rn(log2f(fmaxf(rho, 1e-6f)), in.mip_bias);
          const float tl =
              fminf(fmaxf(__fsub_rn(lam_px, sh.mip), 0.0f), 1.0f);
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            vals[k] = __fadd_rn(vals[k],
                                __fmul_rn(__fsub_rn(hi[k], vals[k]), tl));
          }
        }
      }
      if (ok) {
        // gamma-2.0 decode and the normal's [0, 1] -> [-1, 1]
        vals[0] = __fmul_rn(vals[0], vals[0]);
        vals[1] = __fmul_rn(vals[1], vals[1]);
        vals[2] = __fmul_rn(vals[2], vals[2]);
        vals[4] = __fsub_rn(__fmul_rn(vals[4], 2.0f), 1.0f);
        vals[5] = __fsub_rn(__fmul_rn(vals[5], 2.0f), 1.0f);
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k) vals[k] = 0.0f;
      }
    }
    // streaming stores: the channels are read once, by the next pass
#pragma unroll
    for (int k = 0; k < 8; ++k) __stcs(in.out + k * in.plane + o, vals[k]);
    __stcs(in.out + 8 * in.plane + o, ok ? 1.0f : 0.0f);
  }
}

extern "C" int texture_launch(const void* uv, const void* duv,
                              const void* mat_id, const void* valid,
                              const void* mat_tex, const void* info,
                              const void* word0, const void* word1, void* out,
                              int h, int w, int n_mat, int n_mips, int two_mat,
                              int trilinear, int aniso, float mip_bias,
                              void* stream) {
  TileInputs in;
  in.uv = (const float*)uv;
  in.duv = (const float*)duv;
  in.mat_tex = (const int*)mat_tex;
  in.info = (const int*)info;
  in.word0 = (const int*)word0;
  in.word1 = (const int*)word1;
  in.out = (float*)out;
  in.plane = (size_t)h * w;
  in.w = w;
  in.n_mips = n_mips;
  in.mip_bias = mip_bias;
  const int blocks = (h / PLAIN_TILE_H) * (w / PLAIN_TILE_W);
  const cudaStream_t s = (cudaStream_t)stream;
  const float* ids = (const float*)mat_id;
  const unsigned char* ok = (const unsigned char*)valid;
  if (trilinear && aniso) {
    texture_kernel<true, true>
        <<<blocks, PLAIN_TILE_THREADS, 0, s>>>(in, ids, ok, n_mat, two_mat);
  } else if (trilinear) {
    texture_kernel<true, false>
        <<<blocks, PLAIN_TILE_THREADS, 0, s>>>(in, ids, ok, n_mat, two_mat);
  } else if (aniso) {
    texture_kernel<false, true>
        <<<blocks, PLAIN_TILE_THREADS, 0, s>>>(in, ids, ok, n_mat, two_mat);
  } else {
    texture_kernel<false, false>
        <<<blocks, PLAIN_TILE_THREADS, 0, s>>>(in, ids, ok, n_mat, two_mat);
  }
  PLAIN_RETURN_LAUNCH_STATUS();
}
