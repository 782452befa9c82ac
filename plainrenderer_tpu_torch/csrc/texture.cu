// Kernel D: per-tile windowed material texture sampling.
//
// Replaces plainrenderer_tpu/ops/texture.py:_sample_kernel (:47) in all its
// variants: bilinear (the frame's default, texture_filter 0), trilinear
// (texture_filter >= 1) and anisotropic (texture_filter >= 2), each with or
// without two_mat. One block of 256 threads per 16x128 screen tile; thread
// t owns column t % 128 and rows (t / 128) * 8 .. + 8. Per tile it:
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
// device memory with the window's own addressing: window texel (yi, xi) is
// pool brick base + ((by0 + yi / 8) mod nby) * nbx + (bx0 + xi / 128) mod
// nbx, row yi % 8, lane xi % 128. Tile sums (rho, texel offsets) use
// plain_tile_reduce's fixed tree and the plain version's per-thread order,
// with __fadd_rn / __fmul_rn everywhere (no FMA contraction), so each
// tile's mip and window origin equal ops/texture.py:sample_plain's.
// Integer >> is arithmetic, so every byte extract masks with & 0xFF.
//
// Bound on the H100: it reads uv, 4 derivatives, the material id and the
// valid byte and writes 9 f32 channels, 65 B per pixel (136 MB at 1080p,
// ~0.04 ms at 3.35 TB/s), plus 8 texel words per tap of a sampled pixel
// (4 taps bilinear, 12 aniso, twice under trilinear), mostly L2 hits
// because neighbouring pixels share texels. Design: reductions in shared
// memory (7-9 per tile and window), taps as plain global loads; no
// tensor-core or TMA use because the work is a gather.
#include "common.cuh"

__device__ __forceinline__ float jnp_mod(float x, float y) {
  float r = fmodf(x, y);
  if (r != 0.0f && ((r < 0.0f) != (y < 0.0f))) r = __fadd_rn(r, y);
  return r;
}

__device__ __forceinline__ float unpack8(int w, int shift) {
  return __fdiv_rn((float)((w >> shift) & 0xFF), 255.0f);
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

// one (texture, mip) window of one material's pixels in a tile
struct Window {
  int base, nbx, lw, lh, nbx1, nby1, bx0, by0;
  float lwf, lhf, bxf, byf;
  bool fits_x, fits_y;
};

// Place the window of level `mip` of texture texc around the circular mean
// texel of the selected pixels: anchor at the selected minimum, wrap
// offsets into [-L/4, 3L/4), average. Every thread of the block calls it.
__device__ __forceinline__ Window place_window(
    const TileInputs& in, int texc, int mip, const bool* sel, float n_sel,
    const float* u, const float* v, float* red_f) {
  Window W;
  const int row = (texc * in.n_mips + mip) * 4;
  W.base = in.info[row];
  W.nbx = in.info[row + 1];
  W.lw = in.info[row + 2];
  W.lh = in.info[row + 3];
  const int nby = plain_floordiv(W.lh + 7, 8);
  W.lwf = (float)W.lw;
  W.lhf = (float)W.lh;
  float uf[PLAIN_ROWS_PER_THREAD], vf[PLAIN_ROWS_PER_THREAD];
  float mu = 1e9f, mv = 1e9f;
#pragma unroll
  for (int r = 0; r < PLAIN_ROWS_PER_THREAD; ++r) {
    uf[r] = __fmul_rn(__fsub_rn(u[r], floorf(u[r])), W.lwf);
    vf[r] = __fmul_rn(__fsub_rn(v[r], floorf(v[r])), W.lhf);
    if (sel[r]) {
      mu = fminf(mu, uf[r]);
      mv = fminf(mv, vf[r]);
    }
  }
  const float a_u = plain_tile_reduce(mu, red_f, PlainMinF());
  const float a_v = plain_tile_reduce(mv, red_f, PlainMinF());
  float su = 0.0f, sv = 0.0f;
#pragma unroll
  for (int r = 0; r < PLAIN_ROWS_PER_THREAD; ++r) {
    float ru = __fsub_rn(uf[r], a_u);
    ru = __fsub_rn(
        ru, __fmul_rn(floorf(__fadd_rn(__fdiv_rn(ru, W.lwf), 0.25f)), W.lwf));
    float rv = __fsub_rn(vf[r], a_v);
    rv = __fsub_rn(
        rv, __fmul_rn(floorf(__fadd_rn(__fdiv_rn(rv, W.lhf), 0.25f)), W.lhf));
    su = __fadd_rn(su, sel[r] ? ru : 0.0f);
    sv = __fadd_rn(sv, sel[r] ? rv : 0.0f);
  }
  const float mean_u = __fadd_rn(
      a_u, __fdiv_rn(plain_tile_reduce(su, red_f, PlainAddF()), n_sel));
  const float mean_v = __fadd_rn(
      a_v, __fdiv_rn(plain_tile_reduce(sv, red_f, PlainAddF()), n_sel));
  W.bx0 = plain_floordiv(__float2int_rz(__fsub_rn(mean_u, 128.0f)), 128);
  W.by0 = plain_floordiv(__float2int_rz(__fsub_rn(mean_v, 12.0f)), 8);
  W.fits_x = W.lw <= 256;
  W.fits_y = W.lh <= 24;
  W.nbx1 = max(W.nbx, 1);
  W.nby1 = max(nby, 1);
  W.bxf = (float)(W.bx0 * 128);
  W.byf = (float)(W.by0 * 8);
  return W;
}

__device__ __forceinline__ bool in_window(const Window& W, float tx,
                                          float ty) {
  return (W.fits_x || (tx >= 0.5f && tx <= 254.5f)) &&
         (W.fits_y || (ty >= 0.5f && ty <= 22.5f));
}

// the 8 bilinear blends (4 bytes of each packed word) at window coords
// (tx, ty), taps wrapped on the level's torus
__device__ __forceinline__ void bilinear_at(const TileInputs& in,
                                            const Window& W, float tx,
                                            float ty, float raw[8]) {
  const float tx5 = __fsub_rn(tx, 0.5f), ty5 = __fsub_rn(ty, 0.5f);
  const int x0 = (int)floorf(tx5), yb = (int)floorf(ty5);
  const float fx = fminf(fmaxf(__fsub_rn(tx5, (float)x0), 0.0f), 1.0f);
  const float fy = fminf(fmaxf(__fsub_rn(ty5, (float)yb), 0.0f), 1.0f);
  const float wts[4] = {
      __fmul_rn(__fsub_rn(1.0f, fx), __fsub_rn(1.0f, fy)),
      __fmul_rn(fx, __fsub_rn(1.0f, fy)), __fmul_rn(__fsub_rn(1.0f, fx), fy),
      __fmul_rn(fx, fy)};
  int w0[4], w1[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    int xi = x0 + (k & 1), yi = yb + (k >> 1);
    if (xi >= W.lw) xi -= W.lw;
    if (xi < 0) xi += W.lw;
    if (yi >= W.lh) yi -= W.lh;
    if (yi < 0) yi += W.lh;
    xi = min(max(xi, 0), 255);
    yi = min(max(yi, 0), 23);
    const int by = plain_floormod(W.by0 + (yi >> 3), W.nby1);
    const int bx = plain_floormod(W.bx0 + (xi >> 7), W.nbx1);
    const size_t idx =
        ((size_t)(W.base + by * W.nbx + bx) * 8 + (yi & 7)) * 128 +
        (xi & 127);
    w0[k] = __ldg(in.word0 + idx);
    w1[k] = __ldg(in.word1 + idx);
  }
#pragma unroll
  for (int ch = 0; ch < 4; ++ch) {
    float a = __fmul_rn(unpack8(w0[0], 8 * ch), wts[0]);
    float b = __fmul_rn(unpack8(w1[0], 8 * ch), wts[0]);
#pragma unroll
    for (int k = 1; k < 4; ++k) {
      a = __fadd_rn(a, __fmul_rn(unpack8(w0[k], 8 * ch), wts[k]));
      b = __fadd_rn(b, __fmul_rn(unpack8(w1[k], 8 * ch), wts[k]));
    }
    raw[ch] = a;
    raw[4 + ch] = b;
  }
}

// One window's sample of a selected pixel with level coords (uf, vf):
// false when a tap leaves the window (raw is then not written). ANISO takes
// 3 taps along (mvx, mvy), the major axis in mip-0 uv units per pixel.
template <bool ANISO>
__device__ __forceinline__ bool sample_window(const TileInputs& in,
                                              const Window& W, float uf,
                                              float vf, float mvx,
                                              float mvy, float raw[8]) {
  const float tx = jnp_mod(__fsub_rn(uf, W.bxf), W.lwf);
  const float ty = jnp_mod(__fsub_rn(vf, W.byf), W.lhf);
  if (!ANISO) {
    if (!in_window(W, tx, ty)) return false;
    bilinear_at(in, W, tx, ty, raw);
    return true;
  }
  const float ax = __fmul_rn(mvx, W.lwf), ay = __fmul_rn(mvy, W.lhf);
  const float offs[3] = {-(1.0f / 3.0f), 0.0f, 1.0f / 3.0f};
  float txo[3], tyo[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    txo[k] = __fadd_rn(tx, __fmul_rn(ax, offs[k]));
    tyo[k] = __fadd_rn(ty, __fmul_rn(ay, offs[k]));
    if (!in_window(W, txo[k], tyo[k])) return false;
  }
  bilinear_at(in, W, txo[0], tyo[0], raw);
#pragma unroll
  for (int k = 1; k < 3; ++k) {
    float tap[8];
    bilinear_at(in, W, txo[k], tyo[k], tap);
#pragma unroll
    for (int c = 0; c < 8; ++c) raw[c] = __fadd_rn(raw[c], tap[c]);
  }
#pragma unroll
  for (int c = 0; c < 8; ++c) raw[c] = __fmul_rn(raw[c], 1.0f / 3.0f);
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

// one material's pass over the tile; writes every pixel (first pass) or
// only this material's pixels (second pass)
template <bool TRI, bool ANISO>
__device__ __forceinline__ void material_pass(
    const TileInputs& in, int m, int n_valid, const float* u, const float* v,
    const int* mat, const bool* val, int x, int y0, bool write_all,
    float* red_f, int* red_i) {
  const int tex = in.mat_tex[m];
  const bool textured = tex >= 0 && n_valid > 0;
  const int texc = max(tex, 0);
  bool sel[PLAIN_ROWS_PER_THREAD];
  int ns = 0;
#pragma unroll
  for (int r = 0; r < PLAIN_ROWS_PER_THREAD; ++r) {
    sel[r] = val[r] && mat[r] == m;
    ns += sel[r] ? 1 : 0;
  }
  const float n_sel =
      fmaxf((float)plain_tile_reduce(ns, red_i, PlainAddI()), 1.0f);

  // mip from the mean uv footprint of this material's pixels
  const float lw0 = (float)in.info[(texc * in.n_mips) * 4 + 2];
  const float lh0 = (float)in.info[(texc * in.n_mips) * 4 + 3];
  float srho = 0.0f, mvx, mvy;
#pragma unroll
  for (int r = 0; r < PLAIN_ROWS_PER_THREAD; ++r) {
    float rho = 0.0f;
    if (sel[r]) {
      rho = footprint<ANISO>(in, (size_t)(y0 + r) * in.w + x, lw0, lh0,
                             &mvx, &mvy);
    }
    srho = __fadd_rn(srho, rho);
  }
  const float mean_rho =
      __fdiv_rn(plain_tile_reduce(srho, red_f, PlainAddF()), n_sel);
  const float lam = __fadd_rn(log2f(fmaxf(mean_rho, 1e-6f)), in.mip_bias);
  const int mip = min(max(__float2int_rz(lam), 0), in.n_mips - 1);

  const Window W0 = place_window(in, texc, mip, sel, n_sel, u, v, red_f);
  Window W1;
  if (TRI) {
    W1 = place_window(in, texc, min(mip + 1, in.n_mips - 1), sel, n_sel, u,
                      v, red_f);
  }
#pragma unroll
  for (int r = 0; r < PLAIN_ROWS_PER_THREAD; ++r) {
    if (!write_all && !sel[r]) continue;
    const size_t o = (size_t)(y0 + r) * in.w + x;
    float vals[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) vals[k] = 0.0f;
    bool ok = false;
    if (sel[r] && textured) {
      mvx = mvy = 0.0f;
      const float rho = (TRI || ANISO)
                            ? footprint<ANISO>(in, o, lw0, lh0, &mvx, &mvy)
                            : 0.0f;
      const float fu = __fsub_rn(u[r], floorf(u[r]));
      const float fv = __fsub_rn(v[r], floorf(v[r]));
      ok = sample_window<ANISO>(in, W0, __fmul_rn(fu, W0.lwf),
                                __fmul_rn(fv, W0.lhf), mvx, mvy, vals);
      if (TRI && ok) {
        float hi[8];
        ok = sample_window<ANISO>(in, W1, __fmul_rn(fu, W1.lwf),
                                  __fmul_rn(fv, W1.lhf), mvx, mvy, hi);
        if (ok) {
          const float lam_px =
              __fadd_rn(log2f(fmaxf(rho, 1e-6f)), in.mip_bias);
          const float t =
              fminf(fmaxf(__fsub_rn(lam_px, (float)mip), 0.0f), 1.0f);
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            vals[k] = __fadd_rn(vals[k],
                                __fmul_rn(__fsub_rn(hi[k], vals[k]), t));
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
#pragma unroll
    for (int k = 0; k < 8; ++k) in.out[k * in.plane + o] = vals[k];
    in.out[8 * in.plane + o] = ok ? 1.0f : 0.0f;
  }
}

template <bool TRI, bool ANISO>
__global__ void __launch_bounds__(PLAIN_TILE_THREADS)
texture_kernel(TileInputs in, const float* __restrict__ mat_id,
               const unsigned char* __restrict__ valid, int n_mat,
               int two_mat) {
  __shared__ float red_f[PLAIN_TILE_THREADS];
  __shared__ int red_i[PLAIN_TILE_THREADS];
  const int ntx = in.w / PLAIN_TILE_W;
  const int ty = blockIdx.x / ntx, tx = blockIdx.x - ty * ntx;
  const int x = tx * PLAIN_TILE_W + (threadIdx.x % PLAIN_TILE_W);
  const int y0 = ty * PLAIN_TILE_H +
                 (threadIdx.x / PLAIN_TILE_W) * PLAIN_ROWS_PER_THREAD;

  float u[PLAIN_ROWS_PER_THREAD], v[PLAIN_ROWS_PER_THREAD];
  int mat[PLAIN_ROWS_PER_THREAD];
  bool val[PLAIN_ROWS_PER_THREAD];
  int nv = 0, mn = 1 << 20, mx = -1;
#pragma unroll
  for (int r = 0; r < PLAIN_ROWS_PER_THREAD; ++r) {
    const size_t o = (size_t)(y0 + r) * in.w + x;
    u[r] = in.uv[o];
    v[r] = in.uv[in.plane + o];
    mat[r] = __float2int_rz(mat_id[o]);
    val[r] = valid[o] != 0;
    if (val[r]) {
      ++nv;
      mn = min(mn, mat[r]);
      mx = max(mx, mat[r]);
    }
  }
  const int n_valid = plain_tile_reduce(nv, red_i, PlainAddI());
  const int m_min =
      min(max(plain_tile_reduce(mn, red_i, PlainMinI()), 0), n_mat - 1);
  const int m_max =
      min(max(plain_tile_reduce(mx, red_i, PlainMaxI()), 0), n_mat - 1);
  int cmin = 0, csec = 0;
#pragma unroll
  for (int r = 0; r < PLAIN_ROWS_PER_THREAD; ++r) {
    cmin += (val[r] && mat[r] == m_min) ? 1 : 0;
  }
  const int n_min = plain_tile_reduce(cmin, red_i, PlainAddI());
  const int dom = 2 * n_min >= n_valid ? m_min : m_max;
  const int second = dom == m_min ? m_max : m_min;

  material_pass<TRI, ANISO>(in, dom, n_valid, u, v, mat, val, x, y0, true,
                            red_f, red_i);
  if (two_mat && !TRI) {
#pragma unroll
    for (int r = 0; r < PLAIN_ROWS_PER_THREAD; ++r) {
      csec += (val[r] && mat[r] == second) ? 1 : 0;
    }
    const int n_sec = plain_tile_reduce(csec, red_i, PlainAddI());
    if (second != dom && n_sec > 0 && in.mat_tex[second] >= 0) {
      material_pass<TRI, ANISO>(in, second, n_valid, u, v, mat, val, x, y0,
                                false, red_f, red_i);
    }
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
