"""Material texture pool: mip-chained, brick-pooled (numpy).

A copy of plainrenderer_tpu/assets/textures.py: the same materials give a
bit-identical pool (tests/test_torch_texture.py). The reference binds
per-mesh albedo/normal/specular textures through a 1000-entry bindless
descriptor array with hardware mips and samplers (RenderBackend.cpp:45,
1433-1518; loading RenderFrontend.cpp:958-1029). The JAX package re-lays
textures out as aligned (8, 128) bricks for its TPU DMA windows; the port
keeps that layout because the sampling semantics (ops/texture.py) are
defined on it.

Layout:
  - every texture level (texture t, mip m) is padded to a multiple of
    (8, 128) texels and cut into BRICKS of 8x128 texels;
  - each texel is TWO int32 words:
      word0 = albedo r|g<<8|b<<16|alpha<<24   (gamma-2.0 encoded rgb)
      word1 = nx|ny<<8|roughness<<16|metal<<24 (tangent-space normal xy
               biased to [0,255])
    so one material fetch costs two gathers;
  - all bricks of all (t, m) levels live in two global pools
    (NB, 8, 128) int32 (word0 pool + word1 pool), with a per-(t, m) info
    table [brick_base, n_bricks_x, n_bricks_y, logical_w, logical_h];
  - the sampling kernel (ops/texture.py) DMAs a 3x2-brick window (24x256
    texels) of the tile's dominant (texture, mip) around the tile's mean
    texel coordinate.

Gamma-2.0 ("sqrt") encoding keeps the in-kernel sRGB-ish decode to a single
multiply (v*v) instead of the piecewise sRGB curve (the reference gets the
decode for free from VK_FORMAT_*_SRGB hardware).
"""

from __future__ import annotations

import dataclasses

import numpy as np

BRICK_H = 8
BRICK_W = 128
MAX_MIPS = 12

# alpha-test mask pool (depthPrepass.frag:28-31 / sunShadow.frag alpha clip):
# each alpha-tested material gets a 64x64 binary visibility mask sampled
# nearest-with-wrap inside the raster visibility kernels. 64x64 is the
# in-register budget: one mask = 128 int32 words = one (1, 128) lane row,
# so the kernel's per-pair mask table is a single vreg-width lane gather.
ALPHA_MASK_RES = 64
ALPHA_MASK_WORDS = 128  # 64 rows x 2 words (32 bits each)
MAX_ALPHA_MATERIALS = 8


@dataclasses.dataclass
class TexturePool:
    """Brick-pooled texture set, ready for device upload."""

    word0: np.ndarray  # (NB, 8, 128) int32: albedo rgba8 (rgb gamma-2.0)
    word1: np.ndarray  # (NB, 8, 128) int32: normal xy, roughness, metal
    info: np.ndarray  # (n_tex * n_mips, 4) int32: base, nbx, log_w, log_h
    n_mips: int
    n_textures: int
    # alpha-test support (all-zero when no material is alpha-tested):
    alpha_masks: np.ndarray = None  # (MAX_ALPHA_MATERIALS, 128) int32 bits
    alpha_slot: np.ndarray = None  # (n_tex,) int32: 0 = opaque, s>0 =
    #   masks row s-1 (slot semantics shared with ops/raster.py)


def generate_mips(img: np.ndarray, n_mips: int) -> list[np.ndarray]:
    """Box-filter mip chain of (H, W, C) float image (values in [0,1])."""
    mips = [img]
    for _ in range(n_mips - 1):
        m = mips[-1]
        h, w = m.shape[:2]
        if h <= 1 and w <= 1:
            break
        h2, w2 = max(h // 2, 1), max(w // 2, 1)
        m = m[: h2 * 2, : w2 * 2]
        if h > 1:
            m = (m[0::2] + m[1::2]) * 0.5
        if w > 1:
            m = (m[:, 0::2] + m[:, 1::2]) * 0.5
        mips.append(m)
    return mips


def _renormalize_normal_mip(n: np.ndarray) -> np.ndarray:
    """Keep averaged tangent-space normals unit-ish per mip."""
    z = np.sqrt(np.maximum(1.0 - n[..., 0] ** 2 - n[..., 1] ** 2, 1e-4))
    length = np.sqrt(n[..., 0] ** 2 + n[..., 1] ** 2 + z * z)
    return n / np.maximum(length[..., None], 1e-6)


def _pack_level(albedo, alpha, normal_xy, rough, metal):
    """One mip level -> (word0, word1) int32 (H, W)."""
    def q(x):
        return np.clip(np.round(x * 255.0), 0, 255).astype(np.int64)

    rgb = q(np.sqrt(np.clip(albedo, 0.0, 1.0)))  # gamma-2.0 encode
    w0 = rgb[..., 0] | (rgb[..., 1] << 8) | (rgb[..., 2] << 16) \
        | (q(alpha) << 24)
    nq = q(normal_xy * 0.5 + 0.5)
    w1 = nq[..., 0] | (nq[..., 1] << 8) | (q(rough) << 16) | (q(metal) << 24)
    return w0.astype(np.int64), w1.astype(np.int64)


def _to_bricks(plane: np.ndarray) -> np.ndarray:
    """(H, W) int -> (nby * nbx, 8, 128) with row-major brick order."""
    h, w = plane.shape
    ph = (-h) % BRICK_H
    pw = (-w) % BRICK_W
    if ph or pw:
        # clamp-pad: repeat the border texel so bilinear taps at the
        # logical edge read sensible values
        plane = np.pad(plane, ((0, ph), (0, pw)), mode="edge")
    h2, w2 = plane.shape
    nby, nbx = h2 // BRICK_H, w2 // BRICK_W
    b = plane.reshape(nby, BRICK_H, nbx, BRICK_W).transpose(0, 2, 1, 3)
    return b.reshape(nby * nbx, BRICK_H, BRICK_W)


@dataclasses.dataclass
class MaterialTextures:
    """One material's source images (float, [0,1]); any may be None."""

    albedo: np.ndarray | None = None  # (H, W, 3/4); alpha in channel 3
    normal: np.ndarray | None = None  # (H, W, >=2) tangent-space, [0,1]
    specular: np.ndarray | None = None  # (H, W, >=3) glTF ORM (G=rough,
    #                                     B=metal) like the reference
    # alpha-tested material (clip at 0.5 — depthPrepass.frag:28-31).
    # None = auto-detect: any albedo texel with alpha < 0.5
    alpha_test: bool | None = None

    def is_alpha_tested(self) -> bool:
        if self.alpha_test is not None:
            return self.alpha_test
        return (self.albedo is not None and self.albedo.shape[-1] >= 4
                and bool((self.albedo[..., 3] < 0.5).any()))


def build_alpha_mask(alpha: np.ndarray) -> np.ndarray:
    """(H, W) alpha channel -> (ALPHA_MASK_WORDS,) int32 bit mask.

    Area-averaged down to 64x64, thresholded at the reference's 0.5 alpha
    cutoff (depthPrepass.frag:28-31). Word layout consumed by the raster
    kernels: word index = row * 2 + (col >= 32), bit = col & 31; bit 1 =
    texel passes the alpha test (opaque)."""
    r = ALPHA_MASK_RES
    h, w = alpha.shape[:2]
    # area-average via integer bucketing (handles any source size)
    ys = np.minimum((np.arange(h) * r) // max(h, 1), r - 1)
    xs = np.minimum((np.arange(w) * r) // max(w, 1), r - 1)
    acc = np.zeros((r, r), np.float64)
    cnt = np.zeros((r, r), np.float64)
    np.add.at(acc, (ys[:, None], xs[None, :]),
              alpha.astype(np.float64))
    np.add.at(cnt, (ys[:, None], xs[None, :]), 1.0)
    grid = acc / np.maximum(cnt, 1.0)
    bits = grid >= 0.5  # (64, 64) bool
    words = np.zeros((ALPHA_MASK_WORDS,), np.uint32)
    for half in range(2):
        block = bits[:, half * 32:(half + 1) * 32]  # (64, 32)
        vals = (block.astype(np.uint32)
                << np.arange(32, dtype=np.uint32)[None, :]).sum(
                    axis=1, dtype=np.uint64)
        words[half::2] = vals.astype(np.uint32)
    return words.view(np.int32)


def build_texture_pool(materials: list[MaterialTextures],
                       defaults: list[dict] | None = None,
                       max_mips: int = MAX_MIPS) -> TexturePool:
    """Pack per-material texture sets into the global brick pools.

    defaults[i] may carry 'albedo' (3,), 'roughness', 'metal' used to fill
    missing maps (a 4x4 constant texture).
    """
    n_tex = len(materials)
    # FIXED mip count across the pool: the sampling kernel bakes n_mips in
    # as a static parameter, so it must not depend on texture sizes; short
    # chains just repeat their last level (one extra brick per level)
    n_mips = max_mips

    info = np.zeros((n_tex * n_mips, 4), np.int32)
    alpha_masks = np.zeros((MAX_ALPHA_MATERIALS, ALPHA_MASK_WORDS), np.int32)
    alpha_slot = np.zeros((n_tex,), np.int32)
    n_alpha = 0
    bricks0, bricks1 = [], []
    base_count = 0
    for t, mt in enumerate(materials):
        if mt.is_alpha_tested():
            if n_alpha < MAX_ALPHA_MATERIALS:
                alpha_masks[n_alpha] = build_alpha_mask(mt.albedo[..., 3])
                n_alpha += 1
                alpha_slot[t] = n_alpha  # slot = row + 1; 0 = opaque
            else:
                import sys

                print("textures: alpha-tested material budget "
                      f"({MAX_ALPHA_MATERIALS}) exceeded; material {t} "
                      "renders opaque", file=sys.stderr)
        d = (defaults[t] if defaults else None) or {}
        alb = mt.albedo
        if alb is None:
            alb = np.ones((4, 4, 3), np.float32) \
                * np.asarray(d.get("albedo", [0.5, 0.5, 0.5]), np.float32)
        if alb.shape[-1] == 3:
            alpha = np.ones(alb.shape[:2], np.float32)
        else:
            alpha = alb[..., 3]
            alb = alb[..., :3]
        h, w = alb.shape[:2]

        def fit(img, channels, fill):
            if img is None:
                return np.full((h, w, channels), fill, np.float32)
            out = img[..., :channels].astype(np.float32)
            if out.shape[:2] != (h, w):
                ys = (np.arange(h) * out.shape[0] // h)
                xs = (np.arange(w) * out.shape[1] // w)
                out = out[ys][:, xs]
            return out

        nrm = fit(mt.normal, 2, 0.5) * 2.0 - 1.0
        spec = fit(mt.specular, 3, 0.0)
        if mt.specular is None:
            rough = np.full((h, w), float(d.get("roughness", 0.6)),
                            np.float32)
            metal = np.full((h, w), float(d.get("metal", 0.0)), np.float32)
        else:
            rough = spec[..., 1]
            metal = spec[..., 2]

        alb_mips = generate_mips(alb, n_mips)
        alpha_mips = generate_mips(alpha[..., None], n_mips)
        nrm_mips = [_renormalize_normal_mip(m)
                    for m in generate_mips(nrm, n_mips)]
        rough_mips = generate_mips(rough[..., None], n_mips)
        metal_mips = generate_mips(metal[..., None], n_mips)

        for m in range(n_mips):
            mi = min(m, len(alb_mips) - 1)
            w0, w1 = _pack_level(
                alb_mips[mi], alpha_mips[mi][..., 0], nrm_mips[mi],
                rough_mips[mi][..., 0], metal_mips[mi][..., 0])
            b0 = _to_bricks(w0)
            b1 = _to_bricks(w1)
            lh, lw = w0.shape
            nbx = (lw + BRICK_W - 1) // BRICK_W
            info[t * n_mips + m] = [base_count, nbx, lw, lh]
            bricks0.append(b0)
            bricks1.append(b1)
            base_count += b0.shape[0]

    word0 = np.concatenate(bricks0).astype(np.int64)
    word1 = np.concatenate(bricks1).astype(np.int64)
    # int32 with wraparound for the alpha<<24 sign bit
    word0 = (word0 & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    word1 = (word1 & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    return TexturePool(word0=word0, word1=word1, info=info,
                       n_mips=n_mips, n_textures=n_tex,
                       alpha_masks=alpha_masks, alpha_slot=alpha_slot)
