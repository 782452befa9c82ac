"""The picture libwebp's lossy encoder codes, from (H, W), (H, W, 3) or
(H, W, 4) u8, as Pillow 12.1 hands it to libwebp 1.6.0 (an ARGB picture;
grey becomes RGB first, WebPImagePlugin._convert_frame):

  - ``to_yuva``: WebPPictureARGBToYUVA without sharp YUV or dithering
    (src/enc/picture_csp_enc.c ImportYUVAFromRGBA): Y from the 16-bit
    fixed-point luma of every pixel, U and V from each 2x2 block's red,
    green and blue averaged in a gamma-compressed domain (kGamma 0.80,
    12-bit linear values, a 33-entry table interpolated at 2 extra bits),
    alpha-weighted where the block is neither all transparent nor all
    opaque, the last column and row of an odd size as blocks of two or
    one; alpha is kept only if some pixel is below 255;
  - ``cleanup_transparent``: WebPCleanupTransparentArea on those planes
    (8x8 luma blocks: a fully transparent one is flattened to the values
    of the first of its run, a partly transparent one gets the mean luma
    of its visible pixels under its transparent ones).
"""

from __future__ import annotations

import numpy as np

_GAMMA_FIX = 12
_GAMMA_TAB_FIX = 7
_GAMMA_TAB_SIZE = 1 << (_GAMMA_FIX - _GAMMA_TAB_FIX)
_YUV_FIX = 16
_YUV_HALF = 1 << (_YUV_FIX - 1)
_ALPHA_FIX = 19


def _tables():
    scale = float(1 << _GAMMA_TAB_FIX) / ((1 << _GAMMA_FIX) - 1)
    v = np.arange(256, dtype=np.float64)
    to_lin = np.floor((v / 255.0) ** 0.80 * ((1 << _GAMMA_FIX) - 1) + 0.5)
    t = np.arange(_GAMMA_TAB_SIZE + 1, dtype=np.float64)
    to_gamma = np.floor(255.0 * (scale * t) ** (1.0 / 0.80) + 0.5)
    inv_alpha = np.zeros(4 * 255 + 1, np.int64)
    inv_alpha[1:] = (1 << _ALPHA_FIX) // np.arange(1, 4 * 255 + 1)
    return to_lin.astype(np.int64), to_gamma.astype(np.int64), inv_alpha


_TO_LINEAR, _TO_GAMMA, _INV_ALPHA = _tables()


def _linear_to_gamma(base, shift):
    """LinearToGamma: a sum of linear values -> the gamma value at 2
    extra bits of precision (the scale of a 2x2 sum)."""
    v = base << shift
    pos = v >> (_GAMMA_TAB_FIX + 2)
    x = v & ((1 << (_GAMMA_TAB_FIX + 2)) - 1)
    y = _TO_GAMMA[pos + 1] * x + _TO_GAMMA[pos] * ((1 << (_GAMMA_TAB_FIX + 2))
                                                   - x)
    return (y + (1 << (_GAMMA_TAB_FIX - 1))) >> _GAMMA_TAB_FIX


def _clip_uv(uv):
    uv = (uv + (_YUV_HALF << 2) + (128 << (_YUV_FIX + 2))) >> (_YUV_FIX + 2)
    return np.clip(uv, 0, 255)


def as_rgba(image: np.ndarray) -> np.ndarray:
    """(H, W) grey, (H, W, 3) or (H, W, 4) u8 -> (H, W, 4) u8 as the ARGB
    picture holds it (grey and RGB opaque)."""
    a = np.asarray(image, np.uint8)
    if a.ndim == 2:
        a = np.repeat(a[:, :, None], 3, axis=2)
    if a.shape[2] == 3:
        a = np.concatenate([a, np.full(a.shape[:2] + (1,), 255, np.uint8)],
                           axis=2)
    return a


def to_yuva(rgba: np.ndarray):
    """(H, W, 4) u8 -> (Y (H, W), U, V (ceil(H/2), ceil(W/2)), A (H, W) or
    None where every pixel is opaque), all u8."""
    px = rgba.astype(np.int64)
    h, w = px.shape[:2]
    r, g, b, a = px[..., 0], px[..., 1], px[..., 2], px[..., 3]
    y = (16839 * r + 33059 * g + 6420 * b + _YUV_HALF + (16 << _YUV_FIX)) \
        >> _YUV_FIX
    has_alpha = bool((a != 255).any())
    # pad to even sides by repeating the last row and column: the 2x2 sums
    # are then what SUM2 (a pair, doubled) and the last row of an odd
    # height (read twice) give
    pad = ((0, h & 1), (0, w & 1))
    lin = _TO_LINEAR[np.pad(px[..., :3], pad + ((0, 0),), mode="edge")]

    def blocks(x):
        return x[0::2, 0::2] + x[0::2, 1::2] + x[1::2, 0::2] + x[1::2, 1::2]

    rgb = _linear_to_gamma(blocks(lin), 0)
    if has_alpha:
        ap = np.pad(a, pad, mode="edge")
        a_sum = blocks(ap)
        weighted = (a_sum != 0) & (a_sum != 4 * 255)
        if weighted.any():
            wsum = blocks(lin * ap[..., None])
            div = (wsum * _INV_ALPHA[a_sum][..., None]) >> (_ALPHA_FIX - 2)
            rgb = np.where(weighted[..., None], _linear_to_gamma(div, 0), rgb)
    rr, gg, bb = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    u = _clip_uv(-9719 * rr - 19081 * gg + 28800 * bb)
    v = _clip_uv(28800 * rr - 24116 * gg - 4684 * bb)
    return (y.astype(np.uint8), u.astype(np.uint8), v.astype(np.uint8),
            rgba[..., 3].copy() if has_alpha else None)


def _smoothen(a, y) -> bool:
    """SmoothenBlock in place; True where the block is fully transparent."""
    visible = a != 0
    count = int(visible.sum())
    if 0 < count < a.size:
        y[~visible] = int(y[visible].astype(np.int64).sum()) // count
    return count == 0


def cleanup_transparent(y, u, v, a) -> None:
    """WebPCleanupTransparentArea on YUVA planes, in place."""
    h, w = y.shape
    size, half = 8, 4
    for y0 in range(0, h - size + 1, size):
        need_reset = True
        values = (0, 0, 0)
        x0 = 0
        while x0 + size <= w:
            if _smoothen(a[y0:y0 + size, x0:x0 + size],
                         y[y0:y0 + size, x0:x0 + size]):
                if need_reset:
                    values = (int(y[y0, x0]), int(u[y0 // 2, x0 // 2]),
                              int(v[y0 // 2, x0 // 2]))
                    need_reset = False
                y[y0:y0 + size, x0:x0 + size] = values[0]
                u[y0 // 2:y0 // 2 + half, x0 // 2:x0 // 2 + half] = values[1]
                v[y0 // 2:y0 // 2 + half, x0 // 2:x0 // 2 + half] = values[2]
            else:
                need_reset = True
            x0 += size
        if x0 < w:
            _smoothen(a[y0:y0 + size, x0:], y[y0:y0 + size, x0:])
    y0 = (h // size) * size
    if y0 < h:
        x0 = 0
        while x0 + size <= w:
            _smoothen(a[y0:, x0:x0 + size], y[y0:, x0:x0 + size])
            x0 += size
        if x0 < w:
            _smoothen(a[y0:, x0:], y[y0:, x0:])
