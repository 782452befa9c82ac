"""libavif 1.3.0's YUV to RGBA8 as PIL's wheel computes it, from 8, 10 and
12-bit planes: libyuv 1909's fixed-point conversion (row_common.cc's
YuvPixel, YuvPixel10 and YuvPixel12 with the matrix's YuvConstants), its
bilinear chroma upsampling for 4:2:0 and linear for 4:2:2 (libavif's
AUTOMATIC choice when libyuv is present), luma alone for 4:0:0, and
libyuv's ARGBUnattenuate where the alpha is premultiplied.

The constants (luma scale YG and bias YB, chroma weights UB UG VG VR) are
libyuv's kYuvJPEG / F709 / V2020 (full range) and kYuvI601 / H709 / 2020
(limited range) tables; libavif maps matrix coefficients 1 to BT.709, 2, 5
and 6 to BT.601 and 9 to BT.2020, and matrix 12 (chromaticity-derived)
with colour primaries 1 or 2 to BT.709, 5 or 6 to BT.601 and 9 to
BT.2020. The other matrices it converts (0, 4, 7, 8, 12 with any other
primaries, 15) go through libavif's own floating-point path
(assets/avif_reformat.py), and the alpha is unpremultiplied after either
by libyuv's ARGBUnattenuate. What libavif refuses raises ValueError.
"""

from __future__ import annotations

import numpy as np

from . import avif_reformat

# (YG, YB, UB, UG, VG, VR)
_FULL = {"601": (16320, 32, 113, 22, 46, 90), "709": (16320, 32, 119, 12, 30, 101),
         "2020": (16320, 32, 120, 11, 37, 94)}
_LIMITED = {"601": (18997, -1160, 128, 25, 52, 102),
            "709": (18997, -1160, 128, 14, 34, 115),
            "2020": (19003, -1160, 128, 12, 42, 107)}
_MATRIX = {1: "709", 2: "601", 5: "601", 6: "601", 9: "2020"}
# matrix 12's colour primaries that libavif hands to libyuv's tables
_DERIVED = {1: "709", 2: "709", 5: "601", 6: "601", 9: "2020"}
_ROWS = 256        # picture rows converted at once


def libyuv_table(matrix: int, primaries: int) -> str | None:
    """The libyuv table libavif converts this matrix with, or None."""
    if matrix == 12:
        return _DERIVED.get(primaries)
    return _MATRIX.get(matrix)


def _wide(s: np.ndarray):
    """int16 for 8-bit samples, int32 for wider ones (16 x 4095 passes
    int16)."""
    return np.int16 if s.dtype == np.uint8 else np.int32


def _up_linear(s: np.ndarray, n: int) -> np.ndarray:
    """libyuv ScaleRowUp2_Linear_Any along the last axis: n outputs
    (int16 from 8-bit samples)."""
    s = s.astype(_wide(s))
    cw = s.shape[-1]
    x = np.arange(n)
    i = np.clip((x - 1) // 2, 0, cw - 1)
    i1 = np.minimum(i + 1, cw - 1)
    a, b = s[..., i], s[..., i1]
    out = np.where(x % 2 == 1, (3 * a + b + 2) >> 2, (a + 3 * b + 2) >> 2)
    out[..., 0] = s[..., 0]
    out[..., n - 1] = s[..., (n - 1) // 2]
    return out


def _up_bilinear(s: np.ndarray, h: int, w: int,
                 rows: slice = slice(None)) -> np.ndarray:
    """libyuv I420ToARGBMatrixBilinear's chroma (int16 from 8-bit samples)
    of an h x w picture, its rows ``rows``: the first row (and the last of
    an even height) linear from one chroma row, the others 9:3:3:1 from
    two, the first and last column vertical only."""
    ch = s.shape[0]
    y = np.arange(h)[rows]
    k = np.clip((y - 1) // 2, 0, ch - 1)
    k1 = np.minimum(k + 1, ch - 1)
    near = np.where(y % 2 == 1, k, k1)
    far = np.where(y % 2 == 1, k1, k)
    # only the chroma rows these rows read
    lo = int(min(near.min(), far.min()))
    s = s[lo:int(max(near.max(), far.max())) + 1]
    s = s.astype(_wide(s))
    near, far = near - lo, far - lo
    x = np.arange(w)
    i = np.clip((x - 1) // 2, 0, s.shape[1] - 1)
    i1 = np.minimum(i + 1, s.shape[1] - 1)
    nx = np.where(x % 2 == 1, i, i1)
    fx = np.where(x % 2 == 1, i1, i)
    # 9:3:3:1 is the vertical 3:1 of the horizontal 3:1 of each chroma row:
    # the same sum, at most 4,088 before the shift
    hn = 3 * s[:, nx] + s[:, fx]
    out = hn[near] * 3
    out += hn[far]
    out += 8
    out >>= 4
    for col, c in ((0, 0), (w - 1, (w - 1) // 2)):
        out[:, col] = (3 * s[near, c] + s[far, c] + 2) >> 2
    if y[0] == 0:
        out[0] = _up_linear(s[0], w)
    if h % 2 == 0 and h > 1 and y[-1] == h - 1:
        out[-1] = _up_linear(s[(h - 1) // 2 - lo], w)
    return out


def _pixels(Y, U, V, consts, depth=8):
    """u8 R, G, B from luma and int16 chroma of the depth (libyuv's
    YuvPixel, YuvPixel10 and YuvPixel12: luma widened to 16 bits by
    repeating its top bits, chroma cut to 8 bits). Y32 * YG is below 2**31
    and the chroma terms within int16, so int32 holds every sum."""
    YG, YB, UB, UG, VG, VR = consts
    y32 = ((Y.astype(np.int32) << (16 - depth))
           | (Y.astype(np.int32) >> (2 * depth - 16)))
    y1 = (y32 * YG) >> 16
    if depth > 8:
        U = np.minimum(U >> (depth - 8), 255).astype(np.int16)
        V = np.minimum(V >> (depth - 8), 255).astype(np.int16)
    u = U - np.int16(128)
    v = V - np.int16(128)
    u8 = lambda t: np.clip((y1 + t + YB) >> 6, 0, 255).astype(np.uint8)
    b = u8(UB * u)
    g = u8(-(UG * u + VG * v))
    r = u8(VR * v)
    return r, g, b


def alpha_to_8(a: np.ndarray, depth: int) -> np.ndarray:
    """avifReformatAlpha from the depth to 8 bits: (int)(0.5f + a /
    max * 255.f) in float32."""
    if depth == 8:
        return a
    f = np.asarray(a).astype(np.float32) / np.float32((1 << depth) - 1)
    return (np.float32(0.5) + f * np.float32(255)).astype(np.int64)


def yuv_to_rgba(planes: list, ssx: int, ssy: int, full_range: bool,
                matrix: int, alpha: np.ndarray | None = None,
                premultiplied: bool = False,
                primaries: int = 1, depth: int = 8) -> np.ndarray:
    """(H, W, 4) u8 from 8, 10 or 12-bit Y[, U, V] planes (and an alpha
    plane of the same depth).

    Above 8 bits libavif hands libyuv 10-bit 4:4:4, 4:2:2 and 4:2:0 with
    alpha as they are (I410 / I210 / I010AlphaToARGBMatrix[Filter]: the
    chroma upsampled at 10 bits, alpha >> 2) and 12-bit 4:2:0 with alpha
    too (I012ToARGBMatrix: nearest chroma; alpha by avifReformatAlpha);
    everything else it first shifts down to 8 bits (Convert16To8Plane:
    >> (depth - 8), the alpha too where libyuv converts it) and converts
    as 8-bit planes, but 4:0:0's alpha, which avifReformatAlpha converts
    from the full depth. The float path takes the planes at their depth
    and converts alpha by avifReformatAlpha."""
    why = avif_reformat.refusal(matrix, bool(ssx or ssy), len(planes) == 1,
                                full_range)
    if why is not None:
        raise ValueError(f"{why}: libavif's YUV to RGB refuses it")
    mono = len(planes) == 1
    table = libyuv_table(matrix, primaries)
    if mono:
        # libyuv converts 4:0:0 only into RGBA (the identity with BT.601's
        # luma); RGB output and the other matrices take libavif's path
        table = (table or ("601" if matrix == 0 else None)
                 if alpha is not None else None)
    if table is None:
        inline = premultiplied and alpha is not None and \
            avif_reformat.slow_path(matrix, bool(ssx or ssy), mono,
                                    full_range, depth)
        r, g, b = avif_reformat.yuv_to_rgb(planes, ssx, ssy, full_range,
                                           matrix, primaries,
                                           alpha if inline else None, depth)
        a8 = None if alpha is None else alpha_to_8(alpha, depth)
        return _with_alpha(r, g, b, a8, premultiplied and not inline)
    consts = (_FULL if full_range else _LIMITED)[table]
    near = False
    if depth > 8:
        s = depth - 8
        if alpha is not None and not mono and (depth == 10 or (ssx and ssy)):
            near = depth == 12
            alpha = (np.minimum(alpha >> 2, 255) if depth == 10
                     else alpha_to_8(alpha, depth))
        else:
            if alpha is not None:
                alpha = alpha_to_8(alpha, depth) if mono else alpha >> s
            planes = [p >> s for p in planes]
            depth = 8
    Y = planes[0]
    h, w = Y.shape
    rgb = np.empty((3, h, w), np.uint8)
    for r0 in range(0, h, _ROWS):    # bands bound the wide intermediates
        rows = slice(r0, r0 + _ROWS)
        if len(planes) == 1:
            U = V = np.full((len(range(h)[rows]), w), 128, np.int16)
        elif near:
            ys = np.arange(h)[rows] >> 1
            xs = np.arange(w) >> 1
            U = planes[1][ys][:, xs].astype(np.int16)
            V = planes[2][ys][:, xs].astype(np.int16)
        elif ssx and ssy:
            U = _up_bilinear(planes[1], h, w, rows)
            V = _up_bilinear(planes[2], h, w, rows)
        elif ssx:
            U = _up_linear(planes[1][rows], w)
            V = _up_linear(planes[2][rows], w)
        else:
            U = planes[1][rows].astype(np.int16)
            V = planes[2][rows].astype(np.int16)
        rgb[:, rows] = _pixels(Y[rows], U, V, consts, depth)
    return _with_alpha(*rgb, alpha, premultiplied)


def _with_alpha(r, g, b, alpha, premultiplied):
    """RGBA8, the alpha unpremultiplied by libyuv's ARGBUnattenuate."""
    h, w = r.shape
    out = np.empty((h, w, 4), np.uint8)
    out[..., 3] = 255
    if alpha is not None:
        a = alpha.astype(np.int64)
        out[..., 3] = a
        if premultiplied:
            ia = np.where(a == 0, 0, np.where(a == 1, 0xFFFF,
                                              0x10000 // np.maximum(a, 1)))
            def un(c):
                c = np.asarray(c, np.int64)
                p = c * 257 * ia
                v = np.where(p >= 1 << 31, 0, np.minimum(255, p >> 16))
                return np.where(a == 255, c, v)
            r, g, b = un(r), un(g), un(b)
    out[..., 0], out[..., 1], out[..., 2] = r, g, b
    return out


def limited_to_full_alpha(a: np.ndarray, depth: int = 8) -> np.ndarray:
    """avifLimitedToFullY at the depth (C division truncating toward
    zero): 16-235, 64-940 or 256-3760 to the full range."""
    s = depth - 8
    top = (1 << depth) - 1
    v = (a.astype(np.int64) - (16 << s)) * top
    q = np.where(v < 0, -((-v) // (219 << s)), v // (219 << s))
    return np.clip(q, 0, top)
