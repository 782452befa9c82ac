"""libavif 1.3.0's YUV to RGBA8 as PIL's wheel computes it: libyuv 1909's
fixed-point conversion (row_common.cc's YuvPixel with the matrix's
YuvConstants), its bilinear chroma upsampling for 4:2:0 and linear for
4:2:2 (libavif's AUTOMATIC choice when libyuv is present), luma alone for
4:0:0, and libyuv's ARGBUnattenuate where the alpha is premultiplied.

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


def _up_linear(s: np.ndarray, n: int) -> np.ndarray:
    """libyuv ScaleRowUp2_Linear_Any along the last axis: n outputs
    (int16)."""
    s = s.astype(np.int16)
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
    """libyuv I420ToARGBMatrixBilinear's chroma (int16) of an h x w
    picture, its rows ``rows``: the first row (and the last of an even
    height) linear from one chroma row, the others 9:3:3:1 from two, the
    first and last column vertical only."""
    ch = s.shape[0]
    y = np.arange(h)[rows]
    k = np.clip((y - 1) // 2, 0, ch - 1)
    k1 = np.minimum(k + 1, ch - 1)
    near = np.where(y % 2 == 1, k, k1)
    far = np.where(y % 2 == 1, k1, k)
    # only the chroma rows these rows read
    lo = int(min(near.min(), far.min()))
    s = s[lo:int(max(near.max(), far.max())) + 1].astype(np.int16)
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


def _pixels(Y, U, V, consts):
    """u8 R, G, B from u8 luma and int16 chroma. Y * 257 * YG is below
    2**31 and the chroma terms within int16, so int32 holds every sum."""
    YG, YB, UB, UG, VG, VR = consts
    y1 = (Y.astype(np.int32) * (257 * YG)) >> 16
    u = U - np.int16(128)
    v = V - np.int16(128)
    u8 = lambda t: np.clip((y1 + t + YB) >> 6, 0, 255).astype(np.uint8)
    b = u8(UB * u)
    g = u8(-(UG * u + VG * v))
    r = u8(VR * v)
    return r, g, b


def yuv_to_rgba(planes: list, ssx: int, ssy: int, full_range: bool,
                matrix: int, alpha: np.ndarray | None = None,
                premultiplied: bool = False,
                primaries: int = 1) -> np.ndarray:
    """(H, W, 4) u8 from 8-bit Y[, U, V] planes (and an alpha plane)."""
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
                                    full_range)
        r, g, b = avif_reformat.yuv_to_rgb(planes, ssx, ssy, full_range,
                                           matrix, primaries,
                                           alpha if inline else None)
        return _with_alpha(r, g, b, alpha, premultiplied and not inline)
    consts = (_FULL if full_range else _LIMITED)[table]
    Y = planes[0]
    h, w = Y.shape
    rgb = np.empty((3, h, w), np.uint8)
    for r0 in range(0, h, _ROWS):    # bands bound the wide intermediates
        rows = slice(r0, r0 + _ROWS)
        if len(planes) == 1:
            U = V = np.full((len(range(h)[rows]), w), 128, np.int16)
        elif ssx and ssy:
            U = _up_bilinear(planes[1], h, w, rows)
            V = _up_bilinear(planes[2], h, w, rows)
        elif ssx:
            U = _up_linear(planes[1][rows], w)
            V = _up_linear(planes[2][rows], w)
        else:
            U = planes[1][rows].astype(np.int16)
            V = planes[2][rows].astype(np.int16)
        rgb[:, rows] = _pixels(Y[rows], U, V, consts)
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


def limited_to_full_alpha(a: np.ndarray) -> np.ndarray:
    """avifLimitedToFullY at 8 bits (C division truncating toward zero)."""
    v = (a.astype(np.int64) - 16) * 255
    q = np.where(v < 0, -((-v) // 219), v // 219)
    return np.clip(q, 0, 255)
