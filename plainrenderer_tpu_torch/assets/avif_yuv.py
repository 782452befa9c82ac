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


def libyuv_table(matrix: int, primaries: int) -> str | None:
    """The libyuv table libavif converts this matrix with, or None."""
    if matrix == 12:
        return _DERIVED.get(primaries)
    return _MATRIX.get(matrix)


def _up_linear(s: np.ndarray, n: int) -> np.ndarray:
    """libyuv ScaleRowUp2_Linear_Any along the last axis: n outputs."""
    s = s.astype(np.int64)
    cw = s.shape[-1]
    x = np.arange(n)
    i = np.clip((x - 1) // 2, 0, cw - 1)
    i1 = np.minimum(i + 1, cw - 1)
    a, b = s[..., i], s[..., i1]
    out = np.where(x % 2 == 1, (3 * a + b + 2) >> 2, (a + 3 * b + 2) >> 2)
    out[..., 0] = s[..., 0]
    out[..., n - 1] = s[..., (n - 1) // 2]
    return out


def _up_bilinear(s: np.ndarray, h: int, w: int) -> np.ndarray:
    """libyuv I420ToARGBMatrixBilinear's chroma: the first row (and the
    last of an even height) linear from one chroma row, the others 9:3:3:1
    from two, the first and last column vertical only."""
    s = s.astype(np.int64)
    ch = s.shape[0]
    lin = _up_linear(s, w)                        # (ch, w) horizontal pass
    out = np.empty((h, w), np.int64)
    y = np.arange(h)
    k = np.clip((y - 1) // 2, 0, ch - 1)
    k1 = np.minimum(k + 1, ch - 1)
    near = np.where(y % 2 == 1, k, k1)
    far = np.where(y % 2 == 1, k1, k)
    # 2D weights: horizontal 3:1 then vertical 3:1 combine to 9:3:3:1 /16;
    # rebuild them exactly from the four source samples
    x = np.arange(w)
    i = np.clip((x - 1) // 2, 0, s.shape[1] - 1)
    i1 = np.minimum(i + 1, s.shape[1] - 1)
    nx = np.where(x % 2 == 1, i, i1)
    fx = np.where(x % 2 == 1, i1, i)
    sn = s[near][:, nx]
    snf = s[near][:, fx]
    sfn = s[far][:, nx]
    sff = s[far][:, fx]
    out[:] = (9 * sn + 3 * snf + 3 * sfn + sff + 8) >> 4
    for col, c in ((0, 0), (w - 1, (w - 1) // 2)):
        out[:, col] = (3 * s[near, c] + s[far, c] + 2) >> 2
    out[0] = lin[0]
    if h % 2 == 0 and h > 1:
        out[h - 1] = lin[(h - 1) // 2]
    return out


def _pixels(Y, U, V, consts):
    YG, YB, UB, UG, VG, VR = consts
    y1 = (Y.astype(np.int64) * 257 * YG) >> 16
    u = U - 128
    v = V - 128
    b = np.clip((y1 + UB * u + YB) >> 6, 0, 255)
    g = np.clip((y1 - (UG * u + VG * v) + YB) >> 6, 0, 255)
    r = np.clip((y1 + VR * v + YB) >> 6, 0, 255)
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
    Y = planes[0].astype(np.int64)
    h, w = Y.shape
    if len(planes) == 1:
        U = V = np.full((h, w), 128, np.int64)
    elif ssx and ssy:
        U = _up_bilinear(planes[1], h, w)
        V = _up_bilinear(planes[2], h, w)
    elif ssx:
        U = _up_linear(planes[1], w)
        V = _up_linear(planes[2], w)
    else:
        U = planes[1].astype(np.int64)
        V = planes[2].astype(np.int64)
    r, g, b = _pixels(Y, U, V, consts)
    return _with_alpha(r, g, b, alpha, premultiplied)


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
