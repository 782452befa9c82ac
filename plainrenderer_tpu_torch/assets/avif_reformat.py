"""libavif 1.3.0's own YUV to RGB8 (reformat.c), which PIL's wheel takes
for the matrix coefficients libyuv has no table for: 8, 10 or 12-bit
planes in float32 arithmetic, as the C code evaluates it (x86-64 SSE2, no
fused multiply-adds).

  - The planes go through per-value tables: Y' = (y - biasY) / rangeY and
    C' = (c - 128 << s) / rangeUV (s = depth - 8), with bias 0, range 2^depth
    - 1 at full range and bias 16 << s, range 219 << s (224 << s for
    chroma) at limited range; the identity mode reads its chroma through
    the luma table.
  - Matrix 0 (identity, 4:4:4 and 4:0:0 only): G = Y', B = U', R = V'.
  - Matrix 8 (YCgCo, full range only): t = Y' - U', G = Y' + U',
    B = t - V', R = t + V'.
  - Matrices 4 (FCC), 7 (SMPTE 240), 12 (chromaticity-derived, kr and kb
    from the nclx colour primaries by H.273's equations 32-37) and 15
    (no entry of libavif's table: BT.601's kr and kb): R = Y' + 2(1 - kr)
    V', B = Y' + 2(1 - kb) U', G = Y' - 2(kr(1 - kr) V' + kb(1 - kb) U') /
    kg with kg = 1 - kr - kb.
  - 4:2:0 and 4:2:2 chroma is upsampled per pixel from the 2 x 2 nearest
    samples with weights 9/16, 3/16, 3/16, 1/16 (4:2:2: the same row
    twice), the nearest one repeated at the image's edges; 4:0:0 gives R =
    G = B = Y'.
  - Each channel is clamped to [0, 1] and stored as (u8)(0.5 + x * 255).

libavif refuses (and PIL raises "Reformat failed") matrices 3, 10, 11,
13, 14 and 16 and above, YCgCo at limited range, and the identity with
4:2:0 or 4:2:2 chroma.
"""

from __future__ import annotations

import numpy as np

F = np.float32

# matrix -> (kr, kb) as libavif's matrixCoefficientsTables holds them
_KRKB = {1: (0.2126, 0.0722), 4: (0.30, 0.11), 5: (0.299, 0.114),
         6: (0.299, 0.114), 7: (0.212, 0.087), 9: (0.2627, 0.0593)}
# colour primaries -> (rX, rY, gX, gY, bX, bY, wX, wY), libavif's
# avifColorPrimariesTables; any other value takes BT.709's
_PRIMARIES = {
    1: (0.64, 0.33, 0.3, 0.6, 0.15, 0.06, 0.3127, 0.329),
    4: (0.67, 0.33, 0.21, 0.71, 0.14, 0.08, 0.310, 0.316),
    5: (0.64, 0.33, 0.29, 0.60, 0.15, 0.06, 0.3127, 0.3290),
    6: (0.630, 0.340, 0.310, 0.595, 0.155, 0.070, 0.3127, 0.3290),
    7: (0.630, 0.340, 0.310, 0.595, 0.155, 0.070, 0.3127, 0.3290),
    8: (0.681, 0.319, 0.243, 0.692, 0.145, 0.049, 0.310, 0.316),
    9: (0.708, 0.292, 0.170, 0.797, 0.131, 0.046, 0.3127, 0.3290),
    10: (1.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.3333, 0.3333),
    11: (0.680, 0.320, 0.265, 0.690, 0.150, 0.060, 0.314, 0.351),
    12: (0.680, 0.320, 0.265, 0.690, 0.150, 0.060, 0.3127, 0.3290),
    22: (0.630, 0.340, 0.295, 0.605, 0.155, 0.077, 0.3127, 0.3290),
}

def refusal(matrix: int, ss: bool, mono: bool, full: bool) -> str | None:
    """Why libavif 1.3.0 refuses this conversion, or None."""
    if matrix in (3, 10, 11, 13, 14) or matrix >= 16:
        return f"AVIF matrix coefficients {matrix}"
    if matrix == 8 and not full:
        return "AVIF YCgCo (matrix coefficients 8) at limited range"
    if matrix == 0 and ss and not mono:
        return "AVIF identity matrix with subsampled chroma"
    return None


def coefficients(matrix: int, primaries: int) -> tuple:
    """(kr, kg, kb) as float32, as avifCalcYUVCoefficients gives them."""
    if matrix == 12:
        rx, ry, gx, gy, bx, by, wx, wy = (F(v) for v in _PRIMARIES.get(
            primaries, _PRIMARIES[1]))
        one = F(1)
        rz = one - (rx + ry)
        gz = one - (gx + gy)
        bz = one - (bx + by)
        wz = one - (wx + wy)
        den = wy * (rx * (gy * bz - by * gz) + gx * (by * rz - ry * bz)
                    + bx * (ry * gz - gy * rz))
        kr = (ry * (wx * (gy * bz - by * gz) + wy * (bx * gz - gx * bz)
                    + wz * (gx * by - bx * gy))) / den
        kb = (by * (wx * (ry * gz - gy * rz) + wy * (gx * rz - rx * gz)
                    + wz * (rx * gy - gx * ry))) / den
    else:
        kr, kb = (F(v) for v in _KRKB.get(matrix, _KRKB[5]))
    return kr, F(1) - kr - kb, kb


def _tables(full: bool, identity: bool, depth: int = 8):
    """avifCreateYUVToRGBLookUpTables: every code value's float."""
    s = depth - 8
    cp = np.arange(1 << depth, dtype=F)
    ty = (cp - F(0 if full else 16 << s)) / F((1 << depth) - 1 if full
                                              else 219 << s)
    if identity:
        return ty, ty
    return ty, (cp - F(128 << s)) / F((1 << depth) - 1 if full else 224 << s)


def _chroma(c, ty_uv, h, w, ssx, ssy):
    """Each pixel's chroma value: the sample itself at 4:4:4, else the
    9:3:3:1 blend of its 2 x 2 nearest samples (reformat.c's slow path)."""
    c = np.asarray(c).astype(np.int64)
    if not ssx and not ssy:
        return ty_uv[c]
    x = np.arange(w)
    y = np.arange(h)
    cx = x >> ssx
    cy = y >> ssy
    # the adjacent column: right for odd x, left for even x; none at x = 0
    # and at an odd last column
    adj_x = np.where(x % 2 == 1, cx + 1, cx - 1)
    adj_x = np.where((x == 0) | ((x == w - 1) & (x % 2 == 1)), cx, adj_x)
    if ssy:
        adj_y = np.where(y % 2 == 1, cy + 1, cy - 1)
        adj_y = np.where((y == 0) | ((y == h - 1) & (y % 2 == 1)), cy, adj_y)
    else:
        adj_y = cy
    t = ty_uv[c]
    return (t[cy][:, cx] * F(9 / 16) + t[cy][:, adj_x] * F(3 / 16)
            + t[adj_y][:, cx] * F(3 / 16) + t[adj_y][:, adj_x] * F(1 / 16))


def _clamp(v):
    return np.where(v < F(0), F(0), np.where(v > F(1), F(1), v))


def _store(v):
    return (F(0.5) + v * F(255)).astype(np.int64)


def slow_path(matrix: int, ss: bool, mono: bool, full: bool,
              depth: int = 8) -> bool:
    """Whether libavif takes reformat.c's per-pixel path, which undoes a
    premultiplied alpha itself in float; its fast paths (4:4:4 or 4:0:0 in
    the coefficient modes, and the full-range 8-bit 4:4:4 identity) leave
    that to libyuv's ARGBUnattenuate."""
    if matrix == 0:
        return not full or mono or depth > 8
    return matrix == 8 or (ss and not mono)


def yuv_to_rgb(planes: list, ssx: int, ssy: int, full: bool, matrix: int,
               primaries: int, alpha=None, depth: int = 8) -> tuple:
    """(R, G, B) int64 planes from Y[, U, V] planes of the depth; alpha,
    when given, is a premultiplied alpha plane of that depth that the
    per-pixel path divides out (Ac = a / (2^depth - 1); 0 where Ac is 0,
    min(c / Ac, 1) where Ac < 1)."""
    y = np.asarray(planes[0]).astype(np.int64)
    h, w = y.shape
    ident = matrix == 0
    ty, tuv = _tables(full, ident, depth)
    yv = ty[y]
    if len(planes) == 1:
        r = g = b = yv
    else:
        r, g, b = _color(planes, yv, tuv, h, w, ssx, ssy, matrix, primaries)
    r, g, b = _clamp(r), _clamp(g), _clamp(b)
    if alpha is not None:
        ac = _clamp(np.asarray(alpha).astype(np.int64).astype(F)
                    / F((1 << depth) - 1))
        with np.errstate(all="ignore"):
            r, g, b = (np.where(ac == F(0), F(0), np.where(
                ac < F(1), np.minimum(c / ac, F(1)), c)) for c in (r, g, b))
    return _store(r), _store(g), _store(b)


def _color(planes, yv, tuv, h, w, ssx, ssy, matrix, primaries):
    ident = matrix == 0
    u = _chroma(planes[1], tuv, h, w, ssx, ssy)
    v = _chroma(planes[2], tuv, h, w, ssx, ssy)
    with np.errstate(all="ignore"):
        if ident:
            r, g, b = v, yv, u
        elif matrix == 8:
            t = yv - u
            r, g, b = t + v, yv + u, t - v
        else:
            kr, kg, kb = coefficients(matrix, primaries)
            one, two = F(1), F(2)
            r = yv + (two * (one - kr)) * v
            b = yv + (two * (one - kb)) * u
            g = yv - ((two * (((kr * (one - kr)) * v)
                              + ((kb * (one - kb)) * u))) / kg)
    return r, g, b
