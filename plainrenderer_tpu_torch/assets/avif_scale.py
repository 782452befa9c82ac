"""libavif 1.3.0's avifImageScale: what it does to an item whose AV1 frame
is not the size its 'ispe' property states. libavif scales each decoded
plane to the ispe's size (chroma to the subsampled size, rounded up) with
libyuv's ScalePlane(..., kFilterBox) at 8 bits and ScalePlane_12 (whose
paths are ScalePlane_16's) at 10 and 12, and PIL's image has the ispe's
size.

ScalePlane first reduces the filter (ScaleFilterReduce: box becomes
bilinear where either axis keeps half or more of its samples, bilinear
becomes linear where the height is kept or cut to a third or the source
is one row high, linear becomes none where the width is kept or cut to a
third or the source is one sample wide), then takes the first of its paths
that applies: a copy, a vertical-only scale, the 3/4, 1/2, 3/8 and 1/4
reductions of both axes, the box average, 2x linear or bilinear
upsampling, bilinear up or down, or point sampling. Each path is libyuv's
C row function (row_common.cc, scale_common.cc), to which its x86 SIMD
versions are equal: 16.16 fixed-point positions, ScaleFilterCols' 7-bit
blend (ScaleFilterCols_16's 16-bit one), InterpolateRow's 8-bit blend.
"""

from __future__ import annotations

import numpy as np

from .avif_yuv import _up_bilinear, _up_linear

BOX, BILINEAR, LINEAR, NONE = "box", "bilinear", "linear", "none"


def _fixed_div(num: int, div: int) -> int:
    return _cdiv(num << 16, div)


def _fixed_div1(num: int, div: int) -> int:
    return _cdiv((num << 16) - 0x00010001, div - 1)


def _cdiv(a: int, b: int) -> int:
    """C integer division (truncates toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b > 0) else -q


def _centerstart(dx: int, s: int) -> int:
    return -((-dx >> 1) + s) if dx < 0 else (dx >> 1) + s


def _reduce(sw, sh, dw, dh, f):
    if f == BOX and (dw * 2 >= sw or dh * 2 >= sh):
        f = BILINEAR
    if f == BILINEAR:
        if sh == 1:
            f = LINEAR
        if dh == sh or dh * 3 == sh:
            f = LINEAR
        if sw == 1:
            f = NONE
    if f == LINEAR:
        if sw == 1:
            f = NONE
        if dw == sw or dw * 3 == sw:
            f = NONE
    return f


def _slope(sw, sh, dw, dh, f):
    """ScaleSlope: (x, y, dx, dy) in 16.16 fixed point."""
    x = y = dx = dy = 0
    if f == BOX:
        dx, dy = _fixed_div(sw, dw), _fixed_div(sh, dh)
    elif f in (BILINEAR, LINEAR):
        if dw <= sw:
            dx = _fixed_div(sw, dw)
            x = _centerstart(dx, -32768)
        elif sw > 1 and dw > 1:
            dx = _fixed_div1(sw, dw)
        if f == LINEAR:
            dy = _fixed_div(sh, dh)
            y = dy >> 1
        elif dh <= sh:
            dy = _fixed_div(sh, dh)
            y = _centerstart(dy, -32768)
        elif sh > 1 and dh > 1:
            dy = _fixed_div1(sh, dh)
    else:
        dx, dy = _fixed_div(sw, dw), _fixed_div(sh, dh)
        x, y = _centerstart(dx, 0), _centerstart(dy, 0)
    return x, y, dx, dy


def _filter_cols(row, n, x, dx, wide=False):
    """ScaleFilterCols_C: a + ((f >> 9) * (b - a) + 64) >> 7; the 16-bit
    ScaleFilterCols_16_C blends with all 16 bits of f."""
    xs = x + dx * np.arange(n, dtype=np.int64)
    xi = xs >> 16
    a = row[xi]
    b = row[np.minimum(xi + 1, len(row) - 1)]
    if wide:
        return a + (((xs & 0xFFFF) * (b - a) + 0x8000) >> 16)
    f = (xs & 0xFFFF) >> 9
    return a + ((f * (b - a) + 0x40) >> 7)


def _cols(row, n, x, dx):
    """ScaleCols_C: point sampling."""
    return row[(x + dx * np.arange(n, dtype=np.int64)) >> 16]


def _interp(r0, r1, f):
    """InterpolateRow_C (its half and copy cases agree with the blend)."""
    return (r0 * (256 - f) + r1 * f + 128) >> 8


def _bilinear_down(s, dw, dh, f, wide):
    sh, sw = s.shape
    x, y, dx, dy = _slope(sw, sh, dw, dh, f)
    max_y = (sh - 1) << 16
    out = np.empty((dh, dw), np.int64)
    y = min(y, max_y)
    for j in range(dh):
        yi = y >> 16
        if f == LINEAR:
            row = s[yi]
        else:
            yf = (y >> 8) & 255
            row = s[yi] if yf == 0 else _interp(s[yi], s[yi + 1], yf)
        out[j] = _filter_cols(row, dw, x, dx, wide)
        y = min(y + dy, max_y)
    return out


def _bilinear_up(s, dw, dh, f, wide):
    sh, sw = s.shape
    x, y, dx, dy = _slope(sw, sh, dw, dh, f)
    max_y = (sh - 1) << 16
    cols = ((lambda r, n, x, dx: _filter_cols(r, n, x, dx, wide))
            if f != NONE else _cols)
    y = min(y, max_y)
    yi = y >> 16
    src = yi
    bufs = [cols(s[src], dw, x, dx), None]
    if sh > 1:
        src += 1
    bufs[1] = cols(s[src], dw, x, dx)
    if sh > 2:
        src += 1
    cur, lasty = 0, yi
    out = np.empty((dh, dw), np.int64)
    for j in range(dh):
        yi = y >> 16
        if yi != lasty:
            if y > max_y:
                y = max_y
                yi = y >> 16
                src = yi
            if yi != lasty:
                bufs[cur] = cols(s[src], dw, x, dx)
                cur ^= 1
                lasty = yi
                if y + 65536 < max_y:
                    src += 1
        if f == LINEAR:
            out[j] = bufs[cur]
        else:
            out[j] = _interp(bufs[cur], bufs[cur ^ 1], (y >> 8) & 255)
        y += dy
    return out


def _vertical(s, dh, f):
    """ScalePlaneVertical over the whole width."""
    sh = s.shape[0]
    if dh <= sh:
        dy = _fixed_div(sh, dh)
        y = _centerstart(dy, -32768)
    elif sh > 1 and dh > 1:
        dy, y = _fixed_div1(sh, dh), 0
    else:
        dy = y = 0
    max_y = ((sh - 1) << 16) - 1 if sh > 1 else 0
    out = np.empty((dh, s.shape[1]), np.int64)
    for j in range(dh):
        y = min(y, max_y)
        yi = y >> 16
        yf = ((y >> 8) & 255) if f != NONE else 0
        out[j] = s[yi] if yf == 0 else _interp(s[yi], s[yi + 1], yf)
        y += dy
    return out


def _h34(r, n):
    """4 -> 3 along a row: 3:1, 1:1, 1:3 with rounding."""
    q = r[:n // 3 * 4].reshape(-1, 4)
    return np.stack([(q[:, 0] * 3 + q[:, 1] + 2) >> 2,
                     (q[:, 1] + q[:, 2] + 1) >> 1,
                     (q[:, 2] + q[:, 3] * 3 + 2) >> 2], 1).reshape(-1)


def _avg(a, b):
    return (a + b + 1) >> 1


def _down34(s, dw, dh, f, wide):
    """ScalePlaneDown34. The C rows blend each row's 4 -> 3 then the rows;
    the 8-bit SSSE3 rows, which take the first dw - dw % 24 outputs of
    each row, blend the rows first with pavgb (3 : 1 as avg(a, avg(a,
    b))). 16-bit rows are C's throughout."""
    n = 0 if wide else dw - dw % 24

    def row0(a, b):    # ScaleRowDown34_0_Box: rows 3 : 1
        c = (_h34(a, dw) * 3 + _h34(b, dw) + 2) >> 2
        c[:n] = _h34(_avg(a, _avg(b, a)), n)
        return c

    def row1(a, b):    # ScaleRowDown34_1_Box: rows 1 : 1
        c = (_h34(a, dw) + _h34(b, dw) + 1) >> 1
        c[:n] = _h34(_avg(a, b), n)
        return c

    out = np.empty((dh, dw), np.int64)
    lin = f == LINEAR
    r = j = 0
    while j < dh - 2:
        out[j] = row0(s[r], s[r if lin else r + 1])
        out[j + 1] = row1(s[r + 1], s[r + 1 if lin else r + 2])
        out[j + 2] = row0(s[r + 3], s[r + 3 if lin else r + 2])
        r += 4
        j += 3
    if dh % 3 == 2:
        out[j] = row0(s[r], s[r if lin else r + 1])
        out[j + 1] = row1(s[r + 1], s[r + 1])
    elif dh % 3 == 1:
        out[j] = row0(s[r], s[r])
    return out


def _down38(s, dw, dh, f, wide):
    """ScalePlaneDown38 (3 x 3 and 3 x 2 boxes). The 8-bit SSSE3 two-row
    box, which takes the first dw - dw % 6 outputs, averages the rows with
    pavgb and scales the sums of 3 and 2 by 65536 / 3 and / 2; 16-bit
    rows are C's throughout."""
    n = 0 if wide else dw - dw % 6

    def sums(t):
        t = t[:dw // 3 * 8].reshape(-1, 8)
        return [t[:, 0:3].sum(1), t[:, 3:6].sum(1), t[:, 6:8].sum(1)]

    def box3(rows):    # ScaleRowDown38_3_Box: 8 x 3 -> 3 x 1
        a, b, c = sums(sum(rows))
        return np.stack([(a * (65536 // 9)) >> 16, (b * (65536 // 9)) >> 16,
                         (c * (65536 // 6)) >> 16], 1).reshape(-1)

    def box2(rows):    # ScaleRowDown38_2_Box: 8 x 2 -> 3 x 1
        a, b, c = sums(rows[0] + rows[1])
        out = np.stack([(a * (65536 // 6)) >> 16, (b * (65536 // 6)) >> 16,
                        (c * (65536 // 4)) >> 16], 1).reshape(-1)
        a, b, c = sums(_avg(rows[0], rows[1]))
        simd = np.stack([(a * (65536 // 3)) >> 16, (b * (65536 // 3)) >> 16,
                         (c * (65536 // 2)) >> 16], 1).reshape(-1)
        out[:n] = simd[:n]
        return out

    out = np.empty((dh, dw), np.int64)
    r = j = 0
    while j < dh - 2:
        out[j] = box3([s[r], s[r + 1], s[r + 2]])
        out[j + 1] = box3([s[r + 3], s[r + 4], s[r + 5]])
        out[j + 2] = box2([s[r + 6], s[r + 7]])
        r += 8
        j += 3
    if dh % 3 == 2:
        out[j] = box3([s[r], s[r + 1], s[r + 2]])
        out[j + 1] = box3([s[r + 3]] * 3)
    elif dh % 3 == 1:
        out[j] = box3([s[r]] * 3)
    return out


def _box(s, dw, dh):
    """ScalePlaneBox: sums of whole source rows and columns, each box
    scaled by 65536 / (its width * height) >> 16."""
    sh, sw = s.shape
    x, y, dx, dy = _slope(sw, sh, dw, dh, BOX)
    max_y = sh << 16
    out = np.empty((dh, dw), np.int64)
    for j in range(dh):
        iy = y >> 16
        y = min(y + dy, max_y)
        bh = max(1, (y >> 16) - iy)
        row = s[iy:iy + bh].sum(0)
        if dx & 0xFFFF:
            mn = dx >> 16
            tbl = (65536 // (max(1, mn) * bh), 65536 // (max(1, mn + 1) * bh))
            xx = x
            for i in range(dw):
                ix = xx >> 16
                xx += dx
                bw = max(1, (xx >> 16) - ix)
                out[j, i] = (int(row[ix:ix + bw].sum()) * tbl[bw - mn]) >> 16
        elif dx != 0x10000:
            bw = max(1, dx >> 16)
            sc = 65536 // (bw * bh)
            x0 = x >> 16
            sums = row[x0:x0 + bw * dw].reshape(dw, bw).sum(1)
            out[j] = (sums * sc) >> 16
        else:
            out[j] = (row[(x >> 16):(x >> 16) + dw] * (65536 // bh)) >> 16
    return out


def _up2_linear(s, dw, dh):
    sh = s.shape[0]
    if dh == 1:
        return _up_linear(s[(sh - 1) // 2][None], dw)
    dy = _fixed_div(sh - 1, dh - 1)
    ys = ((1 << 15) - 1 + dy * np.arange(dh)) >> 16
    return _up_linear(s[ys], dw)


def _simple(s, dw, dh):
    sh, sw = s.shape
    x, y, dx, dy = _slope(sw, sh, dw, dh, NONE)
    ys = (y + dy * np.arange(dh, dtype=np.int64)) >> 16
    if sw * 2 == dw and x < 0x8000:
        return np.repeat(s[ys], 2, axis=1)[:, :dw]
    xs = (x + dx * np.arange(dw, dtype=np.int64)) >> 16
    return s[ys][:, xs]


def scale_plane(src: np.ndarray, dw: int, dh: int,
                depth: int = 8) -> np.ndarray:
    """libyuv ScalePlane(src, dw, dh, kFilterBox) on an 8-bit plane, or
    ScalePlane_12 (ScalePlane_16's paths) on a 10 or 12-bit one."""
    wide = depth > 8
    s = np.asarray(src).astype(np.int64)
    sh, sw = s.shape
    f = _reduce(sw, sh, dw, dh, BOX)
    if (dw, dh) == (sw, sh):
        return s.copy()
    if dw == sw and f != BOX:
        return _vertical(s, dh, f)
    if dw <= sw and dh <= sh:
        if 4 * dw == 3 * sw and 4 * dh == 3 * sh:
            return _down34(s, dw, dh, f, wide)
        if 2 * dw == sw and 2 * dh == sh:
            if f == NONE:
                return s[1::2, 1::2][:dh, :dw].copy()
            if f == LINEAR:
                return (s[0::2, 0::2][:dh, :dw] + s[0::2, 1::2][:dh, :dw]
                        + 1) >> 1
            return (s[0::2, 0::2][:dh, :dw] + s[0::2, 1::2][:dh, :dw]
                    + s[1::2, 0::2][:dh, :dw] + s[1::2, 1::2][:dh, :dw]
                    + 2) >> 2
        if 8 * dw == 3 * sw and 8 * dh == 3 * sh:
            return _down38(s, dw, dh, f, wide)
        if 4 * dw == sw and 4 * dh == sh and f in (BOX, NONE):
            if f == NONE:
                return s[2::4, 2::4][:dh, :dw].copy()
            return (s[:dh * 4, :dw * 4].reshape(dh, 4, dw, 4).sum((1, 3))
                    + 8) >> 4
    if f == BOX and dh * 2 < sh:
        return _box(s, dw, dh)
    if (dw + 1) // 2 == sw and f == LINEAR:
        return _up2_linear(s, dw, dh)
    if (dh + 1) // 2 == sh and (dw + 1) // 2 == sw and f in (BILINEAR, BOX):
        return _up_bilinear(s, dh, dw)
    if f != NONE and dh > sh:
        return _bilinear_up(s, dw, dh, f, wide)
    if f != NONE:
        return _bilinear_down(s, dw, dh, f, wide)
    return _simple(s, dw, dh)


def scale_frame(planes: list, ssx: int, ssy: int, w: int, h: int,
                depth: int = 8) -> list:
    """avifImageScale's planes: Y (or alpha) to w x h, chroma to
    ((w + ssx) >> ssx) x ((h + ssy) >> ssy)."""
    out = []
    for p, plane in enumerate(planes):
        sx, sy = (ssx, ssy) if p else (0, 0)
        out.append(scale_plane(plane, (w + sx) >> sx, (h + sy) >> sy,
                               depth))
    return out
