"""AV1 film grain synthesis (the AV1 specification, section 7.18.3), which
dav1d applies to the output as libavif asks it to: the 16-bit LFSR, the
luma and chroma grain templates with their autoregressive filters, the
piecewise-linear scaling functions, the 32x32 noise blocks with their
random offsets and overlap blending, and the noise added to each plane;
the grain range, its rounding, the scaling function's interpolation and
the clipping ranges follow the bit depth.
The random draws and the autoregressive filter are serial; the blocks and
the blending are numpy.
"""

from __future__ import annotations

import numpy as np

from .av1_cdf import TABLES

GAUSSIAN = [int(v) for v in TABLES["gaussian"]]


class _Rng:
    def __init__(self, seed):
        self.r = seed

    def get(self, bits):
        r = self.r
        bit = (r ^ (r >> 1) ^ (r >> 3) ^ (r >> 12)) & 1
        r = (r >> 1) | (bit << 15)
        self.r = r
        return (r >> (16 - bits)) & ((1 << bits) - 1)


def _round2(x, n):
    return (x + (1 << (n - 1))) >> n if n else x


def _template(rng, h, w, shift, active):
    out = [[0] * w for _ in range(h)]
    if not active:
        return out
    for y in range(h):
        row = out[y]
        for x in range(w):
            row[x] = _round2(GAUSSIAN[rng.get(11)], shift)
    return out


def _scaling(points, bd):
    """The scaling function over every sample value of the bit depth: the
    256-entry piecewise-linear lookup, and above 8 bits scale_lut's
    interpolation between its entries."""
    lut = np.zeros(256, np.int64)
    if points:
        lut[:points[0][0]] = points[0][1]
        for i in range(len(points) - 1):
            dy = points[i + 1][1] - points[i][1]
            dx = points[i + 1][0] - points[i][0]
            delta = dy * ((65536 + (dx >> 1)) // dx)
            for x in range(dx):
                lut[points[i][0] + x] = (points[i][1]
                                         + ((x * delta + 32768) >> 16))
        lut[points[-1][0]:] = points[-1][1]
    s = bd - 8
    if not s:
        return lut
    v = np.arange(1 << bd)
    x = v >> s
    nxt = lut[np.minimum(x + 1, 255)]
    return lut[x] + (((nxt - lut[x]) * (v - (x << s)) + (1 << (s - 1))) >> s)


def apply(planes, seq, g):
    bd = seq.bit_depth
    up = bd - 8     # the 8-bit ranges scaled to the depth
    gmin, gmax = -(128 << up), (128 << up) - 1
    mono = seq.num_planes == 1
    sx, sy = seq.ssx, seq.ssy
    shift = 12 - bd + g.grain_scale_shift
    rng = _Rng(g.seed)
    luma = _template(rng, 73, 82, shift, bool(g.y_points))
    ar_shift = g.ar_shift
    lag = g.ar_lag
    for y in range(3, 73):
        for x in range(3, 82 - 3):
            s = 0
            pos = 0
            for dr in range(-lag, 1):
                for dc in range(-lag, lag + 1):
                    if dr == 0 and dc == 0:
                        break
                    s += luma[y + dr][x + dc] * g.ar_y[pos] if g.ar_y else 0
                    pos += 1
            luma[y][x] = max(gmin, min(gmax, luma[y][x] + _round2(s, ar_shift)))
    grains = [luma]
    if not mono:
        cw = 44 if sx else 82
        ch = 38 if sy else 73
        cb_on = bool(g.cb_points) or g.chroma_from_luma
        cr_on = bool(g.cr_points) or g.chroma_from_luma
        cb = _template(_Rng(g.seed ^ 0xB524), ch, cw, shift, cb_on)
        cr = _template(_Rng(g.seed ^ 0x49D8), ch, cw, shift, cr_on)
        for y in range(3, ch):
            for x in range(3, cw - 3):
                s0 = s1 = 0
                pos = 0
                for dr in range(-lag, 1):
                    for dc in range(-lag, lag + 1):
                        c0 = g.ar_cb[pos] if g.ar_cb else 0
                        c1 = g.ar_cr[pos] if g.ar_cr else 0
                        if dr == 0 and dc == 0:
                            if g.y_points:
                                lx = ((x - 3) << sx) + 3
                                ly = ((y - 3) << sy) + 3
                                lum = 0
                                for i in range(sy + 1):
                                    for j in range(sx + 1):
                                        lum += luma[ly + i][lx + j]
                                lum = _round2(lum, sx + sy)
                                s0 += lum * c0
                                s1 += lum * c1
                            break
                        s0 += c0 * cb[y + dr][x + dc]
                        s1 += c1 * cr[y + dr][x + dc]
                        pos += 1
                if cb_on:
                    cb[y][x] = max(gmin, min(gmax, cb[y][x] + _round2(s0, ar_shift)))
                if cr_on:
                    cr[y][x] = max(gmin, min(gmax, cr[y][x] + _round2(s1, ar_shift)))
        grains += [cb, cr]
    grains = [np.array(t, np.int64) for t in grains]
    luts = [_scaling(g.y_points, bd)]
    if not mono:
        luts.append(_scaling(g.y_points if g.chroma_from_luma else g.cb_points,
                             bd))
        luts.append(_scaling(g.y_points if g.chroma_from_luma else g.cr_points,
                             bd))
    H, W = planes[0].shape
    noise = _noise(grains, g, H, W, sx, sy, len(planes), gmin, gmax)
    out = [p.astype(np.int64) for p in planes]
    if g.clip_restricted:
        lo, max_y = 16 << up, 235 << up
        max_c = max_y if seq.mc == 0 else 240 << up
    else:
        lo, max_y = 0, (256 << up) - 1
        max_c = max_y
    ss = g.scaling_shift
    Y = out[0]
    if not mono:
        ch_, cw_ = out[1].shape
        lx = np.arange(cw_) << sx
        ly = np.arange(ch_) << sy
        lnx = np.minimum(lx + 1, W - 1)
        if sx:
            avg = (Y[ly][:, lx] + Y[ly][:, lnx] + 1) >> 1
        else:
            avg = Y[ly][:, lx]
        for k, (pts, mult, lmult, off) in enumerate(
                ((g.cb_points, g.cb_mult, g.cb_luma_mult, g.cb_offset),
                 (g.cr_points, g.cr_mult, g.cr_luma_mult, g.cr_offset)), 1):
            if not (pts or g.chroma_from_luma):
                continue
            orig = out[k]
            if g.chroma_from_luma:
                merged = avg
            else:
                comb = avg * (lmult - 128) + orig * (mult - 128)
                merged = np.clip((comb >> 6) + ((off - 256) << up), 0,
                                 (256 << up) - 1)
            n = _round2(luts[k][merged] * noise[k], ss)
            out[k] = np.clip(orig + n, lo, max_c)
    if g.y_points:
        n = _round2(luts[0][Y] * noise[0], ss)
        out[0] = np.clip(Y + n, lo, max_y)
    return [o.astype(planes[0].dtype) for o in out]


def _noise(grains, g, H, W, sx, sy, nplanes, gmin, gmax):
    """The noise stripes and the noise image of each plane."""
    stripes = []
    luma_num = 0
    for y in range(0, (H + 1) // 2, 16):
        rng = _Rng(g.seed ^ (((luma_num * 37 + 178) & 255) << 8)
                   ^ ((luma_num * 173 + 105) & 255))
        per_plane = []
        for p in range(nplanes):
            psx = sx if p else 0
            psy = sy if p else 0
            per_plane.append(np.zeros((34 >> psy, ((W + psx) >> psx) + 40),
                                      np.int64))
        offs = [rng.get(8) for _ in range(0, (W + 1) // 2, 16)]
        for bi, x in enumerate(range(0, (W + 1) // 2, 16)):
            rand = offs[bi]
            ox, oy = rand >> 4, rand & 15
            for p in range(nplanes):
                psx = sx if p else 0
                psy = sy if p else 0
                px = 6 + ox if psx else 9 + ox * 2
                py = 6 + oy if psy else 9 + oy * 2
                blk = grains[p][py:py + (34 >> psy), px:px + (34 >> psx)].copy()
                st = per_plane[p]
                col = x if psx else x * 2
                if g.overlap and x > 0:
                    old = st[:, col:col + (1 if psx else 2)]
                    if psx:
                        v = old[:, 0] * 23 + blk[:, 0] * 22
                        blk[:, 0] = np.clip(_round2(v, 5), gmin, gmax)
                    else:
                        v0 = old[:, 0] * 27 + blk[:, 0] * 17
                        v1 = old[:, 1] * 17 + blk[:, 1] * 27
                        blk[:, 0] = np.clip(_round2(v0, 5), gmin, gmax)
                        blk[:, 1] = np.clip(_round2(v1, 5), gmin, gmax)
                st[:, col:col + blk.shape[1]] = blk
        stripes.append(per_plane)
        luma_num += 1
    images = []
    for p in range(nplanes):
        psx = sx if p else 0
        psy = sy if p else 0
        ph = (H + psy) >> psy
        pw = (W + psx) >> psx
        img = np.zeros((ph, pw), np.int64)
        sh = 5 - psy
        for y in range(ph):
            n = y >> sh
            i = y - (n << sh)
            row = stripes[n][p][i, :pw].copy()
            if g.overlap and n > 0:
                if psy == 0 and i < 2:
                    old = stripes[n - 1][p][i + 32, :pw]
                    v = old * 27 + row * 17 if i == 0 else old * 17 + row * 27
                    row = np.clip(_round2(v, 5), gmin, gmax)
                elif psy and i < 1:
                    old = stripes[n - 1][p][i + 16, :pw]
                    row = np.clip(_round2(old * 23 + row * 22, 5), gmin, gmax)
            img[y] = row
        images.append(img)
    return images
