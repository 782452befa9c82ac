"""AV1 loop restoration (the AV1 specification, sections 5.11.57-58 and
7.17): the per-unit syntax read during tile decoding, and the Wiener and
self-guided filters over each plane's restoration units in stripes of 64
rows, with the CDEF output inside a stripe and the deblocked rows saved
above and below it, as the specification's StripeStartY / StripeEndY rules
give.
"""

from __future__ import annotations

import numpy as np

from .av1_cdf import TABLES
from .av1_obu import RESTORE_NONE, RESTORE_SGRPROJ, RESTORE_WIENER

WIENER_MIN = (-5, -23, -17)
WIENER_MAX = (10, 8, 46)
WIENER_K = (1, 2, 3)
WIENER_MID = (3, -7, 15)
SGR_MIN = (-96, -32)
SGR_MAX = (31, 95)
SGR_MID = (-32, 31)
# libaom's order is (r0, r1, s0, s1); the specification's Sgr_Params row is
# (r0, s0, r1, s1)
SGR_PARAMS = tuple((int(a), int(c), int(b), int(d))
                   for a, b, c, d in TABLES["sgr_params"])
X_BY_XPLUS1 = TABLES["sgr_x_by_xplus1"].astype(np.int64)


def reference_params(num_planes):
    return {"sgr": [list(SGR_MID) for _ in range(num_planes)],
            "wiener": [[list(WIENER_MID), list(WIENER_MID)]
                       for _ in range(num_planes)]}


def count_units(unit: int, size: int) -> int:
    return max((size + (unit >> 1)) // unit, 1)


def read_lr(td, r, c, sb4):
    """read_lr for the superblock at (r, c), sb4 4x4 units a side."""
    h, seq = td.h, td.seq
    w4 = h4 = sb4
    for plane in range(seq.num_planes):
        if h.lr_type[plane] == RESTORE_NONE:
            continue
        sx = seq.ssx if plane else 0
        sy = seq.ssy if plane else 0
        unit = h.lr_size[plane]
        rows = count_units(unit, (h.height + sy) >> sy)
        cols = count_units(unit, (h.upscaled_width + sx) >> sx)
        r0 = (r * (4 >> sy) + unit - 1) // unit
        r1 = min(rows, ((r + h4) * (4 >> sy) + unit - 1) // unit)
        if h.use_superres:
            num = (4 >> sx) * h.superres_denom
            den = unit * 8
        else:
            num = 4 >> sx
            den = unit
        c0 = (c * num + den - 1) // den
        c1 = min(cols, ((c + w4) * num + den - 1) // den)
        for ur in range(r0, r1):
            for uc in range(c0, c1):
                _read_unit(td, plane, ur, uc)


def _subexp(sd, num_syms, k):
    i = mk = 0
    while True:
        b2 = k + i - 1 if i else k
        a = 1 << b2
        if num_syms <= mk + 3 * a:
            return sd.ns(num_syms - mk) + mk
        if sd.literal(1):
            i += 1
            mk += a
        else:
            return sd.literal(b2) + mk


def _recenter(r, v):
    if v > 2 * r:
        return v
    if v & 1:
        return r - ((v + 1) >> 1)
    return r + (v >> 1)


def _signed_subexp_ref(sd, low, high, k, r):
    mx = high - low
    r -= low
    v = _subexp(sd, mx, k)
    if (r << 1) <= mx:
        x = _recenter(r, v)
    else:
        x = mx - 1 - _recenter(mx - 1 - r, v)
    return x + low


def _read_unit(td, plane, ur, uc):
    sd, h, c = td.sd, td.h, td.c
    ft = h.lr_type[plane]
    if ft == RESTORE_WIENER:
        kind = RESTORE_WIENER if sd.symbol(c["use_wiener"]) else RESTORE_NONE
    elif ft == RESTORE_SGRPROJ:
        kind = RESTORE_SGRPROJ if sd.symbol(c["use_sgrproj"]) else RESTORE_NONE
    else:
        kind = sd.symbol(c["restoration_type"])
    ref = td.ref_lr
    params = None
    if kind == RESTORE_WIENER:
        coef = []
        for p in range(2):
            first = 1 if plane else 0
            taps = [0, 0, 0]
            for j in range(first, 3):
                v = _signed_subexp_ref(sd, WIENER_MIN[j], WIENER_MAX[j] + 1,
                                       WIENER_K[j], ref["wiener"][plane][p][j])
                taps[j] = v
                ref["wiener"][plane][p][j] = v
            coef.append(taps)
        params = coef
    elif kind == RESTORE_SGRPROJ:
        s = sd.literal(4)
        xqd = [0, 0]
        for i in range(2):
            radius = SGR_PARAMS[s][i * 2]
            if radius:
                v = _signed_subexp_ref(sd, SGR_MIN[i], SGR_MAX[i] + 1, 4,
                                       ref["sgr"][plane][i])
            else:
                v = 0
                if i == 1:
                    v = max(SGR_MIN[i], min(SGR_MAX[i],
                                            (1 << 7) - ref["sgr"][plane][0]))
            xqd[i] = v
            ref["sgr"][plane][i] = v
        params = (s, xqd)
    td.fs.lr[(plane, ur, uc)] = (kind, params)

def apply(fs, deblocked):
    """Loop restoration of fs.planes (the CDEF output) in place, reading
    the deblocked planes above and below each stripe."""
    h, seq = fs.hdr, fs.seq
    bd = seq.bit_depth
    cdef = [p.copy() for p in fs.planes]
    for plane in range(seq.num_planes):
        if h.lr_type[plane] == RESTORE_NONE:
            continue
        sx = seq.ssx if plane else 0
        sy = seq.ssy if plane else 0
        pw = (h.upscaled_width + sx) >> sx
        ph = (h.height + sy) >> sy
        unit = h.lr_size[plane]
        rows = count_units(unit, ph)
        cols = count_units(unit, pw)
        n = 0
        while True:
            start = (-8 + 64 * n) >> sy
            end = start + (64 >> sy) - 1
            if start > ph - 1:
                break
            y0, y1 = max(start, 0), min(end, ph - 1) + 1
            luma_y = y0 << sy
            ur = min(rows - 1, ((luma_y + 8) >> sy) // unit)
            src = _stripe_source(cdef[plane], deblocked[plane], start, end,
                                 pw, ph, y0, y1)
            for uc in range(cols):
                x0 = uc * unit
                x1 = pw if uc == cols - 1 else min(pw, (uc + 1) * unit)
                if x0 >= x1:
                    continue
                kind, params = fs.lr.get((plane, ur, uc), (RESTORE_NONE, None))
                if kind == RESTORE_WIENER:
                    out = _wiener(src, y0, y1, x0, x1, params, bd)
                elif kind == RESTORE_SGRPROJ:
                    out = _sgr(src, cdef[plane], y0, y1, x0, x1, params, bd)
                else:
                    continue
                fs.planes[plane][y0:y1, x0:x1] = np.clip(out, 0,
                                                         (1 << bd) - 1)
            n += 1


_PAD = 4


def _stripe_source(cdef, deb, start, end, pw, ph, y0, y1):
    """get_source_sample over rows y0-4 .. y1+3 and columns -4 .. pw+3:
    (rows, cols) array and its row / column origin."""
    ys = np.arange(y0 - _PAD, y1 + _PAD)
    yc = np.clip(ys, 0, ph - 1)
    xs = np.clip(np.arange(-_PAD, pw + _PAD), 0, pw - 1)
    out = np.empty((ys.size, xs.size), np.int64)
    for k, y in enumerate(yc):
        if y < start:
            out[k] = deb[max(start - 2, y), xs]
        elif y > end:
            out[k] = deb[min(end + 2, y), xs]
        else:
            out[k] = cdef[y, xs]
    return out, y0 - _PAD, -_PAD


def _wiener(src, y0, y1, x0, x1, coef, bd):
    s, oy, ox = src
    v = _taps(coef[0])
    hf = _taps(coef[1])
    rows = slice(y0 - 3 - oy, y1 + 3 - oy)
    acc = 0
    for t in range(7):
        acc = acc + hf[t] * s[rows, x0 + t - 3 - ox:x1 + t - 3 - ox]
    # InterRound0 / InterRound1 of a single prediction (12 bits: 5 / 9)
    r0, r1 = (5, 9) if bd == 12 else (3, 11)
    offset = 1 << (bd + 7 - r0 - 1)
    limit = (1 << (bd + 1 + 7 - r0)) - 1
    inter = np.clip((acc + (1 << (r0 - 1))) >> r0, -offset, limit - offset)
    hh = y1 - y0
    acc = 0
    for t in range(7):
        acc = acc + v[t] * inter[t:t + hh]
    return (acc + (1 << (r1 - 1))) >> r1


def _taps(c):
    f = [0] * 7
    f[3] = 128
    for i in range(3):
        f[i] = f[6 - i] = c[i]
        f[3] -= 2 * c[i]
    return f


def _box(s, r, ya, yb, xa, xb):
    """Sums of s and s*s over (2r+1)^2 windows centred on rows ya..yb-1,
    columns xa..xb-1 (indices into s)."""
    def csum(a):
        c = np.zeros((a.shape[0] + 1, a.shape[1] + 1), np.int64)
        c[1:, 1:] = a.cumsum(0).cumsum(1)
        return c
    c1, c2 = csum(s), csum(s * s)

    def win(c):
        return (c[ya + r + 1:yb + r + 1, xa + r + 1:xb + r + 1]
                - c[ya - r:yb - r, xa + r + 1:xb + r + 1]
                - c[ya + r + 1:yb + r + 1, xa - r:xb - r]
                + c[ya - r:yb - r, xa - r:xb - r])
    return win(c1), win(c2)


def _sgr(src, cdef, y0, y1, x0, x1, params, bd):
    s, oy, ox = src
    sgr_set, xqd = params
    r0, e0, r1, e1 = SGR_PARAMS[sgr_set]
    u = cdef[y0:y1, x0:x1].astype(np.int64)
    flts = []
    for pass_, (r, scale) in enumerate(((r0, e0), (r1, e1))):
        if not r:
            flts.append(None)
            continue
        ya, yb = y0 - 1 - oy, y1 + 1 - oy
        xa, xb = x0 - 1 - ox, x1 + 1 - ox
        b, a = _box(s, r, ya, yb, xa, xb)
        n = (2 * r + 1) ** 2
        sh = bd - 8    # the sums taken back to 8-bit scale
        d = (b + ((1 << sh) >> 1)) >> sh
        a = (a + ((1 << (2 * sh)) >> 1)) >> (2 * sh)
        p = np.maximum(0, a * n - d * d)
        z = (p * scale + (1 << 19)) >> 20
        a2 = X_BY_XPLUS1[np.minimum(z, 255)]
        one_over_n = ((1 << 12) + n // 2) // n
        b2 = (256 - a2) * b * one_over_n
        A = a2
        B = (b2 + (1 << 11)) >> 12
        hh, ww = y1 - y0, x1 - x0
        sl = lambda M, dy, dx: M[1 + dy:1 + dy + hh, 1 + dx:1 + dx + ww]
        if pass_ == 0:
            odd = ((np.arange(y0, y1) & 1) == 1)[:, None]
            ae = (6 * (sl(A, -1, 0) + sl(A, 1, 0))
                  + 5 * (sl(A, -1, -1) + sl(A, -1, 1) + sl(A, 1, -1) + sl(A, 1, 1)))
            be = (6 * (sl(B, -1, 0) + sl(B, 1, 0))
                  + 5 * (sl(B, -1, -1) + sl(B, -1, 1) + sl(B, 1, -1) + sl(B, 1, 1)))
            ao = 6 * sl(A, 0, 0) + 5 * (sl(A, 0, -1) + sl(A, 0, 1))
            bo = 6 * sl(B, 0, 0) + 5 * (sl(B, 0, -1) + sl(B, 0, 1))
            av = np.where(odd, ao, ae)
            bv = np.where(odd, bo, be)
            shift = np.where(odd, 4, 5)
        else:
            av = (4 * (sl(A, 0, 0) + sl(A, -1, 0) + sl(A, 1, 0) + sl(A, 0, -1)
                       + sl(A, 0, 1))
                  + 3 * (sl(A, -1, -1) + sl(A, -1, 1) + sl(A, 1, -1) + sl(A, 1, 1)))
            bv = (4 * (sl(B, 0, 0) + sl(B, -1, 0) + sl(B, 1, 0) + sl(B, 0, -1)
                       + sl(B, 0, 1))
                  + 3 * (sl(B, -1, -1) + sl(B, -1, 1) + sl(B, 1, -1) + sl(B, 1, 1)))
            shift = 5
        v = av * u + bv
        sh = 8 + shift - 4
        flts.append((v + (1 << (sh - 1))) >> sh)
    w0, w1 = xqd
    w2 = (1 << 7) - w0 - w1
    uu = u << 4
    v = w1 * uu
    v = v + (w0 * flts[0] if flts[0] is not None else w0 * uu)
    v = v + (w2 * flts[1] if flts[1] is not None else w2 * uu)
    return (v + (1 << 10)) >> 11
