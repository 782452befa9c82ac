"""AV1 deblocking (the AV1 specification, section 7.14): per plane, every
vertical edge, then every horizontal edge, each 4-sample edge segment with
its transform and block edge rules, filter size, level (segment feature,
delta lf, reference delta), limits (shifted by BitDepth - 8) and the 4 /
6 / 8 / 14-tap filters.

Within one pass the filters of different edges read and write disjoint
samples (an edge's filter length is bounded by the transform sizes on both
sides), so a pass runs on its edges at once in numpy (in raster-order
chunks of _EDGES, which bound the filters' arrays on a large frame) and
gives the specification's sequential result.
"""

from __future__ import annotations

import numpy as np

from .av1_block import BLOCK_DIMS, TX_DIMS

_BW = np.array([d[0] for d in BLOCK_DIMS], np.int32)
_BH = np.array([d[1] for d in BLOCK_DIMS], np.int32)
_TW = np.array([d[0] for d in TX_DIMS], np.int32)
_TH = np.array([d[1] for d in TX_DIMS], np.int32)
_EDGES = 1 << 16   # 4-sample edge segments filtered at once


def apply(fs):
    h, seq = fs.hdr, fs.seq
    if not (h.lf_level[0] or h.lf_level[1]):
        return
    for plane in range(seq.num_planes):
        if plane and not h.lf_level[1 + plane]:
            continue
        for pass_ in (0, 1):
            _pass(fs, plane, pass_)


def _levels(fs, plane, pass_, mr, mc):
    h = fs.hdr
    i = pass_ if plane == 0 else plane + 1
    seg = fs.seg_id[mr, mc]
    if h.delta_lf_multi:
        dlf = fs.delta_lf[mr, mc, i].astype(np.int32)
    else:
        dlf = fs.delta_lf[mr, mc, 0].astype(np.int32)
    lvl = np.clip(dlf + h.lf_level[i], 0, 63)
    if h.seg_enabled:
        feat = np.array([h.seg_feature[s][1 + i] for s in range(8)], bool)[seg]
        data = np.array([h.seg_data[s][1 + i] for s in range(8)], np.int32)[seg]
        lvl = np.where(feat, np.clip(lvl + data, 0, 63), lvl)
    if h.lf_delta_enabled:
        lvl = np.clip(lvl + (h.lf_ref_deltas[0] << (lvl >> 5)), 0, 63)
    return lvl


def _pass(fs, plane, pass_):
    h, seq = fs.hdr, fs.seq
    sx = seq.ssx if plane else 0
    sy = seq.ssy if plane else 0
    rows4, cols4 = h.mi_rows >> sy, h.mi_cols >> sx
    if rows4 == 0 or cols4 == 0:
        return
    i = np.arange(rows4)[:, None]
    j = np.arange(cols4)[None, :]
    on = ((j << sx) * 4 < h.width) & ((i << sy) * 4 < h.height)
    if pass_ == 0:
        on = on & (j > 0)
    else:
        on = on & (i > 0)
    mr = np.broadcast_to((i << sy) | sy, (rows4, cols4))
    mc = np.broadcast_to((j << sx) | sx, (rows4, cols4))
    bsize = fs.mi_size[mr, mc]
    pw = np.maximum(4, _BW[bsize] >> sx)
    ph = np.maximum(4, _BH[bsize] >> sy)
    lf_tx = fs.lf_tx[plane][:rows4, :cols4]
    if pass_ == 0:
        prev_tx = np.concatenate([lf_tx[:, :1], lf_tx[:, :-1]], 1)
        pos = np.broadcast_to(j * 4, (rows4, cols4))
        block_edge = pos % pw == 0
        tx_edge = pos % _TW[lf_tx] == 0
        base = np.minimum(_TW[prev_tx], _TW[lf_tx])
        pmr, pmc = mr, mc - (1 << sx)
    else:
        prev_tx = np.concatenate([lf_tx[:1], lf_tx[:-1]], 0)
        pos = np.broadcast_to(i * 4, (rows4, cols4))
        block_edge = pos % ph == 0
        tx_edge = pos % _TH[lf_tx] == 0
        base = np.minimum(_TH[prev_tx], _TH[lf_tx])
        pmr, pmc = mr - (1 << sy), mc
    skip = fs.skip[mr, mc] != 0
    intra = fs.is_inter[mr, mc] == 0
    # inner transform edges of a skipped block are left alone only when it
    # is an inter (intra block copy) block
    apply_ = on & tx_edge & (block_edge | ~skip | intra)
    size = np.minimum(16 if plane == 0 else 8, base)
    lvl = _levels(fs, plane, pass_, mr, mc)
    prev_lvl = _levels(fs, plane, pass_, np.maximum(pmr, 0), np.maximum(pmc, 0))
    lvl = np.where(lvl == 0, prev_lvl, lvl)
    apply_ &= lvl > 0
    ei, ej = np.nonzero(apply_)
    if ei.size == 0:
        return
    lv = lvl[ei, ej]
    sz = size[ei, ej]
    sharp = h.lf_sharpness
    shift = 2 if sharp > 4 else (1 if sharp > 0 else 0)
    if sharp > 0:
        limit = np.clip(lv >> shift, 1, 9 - sharp)
    else:
        limit = np.maximum(1, lv >> shift)
    blimit = 2 * (lv + 2) + limit
    thresh = lv >> 4
    bd = seq.bit_depth
    shift = bd - 8
    # four sample lines per edge segment
    k = np.arange(4)
    for a in range(0, ei.size, _EDGES):
        e = slice(a, a + _EDGES)
        if pass_ == 0:
            ys = (ei[e, None] * 4 + k[None, :]).ravel()
            xs = np.repeat(ej[e] * 4, 4)
        else:
            ys = np.repeat(ei[e] * 4, 4)
            xs = (ej[e, None] * 4 + k[None, :]).ravel()
        rep = lambda v: np.repeat(v[e], 4)
        _filter(fs.planes[plane], ys, xs, pass_, rep(sz),
                rep(limit) << shift, rep(blimit) << shift,
                rep(thresh) << shift, plane, bd)


def _filter(frame, ys, xs, pass_, size, limit, blimit, thresh, plane, bd):
    """The edge segments' filters; limit, blimit and thresh are already
    shifted to the bit depth."""
    H, W = frame.shape
    off = np.arange(-7, 7)
    if pass_ == 0:
        yy = ys[:, None] + 0 * off[None, :]
        xx = np.clip(xs[:, None] + off[None, :], 0, W - 1)
    else:
        yy = np.clip(ys[:, None] + off[None, :], 0, H - 1)
        xx = xs[:, None] + 0 * off[None, :]
    s = frame[yy, xx].astype(np.int64)    # columns: p6..p0 q0..q6
    p = [s[:, 6 - n] for n in range(7)]
    q = [s[:, 7 + n] for n in range(7)]
    ad = lambda a, b: np.abs(a - b)
    hev = (ad(p[1], p[0]) > thresh) | (ad(q[1], q[0]) > thresh)
    mask = ((ad(p[1], p[0]) <= limit) & (ad(q[1], q[0]) <= limit)
            & (ad(p[0], q[0]) * 2 + (ad(p[1], q[1]) >> 1) <= blimit))
    is6 = (size >= 8) & (plane > 0)
    is8 = (size >= 8) & (plane == 0)
    m6 = (ad(p[2], p[1]) <= limit) & (ad(q[2], q[1]) <= limit)
    m8 = m6 & (ad(p[3], p[2]) <= limit) & (ad(q[3], q[2]) <= limit)
    mask = mask & np.where(is6, m6, True) & np.where(is8, m8, True)
    one = 1 << (bd - 8)
    flat6 = ((ad(p[1], p[0]) <= one) & (ad(q[1], q[0]) <= one)
             & (ad(p[2], p[0]) <= one) & (ad(q[2], q[0]) <= one))
    flat8 = flat6 & (ad(p[3], p[0]) <= one) & (ad(q[3], q[0]) <= one)
    flat = np.where(plane > 0, flat6, flat8) & (size >= 8)
    flat2 = ((size >= 16) & (ad(p[6], p[0]) <= one) & (ad(q[6], q[0]) <= one)
             & (ad(p[5], p[0]) <= one) & (ad(q[5], q[0]) <= one)
             & (ad(p[4], p[0]) <= one) & (ad(q[4], q[0]) <= one))
    narrow = mask & ((size == 4) | ~flat)
    wide8 = mask & ~narrow & ((size == 8) | ~flat2)
    wide16 = mask & ~narrow & ~wide8
    out = s.copy()
    if narrow.any():
        half = 1 << (bd - 1)    # 0x80 << (bd - 8), and filter4_clamp's
        c = lambda v: np.clip(v, -half, half - 1)
        ps1, ps0, qs0, qs1 = p[1] - half, p[0] - half, q[0] - half, q[1] - half
        f = np.where(hev, c(ps1 - qs1), 0)
        f = c(f + 3 * (qs0 - ps0))
        f1 = c(f + 4) >> 3
        f2 = c(f + 3) >> 3
        oq0 = c(qs0 - f1) + half
        op0 = c(ps0 + f2) + half
        f = (f1 + 1) >> 1
        oq1 = np.where(hev, q[1], c(qs1 - f) + half)
        op1 = np.where(hev, p[1], c(ps1 + f) + half)
        for col, v in ((5, op1), (6, op0), (7, oq0), (8, oq1)):
            out[:, col] = np.where(narrow, v, out[:, col])
    for sel, log2 in ((wide8, 3), (wide16, 4)):
        if not sel.any():
            continue
        if log2 == 4:
            n, n2 = 6, 1
        elif plane == 0:
            n, n2 = 3, 0
        else:
            n, n2 = 2, 1
        F = {k: (p[-k - 1] if k < 0 else q[k]) for k in range(-(n + 1), n + 1)}
        for i in range(-n, n):
            t = 0
            for jj in range(-n, n + 1):
                pk = max(-(n + 1), min(n, i + jj))
                tap = 2 if abs(jj) <= n2 else 1
                t = t + F[pk] * tap
            v = (t + (1 << (log2 - 1))) >> log2
            col = 7 + i
            out[:, col] = np.where(sel, v, out[:, col])
    cols = np.arange(14)[None, :]
    n8 = 3 if plane == 0 else 2
    wmask = ((narrow[:, None] & (cols >= 5) & (cols <= 8))
             | (wide8[:, None] & (cols >= 7 - n8) & (cols < 7 + n8))
             | (wide16[:, None] & (cols >= 1) & (cols <= 12)))
    if wmask.any():
        frame[yy[wmask], xx[wmask]] = out[wmask]
