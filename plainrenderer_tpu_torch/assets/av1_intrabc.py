"""AV1 intra block copy (the AV1 specification, sections 5.11.26-32,
7.10.2 and 7.11.3, for a block with use_intrabc): the reference vector
stack from the neighbouring intrabc blocks (rows and columns 1, 3 and 5
away, the top-right and top-left points, weights, the stable bubble sort,
the global zero fill and the clamp), the default vector when the first two
are zero, the vector read (joint, sign, class, class0 bit, bits; integer
precision) with dav1d's repair of a vector outside the decoded area, and
the prediction: a bilinear 2D filter over the current frame before any
post filter, which for an integer luma vector is a copy.
"""

from __future__ import annotations

import copy

import numpy as np

from .av1_obu import AV1Error

REF_CAT_LEVEL = 640
MAX_STACK = 8
MV_BORDER = 128
INTRABC_DELAY_PIXELS = 256


def _lower_precision(mv):
    out = []
    for v in mv:
        a = (abs(v) + 3) >> 3
        out.append(a << 3 if v > 0 else -(a << 3))
    return tuple(out)


class _Stack:
    def __init__(self, td):
        self.td = td
        self.mvs = []
        self.weights = []

    def add(self, r, c, weight):
        fs = self.td.fs
        if not fs.is_inter[r, c]:
            return
        mv = _lower_precision((int(fs.mvs[r, c, 0]), int(fs.mvs[r, c, 1])))
        if mv in self.mvs:
            self.weights[self.mvs.index(mv)] += weight
        elif len(self.mvs) < MAX_STACK:
            self.mvs.append(mv)
            self.weights.append(weight)

    def scan_row(self, delta_row):
        td = self.td
        dims = td.block_dims
        bw4 = td.bw4
        end4 = min(min(bw4, td.h.mi_cols - td.mi_col), 16)
        delta_col = 0
        step16 = bw4 >= 16
        if abs(delta_row) > 1:
            delta_row += td.mi_row & 1
            delta_col = 1 - (td.mi_col & 1)
        i = 0
        while i < end4:
            r = td.mi_row + delta_row
            c = td.mi_col + delta_col + i
            if not td._inside(r, c):
                break
            n = min(bw4, dims[td.fs.mi_size[r, c]][0] >> 2)
            if abs(delta_row) > 1:
                n = max(2, n)
            if step16:
                n = max(4, n)
            self.add(r, c, n * 2)
            i += n

    def scan_col(self, delta_col):
        td = self.td
        dims = td.block_dims
        bh4 = td.bh4
        end4 = min(min(bh4, td.h.mi_rows - td.mi_row), 16)
        delta_row = 0
        step16 = bh4 >= 16
        if abs(delta_col) > 1:
            delta_row = 1 - (td.mi_row & 1)
            delta_col += td.mi_col & 1
        i = 0
        while i < end4:
            r = td.mi_row + delta_row + i
            c = td.mi_col + delta_col
            if not td._inside(r, c):
                break
            n = min(bh4, dims[td.fs.mi_size[r, c]][1] >> 2)
            if abs(delta_col) > 1:
                n = max(2, n)
            if step16:
                n = max(4, n)
            self.add(r, c, n * 2)
            i += n

    def scan_point(self, delta_row, delta_col):
        td = self.td
        r, c = td.mi_row + delta_row, td.mi_col + delta_col
        if td._inside(r, c) and td.fs.decoded_mi[r, c]:
            self.add(r, c, 4)

    def sort(self, start, end):
        w, m = self.weights, self.mvs
        while end > start:
            new_end = start
            for i in range(start + 1, end):
                if w[i - 1] < w[i]:
                    w[i - 1], w[i] = w[i], w[i - 1]
                    m[i - 1], m[i] = m[i], m[i - 1]
                    new_end = i
            end = new_end


def ref_stack(td):
    """find_mv_stack for an intrabc block: the first two clamped vectors
    (the match flags and contexts it also derives steer no intrabc
    syntax, so they are left out)."""
    bw4, bh4 = td.bw4, td.bh4
    s = _Stack(td)
    s.scan_row(-1)
    s.scan_col(-1)
    if max(bw4, bh4) <= 16:
        s.scan_point(-1, bw4)
    nearest = len(s.mvs)
    for i in range(nearest):
        s.weights[i] += REF_CAT_LEVEL
    s.scan_point(-1, -1)
    s.scan_row(-3)
    s.scan_col(-3)
    if bh4 > 1:
        s.scan_row(-5)
    if bw4 > 1:
        s.scan_col(-5)
    s.sort(0, nearest)
    s.sort(nearest, len(s.mvs))
    h = td.h
    out = []
    for mv in s.mvs:
        top = -((td.mi_row * 4) * 8)
        bottom = ((h.mi_rows - bh4 - td.mi_row) * 4) * 8
        lft = -((td.mi_col * 4) * 8)
        rgt = ((h.mi_cols - bw4 - td.mi_col) * 4) * 8
        out.append((max(top - (MV_BORDER + bh4 * 32),
                        min(bottom + MV_BORDER + bh4 * 32, mv[0])),
                    max(lft - (MV_BORDER + bw4 * 32),
                        min(rgt + MV_BORDER + bw4 * 32, mv[1]))))
    while len(out) < 2:
        out.append((0, 0))
    return out


def read_dv(td):
    """assign_mv for use_intrabc: the predicted vector plus the read one,
    in 1/8 sample units (row, column)."""
    stack = ref_stack(td)
    pred = stack[0]
    if pred == (0, 0):
        pred = stack[1]
    if pred == (0, 0):
        sb4 = 32 if td.seq.use_128 else 16
        if td.mi_row - sb4 < td.r0:
            pred = (0, -(sb4 * 4 + INTRABC_DELAY_PIXELS) * 8)
        else:
            pred = (-(sb4 * 4 * 8), 0)
    sd, mc = td.sd, td.mv_cdfs
    joint = sd.symbol(mc["joint"])
    diff = [0, 0]
    if joint in (2, 3):
        diff[0] = _component(sd, mc["comp"][0])
    if joint in (1, 3):
        diff[1] = _component(sd, mc["comp"][1])
    return (pred[0] + diff[0], pred[1] + diff[1])


def clip_dv(td, dv, bsize):
    """dav1d's repair of a vector that reaches outside the decoded part of
    the tile (decode.c, after read_mv_residual): the source block moved
    inside the tile's left, right and top edges, then out of the current
    superblock (up into the row above where it fits, else left) and up
    into the current superblock row; a vector that still overlaps the
    current superblock fails the frame, as dav1d fails it."""
    bw4, bh4 = (d >> 2 for d in td.block_dims[bsize])
    left, top = td.c0 * 4, td.r0 * 4
    if td.has_chroma:
        left += 4 if bw4 < 2 and td.seq.ssx else 0
        top += 4 if bh4 < 2 and td.seq.ssy else 0
    x0 = td.mi_col * 4 + (dv[1] >> 3)
    y0 = td.mi_row * 4 + (dv[0] >> 3)
    x1, y1 = x0 + bw4 * 4, y0 + bh4 * 4
    right = ((td.c1 + bw4 - 1) & ~(bw4 - 1)) * 4
    if x0 < left:
        x1, x0 = x1 + left - x0, left
    elif x1 > right:
        x0, x1 = x0 - (x1 - right), right
    if y0 < top:
        y1, y0 = y1 + top - y0, top
    lg = 4 + td.seq.use_128
    sbx = (td.mi_col >> lg) << (lg + 2)
    sby = (td.mi_row >> lg) << (lg + 2)
    if y1 > sby and x1 > sbx:
        if y0 - top >= y1 - sby:
            y0, y1 = y0 - (y1 - sby), sby
        elif x0 - left >= x1 - sbx:
            x0, x1 = x0 - (x1 - sbx), sbx
    if y1 > sby + (4 << lg):
        y0, y1 = y0 - (y1 - sby - (4 << lg)), sby + (4 << lg)
    if y1 > sby and x1 > sbx:
        raise AV1Error("AV1 intra block copy vector overlaps the current "
                       "superblock")
    return ((y0 - td.mi_row * 4) * 8, (x0 - td.mi_col * 4) * 8)


def _component(sd, c):
    sign = sd.symbol(c["sign"])
    cls = sd.symbol(c["class"])
    if cls == 0:
        bit = sd.symbol(c["class0_bit"])
        mag = ((bit << 3) | (3 << 1) | 1) + 1
    else:
        d = 0
        for i in range(cls):
            d |= sd.symbol(c["bits"][i]) << i
        mag = (2 << (cls + 2)) + ((d << 3) | (3 << 1) | 1) + 1
    return -mag if sign else mag


def mv_cdfs(cdfs):
    """The intrabc context's vector CDFs (a copy of the defaults)."""
    comp = {"sign": cdfs["mv_sign"], "class": cdfs["mv_class"],
            "class0_bit": cdfs["mv_class0_bit"], "bits": cdfs["mv_bits"]}
    return {"joint": copy.deepcopy(cdfs["mv_joint"]),
            "comp": [copy.deepcopy(comp), copy.deepcopy(comp)]}


def predict(td, plane):
    """The block's prediction in one plane from the frame decoded so far."""
    fs, seq, h = td.fs, td.seq, td.h
    sx = seq.ssx if plane else 0
    sy = seq.ssy if plane else 0
    pw, ph = td.block_dims[td._residual_size(plane)]
    x0 = (td.mi_col >> sx) * 4
    y0 = (td.mi_row >> sy) * 4
    mvr, mvc = td.dv
    ref = fs.planes[plane]
    # dav1d clamps an intra block copy's reads to the decoded area, the
    # frame rounded up to 8 samples, not to the visible frame
    last_x = ((h.mi_cols * 4) >> sx) - 1
    last_y = ((h.mi_rows * 4) >> sy) - 1
    start_x = (((x0 << 4) + ((2 * mvc) >> sx)) << 6) + 32
    start_y = (((y0 << 4) + ((2 * mvr) >> sy)) << 6) + 32
    # BILINEAR taps: [.., 128 - 8f, 8f, ..] at the 3rd and 4th of 8
    ih = (((ph - 1) * 1024 + 1023) >> 10) + 8
    rows = np.clip((start_y >> 10) + np.arange(ih) - 3, 0, last_y)
    xs = start_x + 1024 * np.arange(pw)
    fx = (xs >> 6) & 15
    c0 = np.clip((xs >> 10), 0, last_x)
    c1 = np.clip((xs >> 10) + 1, 0, last_x)
    block = ref[rows].astype(np.int64)
    # InterRound0 / InterRound1 of a single prediction: 3 / 11, at 12 bits
    # 5 / 9
    r0_, r1_ = (5, 9) if seq.bit_depth == 12 else (3, 11)
    inter = (((128 - 8 * fx) * block[:, c0] + 8 * fx * block[:, c1]
              + (1 << (r0_ - 1))) >> r0_)
    ys = (start_y & 1023) + 1024 * np.arange(ph)
    fy = ((ys >> 6) & 15)[:, None]
    r0 = (ys >> 10) + 3
    pred = (((128 - 8 * fy) * inter[r0] + 8 * fy * inter[r0 + 1]
             + (1 << (r1_ - 1))) >> r1_)
    ref[y0:y0 + ph, x0:x0 + pw] = np.clip(pred, 0, (1 << seq.bit_depth) - 1)
