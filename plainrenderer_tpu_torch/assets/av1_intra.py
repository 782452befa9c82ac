"""AV1 intra prediction (the AV1 specification, section 7.11.2): the edge
arrays with their availability rules, DC, V, H, Paeth, the three smooth
predictors, directional prediction with the intra edge filter and
upsampling, recursive filter intra, chroma from luma and palette
prediction. Each predictor works on numpy arrays of the block at once.
"""

from __future__ import annotations

import numpy as np

from .av1_cdf import TABLES

DC_PRED, V_PRED, H_PRED, D45, D135, D113, D157, D203, D67 = range(9)
SMOOTH, SMOOTH_V, SMOOTH_H, PAETH = 9, 10, 11, 12
MODE_TO_ANGLE = (0, 90, 180, 45, 135, 113, 157, 203, 67, 0, 0, 0, 0)
_DR = [int(v) for v in TABLES["dr_intra_derivative"]]
_SW = [int(v) for v in TABLES["smooth_weights"]]
_SM = {n: np.array(_SW[n - 4:2 * n - 4], np.int64) for n in (4, 8, 16, 32, 64)}
_FI = TABLES["filter_intra_taps"].astype(np.int64)
_EDGE_KERNEL = ((0, 4, 8, 4, 0), (0, 5, 6, 5, 0), (2, 4, 4, 4, 2))
_OFF = 16   # index of edge[-16]


def _strength(w, h, ftype, delta):
    d = abs(delta)
    wh = w + h
    if ftype == 0:
        if wh <= 8:
            return 1 if d >= 56 else 0
        if wh <= 16:
            return 1 if d >= 40 else 0
        if wh <= 24:
            return 3 if d >= 32 else 2 if d >= 16 else 1 if d >= 8 else 0
        if wh <= 32:
            return 3 if d >= 32 else 2 if d >= 4 else 1 if d >= 1 else 0
        return 3 if d >= 1 else 0
    if wh <= 8:
        return 2 if d >= 64 else 1 if d >= 40 else 0
    if wh <= 16:
        return 2 if d >= 48 else 1 if d >= 20 else 0
    if wh <= 24:
        return 3 if d >= 4 else 0
    return 3 if d >= 1 else 0


def _edge_filter(edge, sz, strength):
    """intra_edge_filter over edge[-1 .. sz-2] (numpy, offset _OFF)."""
    if not strength or sz <= 1:
        return
    k = _EDGE_KERNEL[strength - 1]
    src = edge[_OFF - 1:_OFF - 1 + sz].copy()
    pad = np.concatenate([[src[0]] * 2, src, [src[-1]] * 2])
    out = sum(k[j] * pad[j:j + sz] for j in range(5))
    edge[_OFF:_OFF - 1 + sz] = (out[1:] + 8) >> 4


def _upsample(edge, n, maxv):
    buf = edge[_OFF - 1:_OFF + n].copy()      # buf[-1 .. n-1]
    dup = np.empty(n + 3, np.int64)
    dup[0] = buf[0]
    dup[1:n + 2] = buf
    dup[n + 2] = buf[n]
    s = -dup[:n] + 9 * dup[1:n + 1] + 9 * dup[2:n + 2] - dup[3:n + 3]
    s = np.clip((s + 8) >> 4, 0, maxv)
    edge[_OFF - 2] = dup[0]
    idx = np.arange(n)
    edge[_OFF + 2 * idx - 1] = s
    edge[_OFF + 2 * idx] = dup[2:n + 2]


def predict(frame, x, y, log2w, log2h, mode, angle_delta, have_left,
            have_above, have_above_rt, have_below_lt, max_x, max_y,
            bit_depth, edge_filter, filter_type, filter_mode=None):
    """predict_intra: fills frame[y:y+h, x:x+w] (frame is the plane)."""
    w, h = 1 << log2w, 1 << log2h
    n = w + h
    base = 1 << (bit_depth - 1)
    maxv = (1 << bit_depth) - 1
    above = np.zeros(2 * n + 2 * _OFF, np.int64)
    left = np.zeros(2 * n + 2 * _OFF, np.int64)
    if not have_above and have_left:
        above[_OFF:_OFF + n] = frame[y, x - 1]
    elif not have_above and not have_left:
        above[_OFF:_OFF + n] = base - 1
    else:
        lim = min(max_x, x + (2 * w if have_above_rt else w) - 1)
        cols = np.minimum(np.arange(x, x + n), lim)
        above[_OFF:_OFF + n] = frame[y - 1, cols]
    if not have_left and have_above:
        left[_OFF:_OFF + n] = frame[y - 1, x]
    elif not have_left and not have_above:
        left[_OFF:_OFF + n] = base + 1
    else:
        lim = min(max_y, y + (2 * h if have_below_lt else h) - 1)
        rows = np.minimum(np.arange(y, y + n), lim)
        left[_OFF:_OFF + n] = frame[rows, x - 1]
    if have_above and have_left:
        corner = int(frame[y - 1, x - 1])
    elif have_above:
        corner = int(frame[y - 1, x])
    elif have_left:
        corner = int(frame[y, x - 1])
    else:
        corner = base
    above[_OFF - 1] = left[_OFF - 1] = corner
    A = above[_OFF:_OFF + w]
    L = left[_OFF:_OFF + h]
    if filter_mode is not None:
        pred = _filter_intra(above, left, w, h, filter_mode, maxv)
    elif 1 <= mode <= 8:
        pred = _directional(above, left, w, h, mode, angle_delta, have_left,
                            have_above, x, y, max_x, max_y, maxv,
                            edge_filter, filter_type)
    elif mode == SMOOTH:
        wx, wy = _SM[w], _SM[h]
        p = (wy[:, None] * A[None, :] + (256 - wy[:, None]) * L[h - 1]
             + wx[None, :] * L[:, None] + (256 - wx[None, :]) * A[w - 1])
        pred = (p + 256) >> 9
    elif mode == SMOOTH_V:
        wy = _SM[h]
        pred = (wy[:, None] * A[None, :] + (256 - wy[:, None]) * L[h - 1]
                + 128) >> 8
    elif mode == SMOOTH_H:
        wx = _SM[w]
        pred = (wx[None, :] * L[:, None] + (256 - wx[None, :]) * A[w - 1]
                + 128) >> 8
    elif mode == DC_PRED:
        if have_above and have_left:
            avg = (int(A.sum()) + int(L.sum()) + (n >> 1)) // n
        elif have_above:
            avg = (int(A.sum()) + (w >> 1)) >> log2w
        elif have_left:
            avg = (int(L.sum()) + (h >> 1)) >> log2h
        else:
            avg = base
        pred = np.full((h, w), avg, np.int64)
    else:  # PAETH
        b = A[None, :] + L[:, None] - corner
        pl = np.abs(b - L[:, None])
        pt = np.abs(b - A[None, :])
        ptl = np.abs(b - corner)
        pred = np.where((pl <= pt) & (pl <= ptl), L[:, None],
                        np.where(pt <= ptl, A[None, :], corner))
    frame[y:y + h, x:x + w] = pred


def _directional(above, left, w, h, mode, angle_delta, have_left, have_above,
                 x, y, max_x, max_y, maxv, edge_filter, filter_type):
    p_angle = MODE_TO_ANGLE[mode] + angle_delta * 3
    up_a = up_l = 0
    if edge_filter:
        if p_angle != 90 and p_angle != 180:
            if 90 < p_angle < 180 and (w + h) >= 24:
                s = left[_OFF] * 5 + above[_OFF - 1] * 6 + above[_OFF] * 5
                above[_OFF - 1] = left[_OFF - 1] = (s + 8) >> 4
            if have_above:
                st = _strength(w, h, filter_type, p_angle - 90)
                num = min(w, max_x - x + 1) + (h if p_angle < 90 else 0) + 1
                _edge_filter(above, num, st)
            if have_left:
                st = _strength(w, h, filter_type, p_angle - 180)
                num = min(h, max_y - y + 1) + (w if p_angle > 180 else 0) + 1
                _edge_filter(left, num, st)
        up_a = _use_upsample(w, h, filter_type, p_angle - 90)
        if up_a:
            _upsample(above, w + (h if p_angle < 90 else 0), maxv)
        up_l = _use_upsample(w, h, filter_type, p_angle - 180)
        if up_l:
            _upsample(left, h + (w if p_angle > 180 else 0), maxv)
    i = np.arange(h)[:, None]
    j = np.arange(w)[None, :]
    if p_angle == 90:
        return np.broadcast_to(above[_OFF:_OFF + w][None, :], (h, w)).copy()
    if p_angle == 180:
        return np.broadcast_to(left[_OFF:_OFF + h][:, None], (h, w)).copy()
    if p_angle < 90:
        dx = _DR[p_angle]
        idx = (i + 1) * dx
        base = (idx >> (6 - up_a)) + (j << up_a)
        shift = ((idx << up_a) >> 1) & 0x1F
        max_base = (w + h - 1) << up_a
        b = np.minimum(base, max_base)
        b1 = np.minimum(base + 1, max_base)
        v = (above[_OFF + b] * (32 - shift) + above[_OFF + b1] * shift + 16) >> 5
        return np.where(base < max_base, v, above[_OFF + max_base])
    if p_angle > 180:
        dy = _DR[270 - p_angle]
        idx = (j + 1) * dy
        base = (idx >> (6 - up_l)) + (i << up_l)
        shift = ((idx << up_l) >> 1) & 0x1F
        return (left[_OFF + base] * (32 - shift) + left[_OFF + base + 1] * shift
                + 16) >> 5
    dx = _DR[180 - p_angle]
    dy = _DR[p_angle - 90]
    idx = (j << 6) - (i + 1) * dx
    base = idx >> (6 - up_a)
    use_above = base >= -(1 << up_a)
    shift = ((idx << up_a) >> 1) & 0x1F
    ba = np.where(use_above, base, 0)
    va = (above[_OFF + ba] * (32 - shift) + above[_OFF + ba + 1] * shift + 16) >> 5
    idx2 = (i << 6) - (j + 1) * dy
    base2 = idx2 >> (6 - up_l)
    shift2 = ((idx2 << up_l) >> 1) & 0x1F
    bl = np.where(use_above, 0, base2)
    vl = (left[_OFF + bl] * (32 - shift2) + left[_OFF + bl + 1] * shift2 + 16) >> 5
    return np.where(use_above, va, vl)


def _use_upsample(w, h, ftype, delta):
    d = abs(delta)
    if d <= 0 or d >= 40:
        return 0
    return int(w + h <= (8 if ftype else 16))


def _filter_intra(above, left, w, h, fmode, maxv):
    taps = _FI[fmode]
    pred = np.zeros((h, w), np.int64)
    for i2 in range(h >> 1):
        for j4 in range(w >> 2):
            p = np.empty(7, np.int64)
            for i in range(5):
                if i2 == 0:
                    p[i] = above[_OFF + (j4 << 2) + i - 1]
                elif j4 == 0 and i == 0:
                    p[i] = left[_OFF + (i2 << 1) - 1]
                else:
                    p[i] = pred[(i2 << 1) - 1, (j4 << 2) + i - 1]
            for i in (5, 6):
                if j4 == 0:
                    p[i] = left[_OFF + (i2 << 1) + i - 5]
                else:
                    p[i] = pred[(i2 << 1) + i - 5, (j4 << 2) - 1]
            pr = taps @ p
            v = np.where(pr < 0, -((-pr + 8) >> 4), (pr + 8) >> 4)
            pred[i2 * 2:i2 * 2 + 2, j4 * 4:j4 * 4 + 4] = np.clip(
                v, 0, maxv).reshape(2, 4)
    return pred


def cfl(frame_c, luma, x, y, w, h, subx, suby, max_luma_w, max_luma_h,
        alpha, maxv):
    """predict_chroma_from_luma on the DC prediction in frame_c."""
    cy = np.minimum(np.arange(y, y + h), (max_luma_h >> suby) - 1) << suby
    cx = np.minimum(np.arange(x, x + w), (max_luma_w >> subx) - 1) << subx
    t = np.zeros((h, w), np.int64)
    for dy in range(suby + 1):
        for dx in range(subx + 1):
            t += luma[(cy + dy)[:, None], (cx + dx)[None, :]]
    v = t << (3 - subx - suby)
    shift = (w * h).bit_length() - 1
    avg = (int(v.sum()) + (1 << (shift - 1))) >> shift
    d = alpha * (v - avg)
    scaled = np.where(d < 0, -((-d + 32) >> 6), (d + 32) >> 6)
    frame_c[y:y + h, x:x + w] = np.clip(frame_c[y:y + h, x:x + w] + scaled,
                                        0, maxv)
