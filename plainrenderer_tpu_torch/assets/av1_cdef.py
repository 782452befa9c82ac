"""AV1 CDEF, the constrained directional enhancement filter (the AV1
specification, section 7.15): per 8x8 luma block that is not all skip, in
64x64 areas with a CDEF index, the direction search on the deblocked luma,
the variance-adjusted primary strength and the primary / secondary taps
with constrain(), samples outside the frame left out; above 8 bits the
search reads the samples shifted down to 8 bits and the strengths and
damping grow by BitDepth - 8. Every 8x8 block of a
plane is filtered at once in numpy; all reads are of the deblocked frame,
so the order of blocks does not matter.
"""

from __future__ import annotations

import numpy as np

DIV_TABLE = (0, 840, 420, 280, 210, 168, 140, 120, 105)
DIRECTIONS = (((-1, 1), (-2, 2)), ((0, 1), (-1, 2)), ((0, 1), (0, 2)),
              ((0, 1), (1, 2)), ((1, 1), (2, 2)), ((1, 0), (2, 1)),
              ((1, 0), (2, 0)), ((1, 0), (2, -1)))
UV_DIR = {(0, 0): (0, 1, 2, 3, 4, 5, 6, 7), (0, 1): (1, 2, 2, 2, 3, 4, 6, 0),
          (1, 0): (7, 0, 2, 4, 5, 6, 6, 6), (1, 1): (0, 1, 2, 3, 4, 5, 6, 7)}
PRI_TAPS = ((4, 2), (3, 3))
SEC_TAPS = ((2, 1), (2, 1))


def _partial_maps():
    maps = np.zeros((8, 64, 15), np.int64)
    for i in range(8):
        for j in range(8):
            k = i * 8 + j
            for d, idx in enumerate((i + j, i + j // 2, i, 3 + i - j // 2,
                                     7 + i - j, 3 - i // 2 + j, j, i // 2 + j)):
                maps[d, k, idx] = 1
    return maps


_MAPS = _partial_maps()


def directions(blocks: np.ndarray, bd: int = 8):
    """cdef_direction for (n, 8, 8) luma blocks of the bit depth: (dir,
    var) arrays."""
    x = (blocks.reshape(-1, 64).astype(np.int64) >> (bd - 8)) - 128
    part = np.einsum("nk,dkp->ndp", x, _MAPS)
    sq = part * part
    cost = np.zeros((x.shape[0], 8), np.int64)
    cost[:, 2] = sq[:, 2, :8].sum(1) * DIV_TABLE[8]
    cost[:, 6] = sq[:, 6, :8].sum(1) * DIV_TABLE[8]
    for d in (0, 4):
        c = sq[:, d, 7] * DIV_TABLE[8]
        for i in range(7):
            c = c + (sq[:, d, i] + sq[:, d, 14 - i]) * DIV_TABLE[i + 1]
        cost[:, d] = c
    for d in (1, 3, 5, 7):
        c = sq[:, d, 3:8].sum(1) * DIV_TABLE[8]
        for j in range(3):
            c = c + (sq[:, d, j] + sq[:, d, 10 - j]) * DIV_TABLE[2 * j + 2]
        cost[:, d] = c
    best = np.zeros(x.shape[0], np.int64)
    best_cost = np.zeros(x.shape[0], np.int64)
    for d in range(8):
        better = cost[:, d] > best_cost
        best = np.where(better, d, best)
        best_cost = np.where(better, cost[:, d], best_cost)
    orth = cost[np.arange(x.shape[0]), (best + 4) & 7]
    return best, (best_cost - orth) >> 10


def _floor_log2(v):
    out = np.zeros_like(v)
    nz = v > 0
    out[nz] = np.floor(np.log2(v[nz])).astype(np.int64)
    return out


def _constrain(diff, thr, damping):
    adj = np.maximum(0, damping - _floor_log2(thr))
    a = np.abs(diff)
    val = np.minimum(a, np.maximum(0, thr - (a >> adj)))
    return np.where(thr == 0, 0, np.where(diff < 0, -val, val))


def apply(fs):
    h, seq = fs.hdr, fs.seq
    mr, mc = h.mi_rows, h.mi_cols
    r8 = np.arange(0, mr, 2)
    c8 = np.arange(0, mc, 2)
    R, C = np.meshgrid(r8, c8, indexing="ij")
    R, C = R.ravel(), C.ravel()
    idx = fs.cdef_idx[R >> 4, C >> 4].astype(np.int64)
    sk = (fs.skip[R, C] & fs.skip[R + 1, C] & fs.skip[R, C + 1]
          & fs.skip[R + 1, C + 1]).astype(bool)
    sel = (idx >= 0) & ~sk
    if not sel.any():
        return
    R, C, idx = R[sel], C[sel], idx[sel]
    luma = fs.planes[0]
    ys = (R * 4)[:, None, None] + np.arange(8)[None, :, None]
    xs = (C * 4)[:, None, None] + np.arange(8)[None, None, :]
    # strengths and damping grow with the bit depth (coeffShift)
    cs = seq.bit_depth - 8
    ydir, var = directions(luma[ys, xs], seq.bit_depth)
    src = [p.copy() for p in fs.planes]
    y_pri = np.array(h.cdef_y_pri, np.int64)[idx] << cs
    y_sec = np.array(h.cdef_y_sec, np.int64)[idx] << cs
    dir_y = np.where(y_pri == 0, 0, ydir)
    vs = np.where((var >> 6) > 0, np.minimum(_floor_log2(var >> 6), 12), 0)
    pri = np.where(var > 0, (y_pri * (4 + vs) + 8) >> 4, 0)
    _filter(fs, src, 0, R, C, pri, y_sec, h.cdef_damping + cs, dir_y, cs)
    if seq.num_planes > 1:
        uv_pri = np.array(h.cdef_uv_pri, np.int64)[idx] << cs
        uv_sec = np.array(h.cdef_uv_sec, np.int64)[idx] << cs
        uvd = np.array(UV_DIR[(seq.ssx, seq.ssy)], np.int64)
        dir_uv = np.where(uv_pri == 0, 0, uvd[ydir])
        for p in (1, 2):
            _filter(fs, src, p, R, C, uv_pri, uv_sec,
                    h.cdef_damping - 1 + cs, dir_uv, cs)


def _filter(fs, src, plane, R, C, pri, sec, damping, dirs, cs):
    h, seq = fs.hdr, fs.seq
    sx = seq.ssx if plane else 0
    sy = seq.ssy if plane else 0
    w, hh = 8 >> sx, 8 >> sy
    frame = src[plane]
    H, W = frame.shape
    lim_y = (h.mi_rows * 4) >> sy
    lim_x = (h.mi_cols * 4) >> sx
    y0 = (R * 4) >> sy
    x0 = (C * 4) >> sx
    n = R.size
    yy = y0[:, None, None] + np.arange(hh)[None, :, None]
    xx = x0[:, None, None] + np.arange(w)[None, None, :]
    x = frame[yy, xx].astype(np.int64)
    pri_b = pri[:, None, None]
    sec_b = sec[:, None, None]
    ptap = np.array(PRI_TAPS, np.int64)[(pri >> cs) & 1]      # (n, 2)
    stap = np.array(SEC_TAPS, np.int64)[(pri >> cs) & 1]
    dirs_a = np.array(DIRECTIONS, np.int64)           # (8, 2, 2)
    total = np.zeros_like(x)
    mx = x.copy()
    mn = x.copy()

    def tap(d, k, sign):
        off = dirs_a[d, k]                            # (n, 2)
        ty = yy + sign * off[:, 0][:, None, None]
        tx = xx + sign * off[:, 1][:, None, None]
        ok = (ty >= 0) & (ty < lim_y) & (tx >= 0) & (tx < lim_x)
        v = frame[np.clip(ty, 0, H - 1), np.clip(tx, 0, W - 1)].astype(np.int64)
        return v, ok

    for k in range(2):
        for sign in (-1, 1):
            v, ok = tap(dirs, k, sign)
            c = ptap[:, k][:, None, None] * _constrain(v - x, pri_b, damping)
            total += np.where(ok, c, 0)
            mx = np.where(ok, np.maximum(mx, v), mx)
            mn = np.where(ok, np.minimum(mn, v), mn)
            for doff in (-2, 2):
                v, ok = tap((dirs + doff) & 7, k, sign)
                c = stap[:, k][:, None, None] * _constrain(v - x, sec_b, damping)
                total += np.where(ok, c, 0)
                mx = np.where(ok, np.maximum(mx, v), mx)
                mn = np.where(ok, np.minimum(mn, v), mn)
    out = np.clip(x + ((8 + total - (total < 0)) >> 4), mn, mx)
    fs.planes[plane][yy, xx] = out
