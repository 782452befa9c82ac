"""libaom's forward transforms (av1_fwd_txfm2d_*_c, av1_fwd_txfm1d.c):
DCT 4-64, ADST 4, 8 and 16 with their flipped forms, and the identity
transforms 4-32, on every square and rectangular size, with libaom's
per-size shifts, cos-bit precisions, the sqrt(2) rescale of 2:1
rectangles and the zeroed high half of 64-point sizes.

libaom's forward DCT and ADST are the transposed flow graphs of the
inverse ones: the same butterflies in the opposite order, each rotation
transposed and rounded at the forward cos-bit precision, the output
permutation the inverse of the input one. The DCT's graph is read off
assets/av1_transform.py's ``idct`` (run with recording steps); the
4-point ADST is libaom's av1_fadst4 over its sinpi table. A 1D transform
runs on a list of numpy vectors at once.
"""

from __future__ import annotations

import math

import numpy as np

from . import av1_transform
from .av1_transform import ADST, DCT, FLIP, IDT, TX_1D

# (shift0, shift1, shift2) by (log2 w, log2 h)
FWD_SHIFT = {(2, 2): (2, 0, 0), (3, 3): (2, -1, 0), (4, 4): (2, -2, 0),
             (5, 5): (2, -4, 0), (6, 6): (0, -2, -2), (2, 3): (2, -1, 0),
             (3, 2): (2, -1, 0), (3, 4): (2, -2, 0), (4, 3): (2, -2, 0),
             (4, 5): (2, -4, 0), (5, 4): (2, -4, 0), (5, 6): (0, -2, -2),
             (6, 5): (2, -4, -2), (2, 4): (2, -1, 0), (4, 2): (2, -1, 0),
             (3, 5): (2, -2, 0), (5, 3): (2, -2, 0), (4, 6): (0, -2, 0),
             (6, 4): (2, -4, 0)}
# av1_fwd_cos_bit_col / _row [log2 w - 2][log2 h - 2]
COS_BIT_COL = ((13, 13, 13, 0, 0), (13, 13, 13, 12, 0), (13, 13, 13, 12, 13),
               (0, 13, 13, 12, 13), (0, 0, 13, 12, 13))
COS_BIT_ROW = ((13, 13, 12, 0, 0), (13, 13, 13, 12, 0), (13, 13, 12, 13, 12),
               (0, 12, 13, 12, 11), (0, 0, 12, 11, 10))
# av1_sinpi_arr_data (not all the rounded values: 1901, 4964)
SINPI = {10: (0, 330, 621, 836, 951), 11: (0, 660, 1241, 1672, 1901),
         12: (0, 1321, 2482, 3344, 3803), 13: (0, 2642, 4964, 6689, 7606)}
NEW_SQRT2 = 5793


def _cospi(bit: int) -> list:
    return [round((1 << bit) * math.cos(math.pi * i / 128)) for i in range(65)]


_COSPI = {b: _cospi(b) for b in (10, 11, 12, 13)}


def _cos(bit, a):
    c = _COSPI[bit]
    a &= 255
    if a <= 64:
        return c[a]
    if a <= 128:
        return -c[128 - a]
    if a <= 192:
        return -c[a - 128]
    return c[256 - a]


def _rs(v, bit):
    return (v + (1 << (bit - 1))) >> bit


def _dct_graph(n):
    ops = []
    perm = av1_transform.idct(
        list(range(1 << n)), n,
        _B=lambda T, a, b, ang, flip: ops.append((0, a, b, ang, flip)),
        _H=lambda T, a, b, flip: ops.append((1, a, b, 0, flip)))
    return perm, ops[::-1]


_GRAPHS = {n: _dct_graph(n) for n in range(2, 7)}


def _dct_stages(n, bit):
    """The forward graph's steps grouped into stages of steps on disjoint
    points (so each stage runs on all its pairs at once), each stage as
    its butterflies (a, b) and its rotations (a, b, ka, kb, kc, kd): the
    rotation (ka xa + kb xb, kc xa + kd xb) rounded at bit."""
    perm, ops = _GRAPHS[n]
    stages, cur, used = [], ([], []), set()
    for kind, a, b, ang, flip in ops:
        if a in used or b in used:
            stages.append(cur)
            cur, used = ([], []), set()
        used.update((a, b))
        if kind:
            cur[0].append((b, a) if flip else (a, b))
            continue
        c, s = _cos(bit, ang), _cos(bit, ang - 64)
        if flip:      # [[s, c], [c, -s]] is its own transpose
            cur[1].append((a, b, s, c, c, -s))
        else:         # the transpose of [[c, -s], [s, c]]
            cur[1].append((a, b, c, s, -s, c))
    stages.append(cur)
    out = []
    for bf, rot in stages:
        bf = np.array(bf, np.int64).reshape(-1, 2)
        rot = np.array(rot, np.int64).reshape(-1, 6)
        out.append((bf[:, 0], bf[:, 1], rot[:, 0], rot[:, 1],
                    [rot[:, k][:, None] for k in range(2, 6)]))
    inv = np.empty(len(perm), np.int64)
    inv[np.asarray(perm)] = np.arange(len(perm))
    return inv, out


_STAGES = {}
_STEPS = {}


def fdct(x, n: int, bit: int):
    """The forward DCT of 2**n points (libaom's av1_fdctN) along axis 0 of
    x (a list of numpy vectors or a 2-D array): step by step up to 8
    points, a stage at a time above."""
    key = (n, bit)
    if key not in _STAGES:
        _STAGES[key] = _dct_stages(n, bit)
    inv, stages = _STAGES[key]
    rnd = 1 << (bit - 1)
    if n <= 3:
        if key not in _STEPS:
            steps = []
            for ba, bb, ra, rb, ks in stages:
                steps += [(a, b, None) for a, b in zip(ba.tolist(), bb.tolist())]
                steps += [(a, b, tuple(int(k[i, 0]) for k in ks))
                          for i, (a, b) in enumerate(zip(ra.tolist(), rb.tolist()))]
            _STEPS[key] = steps
        T = list(x)
        for a, b, k in _STEPS[key]:
            xa, xb = T[a], T[b]
            if k is None:
                T[a], T[b] = xa + xb, xa - xb
            else:
                T[a] = (k[0] * xa + k[1] * xb + rnd) >> bit
                T[b] = (k[2] * xa + k[3] * xb + rnd) >> bit
        return [T[i] for i in inv.tolist()]
    T = np.array(x, np.int64)
    for ba, bb, ra, rb, (ka, kb, kc, kd) in stages:
        if ba.size:
            xa, xb = T[ba], T[bb]
            T[ba], T[bb] = xa + xb, xa - xb
        if ra.size:
            xa, xb = T[ra], T[rb]
            T[ra] = (ka * xa + kb * xb + rnd) >> bit
            T[rb] = (kc * xa + kd * xb + rnd) >> bit
    return T[inv]


def fadst4(x: list, bit: int) -> list:
    sp = SINPI[bit]
    x0, x1, x2, x3 = x
    s0, s1 = sp[1] * x0, sp[4] * x0
    s2, s3 = sp[2] * x1, sp[1] * x1
    s4 = sp[3] * x2
    s5, s6 = sp[4] * x3, sp[2] * x3
    s7 = x0 + x1 - x3
    x0 = s0 + s2
    x1 = sp[3] * s7
    x2 = s1 - s3
    x3 = s4
    x0 = x0 + s5
    x2 = x2 + s6
    o0 = x0 + x3
    o2 = x2 - x3
    o3 = x2 - x0 + x3
    return [_rs(v, bit) for v in (o0, x1, o2, o3)]


def _rot(bit, w0, a, w1, b):
    return _rs(w0 * a + w1 * b, bit)


def fadst8(x: list, bit: int) -> list:
    c = lambda a: _cos(bit, a)   # noqa: E731
    b = [x[0], -x[7], -x[3], x[4], -x[1], x[6], x[2], -x[5]]
    for g in (2, 6):
        b[g], b[g + 1] = (_rot(bit, c(32), b[g], c(32), b[g + 1]),
                          _rot(bit, c(32), b[g], -c(32), b[g + 1]))
    b = [b[0] + b[2], b[1] + b[3], b[0] - b[2], b[1] - b[3],
         b[4] + b[6], b[5] + b[7], b[4] - b[6], b[5] - b[7]]
    b = b[:4] + [_rot(bit, c(16), b[4], c(48), b[5]),
                 _rot(bit, c(48), b[4], -c(16), b[5]),
                 _rot(bit, -c(48), b[6], c(16), b[7]),
                 _rot(bit, c(16), b[6], c(48), b[7])]
    b = [b[i] + b[i + 4] for i in range(4)] + [b[i] - b[i + 4] for i in range(4)]
    s = [None] * 8
    for k, a in enumerate((4, 20, 36, 52)):
        p, q = b[2 * k], b[2 * k + 1]
        s[2 * k] = _rot(bit, c(a), p, c(64 - a), q)
        s[2 * k + 1] = _rot(bit, c(64 - a), p, -c(a), q)
    order = (7, 0, 5, 2, 3, 4, 1, 6)
    out = [None] * 8
    for j, o in enumerate(order):
        out[o] = s[j]
    return out


def fadst16(x: list, bit: int) -> list:
    c = lambda a: _cos(bit, a)   # noqa: E731
    b = [None] * 16
    for k, (j, sg) in enumerate(((0, 1), (8, -1), (12, 1), (4, -1), (6, 1),
                                 (14, -1), (10, 1), (2, -1), (3, 1), (11, -1),
                                 (15, 1), (7, -1), (5, 1), (13, -1), (9, 1),
                                 (1, -1))):
        b[j] = x[k] if sg > 0 else -x[k]
    for g in (2, 6, 10, 14):
        b[g], b[g + 1] = (_rot(bit, c(32), b[g], c(32), b[g + 1]),
                          _rot(bit, c(32), b[g], -c(32), b[g + 1]))
    s = list(b)
    for g in (0, 4, 8, 12):
        for i in range(2):
            s[g + i], s[g + i + 2] = b[g + i] + b[g + i + 2], b[g + i] - b[g + i + 2]
    b = list(s)
    for g in (4, 12):
        b[g] = _rot(bit, c(16), s[g], c(48), s[g + 1])
        b[g + 1] = _rot(bit, c(48), s[g], -c(16), s[g + 1])
        b[g + 2] = _rot(bit, -c(48), s[g + 2], c(16), s[g + 3])
        b[g + 3] = _rot(bit, c(16), s[g + 2], c(48), s[g + 3])
    s = list(b)
    for g in (0, 8):
        for i in range(4):
            s[g + i], s[g + i + 4] = b[g + i] + b[g + i + 4], b[g + i] - b[g + i + 4]
    b = s[:8] + [_rot(bit, c(8), s[8], c(56), s[9]),
                 _rot(bit, c(56), s[8], -c(8), s[9]),
                 _rot(bit, c(40), s[10], c(24), s[11]),
                 _rot(bit, c(24), s[10], -c(40), s[11]),
                 _rot(bit, -c(56), s[12], c(8), s[13]),
                 _rot(bit, c(8), s[12], c(56), s[13]),
                 _rot(bit, -c(24), s[14], c(40), s[15]),
                 _rot(bit, c(40), s[14], c(24), s[15])]
    s = [b[i] + b[i + 8] for i in range(8)] + [b[i] - b[i + 8] for i in range(8)]
    t = [None] * 16
    for k in range(8):
        a = 2 + 8 * k
        p, q = s[2 * k], s[2 * k + 1]
        t[2 * k] = _rot(bit, c(a), p, c(64 - a), q)
        t[2 * k + 1] = _rot(bit, c(64 - a), p, -c(a), q)
    order = (15, 0, 13, 2, 11, 4, 9, 6, 7, 8, 5, 10, 3, 12, 1, 14)
    out = [None] * 16
    for j, o in enumerate(order):
        out[o] = t[j]
    return out


def fidentity(x: list, n: int) -> list:
    if n == 2:
        return [_rs(v * NEW_SQRT2, 12) for v in x]
    if n == 3:
        return [v * 2 for v in x]
    if n == 4:
        return [_rs(v * (2 * NEW_SQRT2), 12) for v in x]
    return [v * 4 for v in x]


def _f1d(x: list, kind: int, n: int, bit: int) -> list:
    if kind == DCT:
        return fdct(x, n, bit)
    if kind == IDT:
        return fidentity(x, n)
    if n == 2:
        return fadst4(x, bit)
    if n == 3:
        return fadst8(x, bit)
    return fadst16(x, bit)


def _round_shift(a: np.ndarray, s: int) -> np.ndarray:
    """a rounded right by s bits, or shifted left by -s."""
    if s > 0:
        return (a + (1 << (s - 1))) >> s
    return a << -s


def forward_2d(residual: np.ndarray, tx_type: int) -> np.ndarray:
    """The (min(h,32), min(w,32)) coefficients of an (h, w) residual,
    rows the vertical frequency, as libaom's av1_fwd_txfm2d_* gives them."""
    res = np.asarray(residual, np.int64)
    h, w = res.shape
    lw, lh = w.bit_length() - 1, h.bit_length() - 1
    col_kind, row_kind = TX_1D[tx_type]
    s0, s1, s2 = FWD_SHIFT[(lw, lh)]
    bc = COS_BIT_COL[lw - 2][lh - 2]
    br = COS_BIT_ROW[lw - 2][lh - 2]
    a = res[::-1] if col_kind == FLIP else res
    a = _round_shift(a, -s0)
    a = np.asarray(_f1d(a, ADST if col_kind == FLIP else col_kind, lh, bc))
    a = _round_shift(a, -s1)
    if row_kind == FLIP:
        a = a[:, ::-1]
    a = np.asarray(_f1d(a.T, ADST if row_kind == FLIP else row_kind, lw, br)).T
    a = _round_shift(a, -s2)
    if abs(lw - lh) == 1:
        a = _rs(a * NEW_SQRT2, 12)
    return a[:min(h, 32), :min(w, 32)]
