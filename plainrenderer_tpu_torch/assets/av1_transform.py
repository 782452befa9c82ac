"""AV1 reconstruction (the AV1 specification, section 7.13): dequantization
with the Dc / Ac lookup tables of the bit depth and the quantizer
matrices, and the inverse DCT (4-64), ADST (4, 8, 16) with flipped ADST,
the identity transforms (4-32) and the Walsh-Hadamard transform of
lossless blocks, with the specification's rounding between passes and,
as dav1d (itx_1d.c), every butterfly sum clipped to its pass's range,
which only a stream outside the specification's ranges reaches. A 1D
transform runs on all columns of a numpy array at once (axis 0 is the
transform axis).
"""

from __future__ import annotations

import math

import numpy as np

from .av1_cdf import DQ_HIGH, TABLES

# Dc_Qlookup and Ac_Qlookup: [(BitDepth - 8) >> 1][q index]
DC_Q = np.stack([TABLES["dc_q"], DQ_HIGH[0, :, 0], DQ_HIGH[1, :, 0]]
                ).astype(np.int64)
AC_Q = np.stack([TABLES["ac_q"], DQ_HIGH[0, :, 1], DQ_HIGH[1, :, 1]]
                ).astype(np.int64)
_COS = [round(4096 * math.cos(math.pi * i / 128)) for i in range(65)]
SINPI = (0, 1321, 2482, 3344, 3803)

(DCT_DCT, ADST_DCT, DCT_ADST, ADST_ADST, FLIPADST_DCT, DCT_FLIPADST,
 FLIPADST_FLIPADST, ADST_FLIPADST, FLIPADST_ADST, IDTX, V_DCT, H_DCT, V_ADST,
 H_ADST, V_FLIPADST, H_FLIPADST) = range(16)
DCT, ADST, FLIP, IDT = 0, 1, 2, 3
# tx type -> (column / vertical 1D type, row / horizontal 1D type)
TX_1D = ((DCT, DCT), (ADST, DCT), (DCT, ADST), (ADST, ADST), (FLIP, DCT),
         (DCT, FLIP), (FLIP, FLIP), (ADST, FLIP), (FLIP, ADST), (IDT, IDT),
         (DCT, IDT), (IDT, DCT), (ADST, IDT), (IDT, ADST), (FLIP, IDT),
         (IDT, FLIP))


def cos128(a: int) -> int:
    a &= 255
    if a <= 64:
        return _COS[a]
    if a <= 128:
        return -_COS[128 - a]
    if a <= 192:
        return -_COS[a - 128]
    return _COS[256 - a]


def sin128(a: int) -> int:
    return cos128(a - 64)


def _brev(n: int, x: int) -> int:
    return int(format(x, f"0{n}b")[::-1], 2) if n else 0


def _B(T, a, b, ang, flip):
    c, s = cos128(ang), sin128(ang)
    x = T[a] * c - T[b] * s
    y = T[a] * s + T[b] * c
    x = (x + 2048) >> 12
    y = (y + 2048) >> 12
    if flip:
        T[a], T[b] = y, x
    else:
        T[a], T[b] = x, y


def _H(T, a, b, flip):
    if flip:
        a, b = b, a
    x, y = T[a], T[b]
    T[a], T[b] = x + y, x - y


def _clipped_H(lo: int, hi: int):
    """_H with its sums clipped to [lo, hi], as dav1d's itx_1d.c clips
    every butterfly's sum and difference (a conformant stream never
    reaches the bounds)."""
    def H(T, a, b, flip):
        _H(T, a, b, flip)
        for k in (a, b):
            T[k] = np.clip(T[k], lo, hi)
    return H


def idct(T: list, n: int, _B=_B, _H=_H) -> list:
    """The inverse DCT of 2**n points on a list of numpy rows (_B and _H
    are the butterfly steps; assets/av1_fwd_transform.py passes recorders
    to read the flow graph off this function)."""
    T = [T[_brev(n, i)] for i in range(1 << n)]
    if n == 6:
        for i in range(16):
            _B(T, 32 + i, 63 - i, 63 - 4 * _brev(4, i), 0)
    if n >= 5:
        for i in range(8):
            _B(T, 16 + i, 31 - i, 6 + (_brev(3, 7 - i) << 3), 0)
    if n == 6:
        for i in range(16):
            _H(T, 32 + i * 2, 33 + i * 2, i & 1)
    if n >= 4:
        for i in range(4):
            _B(T, 8 + i, 15 - i, 12 + (_brev(2, 3 - i) << 4), 0)
    if n >= 5:
        for i in range(8):
            _H(T, 16 + 2 * i, 17 + 2 * i, i & 1)
    if n == 6:
        for i in range(4):
            for j in range(2):
                _B(T, 62 - i * 4 - j, 33 + i * 4 + j,
                   60 - 16 * _brev(2, i) + 64 * j, 1)
    if n >= 3:
        for i in range(2):
            _B(T, 4 + i, 7 - i, 56 - 32 * i, 0)
    if n >= 4:
        for i in range(4):
            _H(T, 8 + 2 * i, 9 + 2 * i, i & 1)
    if n >= 5:
        for i in range(2):
            for j in range(2):
                _B(T, 30 - 4 * i - j, 17 + 4 * i + j,
                   24 + (j << 6) + ((1 - i) << 5), 1)
    if n == 6:
        for i in range(8):
            for j in range(2):
                _H(T, 32 + i * 4 + j, 35 + i * 4 - j, i & 1)
    for i in range(2):
        _B(T, 2 * i, 2 * i + 1, 32 + 16 * i, 1 - i)
    if n >= 3:
        for i in range(2):
            _H(T, 4 + 2 * i, 5 + 2 * i, i)
    if n >= 4:
        for i in range(2):
            _B(T, 14 - i, 9 + i, 48 + 64 * i, 1)
    if n >= 5:
        for i in range(4):
            for j in range(2):
                _H(T, 16 + 4 * i + j, 19 + 4 * i - j, i & 1)
    if n == 6:
        for i in range(2):
            for j in range(4):
                _B(T, 61 - i * 8 - j, 34 + i * 8 + j,
                   56 - i * 32 + (j >> 1) * 64, 1)
    for i in range(2):
        _H(T, i, 3 - i, 0)
    if n >= 3:
        _B(T, 6, 5, 32, 1)
    if n >= 4:
        for i in range(2):
            for j in range(2):
                _H(T, 8 + 4 * i + j, 11 + 4 * i - j, i)
    if n >= 5:
        for i in range(4):
            _B(T, 29 - i, 18 + i, 48 + (i >> 1) * 64, 1)
    if n == 6:
        for i in range(4):
            for j in range(4):
                _H(T, 32 + 8 * i + j, 39 + 8 * i - j, i & 1)
    if n >= 3:
        for i in range(4):
            _H(T, i, 7 - i, 0)
    if n >= 4:
        for i in range(2):
            _B(T, 13 - i, 10 + i, 32, 1)
    if n >= 5:
        for i in range(2):
            for j in range(4):
                _H(T, 16 + i * 8 + j, 23 + i * 8 - j, i)
    if n == 6:
        for i in range(8):
            _B(T, 59 - i, 36 + i, 48 if i < 4 else 112, 1)
    if n >= 4:
        for i in range(8):
            _H(T, i, 15 - i, 0)
    if n >= 5:
        for i in range(4):
            _B(T, 27 - i, 20 + i, 32, 1)
    if n == 6:
        for i in range(8):
            _H(T, 32 + i, 47 - i, 0)
            _H(T, 48 + i, 63 - i, 1)
    if n >= 5:
        for i in range(16):
            _H(T, i, 31 - i, 0)
    if n == 6:
        for i in range(8):
            _B(T, 55 - i, 40 + i, 32, 1)
    if n == 6:
        for i in range(32):
            _H(T, i, 63 - i, 0)
    return T


def iadst4(T: list) -> list:
    x0, x1, x2, x3 = T
    s0 = SINPI[1] * x0
    s1 = SINPI[2] * x0
    s2 = SINPI[3] * x1
    s3 = SINPI[4] * x2
    s4 = SINPI[1] * x2
    s5 = SINPI[2] * x3
    s6 = SINPI[4] * x3
    a7 = x0 - x2
    b7 = a7 + x3
    s0 = s0 + s3
    s1 = s1 - s4
    s3 = s2
    s2 = SINPI[3] * b7
    s0 = s0 + s5
    s1 = s1 - s6
    x0 = s0 + s3
    x1 = s1 + s3
    x2 = s2
    x3 = s0 + s1 - s3
    return [(v + 2048) >> 12 for v in (x0, x1, x2, x3)]


def _hb(w0, a, w1, b):
    return (w0 * a + w1 * b + 2048) >> 12


def _no_clip(v):
    return v


def iadst8(x: list, clip=_no_clip) -> list:
    c = cos128
    b = [x[7], x[0], x[5], x[2], x[3], x[4], x[1], x[6]]
    s = [None] * 8
    for k, a in enumerate((4, 20, 36, 52)):
        p, q = b[2 * k], b[2 * k + 1]
        s[2 * k] = _hb(c(a), p, c(64 - a), q)
        s[2 * k + 1] = _hb(c(64 - a), p, -c(a), q)
    b = [clip(v) for v in [s[i] + s[i + 4] for i in range(4)]
         + [s[i] - s[i + 4] for i in range(4)]]
    s = b[:4] + [_hb(c(16), b[4], c(48), b[5]), _hb(c(48), b[4], -c(16), b[5]),
                 _hb(-c(48), b[6], c(16), b[7]), _hb(c(16), b[6], c(48), b[7])]
    b = [clip(v) for v in (s[0] + s[2], s[1] + s[3], s[0] - s[2], s[1] - s[3],
                           s[4] + s[6], s[5] + s[7], s[4] - s[6], s[5] - s[7])]
    b[2], b[3] = _hb(c(32), b[2], c(32), b[3]), _hb(c(32), b[2], -c(32), b[3])
    b[6], b[7] = _hb(c(32), b[6], c(32), b[7]), _hb(c(32), b[6], -c(32), b[7])
    return [b[0], -b[4], b[6], -b[2], b[3], -b[7], b[5], -b[1]]


def iadst16(x: list, clip=_no_clip) -> list:
    c = cos128
    order = (15, 0, 13, 2, 11, 4, 9, 6, 7, 8, 5, 10, 3, 12, 1, 14)
    b = [x[i] for i in order]
    s = [None] * 16
    for k in range(8):
        a = 2 + 8 * k
        p, q = b[2 * k], b[2 * k + 1]
        s[2 * k] = _hb(c(a), p, c(64 - a), q)
        s[2 * k + 1] = _hb(c(64 - a), p, -c(a), q)
    b = [clip(v) for v in [s[i] + s[i + 8] for i in range(8)]
         + [s[i] - s[i + 8] for i in range(8)]]
    s = b[:8] + [_hb(c(8), b[8], c(56), b[9]), _hb(c(56), b[8], -c(8), b[9]),
                 _hb(c(40), b[10], c(24), b[11]),
                 _hb(c(24), b[10], -c(40), b[11]),
                 _hb(-c(56), b[12], c(8), b[13]), _hb(c(8), b[12], c(56), b[13]),
                 _hb(-c(24), b[14], c(40), b[15]),
                 _hb(c(40), b[14], c(24), b[15])]
    b = list(s)
    for g in (0, 8):
        for i in range(4):
            b[g + i], b[g + i + 4] = (clip(s[g + i] + s[g + i + 4]),
                                      clip(s[g + i] - s[g + i + 4]))
    s = list(b)
    for g in (4, 12):
        s[g] = _hb(c(16), b[g], c(48), b[g + 1])
        s[g + 1] = _hb(c(48), b[g], -c(16), b[g + 1])
        s[g + 2] = _hb(-c(48), b[g + 2], c(16), b[g + 3])
        s[g + 3] = _hb(c(16), b[g + 2], c(48), b[g + 3])
    b = list(s)
    for g in (0, 4, 8, 12):
        for i in range(2):
            b[g + i], b[g + i + 2] = (clip(s[g + i] + s[g + i + 2]),
                                      clip(s[g + i] - s[g + i + 2]))
    for g in (2, 6, 10, 14):
        b[g], b[g + 1] = (_hb(c(32), b[g], c(32), b[g + 1]),
                          _hb(c(32), b[g], -c(32), b[g + 1]))
    return [b[0], -b[8], b[12], -b[4], b[6], -b[14], b[10], -b[2], b[3], -b[11],
            b[15], -b[7], b[5], -b[13], b[9], -b[1]]


def _identity(T: list, n: int) -> list:
    if n == 2:
        return [(v * 5793 + 2048) >> 12 for v in T]
    if n == 3:
        return [v * 2 for v in T]
    if n == 4:
        return [(v * 11586 + 2048) >> 12 for v in T]
    return [v * 4 for v in T]


def _wht(T: list, shift: int) -> list:
    a, c, d, b = (v >> shift for v in T)
    a = a + c
    d = d - b
    e = (a - d) >> 1
    b = e - b
    c = e - c
    a = a - b
    d = d + c
    return [a, b, c, d]


def _t1d(T: list, kind: int, n: int, lo: int, hi: int) -> list:
    """One pass's 1D transforms, their butterfly sums clipped to [lo, hi]
    as dav1d clips them (the identity and 4-point ADST have none)."""
    if kind == DCT:
        return idct(T, n, _H=_clipped_H(lo, hi))
    if kind == IDT:
        return _identity(T, n)
    if n == 2:
        return iadst4(T)
    clip = lambda v: np.clip(v, lo, hi)
    return (iadst8 if n == 3 else iadst16)(T, clip)


ROW_SHIFT = {(2, 2): 0, (3, 3): 1, (4, 4): 2, (5, 5): 2, (6, 6): 2,
             (2, 3): 0, (3, 2): 0, (3, 4): 1, (4, 3): 1, (4, 5): 1,
             (5, 4): 1, (5, 6): 1, (6, 5): 1, (2, 4): 1, (4, 2): 1,
             (3, 5): 2, (5, 3): 2, (4, 6): 2, (6, 4): 2}


def inverse_2d(coef: np.ndarray, log2w: int, log2h: int, tx_type: int,
               lossless: bool, bit_depth: int) -> np.ndarray:
    """The 2D inverse transform of the dequantized (min(h,32), min(w,32))
    coefficients to an (h, w) residual, flips applied."""
    w, h = 1 << log2w, 1 << log2h
    col_kind, row_kind = TX_1D[tx_type]
    if lossless:
        rows = [coef[:, j].astype(np.int64) for j in range(4)]
        rows = _wht(rows, 2)
        res = np.stack(rows, 1)
        cols = _wht([res[i] for i in range(4)], 0)
        return np.stack(cols, 0)
    th, tw = coef.shape
    lim = 1 << (bit_depth + 7)
    clim = 1 << (max(bit_depth + 6, 16) - 1)
    rs = ROW_SHIFT[(log2w, log2h)]
    if tx_type == DCT_DCT and not coef.flat[1:].any():
        # DC only: every butterfly after the first sees zeros, so each pass
        # gives one value everywhere; dav1d's DC-only path clamps nothing
        # between the passes
        d = int(coef[0, 0])
        if abs(log2w - log2h) == 1:
            d = (d * 2896 + 2048) >> 12
        v = (d * 2896 + 2048) >> 12
        if rs:
            v = (v + (1 << (rs - 1))) >> rs
        return np.full((h, w), (((v * 2896 + 2048) >> 12) + 8) >> 4, np.int64)
    nz = np.flatnonzero(np.any(coef != 0, axis=1))
    nrows = int(nz[-1]) + 1 if nz.size else 0
    inp = np.zeros((max(nrows, 1), w), np.int64)
    inp[:nrows, :tw] = coef[:nrows]
    if abs(log2w - log2h) == 1:
        inp = (inp * 2896 + 2048) >> 12
    inp = np.clip(inp, -lim, lim - 1)
    T = [inp[:, j] for j in range(w)]
    T = _t1d(T, ADST if row_kind == FLIP else row_kind, log2w, -lim, lim - 1)
    mid = np.zeros((h, w), np.int64)
    body = np.stack(T, 1)
    if rs:
        body = (body + (1 << (rs - 1))) >> rs
    mid[:body.shape[0]] = body
    mid = np.clip(mid, -clim, clim - 1)
    C = [mid[i] for i in range(h)]
    C = _t1d(C, ADST if col_kind == FLIP else col_kind, log2h, -clim,
             clim - 1)
    out = (np.stack(C, 0) + 8) >> 4
    if col_kind == FLIP:
        out = out[::-1]
    if row_kind == FLIP:
        out = out[:, ::-1]
    return out
