"""libaom's quantiser at a qindex for 8-bit streams without quantizer
matrices (av1_build_quantizer, av1_quantize_b_facade's aom_quantize_b,
aom_quantize_b_32x32 and aom_quantize_b_64x64): the DC and AC steps of
the Dc_Qlookup / Ac_Qlookup tables, libaom's quant / quant_shift pair
(invert_quant), its zero bin (84 / 128 of the step, 80 / 128 from a DC
step of 148 up, 64 / 128 at qindex 0) and rounding (48 / 128, 64 / 128 at
qindex 0), both rounded down by the transform's scale (log_scale 1 above
256 coefficients, 2 above 1,024), the rounded magnitude saturated to 16
bits as the SIMD kernels add it; and av1_dropout_qcoeff. With its trellis
off, libaom's intra encode at speed 6 gives quantize_b's levels after
dropout (its trellis path quantizes with quantize_fp and then optimizes,
which the port does not reproduce).
"""

from __future__ import annotations

import numpy as np

from .av1_transform import AC_Q, DC_Q


def _invert(d: int) -> tuple:
    lg = d.bit_length() - 1
    m = 1 + (1 << (16 + lg)) // d
    return m - (1 << 16), 1 << (16 - lg)


def params(qindex: int) -> dict:
    """(DC, AC) steps, quant, quant_shift, zbin and round at qindex."""
    q = max(0, min(255, qindex))
    steps = (int(DC_Q[0, q]), int(AC_Q[0, q]))
    zf = 64 if q == 0 else (84 if steps[0] < 148 else 80)
    rf = 64 if q == 0 else 48
    out = {"step": steps, "quant": [], "shift": [], "zbin": [], "round": []}
    for s in steps:
        qu, sh = _invert(s)
        out["quant"].append(qu)
        out["shift"].append(sh)
        out["zbin"].append((zf * s + 64) >> 7)
        out["round"].append((rf * s) >> 7)
    return out


def log_scale(w: int, h: int) -> int:
    n = w * h
    return 2 if n > 1024 else (1 if n > 256 else 0)


def quantize_b(coef: np.ndarray, qindex: int, ls: int) -> np.ndarray:
    """aom_quantize_b (ls 0), _32x32 (1), _64x64 (2) of a coefficient array
    whose [0, 0] is the DC: the quantized levels with their signs."""
    p = params(qindex)
    c = np.asarray(coef, np.int64)
    ac = np.ones(c.shape, bool)
    ac.flat[0] = False
    pick = lambda k: np.where(ac, p[k][1], p[k][0])   # noqa: E731
    zbin = (pick("zbin") + ((1 << ls) >> 1)) >> ls
    rnd = (pick("round") + ((1 << ls) >> 1)) >> ls
    mag = np.minimum(np.abs(np.clip(c, -32768, 32767)), 32767)
    tmp = np.minimum(mag + rnd, 32767)
    lv = ((((tmp * pick("quant")) >> 16) + tmp) * pick("shift")) >> (16 - ls)
    lv = np.where(mag >= zbin, lv, 0)
    return np.where(c < 0, -lv, lv)


# av1_dropout_qcoeff's constants (encodemb.h)
DROPOUT_Q_MIN, DROPOUT_Q_MAX = 16, 128
DROPOUT_COEFF_MAX, DROPOUT_CONTINUITY_MAX = 2, 2
DROPOUT_BASE_MIN, DROPOUT_BASE_MAX = 16, 32
DROPOUT_MULT_MIN, DROPOUT_MULT_MAX, DROPOUT_MULT_Q_BASE = 2, 8, 32


def dropout(levels: np.ndarray, scan: list, w: int, h: int,
            qindex: int) -> np.ndarray:
    """av1_dropout_qcoeff: runs of at most two levels of magnitude 1 or 2
    between long runs of zeros (in scan order) set to zero. levels is the
    (min(h,32), min(w,32)) array, scan its row-major positions in coding
    order; w, h the transform's size."""
    if qindex > DROPOUT_Q_MAX or qindex < DROPOUT_Q_MIN:
        return levels
    base = max(w, h)
    mult = max(DROPOUT_MULT_MIN, min(DROPOUT_MULT_MAX,
                                     qindex // DROPOUT_MULT_Q_BASE))
    clip = max(DROPOUT_BASE_MIN, min(DROPOUT_BASE_MAX, base))
    before = after = mult * clip
    flat = levels.reshape(-1)
    max_eob = flat.size
    q = [int(flat[p]) for p in scan]
    nz = [i for i, v in enumerate(q) if v]
    eob0 = nz[-1] + 1 if nz else 0
    if eob0 == 0 or eob0 <= before or max_eob <= before + after:
        return levels
    zb = za = cnt = 0
    idx = -1
    for i in range(eob0):
        v = q[i]
        if abs(v) > DROPOUT_COEFF_MAX:
            zb = za = 0
            idx = -1
        elif v == 0:
            if idx == -1:
                zb += 1
            else:
                za += 1
        elif zb >= before:
            idx = i if idx == -1 else idx
            cnt += 1
        else:
            zb = 0
        if cnt > DROPOUT_CONTINUITY_MAX:
            zb = za = cnt = 0
            idx = -1
        if idx != -1 and i == eob0 - 1:
            za += max_eob - eob0
        if za >= after:
            for j in range(idx, i + 1):
                q[j] = 0
            zb += i - idx + 1
            za = cnt = 0
    out = levels.copy()
    o = out.reshape(-1)
    for i, p in enumerate(scan):
        o[p] = q[i]
    return out
