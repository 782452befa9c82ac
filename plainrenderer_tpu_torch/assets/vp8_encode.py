"""VP8 key-frame encoding without PIL, byte for byte as libwebp 1.6.0
encodes a picture at Pillow's WebP defaults (quality 80, method 4, the
DEFAULT preset: 4 segments, sns 50, filter strength 60, sharpness 0, the
normal loop filter, one token partition, one pass):

  - analysis (src/enc/analysis_enc.c): every macroblock's susceptibility
    ("alpha", 0-255) from the histograms of its forward DCT under the DC
    and TM predictions (luma 16x16 and chroma; the larger of the two,
    mixed 3:1), taken from source samples; a k-means of those alphas into
    4 segments, each with an alpha and beta;
  - segment parameters (src/enc/quant_enc.c VP8SetSegmentParams): quality
    to quantiser with the sns modulation, the chroma DC and AC deltas,
    per-segment filter strengths, segments that came out equal merged, the
    quant matrices (q, 1/q, bias, zero threshold, sharpening) and lambdas;
  - the mode decision at RD_OPT_BASIC (VP8Decimate: PickBestIntra16,
    PickBestIntra4, PickBestUV), each mode scored by rate plus SSE and
    spectral distortion, with the flatness penalties, no trellis; the
    chroma DCs carry the quantisation error of the blocks above and to
    the left (the error diffusion libwebp runs at quality <= 98);
  - tokens recorded against the coefficient probabilities, which are
    refreshed from the running statistics every max(96, mbs / 8)
    macroblocks for the rate estimates and finally chosen against the
    defaults (src/enc/frame_enc.c VP8EncTokenLoop, FinalizeTokenProbas);
    the cat-5 and cat-6 branch's statistics land in the slot of
    probability 9, as libwebp's VP8RecordCoeffTokens puts them;
  - the minimal filter strength of blocky macroblocks
    (VP8AdjustFilterStrength) and the bitstream: boolean encoder, frame
    tag, segment, filter and quant headers, probability updates, modes
    in partition 0 and tokens in partition 1 (src/enc/syntax_enc.c,
    tree_enc.c, src/utils/bit_writer_utils.c).

The cost tables are libwebp's (src/enc/cost_enc.c): the entropy cost of a
probability is its literal table; the level fixed costs, the level codes
and the 4x4 mode costs follow from it and the token and mode trees (the
level costs of 9 and 10 leave out their last bit, as libwebp's table
does); the 16x16 and chroma mode costs are its literal values.
The decoder's tables and transforms (assets/vp8.py) are reused. Per
macroblock numpy, per token Python: fine for textures, not fast.
"""

from __future__ import annotations

import numpy as np

from .vp8 import (_AC_TABLE, _BANDS, _BMODES_PROBA, _CAT3456,
                  _COEFFS_PROBA0, _COEFFS_UPDATE_PROBA, _DC_TABLE,
                  _YMODES_INTRA4, _ZIGZAG, _pred4, _wht, idct_residual)

ENTROPY_COST = tuple(int(x) for x in """
1792 1792 1792 1536 1536 1408 1366 1280 1280 1216 1178 1152 1110 1076
1061 1024 1024 992 968 951 939 911 896 878 871 854 838 820 811 794 786
768 768 752 740 732 720 709 704 690 683 672 666 655 647 640 631 622 615
607 598 592 586 576 572 564 559 555 547 541 534 528 522 512 512 504 500
494 488 483 477 473 467 461 458 452 448 443 438 434 427 424 419 415 410
406 403 399 394 390 384 384 377 374 370 366 362 359 355 351 347 342 342
336 333 330 326 323 320 316 312 308 305 302 299 296 293 288 287 283 280
277 274 272 268 266 262 256 256 256 251 248 245 242 240 237 234 232 228
226 223 221 218 216 214 211 208 205 203 201 198 196 192 191 188 187 183
181 179 176 175 171 171 168 165 163 160 159 156 154 152 150 148 146 144
142 139 138 135 133 131 128 128 125 123 121 119 117 115 113 111 110 107
105 103 102 100 98 96 94 92 91 89 86 86 83 82 80 77 76 74 73 71 69 67 66
64 63 61 59 57 55 54 52 51 49 47 46 44 43 41 40 38 36 35 33 32 30 29 27
25 24 22 21 19 18 16 15 13 12 10 9 7 6 4 3""".split())
FIXED_COSTS_I16 = (663, 919, 872, 919)
FIXED_COSTS_UV = (302, 984, 439, 642)
MAX_LEVEL = 2047
MAX_VARIABLE_LEVEL = 67
_QFIX = 17
# kBiasMatrices (y1, y2, uv) x (dc, ac); kFreqSharpening; kWeightY
_BIAS = ((96, 110), (96, 108), (110, 115))
_SHARPEN = (0, 30, 60, 90, 30, 60, 90, 90, 60, 90, 90, 90, 90, 90, 90, 90)
_WEIGHT_Y = np.array((38, 32, 20, 9, 32, 28, 17, 7, 20, 17, 10, 4, 9, 7, 4,
                      2), np.int64).reshape(4, 4)
_ZZ = np.array(_ZIGZAG)
_FLATNESS_PENALTY = 140
_RD_DISTO_MULT = 256
DC_PRED, TM_PRED, V_PRED, H_PRED = 0, 1, 2, 3


def bit_cost(bit: int, proba: int) -> int:
    """VP8BitCost."""
    return ENTROPY_COST[255 - proba] if bit else ENTROPY_COST[proba]


def _level_path(v: int) -> list:
    """The token tree's (probability index, bit) pairs from p[2] on that
    code |level| v >= 1 (VP8LevelCodes), and its fixed-probability bits
    after them (sign excluded)."""
    path = [(2, int(v > 1))]
    fixed = []
    if v > 1:
        path.append((3, int(v > 4)))
        if v <= 4:
            path.append((4, int(v != 2)))
            if v != 2:
                path.append((5, int(v == 4)))
        else:
            path.append((6, int(v > 10)))
            if v <= 10:
                path.append((7, int(v > 6)))
                if v <= 6:
                    fixed.append((159, int(v == 6)))
                else:
                    fixed += [(165, int(v >= 9)), (145, int(not v & 1))]
            else:
                cat = 0 if v < 19 else 1 if v < 35 else 2 if v < 67 else 3
                path += [(8, cat >> 1), (9 + (cat >> 1), cat & 1)]
                nb = len(_CAT3456[cat])
                r = v - (3 + (8 << cat))
                fixed += [(p, (r >> (nb - 1 - i)) & 1)
                          for i, p in enumerate(_CAT3456[cat])]
    return path, fixed


def _level_tables():
    codes = [_level_path(v)[0] for v in range(1, MAX_VARIABLE_LEVEL + 1)]
    fixed = [0]
    for v in range(1, MAX_LEVEL + 1):
        bits = _level_path(v)[1]
        if v in (9, 10):
            bits = bits[:1]  # libwebp's VP8LevelFixedCosts lacks the 145 bit
        fixed.append(256 + sum(bit_cost(b, p) for p, b in bits))
    return codes, fixed


LEVEL_CODES, LEVEL_FIXED_COSTS = _level_tables()


def _i4_paths():
    """Each 4x4 mode's (node, bit) path down the decoder's mode tree."""
    out = {}

    def walk(i, acc):
        for bit in (0, 1):
            j = _YMODES_INTRA4[2 * i + bit] if i > 0 else _YMODES_INTRA4[bit]
            if j <= 0:
                out[-j] = acc + [(i, bit)]
            else:
                walk(j, acc + [(i, bit)])
    walk(0, [])
    return [out[m] for m in range(10)]


I4_PATHS = _i4_paths()
FIXED_COSTS_I4 = [[[sum(bit_cost(b, _BMODES_PROBA[(t * 10 + l) * 9 + i])
                        for i, b in I4_PATHS[m]) for m in range(10)]
                   for l in range(10)] for t in range(10)]


def _level_cost_table(p: tuple, not_first: bool) -> list:
    """One context's level costs, 0 to MAX_VARIABLE_LEVEL, for the
    probabilities p (the first position's context pays no 'not EOB'
    bit)."""
    cost0 = bit_cost(1, p[0]) if not_first else 0
    base = bit_cost(1, p[1]) + cost0
    return [bit_cost(0, p[1]) + cost0] + [
        base + sum(bit_cost(bit, p[i]) for i, bit in code)
        for code in LEVEL_CODES]


def _cdiv(a: int, b: int) -> int:
    """C integer division (truncates toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


# ------------------------------------------------------------ bit writer

_NORM = [7 - (r + 1).bit_length() + 1 for r in range(127)]
_NEW_RANGE = [((r + 1) << _NORM[r]) - 1 for r in range(127)]


class BoolWriter:
    """libwebp's VP8BitWriter."""

    def __init__(self):
        self.range, self.value, self.run, self.nb_bits = 254, 0, 0, -8
        self.buf = bytearray()

    def put(self, bit: int, prob: int) -> int:
        split = (self.range * prob) >> 8
        if bit:
            self.value += split + 1
            self.range -= split + 1
        else:
            self.range = split
        if self.range < 127:
            shift = _NORM[self.range]
            self.range = _NEW_RANGE[self.range]
            self.value <<= shift
            self.nb_bits += shift
            if self.nb_bits > 0:
                self._flush()
        return bit

    def put_bits(self, value: int, nb: int) -> None:
        for k in range(nb - 1, -1, -1):
            self.put((value >> k) & 1, 128)

    def put_signed(self, value: int, nb: int) -> None:
        if not self.put(int(value != 0), 128):
            return
        self.put_bits(((-value) << 1) | 1 if value < 0 else value << 1,
                      nb + 1)

    def _flush(self):
        s = 8 + self.nb_bits
        bits = self.value >> s
        self.value -= bits << s
        self.nb_bits -= 8
        if (bits & 0xFF) != 0xFF:
            if bits & 0x100 and self.buf:
                self.buf[-1] += 1
            if self.run:
                self.buf.extend((0x00 if bits & 0x100 else 0xFF,) * self.run)
                self.run = 0
            self.buf.append(bits & 0xFF)
        else:
            self.run += 1

    def finish(self) -> bytes:
        self.put_bits(0, 9 - self.nb_bits)
        self.nb_bits = 0
        self._flush()
        return bytes(self.buf)


# ------------------------------------------------------------ transforms

_FDCT_H = np.array([[8, 5352, 8, 2217], [8, 2217, -8, -5352],
                    [8, -2217, -8, 5352], [8, -5352, 8, -2217]], np.int64)
_FDCT_H_ADD = np.array([0, 1812, 0, 937], np.int64)
_FDCT_H_SHIFT = np.array([0, 9, 0, 9], np.int64)
_FDCT_V = np.array([[1, 1, 1, 1], [5352, 2217, -2217, -5352],
                    [1, -1, -1, 1], [2217, -5352, 5352, -2217]], np.int64)
_FDCT_V_ADD = np.array([7, 12000, 7, 51000], np.int64)[:, None]
_FDCT_V_SHIFT = np.array([4, 16, 4, 16], np.int64)[:, None]


def fdct(src, ref):
    """FTransform_C over (..., 4, 4) blocks -> (..., 16) coefficients (each
    pass a 4 x 4 integer product, then its rounding and shift)."""
    d = np.asarray(src, np.int64) - ref
    t = (d @ _FDCT_H + _FDCT_H_ADD) >> _FDCT_H_SHIFT  # rows: [row][k]
    out = (_FDCT_V @ t + _FDCT_V_ADD) >> _FDCT_V_SHIFT  # [freq][k]
    out[..., 1, :] += (t[..., 0, :] != t[..., 3, :])
    return out.reshape(out.shape[:-2] + (16,))


def fwht(dc):
    """FTransformWHT_C: the 16 blocks' DCs (raster order) -> (16,)."""
    i = np.asarray(dc, np.int64).reshape(4, 4)
    a0, a1 = i[:, 0] + i[:, 2], i[:, 1] + i[:, 3]
    a2, a3 = i[:, 1] - i[:, 3], i[:, 0] - i[:, 2]
    t = np.stack([a0 + a1, a3 + a2, a3 - a2, a0 - a1], 1)  # [row][k]
    a0, a1 = t[0] + t[2], t[1] + t[3]
    a2, a3 = t[1] - t[3], t[0] - t[2]
    return (np.stack([a0 + a1, a3 + a2, a3 - a2, a0 - a1]) >> 1).reshape(16)


_HADAMARD = np.array([[1, 1, 1, 1], [1, 1, -1, -1], [1, -1, -1, 1],
                      [1, -1, 1, -1]], np.int64)


def _ttransform(b):
    """TTransform_C over (..., 4, 4) -> weighted sums (...,)."""
    v = _HADAMARD @ (np.asarray(b, np.int64) @ _HADAMARD.T)
    return (np.abs(v) * _WEIGHT_Y).sum(axis=(-2, -1))


def tdisto(a, b):
    """Disto4x4_C per (..., 4, 4) block pair."""
    return np.abs(_ttransform(b) - _ttransform(a)) >> 5


def _blocks(plane, n):
    """(4n, 4m) -> (n * m, 4, 4) in raster order of the 4x4 blocks."""
    h, w = plane.shape
    return plane.reshape(h // 4, 4, w // 4, 4).transpose(0, 2, 1, 3) \
        .reshape(-1, 4, 4)


def _unblocks(blocks, h, w):
    return blocks.reshape(h // 4, w // 4, 4, 4).transpose(0, 2, 1, 3) \
        .reshape(h, w)


class _Matrix:
    """VP8Matrix after ExpandMatrix, in natural coefficient order."""

    def __init__(self, dc: int, ac: int, kind: int):
        self.q = np.array([dc] + [ac] * 15, np.int64)
        iq = (1 << _QFIX) // self.q
        bias = np.array([_BIAS[kind][0]] + [_BIAS[kind][1]] * 15,
                        np.int64) << (_QFIX - 8)
        self.iq, self.bias = iq, bias
        self.zthresh = ((1 << _QFIX) - 1 - bias) // iq
        self.sharpen = (np.array(_SHARPEN, np.int64) * self.q) >> 11 \
            if kind == 0 else np.zeros(16, np.int64)
        self.average = (int(self.q.sum()) + 8) >> 4
        self.zz = [x[_ZZ] for x in (self.q, self.iq, self.bias,
                                    self.zthresh, self.sharpen)]

    def quantize(self, coefs):
        """QuantizeBlock_C on (..., 16) natural coefficients -> (levels in
        zigzag order, dequantized coefficients in natural order)."""
        q, iq, bias, zthresh, sharpen = self.zz
        c = coefs[..., _ZZ]
        coeff = np.abs(c) + sharpen
        level = np.minimum((coeff * iq + bias) >> _QFIX, MAX_LEVEL)
        level *= (coeff > zthresh)
        level = np.where(c < 0, -level, level)
        deq = np.empty_like(level)
        deq[..., _ZZ] = level * q
        return level, deq


class _Segment:
    def __init__(self):
        self.alpha = self.beta = 0
        self.quant = self.fstrength = 0
        self.max_edge = 0


def _pred_mb(mode, top, left, tl, size):
    """VP8EncPredLuma16 / VP8EncPredChroma8 of one mode (top or left None
    where the macroblock has none)."""
    if mode == DC_PRED:
        shift = 5 if size == 16 else 4
        if top is not None:
            s = int(top.sum())
            s += int(left.sum()) if left is not None else s
            v = (s + (1 << (shift - 1))) >> shift
        elif left is not None:
            v = (2 * int(left.sum()) + (1 << (shift - 1))) >> shift
        else:
            v = 0x80
        return np.full((size, size), v, np.int64)
    if mode == TM_PRED:
        if left is not None:
            if top is not None:
                return np.clip(left[:, None] + top[None, :] - tl, 0, 255)
            return np.repeat(left[:, None], size, axis=1)
        if top is not None:
            return np.repeat(top[None, :], size, axis=0)
        return np.full((size, size), 129, np.int64)
    if mode == V_PRED:
        if top is not None:
            return np.repeat(top[None, :], size, axis=0)
        return np.full((size, size), 127, np.int64)
    if left is not None:
        return np.repeat(left[:, None], size, axis=1)
    return np.full((size, size), 129, np.int64)


def _histogram_alpha(src_blocks, pred_blocks) -> int:
    """VP8CollectHistogram then GetAlpha."""
    v = np.minimum(np.abs(fdct(src_blocks, pred_blocks)) >> 3, 31)
    dist = np.bincount(v.reshape(-1), minlength=32)
    nz = np.nonzero(dist)[0]
    max_value = int(dist.max())
    last = int(nz[-1]) if len(nz) else 1
    return 2 * 255 * last // max_value if max_value > 1 else 0


def _uv_blocks(u, v):
    """The 8 chroma 4x4 blocks in VP8DspScan's order (U then V, raster)."""
    return np.concatenate([_blocks(u, 2), _blocks(v, 2)])


class Encoder:
    """One key frame from padded YUV 4:2:0 planes at Pillow's settings."""

    quality, sns, filter_strength, sharpness, n_segments = 80.0, 50, 60, 0, 4

    def __init__(self, y, u, v, width, height):
        self.width, self.height = width, height
        self.mbw, self.mbh = (width + 15) >> 4, (height + 15) >> 4
        hy, wy = 16 * self.mbh, 16 * self.mbw
        self.y = np.pad(y.astype(np.int64), ((0, hy - y.shape[0]),
                                             (0, wy - y.shape[1])), "edge")
        self.u = np.pad(u.astype(np.int64), ((0, hy // 2 - u.shape[0]),
                                             (0, wy // 2 - u.shape[1])),
                        "edge")
        self.v = np.pad(v.astype(np.int64), ((0, hy // 2 - v.shape[0]),
                                             (0, wy // 2 - v.shape[1])),
                        "edge")
        self.segments = [_Segment() for _ in range(4)]
        self.cost_tables = {}
        self.mb_seg = np.zeros((self.mbh, self.mbw), np.int64)
        self.mb_alpha = np.zeros((self.mbh, self.mbw), np.int64)

    # -------------------------------------------------------- analysis

    def _source_bounds(self, plane, x0, y0, size):
        top = plane[y0 - 1, x0:x0 + size] if y0 else None
        left = plane[y0:y0 + size, x0 - 1] if x0 else None
        tl = int(plane[y0 - 1, x0 - 1]) if x0 and y0 else None
        return top, left, tl

    def analyze(self):
        alphas = np.zeros(256, np.int64)
        uv_alpha_sum = 0
        for my in range(self.mbh):
            for mx in range(self.mbw):
                y0, x0 = 16 * my, 16 * mx
                src = _blocks(self.y[y0:y0 + 16, x0:x0 + 16], 4)
                top, left, tl = self._source_bounds(self.y, x0, y0, 16)
                best_alpha = max(
                    _histogram_alpha(src, _blocks(_pred_mb(
                        mode, top, left, tl, 16), 4)) for mode in range(2))
                c0, d0 = 8 * my, 8 * mx
                usrc = _uv_blocks(self.u[c0:c0 + 8, d0:d0 + 8],
                                  self.v[c0:c0 + 8, d0:d0 + 8])
                bounds = [self._source_bounds(p, d0, c0, 8)
                          for p in (self.u, self.v)]
                best_uv = max(
                    _histogram_alpha(usrc, _uv_blocks(
                        _pred_mb(mode, *bounds[0], 8),
                        _pred_mb(mode, *bounds[1], 8))) for mode in range(2))
                mix = (3 * best_alpha + best_uv + 2) >> 2
                mix = min(max(255 - mix, 0), 255)
                alphas[mix] += 1
                self.mb_alpha[my, mx] = mix
                uv_alpha_sum += best_uv
        self.uv_alpha = uv_alpha_sum // (self.mbw * self.mbh)
        self._assign_segments(alphas)

    def _assign_segments(self, alphas):
        nb = self.n_segments
        nzs = np.nonzero(alphas)[0]
        min_a, max_a = int(nzs[0]), int(nzs[-1])
        range_a = max_a - min_a
        centers = [min_a + (n * range_a) // (2 * nb)
                   for n in range(1, 2 * nb, 2)]
        amap = {}
        weighted_average = 0
        for _ in range(6):
            accum = [0] * nb
            dist = [0] * nb
            n = 0
            for a in range(min_a, max_a + 1):
                if alphas[a]:
                    while n + 1 < nb and abs(a - centers[n + 1]) < \
                            abs(a - centers[n]):
                        n += 1
                    amap[a] = n
                    dist[n] += a * int(alphas[a])
                    accum[n] += int(alphas[a])
            displaced = 0
            weighted_average = total = 0
            for n in range(nb):
                if accum[n]:
                    new_center = (dist[n] + accum[n] // 2) // accum[n]
                    displaced += abs(centers[n] - new_center)
                    centers[n] = new_center
                    weighted_average += new_center * accum[n]
                    total += accum[n]
            weighted_average = (weighted_average + total // 2) // total
            if displaced < 5:
                break
        for my in range(self.mbh):
            for mx in range(self.mbw):
                self.mb_seg[my, mx] = amap[int(self.mb_alpha[my, mx])]
        mn, mx_ = min(centers), max(centers)
        if mx_ == mn:
            mx_ = mn + 1
        for n in range(nb):
            alpha = _cdiv(255 * (centers[n] - weighted_average), mx_ - mn)
            beta = _cdiv(255 * (centers[n] - mn), mx_ - mn)
            self.segments[n].alpha = min(max(alpha, -127), 127)
            self.segments[n].beta = min(max(beta, 0), 255)

    # ---------------------------------------------------- segment params

    def set_segment_params(self):
        nseg = self.n_segments
        amp = 0.9 * self.sns / 100. / 128.
        q_ = self.quality / 100.
        linear_c = q_ * (2. / 3.) if q_ < 0.75 else 2. * q_ - 1.
        c_base = linear_c ** (1 / 3.)
        for s in self.segments[:nseg]:
            expn = 1. - amp * s.alpha
            c = c_base ** expn
            s.quant = min(max(int(127. * (1. - c)), 0), 127)
        self.base_quant = self.segments[0].quant
        dq_uv_ac = _cdiv((self.uv_alpha - 64) * (6 - -4), 100 - 30)
        dq_uv_ac = _cdiv(dq_uv_ac * self.sns, 100)
        self.dq_uv_ac = min(max(dq_uv_ac, -4), 6)
        self.dq_uv_dc = min(max(_cdiv(-4 * self.sns, 100), -15), 15)
        level0 = 5 * self.filter_strength
        for s in self.segments:
            qstep = _AC_TABLE[min(max(s.quant, 0), 127)] >> 2
            base = min(qstep, 63)  # kLevelsFromDelta[0] at sharpness 0
            f = base * level0 // (256 + s.beta)
            s.fstrength = 0 if f < 2 else min(f, 63)
        self.filter_level = self.segments[0].fstrength
        if nseg > 1:
            self._simplify_segments()
        self._setup_matrices()

    def _simplify_segments(self):
        """SimplifySegments: equal (quant, filter strength) segments
        merged, the macroblocks remapped, the unused entries copies of the
        last one kept."""
        segs = self.segments
        nseg = self.n_segments
        remap = [0, 1, 2, 3]
        final = 1
        for s1 in range(1, nseg):
            s2 = next((k for k in range(final)
                       if segs[s1].quant == segs[k].quant
                       and segs[s1].fstrength == segs[k].fstrength), final)
            remap[s1] = s2
            if s2 == final:
                segs[final] = segs[s1]
                final += 1
        if final < nseg:
            self.mb_seg = np.array(remap)[self.mb_seg]
            self.n_segments = final
            for i in range(final, nseg):
                segs[i] = _copy_segment(segs[final - 1])

    def _setup_matrices(self):
        for s in self.segments[:self.n_segments]:
            q = s.quant
            s.y1 = _Matrix(_DC_TABLE[min(max(q, 0), 127)],
                           _AC_TABLE[min(max(q, 0), 127)], 0)
            s.y2 = _Matrix(_DC_TABLE[min(max(q, 0), 127)] * 2,
                           max(8, _AC_TABLE[min(max(q, 0), 127)] * 155
                               // 100), 1)
            s.uv = _Matrix(_DC_TABLE[min(max(q + self.dq_uv_dc, 0), 117)],
                           _AC_TABLE[min(max(q + self.dq_uv_ac, 0), 127)], 2)
            q_i4, q_i16, q_uv = s.y1.average, s.y2.average, s.uv.average
            s.lambda_i4 = max(1, (3 * q_i4 * q_i4) >> 7)
            s.lambda_i16 = max(1, 3 * q_i16 * q_i16)
            s.lambda_uv = max(1, (3 * q_uv * q_uv) >> 6)
            s.lambda_mode = max(1, (q_i4 * q_i4) >> 7)
            s.tlambda = max(1, (self.sns * q_i4) >> 5)
            s.min_disto = 20 * int(s.y1.q[0])
            s.max_edge = 0

    def _segment_probas(self):
        p = np.bincount(self.mb_seg.reshape(-1), minlength=4)
        if self.n_segments > 1:
            def get(a, b):
                total = a + b
                return 255 if total == 0 else (255 * a + total // 2) // total
            self.seg_probs = [get(p[0] + p[1], p[2] + p[3]), get(p[0], p[1]),
                              get(p[2], p[3])]
            self.update_map = any(x != 255 for x in self.seg_probs)
            if not self.update_map:
                self.mb_seg[:] = 0
        else:
            self.seg_probs = [255, 255, 255]
            self.update_map = False

    # ------------------------------------------------------ probabilities

    def _reset_probas(self):
        self.coeffs = [[[list(_COEFFS_PROBA0[((t * 8 + b) * 3 + c) * 11:
                                            ((t * 8 + b) * 3 + c + 1) * 11])
                         for c in range(3)] for b in range(8)]
                       for t in range(4)]
        self.dirty = True
        self.stats = [0] * (4 * 8 * 3 * 11)
        self._level_costs()

    def _level_costs(self):
        """VP8CalculateLevelCosts (where the probabilities changed): per
        type, position and context, the cost of each level up to 67."""
        if not self.dirty:
            return
        self.costs = []
        for t in range(4):
            per_band = [[self._cost_table(tuple(self.coeffs[t][b][c]), c > 0)
                         for c in range(3)] for b in range(8)]
            self.costs.append([per_band[_BANDS[n]] for n in range(16)])
        self.dirty = False

    def _cost_table(self, p: tuple, not_first: bool) -> list:
        """_level_cost_table, kept per probabilities: most contexts keep
        theirs between refreshes, and many share them."""
        key = (p, not_first)
        if key not in self.cost_tables:
            self.cost_tables[key] = _level_cost_table(p, not_first)
        return self.cost_tables[key]

    def _finalize_probas(self):
        changed = False
        for t in range(4):
            for b in range(8):
                for c in range(3):
                    for i in range(11):
                        k = ((t * 8 + b) * 3 + c) * 11 + i
                        st = self.stats[k]
                        nb, total = st & 0xFFFF, (st >> 16) & 0xFFFF
                        upd = _COEFFS_UPDATE_PROBA[k]
                        old_p = _COEFFS_PROBA0[k]
                        new_p = 255 - nb * 255 // total if nb else 255
                        old_cost = (nb * bit_cost(1, old_p)
                                    + (total - nb) * bit_cost(0, old_p)
                                    + bit_cost(0, upd))
                        new_cost = (nb * bit_cost(1, new_p)
                                    + (total - nb) * bit_cost(0, new_p)
                                    + bit_cost(1, upd) + 8 * 256)
                        if old_cost > new_cost:
                            self.coeffs[t][b][c][i] = new_p
                            changed |= new_p != old_p
                        else:
                            self.coeffs[t][b][c][i] = old_p
        self.dirty = changed

    def residual_cost(self, t, ctx0, lv, first):
        """VP8GetResidualCost for levels lv (16, zigzag order)."""
        last = -1
        for n in range(15, first - 1, -1):
            if lv[n]:
                last = n
                break
        prob = self.coeffs[t]
        p0 = prob[first][ctx0][0]
        if last < 0:
            return ENTROPY_COST[p0]
        costs = self.costs[t]
        fixed = LEVEL_FIXED_COSTS
        cost = ENTROPY_COST[255 - p0] if ctx0 == 0 else 0
        tbl = costs[first][ctx0]
        for n in range(first, last):
            v = lv[n]
            if v < 0:
                v = -v
            cost += fixed[v] + tbl[v if v < 68 else 67]
            tbl = costs[n + 1][v if v < 2 else 2]
        v = lv[last]
        if v < 0:
            v = -v
        cost += fixed[v] + tbl[v if v < 68 else 67]
        if last < 15:
            cost += ENTROPY_COST[prob[_BANDS[last + 1]][1 if v == 1 else 2][0]]
        return cost

    def _record(self, t, ctx, lv, first):
        """VP8RecordCoeffTokens: tokens and statistics of one block;
        returns whether it has a non-zero level."""
        tokens, stats = self.tokens, self.stats

        def add(bit, idx, sidx):
            tokens.append((bit << 15) | idx)
            st = stats[sidx]
            if st >= 0xFFFE0000:
                st = ((st + 1) >> 1) & 0x7FFF7FFF
            stats[sidx] = st + 0x10000 + bit
            return bit

        def const(bit, prob):
            tokens.append((bit << 15) | 0x4000 | prob)

        last = -1
        for n in range(15, first - 1, -1):
            if lv[n]:
                last = n
                break
        n = first
        base = 11 * (ctx + 3 * (n + 8 * t))
        if not add(int(last >= 0), base, base):
            return 0
        while n < 16:
            c = lv[n]
            n += 1
            v = abs(c)
            if not add(int(v != 0), base + 1, base + 1):
                base = 11 * (3 * (_BANDS[n] + 8 * t))
                continue
            if not add(int(v > 1), base + 2, base + 2):
                nxt = 1
            else:
                if not add(int(v > 4), base + 3, base + 3):
                    if add(int(v != 2), base + 4, base + 4):
                        add(int(v == 4), base + 5, base + 5)
                elif not add(int(v > 10), base + 6, base + 6):
                    if not add(int(v > 6), base + 7, base + 7):
                        const(int(v == 6), 159)
                    else:
                        const(int(v >= 9), 165)
                        const(int(not v & 1), 145)
                else:
                    residue = v - 3
                    if residue < (8 << 1):
                        add(0, base + 8, base + 8)
                        add(0, base + 9, base + 9)
                        residue -= 8 << 0
                        cat = 0
                    elif residue < (8 << 2):
                        add(0, base + 8, base + 8)
                        add(1, base + 9, base + 9)
                        residue -= 8 << 1
                        cat = 1
                    elif residue < (8 << 3):
                        add(1, base + 8, base + 8)
                        add(0, base + 10, base + 9)
                        residue -= 8 << 2
                        cat = 2
                    else:
                        add(1, base + 8, base + 8)
                        add(1, base + 10, base + 9)
                        residue -= 8 << 3
                        cat = 3
                    tab = _CAT3456[cat]
                    nb = len(tab)
                    for i, p in enumerate(tab):
                        const((residue >> (nb - 1 - i)) & 1, p)
                nxt = 2
            base = 11 * (nxt + 3 * (_BANDS[n] + 8 * t))
            const(int(c < 0), 128)
            if n == 16 or not add(int(n <= last), base, base):
                return 1
        return 1

    # ------------------------------------------------------ the frame

    def encode(self) -> bytes:
        self.analyze()
        self.set_segment_params()
        self._segment_probas()
        self._reset_probas()
        self.tokens = []
        mbw, mbh = self.mbw, self.mbh
        self.ry = np.zeros((16 * mbh, 16 * mbw), np.int64)
        self.ru = np.zeros((8 * mbh, 8 * mbw), np.int64)
        self.rv = np.zeros((8 * mbh, 8 * mbw), np.int64)
        # 4x4 mode contexts: preds[4 * my + k][4 * mx + j]
        self.preds = np.zeros((4 * mbh, 4 * mbw), np.int64)
        self.is_i4 = np.zeros((mbh, mbw), bool)
        self.uv_mode = np.zeros((mbh, mbw), np.int64)
        self.top_nz = [[0] * 9 for _ in range(mbw)]
        self.top_derr = [[[0, 0], [0, 0]] for _ in range(mbw)]
        max_count = max((mbw * mbh) >> 3, 96)
        cnt = max_count
        for my in range(mbh):
            self.left_nz = [0] * 9
            self.left_derr = [[0, 0], [0, 0]]
            for mx in range(mbw):
                cnt -= 1
                if cnt < 0:
                    self._finalize_probas()
                    self._level_costs()
                    cnt = max_count
                self._decimate(mx, my)
        self._finalize_probas()
        part1 = BoolWriter()
        p = [v for t in self.coeffs for b in t for c in b for v in c]
        for tok in self.tokens:
            bit = (tok >> 15) & 1
            part1.put(bit, tok & 0xFF if tok & 0x4000 else p[tok & 0x3FFF])
        part1 = part1.finish()
        self._adjust_filter_strength()
        part0 = self._partition0()
        return _frame(part0, part1, self.width, self.height)

    def _adjust_filter_strength(self):
        level = 0
        for s in self.segments:
            if getattr(s, "y2", None) is not None:
                delta = (s.max_edge * int(s.y2.q[1])) >> 3
                lvl = min(delta, 63)
                if lvl > s.fstrength:
                    s.fstrength = lvl
            level = max(level, s.fstrength)
        self.filter_level = level

    def _partition0(self) -> bytes:
        bw = BoolWriter()
        bw.put(0, 128)  # colour space
        bw.put(0, 128)  # clamping type
        segs = self.segments
        if bw.put(int(self.n_segments > 1), 128):
            bw.put(int(self.update_map), 128)
            bw.put(1, 128)  # update data
            bw.put(1, 128)  # absolute values
            for s in segs:
                bw.put_signed(s.quant, 7)
            for s in segs:
                bw.put_signed(s.fstrength, 6)
            if self.update_map:
                for p in self.seg_probs:
                    if bw.put(int(p != 255), 128):
                        bw.put_bits(p, 8)
        bw.put(0, 128)  # normal filter
        bw.put_bits(self.filter_level, 6)
        bw.put_bits(self.sharpness, 3)
        bw.put(0, 128)  # no lf delta
        bw.put_bits(0, 2)  # one token partition
        bw.put_bits(self.base_quant, 7)
        for dq in (0, 0, 0, self.dq_uv_dc, self.dq_uv_ac):
            bw.put_signed(dq, 4)
        bw.put(0, 128)  # no proba update
        k = 0
        for t in self.coeffs:
            for b in t:
                for c in b:
                    for p in c:
                        if bw.put(int(p != _COEFFS_PROBA0[k]),
                                  _COEFFS_UPDATE_PROBA[k]):
                            bw.put_bits(p, 8)
                        k += 1
        bw.put(0, 128)  # no skip probability
        for my in range(self.mbh):
            for mx in range(self.mbw):
                if self.update_map:
                    s = int(self.mb_seg[my, mx])
                    if bw.put(int(s >= 2), self.seg_probs[0]):
                        bw.put(s & 1, self.seg_probs[2])
                    else:
                        bw.put(s & 1, self.seg_probs[1])
                if bw.put(int(not self.is_i4[my, mx]), 145):
                    mode = int(self.preds[4 * my, 4 * mx])
                    if bw.put(int(mode in (TM_PRED, H_PRED)), 156):
                        bw.put(int(mode == TM_PRED), 128)
                    else:
                        bw.put(int(mode == V_PRED), 163)
                else:
                    for j in range(4):
                        for i in range(4):
                            py, px = 4 * my + j, 4 * mx + i
                            top = int(self.preds[py - 1, px]) if py else 0
                            left = int(self.preds[py, px - 1]) if px else 0
                            base = (top * 10 + left) * 9
                            for node, bit in I4_PATHS[int(self.preds[py,
                                                                     px])]:
                                bw.put(bit, _BMODES_PROBA[base + node])
                uv = int(self.uv_mode[my, mx])
                if bw.put(int(uv != DC_PRED), 142):
                    if bw.put(int(uv != V_PRED), 114):
                        bw.put(int(uv == TM_PRED), 183)
        return bw.finish()

    # ------------------------------------------------------ one macroblock

    def _recon_bounds(self, plane, x0, y0, size):
        top = plane[y0 - 1, x0:x0 + size] if y0 else None
        left = plane[y0:y0 + size, x0 - 1] if x0 else None
        if x0 and y0:
            tl = int(plane[y0 - 1, x0 - 1])
        else:
            tl = 129 if y0 else 127
        return top, left, tl

    def _decimate(self, mx, my):
        seg = self.segments[int(self.mb_seg[my, mx])]
        y0, x0 = 16 * my, 16 * mx
        src = self.y[y0:y0 + 16, x0:x0 + 16]
        top, left, tl = self._recon_bounds(self.ry, x0, y0, 16)
        tn, ln = self.top_nz[mx], self.left_nz
        # ---- PickBestIntra16
        src_b = _blocks(src, 4)
        is_flat = bool((src == src[0, 0]).all())
        best = None
        for mode in range(4):
            pred = _pred_mb(mode, top, left, tl, 16)
            pb = _blocks(pred, 4)
            coefs = fdct(src_b, pb)
            dc_lv, dc_deq = seg.y2.quantize(fwht(coefs[:, 0]))
            coefs[:, 0] = 0
            ac_lv, ac_deq = seg.y1.quantize(coefs)
            ac_deq[:, 0] = _wht(dc_deq)
            rec = np.clip(pb + idct_residual(ac_deq), 0, 255)
            nz = (int(dc_lv.any()) << 24) | sum(
                1 << n for n in range(16) if ac_lv[n].any())
            d = int(((src_b - rec) ** 2).sum())
            sd = (seg.tlambda * int(tdisto(src_b, rec).sum()) + 128) >> 8
            h = FIXED_COSTS_I16[mode]
            dcl, acl = dc_lv.tolist(), ac_lv.tolist()
            r = self.residual_cost(1, tn[8] + ln[8], dcl, 0)
            t4, l4 = tn[:4], ln[:4]
            for n in range(16):
                ctx = t4[n & 3] + l4[n >> 2]
                r += self.residual_cost(0, ctx, acl[n], 1)
                t4[n & 3] = l4[n >> 2] = int(ac_lv[n].any())
            if is_flat:
                is_flat = int(np.count_nonzero(ac_lv[:, 1:])) == 0
                if is_flat:
                    d *= 2
                    sd *= 2
            score = (r + h) * seg.lambda_i16 + _RD_DISTO_MULT * (d + sd)
            if mode == 0 or score < best["score"]:
                best = dict(mode=mode, score=score, d=d, sd=sd, r=r, h=h,
                            nz=nz, dc=dcl, ac=acl, rec=rec)
        rd = best
        rd["score"] = (rd["r"] + rd["h"]) * seg.lambda_mode \
            + _RD_DISTO_MULT * (rd["d"] + rd["sd"])
        if (rd["nz"] & 0x100FFFF) == 0x1000000 and rd["d"] > seg.min_disto:
            dcs = rd["dc"]
            seg.max_edge = max(seg.max_edge, abs(dcs[1]), abs(dcs[2]),
                               abs(dcs[4]))
        i4 = self._pick_intra4(mx, my, seg, src, top, left, tl, rd)
        if i4 is None:
            rec_y = _unblocks(rd["rec"], 16, 16)
            self.preds[4 * my:4 * my + 4, 4 * mx:4 * mx + 4] = rd["mode"]
            self.is_i4[my, mx] = False
        else:
            rd, rec_y, modes = i4
            self.preds[4 * my:4 * my + 4, 4 * mx:4 * mx + 4] = \
                np.asarray(modes).reshape(4, 4)
            self.is_i4[my, mx] = True
        self.ry[y0:y0 + 16, x0:x0 + 16] = rec_y
        uv = self._pick_uv(mx, my, seg)
        # ---- RecordTokens
        tn, ln = self.top_nz[mx], self.left_nz
        if not self.is_i4[my, mx]:
            nzdc = self._record(1, tn[8] + ln[8], rd["dc"], 0)
            tn[8] = ln[8] = nzdc
            t, first = 0, 1
        else:
            t, first = 3, 0
        for n in range(16):
            x, y = n & 3, n >> 2
            tn[x] = ln[y] = self._record(t, tn[x] + ln[y], rd["ac"][n],
                                         first)
        for ch in (0, 2):
            for y in range(2):
                for x in range(2):
                    k = 4 + ch
                    tn[k + x] = ln[k + y] = self._record(
                        2, tn[k + x] + ln[k + y], uv[ch * 2 + x + y * 2], 0)

    def _pick_intra4(self, mx, my, seg, src, top, left, tl, rd16):
        y0, x0 = 16 * my, 16 * mx
        wb = [[0] * 21 for _ in range(17)]
        toprow = top.tolist() if top is not None else [127] * 16
        if my == 0:
            tr = [127] * 4
        elif mx == self.mbw - 1:
            tr = [toprow[15]] * 4
        else:
            tr = self.ry[y0 - 1, x0 + 16:x0 + 20].tolist()
        wb[0] = [tl] + toprow + tr
        leftcol = left.tolist() if left is not None else [129] * 16
        for k in range(16):
            wb[k + 1][0] = leftcol[k]
        for k in (4, 8, 12):
            wb[k][17:21] = tr
        tn, ln = self.top_nz[mx][:4], self.left_nz[:4]
        srcl = src
        lam, lam_mode, tlam = seg.lambda_i4, seg.lambda_mode, seg.tlambda
        best_score = 211 * lam_mode
        tot = dict(d=0, sd=0, r=0, h=211, nz=0)
        modes = [0] * 16
        levels = [None] * 16
        header_bits = 0
        for n in range(16):
            by, bx = n >> 2, n & 3
            py, px = 4 * my + by, 4 * mx + bx
            tctx = modes[n - 4] if by else (int(self.preds[py - 1, px])
                                           if py else 0)
            lctx = modes[n - 1] if bx else (int(self.preds[py, px - 1])
                                           if px else 0)
            mode_costs = FIXED_COSTS_I4[tctx][lctx]
            t8 = wb[4 * by][1 + 4 * bx:9 + 4 * bx]
            l4 = [wb[4 * by + 1 + k][4 * bx] for k in range(4)]
            c = wb[4 * by][4 * bx]
            preds = np.array([_pred4(m, t8, l4, c) for m in range(10)],
                             np.int64)
            sb = srcl[4 * by:4 * by + 4, 4 * bx:4 * bx + 4]
            lv, deq = seg.y1.quantize(fdct(sb[None], preds))
            rec = np.clip(preds + idct_residual(deq), 0, 255)
            d = ((sb[None] - rec) ** 2).sum(axis=(1, 2))
            sd = (tlam * tdisto(sb[None], rec) + 128) >> 8
            nzc = np.count_nonzero(lv[:, 1:], axis=1)
            lvl = lv.tolist()
            bm, bs = -1, None
            ctx = tn[bx] + ln[by]
            for m in range(10):
                r = _FLATNESS_PENALTY if m > 0 and nzc[m] <= 3 else 0
                h = mode_costs[m]
                dm, sdm = int(d[m]), int(sd[m])
                score = (r + h) * lam + _RD_DISTO_MULT * (dm + sdm)
                if bm >= 0 and score >= bs[0]:
                    continue
                r += self.residual_cost(3, ctx, lvl[m], 0)
                score = (r + h) * lam + _RD_DISTO_MULT * (dm + sdm)
                if bm < 0 or score < bs[0]:
                    bm = m
                    bs = (score, dm, sdm, r, h, int(any(lvl[m])))
            score, dm, sdm, r, h, nzb = bs
            best_score += (r + h) * lam_mode + _RD_DISTO_MULT * (dm + sdm)
            tot["d"] += dm
            tot["sd"] += sdm
            tot["r"] += r
            tot["h"] += h
            tot["nz"] |= nzb << n
            if best_score >= rd16["score"]:
                return None
            header_bits += h
            if header_bits > 65536:
                return None
            modes[n] = bm
            levels[n] = lvl[bm]
            blk = rec[bm].tolist()
            for yy in range(4):
                wb[4 * by + 1 + yy][1 + 4 * bx:5 + 4 * bx] = blk[yy]
            tn[bx] = ln[by] = nzb
        rd = dict(score=best_score, ac=levels, **tot)
        rec_y = np.asarray(wb, np.int64)[1:17, 1:17]
        return rd, rec_y, modes

    def _correct_dc(self, coefs, mtx, mx):
        """CorrectDCValues: the chroma DCs with the quantisation errors
        of the blocks above and to the left diffused into them (7/16 from
        above, 8/16 from the left, errors halved for storage), quantised
        one by one; returns each plane's errors (err1, err2, err3)."""
        q, iq, bias, zthresh = (int(mtx.q[0]), int(mtx.iq[0]),
                                int(mtx.bias[0]), int(mtx.zthresh[0]))

        def single(k):
            v = int(coefs[k, 0])
            mag = abs(v)
            if mag > zthresh:
                qv = ((mag * iq + bias) >> _QFIX) * q
                coefs[k, 0] = -qv if v < 0 else qv
                err = mag - qv
                return (-err if v < 0 else err) >> 1
            coefs[k, 0] = 0
            return v >> 1

        out = []
        for ch in (0, 1):
            top, left = self.top_derr[mx][ch], self.left_derr[ch]
            b = 4 * ch
            coefs[b, 0] += (7 * top[0] + 8 * left[0]) >> 3
            e0 = single(b)
            coefs[b + 1, 0] += (7 * top[1] + 8 * e0) >> 3
            e1 = single(b + 1)
            coefs[b + 2, 0] += (7 * e0 + 8 * left[1]) >> 3
            e2 = single(b + 2)
            coefs[b + 3, 0] += (7 * e1 + 8 * e2) >> 3
            e3 = single(b + 3)
            out.append((e1, e2, e3))
        return out

    def _pick_uv(self, mx, my, seg):
        c0, d0 = 8 * my, 8 * mx
        src = np.concatenate([self.u[c0:c0 + 8, d0:d0 + 8],
                              self.v[c0:c0 + 8, d0:d0 + 8]], axis=1)
        src_b = _uv_blocks(src[:, :8], src[:, 8:])
        bounds = [self._recon_bounds(p, d0, c0, 8) for p in (self.ru,
                                                             self.rv)]
        tn, ln = self.top_nz[mx], self.left_nz
        best = None
        for mode in range(4):
            pu = _pred_mb(mode, *bounds[0], 8)
            pv = _pred_mb(mode, *bounds[1], 8)
            pb = _uv_blocks(pu, pv)
            coefs = fdct(src_b, pb)
            derr = self._correct_dc(coefs, seg.uv, mx)
            lv, deq = seg.uv.quantize(coefs)
            rec = np.clip(pb + idct_residual(deq), 0, 255)
            d = int(((src_b - rec) ** 2).sum())
            h = FIXED_COSTS_UV[mode]
            lvl = lv.tolist()
            r = 0
            t2, l2 = tn[4:8], ln[4:8]
            for ch in (0, 2):
                for y in range(2):
                    for x in range(2):
                        blk = lvl[ch * 2 + x + y * 2]
                        r += self.residual_cost(2, t2[ch + x] + l2[ch + y],
                                                blk, 0)
                        t2[ch + x] = l2[ch + y] = int(any(blk))
            if mode > 0 and int(np.count_nonzero(lv[:, 1:])) <= 2:
                r += _FLATNESS_PENALTY * 8
            score = (r + h) * seg.lambda_uv + _RD_DISTO_MULT * d
            if mode == 0 or score < best[0]:
                best = (score, mode, lvl, rec, derr)
        _, mode, lvl, rec, derr = best
        self.uv_mode[my, mx] = mode
        for ch in (0, 1):  # StoreDiffusionErrors
            e1, e2, e3 = derr[ch]
            left1 = (3 * e3) >> 2
            self.left_derr[ch] = [e1, left1]
            self.top_derr[mx][ch] = [e2, e3 - left1]
        self.ru[c0:c0 + 8, d0:d0 + 8] = _unblocks(rec[:4], 8, 8)
        self.rv[c0:c0 + 8, d0:d0 + 8] = _unblocks(rec[4:], 8, 8)
        return lvl


def _copy_segment(s):
    c = _Segment()
    c.__dict__.update(s.__dict__)
    return c


def _frame(part0: bytes, part1: bytes, width: int, height: int) -> bytes:
    """The key frame: tag (profile 0, shown, partition 0's size), start
    code, dimensions, then the partitions."""
    if len(part0) >= 1 << 19:
        raise ValueError("VP8 partition 0 overflows its 19-bit size")
    bits = (0 << 1) | (1 << 4) | (len(part0) << 5)
    head = bytes((bits & 0xFF, (bits >> 8) & 0xFF, (bits >> 16) & 0xFF,
                  0x9D, 0x01, 0x2A, width & 0xFF, width >> 8, height & 0xFF,
                  height >> 8))
    return head + part0 + part1


def encode_vp8(y, u, v, width: int, height: int) -> bytes:
    """YUV 4:2:0 planes ((H, W), (ceil(H/2), ceil(W/2)) u8) -> the "VP8 "
    chunk's payload (without the padding byte of an odd size)."""
    return Encoder(y, u, v, width, height).encode()
