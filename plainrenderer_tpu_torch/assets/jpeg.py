"""JPEG decoding without PIL, bit-equal to libjpeg(-turbo) as PIL runs it
(``Image.open(path).convert("RGBA")``; the JAX package's load_image reads
JPEG textures so, plainrenderer_tpu/assets/image_io.py:36-40).

Covered: baseline and extended sequential Huffman coding, 8-bit samples;
progressive Huffman coding (spectral selection and successive
approximation, DC and AC, first and refinement scans, EOB runs); restart
intervals; grayscale, YCbCr and RGB (Adobe APP14 transform 0, or the
component ids 'R', 'G', 'B' without JFIF); four components, CMYK (Adobe
transform 0, or no Adobe marker) and YCCK (any other transform), which
PIL reads as Adobe's inverted CMYK ("CMYK;I") and converts to RGB; any
integral sampling factors (4:4:4, 4:2:2, 4:4:0, 4:2:0, ...) and image
sizes that are not multiples of the MCU. 12-bit samples, arithmetic
coding, lossless and hierarchical modes raise ValueError naming the
feature.

The entropy decoder is the one sequential part: a Python loop over the
scan's Huffman symbols, table-driven (a 16-bit lookahead table per
Huffman table gives symbol and code length in one index, and the bit
reader reads every field from a precomputed list of 32-bit windows).
Everything after it is vectorised with numpy over all blocks at once,
with libjpeg's integer rules:
  - dequantisation and jidctint.c's "islow" IDCT (CONST_BITS 13,
    PASS1_BITS 2, 64-bit intermediates, the range-limit table's 10-bit
    wrap-around);
  - jdsample.c's fancy upsampling: h2v1 and h2v2 (the triangle filter,
    its alternating +1 / +2 and +8 / +7 biases) when the component is
    wider than 2 samples, h1v2 (+1 / +2), plain replication for the
    other integral ratios; edges replicate the last real sample row and
    column (jdmainct.c's context rows, the last-column special cases);
  - jdcolor.c's fixed-point YCbCr -> RGB tables (SCALEBITS 16).
A progressive file whose scans stop before coefficients 1-9 are complete
is block-smoothed as libjpeg-turbo 3.1 does it (jdcoefct.c smoothing_ok
and decompress_smooth_data): the missing low-frequency coefficients are
estimated from the DC values of the 5 x 5 block neighbourhood, with the
DC itself re-estimated when no AC scan has arrived (the variant of
libjpeg-turbo 2.1 and later).
"""

from __future__ import annotations

import numpy as np

from . import modes

EOI, SOS, DHT, DQT, DRI = 0xD9, 0xDA, 0xC4, 0xDB, 0xDD
# zigzag index -> natural (row-major) index (jutils.c jpeg_natural_order)
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
_NATURAL = ZIGZAG.tolist()
_UNSUPPORTED_SOF = {
    0xC3: "lossless mode", 0xC5: "hierarchical (differential) mode",
    0xC6: "hierarchical (differential) mode",
    0xC7: "hierarchical lossless mode", 0xC9: "arithmetic coding",
    0xCA: "arithmetic coding", 0xCB: "arithmetic coding (lossless)",
    0xCD: "arithmetic coding", 0xCE: "arithmetic coding",
    0xCF: "arithmetic coding (lossless)"}


class _Component:
    def __init__(self, cid, h, v, tq):
        self.id, self.h, self.v, self.tq = cid, h, v, tq
        self.coefs = None  # flat list: block (row-major) * 64 + natural
        self.quant = None  # latched at the component's first scan
        self.dc_pred = 0
        # progressive status (jdphuff.c): the successive-approximation bit
        # each coefficient was last refined to (-1: never), and the same
        # before the latest scan that included the component
        self.coef_bits = [-1] * 64
        self.prev_bits = [0] * 64


def _huffman_table(counts, symbols):
    """The lookahead table of one Huffman table: entry [peek16] = code
    length << 8 | symbol for every 16-bit window that starts with a code
    (0: no code starts it)."""
    table = np.zeros(1 << 16, np.int64)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            if code >= 1 << length:
                raise ValueError("JPEG: bad Huffman table")
            lo = code << (16 - length)
            table[lo:lo + (1 << (16 - length))] = length << 8 | symbols[k]
            code += 1
            k += 1
        code <<= 1
    return table.tolist()


class _Bits:
    """MSB-first bit reader over one entropy-coded segment (stuffed zero
    bytes removed); past its end it reads zero bits, as libjpeg does."""

    def __init__(self, seg: bytes):
        raw = np.frombuffer(seg.replace(b"\xff\x00", b"\xff") + b"\0" * 8,
                            np.uint8).astype(np.int64)
        self.win = ((raw[:-3] << 24) | (raw[1:-2] << 16) | (raw[2:-1] << 8)
                    | raw[3:]).tolist()
        self.pos = 0


def _receive_extend(bits, s):
    """s bits as the JPEG magnitude category's signed value."""
    pos = bits.pos
    v = (bits.win[pos >> 3] >> (32 - (pos & 7) - s)) & ((1 << s) - 1)
    bits.pos = pos + s
    return v if v >= 1 << (s - 1) else v - (1 << s) + 1


def _decode(bits, table):
    pos = bits.pos
    e = table[(bits.win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
    if not e:
        raise ValueError("JPEG: corrupt Huffman code")
    bits.pos = pos + (e >> 8)
    return e & 0xFF


def _get(bits, n):
    pos = bits.pos
    bits.pos = pos + n
    return (bits.win[pos >> 3] >> (32 - (pos & 7) - n)) & ((1 << n) - 1)


class _Frame:
    def __init__(self):
        self.progressive = False
        self.width = self.height = 0
        self.comps = []
        self.qt = {}
        self.dc_tables, self.ac_tables = {}, {}
        self.restart = 0
        self.adobe = None
        self.jfif = False
        self.eobrun = 0
        self.scans = 0  # cinfo->input_scan_number


def _parse_sof(fr, body, marker):
    if marker in _UNSUPPORTED_SOF:
        raise ValueError(f"JPEG: {_UNSUPPORTED_SOF[marker]} is not supported")
    if body[0] != 8:
        raise ValueError(f"JPEG: {body[0]}-bit samples are not supported "
                         "(8-bit only)")
    fr.progressive = marker == 0xC2
    fr.height = body[1] << 8 | body[2]
    fr.width = body[3] << 8 | body[4]
    n = body[5]
    if fr.height == 0 or fr.width == 0:
        raise ValueError("JPEG: empty image (or a DNL marker height)")
    if n not in (1, 3, 4):
        raise ValueError(f"JPEG: {n} components are not supported")
    for i in range(n):
        cid, hv, tq = body[6 + 3 * i:9 + 3 * i]
        fr.comps.append(_Component(cid, hv >> 4, hv & 15, tq))
    fr.hmax = max(c.h for c in fr.comps)
    fr.vmax = max(c.v for c in fr.comps)
    fr.mcux = -(-fr.width // (8 * fr.hmax))
    fr.mcuy = -(-fr.height // (8 * fr.vmax))
    for c in fr.comps:
        if fr.hmax % c.h or fr.vmax % c.v:
            raise ValueError("JPEG: fractional sampling factors are not "
                             "supported")
        c.bw, c.bh = fr.mcux * c.h, fr.mcuy * c.v  # blocks incl. MCU pad
        # the component's own size and block grid (non-interleaved scans)
        c.w = -(-fr.width * c.h // fr.hmax)
        c.hgt = -(-fr.height * c.v // fr.vmax)
        c.nbx, c.nby = -(-c.w // 8), -(-c.hgt // 8)
        c.coefs = [0] * (c.bw * c.bh * 64)


def _parse_dht(fr, body):
    i = 0
    while i < len(body):
        tc_th = body[i]
        counts = list(body[i + 1:i + 17])
        n = sum(counts)
        symbols = list(body[i + 17:i + 17 + n])
        (fr.ac_tables if tc_th >> 4 else fr.dc_tables)[tc_th & 15] = \
            _huffman_table(counts, symbols)
        i += 17 + n


def _parse_dqt(fr, body):
    i = 0
    while i < len(body):
        pq, tq = body[i] >> 4, body[i] & 15
        if pq:
            vals = np.frombuffer(body[i + 1:i + 129], ">u2").astype(np.int64)
            i += 129
        else:
            vals = np.frombuffer(body[i + 1:i + 65], np.uint8) \
                .astype(np.int64)
            i += 65
        q = np.zeros(64, np.int64)
        q[ZIGZAG] = vals
        fr.qt[tq] = q


def _segments(data, start):
    """Entropy-coded segments of the scan at data[start:], split at RST
    markers; returns (segments, the offset of the next marker)."""
    segs, i, seg_start = [], start, start
    n = len(data)
    while True:
        j = data.find(b"\xff", i)
        if j < 0 or j + 1 >= n:
            segs.append(data[seg_start:])
            return segs, n
        nxt = data[j + 1]
        if nxt == 0:  # a stuffed zero byte
            i = j + 2
        elif 0xD0 <= nxt <= 0xD7:
            segs.append(data[seg_start:j])
            seg_start = i = j + 2
        elif nxt == 0xFF:  # fill bytes before a marker
            i = j + 1
        else:
            segs.append(data[seg_start:j])
            return segs, j


def _block_order(fr, comps):
    """For one scan: the list of (component, block index) in decode order,
    grouped per MCU (MCUs in raster order); a single-component scan's MCU
    is one block of the component's own grid."""
    if len(comps) == 1:
        c = comps[0]
        mcus = [[(c, by * c.bw + bx)] for by in range(c.nby)
                for bx in range(c.nbx)]
        return mcus
    mcus = []
    for my in range(fr.mcuy):
        for mx in range(fr.mcux):
            mcu = []
            for c in comps:
                for v in range(c.v):
                    row = (my * c.v + v) * c.bw + mx * c.h
                    mcu.extend((c, row + h) for h in range(c.h))
            mcus.append(mcu)
    return mcus


def _decode_scan(fr, body, data, start):
    ns = body[0]
    by_id = {c.id: c for c in fr.comps}
    comps, tables = [], []
    for i in range(ns):
        cid, td_ta = body[1 + 2 * i], body[2 + 2 * i]
        c = by_id[cid]
        if c.quant is None:
            c.quant = fr.qt[c.tq]
        comps.append(c)
        tables.append((td_ta >> 4, td_ta & 15))
    ss, se = body[1 + 2 * ns], body[2 + 2 * ns]
    ah, al = body[3 + 2 * ns] >> 4, body[3 + 2 * ns] & 15
    fr.scans += 1
    if fr.progressive:  # start_pass_phuff_decoder's status update
        for c in comps:
            for k in range(min(ss, 1), max(se, 9) + 1):
                c.prev_bits[k] = c.coef_bits[k] if fr.scans > 1 else 0
            for k in range(ss, se + 1):
                c.coef_bits[k] = al
    segs, end = _segments(data, start)
    mcus = _block_order(fr, comps)
    per = fr.restart or len(mcus)
    dc_tab = {id(c): fr.dc_tables.get(t[0]) for c, t in zip(comps, tables)}
    ac_tab = {id(c): fr.ac_tables.get(t[1]) for c, t in zip(comps, tables)}
    if not fr.progressive:
        kind = "sequential"
    elif ss == 0:
        kind = "dc_first" if ah == 0 else "dc_refine"
    else:
        kind = "ac_first" if ah == 0 else "ac_refine"
        if len(comps) != 1:
            raise ValueError("JPEG: an interleaved progressive AC scan")
    for k in range(0, len(mcus), per):
        bits = _Bits(segs[k // per] if k // per < len(segs) else b"")
        for c in comps:
            c.dc_pred = 0
        fr.eobrun = 0
        for mcu in mcus[k:k + per]:
            for c, blk in mcu:
                base = blk * 64
                if kind == "sequential":
                    _block_sequential(bits, c, base, dc_tab[id(c)],
                                      ac_tab[id(c)])
                elif kind == "dc_first":
                    s = _decode(bits, dc_tab[id(c)])
                    if s:
                        c.dc_pred += _receive_extend(bits, s)
                    c.coefs[base] = c.dc_pred << al
                elif kind == "dc_refine":
                    if _get(bits, 1):
                        c.coefs[base] |= 1 << al
                elif kind == "ac_first":
                    _block_ac_first(fr, bits, c.coefs, base, ac_tab[id(c)],
                                    ss, se, al)
                else:
                    _block_ac_refine(fr, bits, c.coefs, base, ac_tab[id(c)],
                                     ss, se, al)
    return end


def _block_sequential(bits, c, base, dc, ac):
    """One block of a sequential scan: _decode and _receive_extend
    inlined (the decoder's hottest loop)."""
    coefs, win, pos, natural = c.coefs, bits.win, bits.pos, _NATURAL
    e = dc[(win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
    if not e:
        raise ValueError("JPEG: corrupt Huffman code")
    pos += e >> 8
    s = e & 0xFF
    if s:
        v = (win[pos >> 3] >> (32 - (pos & 7) - s)) & ((1 << s) - 1)
        pos += s
        c.dc_pred += v if v >= 1 << (s - 1) else v - (1 << s) + 1
    coefs[base] = c.dc_pred
    k = 1
    while k < 64:
        e = ac[(win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
        if not e:
            raise ValueError("JPEG: corrupt Huffman code")
        pos += e >> 8
        s = e & 15
        if s:
            k += (e >> 4) & 15
            v = (win[pos >> 3] >> (32 - (pos & 7) - s)) & ((1 << s) - 1)
            pos += s
            coefs[base + natural[k]] = v if v >= 1 << (s - 1) \
                else v - (1 << s) + 1
            k += 1
        elif (e & 0xF0) == 0xF0:
            k += 16
        else:
            break
    bits.pos = pos


def _block_ac_first(fr, bits, coefs, base, ac, ss, se, al):
    if fr.eobrun > 0:
        fr.eobrun -= 1
        return
    k = ss
    while k <= se:
        rs = _decode(bits, ac)
        r, s = rs >> 4, rs & 15
        if s:
            k += r
            coefs[base + _NATURAL[k]] = _receive_extend(bits, s) << al
        elif r == 15:
            k += 15
        else:
            fr.eobrun = (1 << r) + (_get(bits, r) if r else 0) - 1
            return
        k += 1


def _block_ac_refine(fr, bits, coefs, base, ac, ss, se, al):
    p1, m1 = 1 << al, -1 << al
    k = ss
    if fr.eobrun == 0:
        while k <= se:
            rs = _decode(bits, ac)
            r, s = rs >> 4, rs & 15
            if s:
                s = p1 if _get(bits, 1) else m1
            elif r != 15:
                fr.eobrun = (1 << r) + (_get(bits, r) if r else 0)
                break
            # advance over nonzero coefs (appending their correction bits)
            # and r zero coefs
            while k <= se:
                pos = base + _NATURAL[k]
                v = coefs[pos]
                if v:
                    if _get(bits, 1) and not v & p1:
                        coefs[pos] = v + p1 if v >= 0 else v + m1
                else:
                    r -= 1
                    if r < 0:
                        break
                k += 1
            if s:
                coefs[base + _NATURAL[k]] = s
            k += 1
    if fr.eobrun > 0:
        while k <= se:
            pos = base + _NATURAL[k]
            v = coefs[pos]
            if v and _get(bits, 1) and not v & p1:
                coefs[pos] = v + p1 if v >= 0 else v + m1
            k += 1
        fr.eobrun -= 1


# ----------------------------- the IDCT -----------------------------

_C = 13  # CONST_BITS
_P = 2  # PASS1_BITS
(F0298, F0390, F0541, F0765, F0899, F1175, F1501, F1847, F1961, F2053,
 F2562, F3072) = (2446, 3196, 4433, 6270, 7373, 9633, 12299, 15137, 16069,
                  16819, 20995, 25172)


def _idct_1d(x0, x1, x2, x3, x4, x5, x6, x7):
    """jidctint.c's 1-D pass: the 8 outputs before descaling."""
    z1 = (x2 + x6) * F0541
    tmp2 = z1 + x6 * -F1847
    tmp3 = z1 + x2 * F0765
    tmp0 = (x0 + x4) << _C
    tmp1 = (x0 - x4) << _C
    t10, t13 = tmp0 + tmp3, tmp0 - tmp3
    t11, t12 = tmp1 + tmp2, tmp1 - tmp2
    o0, o1, o2, o3 = x7, x5, x3, x1
    z1, z2, z3, z4 = o0 + o3, o1 + o2, o0 + o2, o1 + o3
    z5 = (z3 + z4) * F1175
    o0, o1, o2, o3 = o0 * F0298, o1 * F2053, o2 * F3072, o3 * F1501
    z1, z2 = z1 * -F0899, z2 * -F2562
    z3, z4 = z3 * -F1961 + z5, z4 * -F0390 + z5
    o0 = o0 + (z1 + z3)
    o1 = o1 + (z2 + z4)
    o2 = o2 + (z2 + z3)
    o3 = o3 + (z1 + z4)
    return (t10 + o3, t11 + o2, t12 + o1, t13 + o0, t13 - o0, t12 - o1,
            t11 - o2, t10 - o3)


def idct_islow(coefs, quant):
    """(N, 64) natural-order coefficients, (64,) quantisation table ->
    (N, 8, 8) u8 samples by jidctint.c jpeg_idct_islow (its zero-column
    and zero-row shortcuts give the same values as the full passes)."""
    d = (np.asarray(coefs, np.int64) * quant).reshape(-1, 8, 8)
    cols = _idct_1d(*(d[:, r, :] for r in range(8)))  # over rows: columns
    n1 = _C - _P
    ws = np.stack([(v + (1 << (n1 - 1))) >> n1 for v in cols], axis=1)
    rows = _idct_1d(*(ws[:, :, c] for c in range(8)))
    n2 = _C + _P + 3
    out = np.stack([(v + (1 << (n2 - 1))) >> n2 for v in rows], axis=2)
    # the range-limit table: the low 10 bits as a signed value, + 128,
    # clamped (jdmaster.c prepare_range_limit_table)
    out = ((out & 1023) ^ 512) - 512
    return np.clip(out + 128, 0, 255).astype(np.uint8)


# --------------------------- upsampling ---------------------------

def _edge(p, h, w):
    """p cropped to (h, w) and padded by one replicated sample around."""
    return np.pad(p[:h, :w].astype(np.int32), 1, mode="edge")


def _h2v1(p):
    e = p[1:-1]
    this = e[:, 1:-1] * 3
    out = np.empty((this.shape[0], this.shape[1] * 2), np.int32)
    out[:, 0::2] = (this + e[:, :-2] + 1) >> 2
    out[:, 1::2] = (this + e[:, 2:] + 2) >> 2
    return out


def _h1v2(p):
    this = p[1:-1, 1:-1] * 3
    out = np.empty((this.shape[0] * 2, this.shape[1]), np.int32)
    out[0::2] = (this + p[:-2, 1:-1] + 1) >> 2
    out[1::2] = (this + p[2:, 1:-1] + 2) >> 2
    return out


def _h2v2(p):
    out = np.empty(((p.shape[0] - 2) * 2, (p.shape[1] - 2) * 2), np.int32)
    for v, near in ((0, p[:-2]), (1, p[2:])):
        colsum = p[1:-1] * 3 + near  # nearer row x 3 + further row
        this = colsum[:, 1:-1] * 3
        out[v::2, 0::2] = (this + colsum[:, :-2] + 8) >> 4
        out[v::2, 1::2] = (this + colsum[:, 2:] + 7) >> 4
    return out


def _upsample(plane, c, fr):
    """A component's samples (its block grid) -> (H, W) at full size
    (jdsample.c's method for its ratio)."""
    fh, fv = fr.hmax // c.h, fr.vmax // c.v
    if (fh, fv) == (1, 1):
        out = plane
    elif (fh, fv) == (2, 1) and c.w > 2:
        out = _h2v1(_edge(plane, c.hgt, c.w))
    elif (fh, fv) == (1, 2):
        out = _h1v2(_edge(plane, c.hgt, c.w))
    elif (fh, fv) == (2, 2) and c.w > 2:
        out = _h2v2(_edge(plane, c.hgt, c.w))
    else:
        out = np.repeat(np.repeat(plane, fv, axis=0), fh, axis=1)
    return out[:fr.height, :fr.width]


# ------------------------- colour conversion -------------------------

def _ycc_tables():
    """jdcolor.c build_ycc_rgb_table (SCALEBITS 16)."""
    x = np.arange(256, dtype=np.int64) - 128
    one_half = 1 << 15

    def fix(v):
        return int(v * 65536 + 0.5)
    cr_r = (fix(1.40200) * x + one_half) >> 16
    cb_b = (fix(1.77200) * x + one_half) >> 16
    cr_g = -fix(0.71414) * x
    cb_g = -fix(0.34414) * x + one_half
    return cr_r, cb_b, cr_g, cb_g


_CR_R, _CB_B, _CR_G, _CB_G = _ycc_tables()


def _ycc_to_rgb(y, cb, cr, clip=True):
    y = y.astype(np.int64)
    cb = cb.astype(np.int64)
    cr = cr.astype(np.int64)
    r = y + _CR_R[cr]
    g = y + ((_CB_G[cb] + _CR_G[cr]) >> 16)
    b = y + _CB_B[cb]
    if not clip:
        return [r, g, b]
    return [np.clip(v, 0, 255).astype(np.uint8) for v in (r, g, b)]


# --------------------------- block smoothing ---------------------------

# jdcoefct.c decompress_smooth_data (libjpeg-turbo 2.1 and later): the
# weights of the 5 x 5 DC neighbourhood (rows -2..2, columns -2..2, as
# DC01..DC25) for each estimated coefficient: (natural position,
# coef_bits index, weights when only DC is known (change_dc), weights
# otherwise or None where only the DC-only pass estimates it).
_SMOOTH = (
    (1, 1, (-1, -1, 0, 1, 1, -3, 13, 0, -13, 3, -3, 38, 0, -38, 3,
            -3, 13, 0, -13, 3, -1, -1, 0, 1, 1),
     (0,) * 10 + (-7, 50, 0, -50, 7) + (0,) * 10),
    (8, 2, (-1, -3, -3, -3, -1, -1, 13, 38, 13, -1, 0, 0, 0, 0, 0,
            1, -13, -38, -13, 1, 1, 3, 3, 3, 1),
     (0, 0, -7, 0, 0, 0, 0, 50, 0, 0, 0, 0, 0, 0, 0, 0, 0, -50, 0, 0,
      0, 0, 7, 0, 0)),
    (16, 3, (0, 0, 1, 0, 0, 0, 2, 7, 2, 0, 0, -5, -14, -5, 0, 0, 2, 7, 2,
             0, 0, 0, 1, 0, 0),
     (0, 0, -1, 0, 0, 0, 0, 13, 0, 0, 0, 0, -24, 0, 0, 0, 0, 13, 0, 0,
      0, 0, -1, 0, 0)),
    (9, 4, (-1, 0, 0, 0, 1, 0, 9, 0, -9, 0, 0, 0, 0, 0, 0, 0, -9, 0, 9, 0,
            1, 0, 0, 0, -1),
     (0, -1, 0, 1, 0, -1, 10, 0, -10, 1, 0, 0, 0, 0, 0, 1, -10, 0, 10, -1,
      0, 1, 0, -1, 0)),
    (2, 5, (0, 0, 0, 0, 0, 0, 2, -5, 2, 0, 1, 7, -14, 7, 1, 0, 2, -5, 2, 0,
            0, 0, 0, 0, 0),
     (0,) * 10 + (-1, 13, -24, 13, -1) + (0,) * 10),
    (3, 6, (0, 0, 0, 0, 0, 0, 1, 0, -1, 0, 0, 2, 0, -2, 0, 0, 1, 0, -1, 0,
            0, 0, 0, 0, 0), None),
    (10, 7, (0, 0, 0, 0, 0, 0, 1, -3, 1, 0, 0, 0, 0, 0, 0, 0, -1, 3, -1, 0,
             0, 0, 0, 0, 0), None),
    (17, 8, (0, 0, 0, 0, 0, 0, 1, 0, -1, 0, 0, -3, 0, 3, 0, 0, 1, 0, -1, 0,
             0, 0, 0, 0, 0), None),
    (24, 9, (0, 0, 0, 0, 0, 0, 1, 2, 1, 0, 0, 0, 0, 0, 0, 0, -1, -2, -1, 0,
             0, 0, 0, 0, 0), None),
)
_SMOOTH_DC = (-2, -6, -8, -6, -2, -6, 6, 42, 6, -6, -8, 42, 152, 42, -8,
              -6, 6, 42, 6, -6, -2, -6, -8, -6, -2)


def _smoothing_ok(fr) -> bool:
    """jdcoefct.c smoothing_ok: a progressive file whose every component
    has DC and non-zero quantisers 0-9, and some coefficient 1-9 not
    refined to its last bit."""
    if not fr.progressive:
        return False
    useful = False
    for c in fr.comps:
        if c.quant is None or not c.quant[:10].all() or c.coef_bits[0] < 0:
            return False
        useful = useful or any(c.coef_bits[k] != 0 for k in range(1, 10))
    return useful


def _predict(num, q, al):
    """The estimate num / (q << 8), rounded, its magnitude capped below
    1 << al when al > 0."""
    mag = ((q << 7) + np.abs(num)) // (q << 8)
    if al > 0:
        mag = np.minimum(mag, (1 << al) - 1)
    return np.where(num >= 0, mag, -mag)


def _smooth(fr, c, coefs):
    """Estimate the missing low-frequency coefficients of every block of
    component c from the DC of its 5 x 5 neighbourhood (coefs: (bh * bw,
    64) natural order, modified in place)."""
    bits = c.coef_bits
    change_dc = all(bits[k] == -1 for k in range(1, 10))
    blocks = coefs.reshape(c.bh, c.bw, 64)
    dc = blocks[..., 0].copy()
    v = c.v
    total = fr.mcuy
    nby, nbx = c.nby, c.nbx
    rows = np.arange(nby)
    # image_block_row and image_block_rows as libjpeg counts them (the
    # last iMCU row counts its own block rows)
    last_rows = nby % v or v
    in_last = rows >= (total - 1) * v
    brows = np.where(in_last, last_rows, v)
    ibr_row = np.where(in_last, (total - 1) * last_rows + rows % v, rows)
    ibr = brows * total
    prev = np.where(ibr_row > 0, rows - 1, rows)
    prev2 = np.where(ibr_row > 1, rows - 2, prev)
    nxt = np.where(ibr_row < ibr - 1, rows + 1, rows)
    nxt2 = np.where(ibr_row < ibr - 2, rows + 2, nxt)
    cols = np.arange(nbx)
    nb = []
    for r in (prev2, prev, rows, nxt, nxt2):
        for dx in (-2, -1, 0, 1, 2):
            nb.append(dc[r][:, np.clip(cols + dx, 0, nbx - 1)])
    nb = np.stack(nb).astype(np.int64)  # (25, nby, nbx)
    work = blocks[:nby, :nbx]
    q = c.quant
    for pos, k, w_dc, w_ac in _SMOOTH:
        w = w_dc if change_dc else w_ac
        al = bits[k]
        if w is None or al == 0:
            continue
        num = int(q[0]) * np.tensordot(np.asarray(w, np.int64), nb, 1)
        pred = _predict(num, int(q[pos]), al)
        cur = work[..., pos]
        work[..., pos] = np.where(cur == 0, pred, cur)
    if change_dc:
        num = int(q[0]) * np.tensordot(np.asarray(_SMOOTH_DC, np.int64),
                                       nb, 1)
        work[..., 0] = _predict(num, int(q[0]), 0)
    blocks[:nby, :nbx] = work


# ------------------------------ decode ------------------------------

def decode_jpeg(data: bytes, name: str = "<jpeg>",
                cmyk_space: bool = False) -> np.ndarray:
    """JPEG bytes -> (H, W, 4) u8 RGBA, alpha 255, equal to PIL's
    ``Image.open(...).convert("RGBA")``. Raises ValueError for a feature
    outside the module docstring's list, or for a malformed file. With
    `cmyk_space` four components are CMYK whatever the Adobe transform
    says (the JPEG colour space "CMYK" that PIL sets for BLP files)."""
    fr, planes = _planes(data, name)
    h, w = fr.height, fr.width
    out = np.full((h, w, 4), 255, np.uint8)
    if len(planes) == 1:
        out[..., :3] = planes[0][..., None]
        return out
    if len(planes) == 4:
        # jdapimin.c: Adobe transform 2 (or another non-zero one) is YCCK,
        # else CMYK; jdcolor.c ycck_cmyk_convert; PIL reads the CMYK as
        # Adobe's inverted "CMYK;I" and converts it to RGB (cmyk2rgb)
        if fr.adobe is not None and fr.adobe != 0 and not cmyk_space:
            r, g, b = _ycc_to_rgb(*planes[:3], clip=False)
            cmyk = [np.clip(255 - v, 0, 255) for v in (r, g, b)]
        else:
            cmyk = [p.astype(np.int64) for p in planes[:3]]
        cmyk.append(planes[3].astype(np.int64))
        return modes.to_rgba("CMYK", (255 - np.stack(cmyk, -1)).astype(
            np.uint8))
    if _is_rgb(fr):
        rgb = [p.astype(np.uint8) for p in planes]
    else:
        rgb = _ycc_to_rgb(*planes)
    for k in range(3):
        out[..., k] = rgb[k]
    return out


def decode_components(data: bytes, name: str = "<jpeg>",
                      ycbcr: bool = False):
    """JPEG bytes -> ((H, W, components) u8 samples, [(h, v) sampling
    factors of each component]), upsampled but not colour-converted (a
    TIFF strip's JPEG, which libtiff decodes as colour space "unknown"),
    or, with `ycbcr`, 3 components converted from YCbCr to RGB (libtiff's
    JPEGCOLORMODE_RGB)."""
    fr, planes = _planes(data, name)
    if ycbcr:
        if len(planes) != 3:
            raise ValueError(f"JPEG with {len(planes)} components is not "
                             f"YCbCr: {name}")
        planes = _ycc_to_rgb(*planes)
    return (np.stack([p.astype(np.uint8) for p in planes], -1),
            [(c.h, c.v) for c in fr.comps])


def _planes(data: bytes, name: str):
    """The frame and its components' samples at full size, (H, W) each."""
    if not data.startswith(b"\xff\xd8"):
        raise ValueError(f"not a JPEG file: {name}")
    fr = _Frame()
    i, seen_sof = 2, False
    try:
        while i < len(data):
            if data[i] != 0xFF:
                i += 1  # garbage between markers (libjpeg skips it too)
                continue
            marker = data[i + 1]
            if marker == 0xFF:
                i += 1
                continue
            if marker == EOI:
                break
            if marker in (0x01,) or 0xD0 <= marker <= 0xD7:
                i += 2
                continue
            length = data[i + 2] << 8 | data[i + 3]
            body = data[i + 4:i + 2 + length]
            i += 2 + length
            if 0xC0 <= marker <= 0xCF and marker not in (DHT, 0xC8, 0xCC):
                _parse_sof(fr, body, marker)
                seen_sof = True
            elif marker == 0xCC:
                raise ValueError("JPEG: arithmetic coding is not supported")
            elif marker == DHT:
                _parse_dht(fr, body)
            elif marker == DQT:
                _parse_dqt(fr, body)
            elif marker == DRI:
                fr.restart = body[0] << 8 | body[1]
            elif marker == 0xE0 and body[:5] == b"JFIF\0":
                fr.jfif = True
            elif marker == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
                fr.adobe = body[11]
            elif marker == SOS:
                if not seen_sof:
                    raise ValueError("JPEG: SOS before SOF")
                i = _decode_scan(fr, body, data, i)
    except (IndexError, KeyError, TypeError) as e:
        raise ValueError(f"malformed JPEG file {name}: {e!r}") from e
    if not seen_sof:
        raise ValueError(f"JPEG without a frame header: {name}")
    smoothing = _smoothing_ok(fr)
    planes = []
    for c in fr.comps:
        if c.quant is None:
            raise ValueError(f"JPEG: component {c.id} has no scan: {name}")
        coefs = np.array(c.coefs, np.int64).reshape(-1, 64)
        if smoothing:
            _smooth(fr, c, coefs)
        blocks = idct_islow(coefs, c.quant).reshape(c.bh, c.bw, 8, 8)
        plane = blocks.transpose(0, 2, 1, 3).reshape(c.bh * 8, c.bw * 8)
        planes.append(_upsample(plane, c, fr))
    return fr, planes


def _is_rgb(fr) -> bool:
    """jdapimin.c default_decompress_parms for 3 components: JFIF means
    YCbCr; else an Adobe marker's transform 0 means RGB (1 or other
    YCbCr); else the component ids 'R', 'G', 'B' mean RGB."""
    if fr.jfif:
        return False
    if fr.adobe is not None:
        return fr.adobe == 0
    return [c.id for c in fr.comps] == [82, 71, 66]

