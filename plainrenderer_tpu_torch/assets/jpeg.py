"""JPEG decoding without PIL, bit-equal to libjpeg(-turbo) as PIL runs it
(``Image.open(path).convert("RGBA")``; the JAX package's load_image reads
JPEG textures so, plainrenderer_tpu/assets/image_io.py:36-40).

Covered: baseline and extended sequential Huffman coding, 8-bit samples;
progressive Huffman coding (spectral selection and successive
approximation, DC and AC, first and refinement scans, EOB runs);
arithmetic coding, sequential (SOF9) and progressive (SOF10, refinement
scans too), by jdarith.c's QM decoder (T.81 Annex D: the 113-state
probability table, DAC conditioning with the defaults L = 0, U = 1, Kx =
5, statistics reset at each scan and restart); lossless mode with Huffman
coding (SOF3, jdlhuff.c / jddiffct.c / jdlossls.c: predictors 1-7, the
first row and each restart's first row predicted from 2^(P - Pt - 1) and
the left sample, the first column from the sample above, the point
transform Pt, restart intervals that are whole MCU rows, subsampled
components replicated, not fancy-upsampled; colours that would need
converting, YCbCr or YCCK, are refused as libjpeg-turbo refuses them in
lossless mode); restart intervals;
grayscale, YCbCr and RGB (Adobe APP14 transform 0, or the component ids
'R', 'G', 'B' without JFIF); four components, CMYK (Adobe transform 0,
or no Adobe marker) and YCCK (any other transform), which PIL reads as
Adobe's inverted CMYK ("CMYK;I") and converts to RGB; any integral
sampling factors (4:4:4, 4:2:2, 4:4:0, 4:2:0, ...) and image sizes that
are not multiples of the MCU. 12-bit DCT samples are decoded for TIFF
strips (decode_components(precision=12), jidctint.c at 12 bits), never
for a JPEG file, which PIL reads at 8 bits only. Lossless arithmetic
coding (SOF11, which libjpeg-turbo does not implement), other
precisions and the hierarchical modes raise ValueError naming the
feature.

Corrupt and cut data are read as libjpeg-turbo reads them: a stream
without EOI is refused (PIL: image file is truncated); the header checks
libjpeg makes (segment lengths, table indexes, sampling factors 1-4, at
most 10 blocks an MCU, DC symbols 0-15) raise; a Huffman code that
matches nothing reads as 0 after 17 bits; once a restart interval's data
runs out its remaining MCUs stay as they are (lossless: zeros, the
predictors reset); a bad restart marker resynchronises as
jpeg_resync_to_restart does; a run past a block's end lands on
coefficient 63.

The entropy decoders are the one sequential part: Python loops over the
scan's Huffman symbols (table-driven: a 16-bit lookahead table per
Huffman table gives symbol and code length in one index, and the bit
reader reads every field from a precomputed list of 32-bit windows) or
arithmetic decisions. Everything after them is vectorised with numpy
over all blocks at once, with libjpeg-turbo's integer rules:
  - dequantisation and the "islow" IDCT as libjpeg-turbo runs it on
    x86-64 at 8 bits (jidctint-avx2.asm: jidctint.c's arithmetic in
    16-bit lanes, which differs from it only on corrupt data) and at 12
    bits (jidctint.c: CONST_BITS 13, PASS1_BITS 1, the range-limit
    table's wrap-around);
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
# jutils.c jpeg_natural_order: 16 more entries of 63, where a corrupt run
# past the block's end lands
_NATURAL = ZIGZAG.tolist() + [63] * 16
# jcparam.c's standard Huffman tables, (class, slot) -> (code counts for
# lengths 1-16, symbols); jstdhuff.c installs them in the slots a DCT
# file leaves undefined (Motion-JPEG frames have no DHT), not in lossless
# mode
_STD_DC_LUMA = ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0),
                tuple(range(12)))
_STD_DC_CHROMA = ((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0),
                  tuple(range(12)))
_STD_AC_LUMA = ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D),
                bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a434445464748494a"
    "535455565758595a636465666768696a737475767778797a838485868788898a"
    "92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6"
    "c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa"))
_STD_AC_CHROMA = ((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77),
                  bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa"))
STD_HUFFMAN = {(0, 0): _STD_DC_LUMA, (1, 0): _STD_AC_LUMA,
               (0, 1): _STD_DC_CHROMA, (1, 1): _STD_AC_CHROMA}
_UNSUPPORTED_SOF = {
    0xC5: "hierarchical (differential) mode",
    0xC6: "hierarchical (differential) mode",
    0xC7: "hierarchical lossless mode",
    0xCB: "arithmetic coding in lossless mode (libjpeg-turbo does not "
          "implement it)",
    0xCD: "hierarchical (differential) mode with arithmetic coding",
    0xCE: "hierarchical (differential) mode with arithmetic coding",
    0xCF: "hierarchical lossless mode with arithmetic coding"}
DAC = 0xCC
# T.81 Table D.2 as jaricom.c packs it: Qe << 16 | Next_Index_MPS << 8 |
# Switch_MPS << 7 | Next_Index_LPS; entry 113 is the fixed 0.5 estimate
# (the sign bits of AC coefficients and the DC refinement bits)
_QE = (
    (0x5a1d, 1, 1, 1), (0x2586, 2, 14, 0), (0x1114, 3, 16, 0),
    (0x080b, 4, 18, 0), (0x03d8, 5, 20, 0), (0x01da, 6, 23, 0),
    (0x00e5, 7, 25, 0), (0x006f, 8, 28, 0), (0x0036, 9, 30, 0),
    (0x001a, 10, 33, 0), (0x000d, 11, 35, 0), (0x0006, 12, 9, 0),
    (0x0003, 13, 10, 0), (0x0001, 13, 12, 0), (0x5a7f, 15, 15, 1),
    (0x3f25, 16, 36, 0), (0x2cf2, 17, 38, 0), (0x207c, 18, 39, 0),
    (0x17b9, 19, 40, 0), (0x1182, 20, 42, 0), (0x0cef, 21, 43, 0),
    (0x09a1, 22, 45, 0), (0x072f, 23, 46, 0), (0x055c, 24, 48, 0),
    (0x0406, 25, 49, 0), (0x0303, 26, 51, 0), (0x0240, 27, 52, 0),
    (0x01b1, 28, 54, 0), (0x0144, 29, 56, 0), (0x00f5, 30, 57, 0),
    (0x00b7, 31, 59, 0), (0x008a, 32, 60, 0), (0x0068, 33, 62, 0),
    (0x004e, 34, 63, 0), (0x003b, 35, 32, 0), (0x002c, 9, 33, 0),
    (0x5ae1, 37, 37, 1), (0x484c, 38, 64, 0), (0x3a0d, 39, 65, 0),
    (0x2ef1, 40, 67, 0), (0x261f, 41, 68, 0), (0x1f33, 42, 69, 0),
    (0x19a8, 43, 70, 0), (0x1518, 44, 72, 0), (0x1177, 45, 73, 0),
    (0x0e74, 46, 74, 0), (0x0bfb, 47, 75, 0), (0x09f8, 48, 77, 0),
    (0x0861, 49, 78, 0), (0x0706, 50, 79, 0), (0x05cd, 51, 48, 0),
    (0x04de, 52, 50, 0), (0x040f, 53, 50, 0), (0x0363, 54, 51, 0),
    (0x02d4, 55, 52, 0), (0x025c, 56, 53, 0), (0x01f8, 57, 54, 0),
    (0x01a4, 58, 55, 0), (0x0160, 59, 56, 0), (0x0125, 60, 57, 0),
    (0x00f6, 61, 58, 0), (0x00cb, 62, 59, 0), (0x00ab, 63, 61, 0),
    (0x008f, 32, 61, 0), (0x5b12, 65, 65, 1), (0x4d04, 66, 80, 0),
    (0x412c, 67, 81, 0), (0x37d8, 68, 82, 0), (0x2fe8, 69, 83, 0),
    (0x293c, 70, 84, 0), (0x2379, 71, 86, 0), (0x1edf, 72, 87, 0),
    (0x1aa9, 73, 87, 0), (0x174e, 74, 72, 0), (0x1424, 75, 72, 0),
    (0x119c, 76, 74, 0), (0x0f6b, 77, 74, 0), (0x0d51, 78, 75, 0),
    (0x0bb6, 79, 77, 0), (0x0a40, 48, 77, 0), (0x5832, 81, 80, 1),
    (0x4d1c, 82, 88, 0), (0x438e, 83, 89, 0), (0x3bdd, 84, 90, 0),
    (0x34ee, 85, 91, 0), (0x2eae, 86, 92, 0), (0x299a, 87, 93, 0),
    (0x2516, 71, 86, 0), (0x5570, 89, 88, 1), (0x4ca9, 90, 95, 0),
    (0x44d9, 91, 96, 0), (0x3e22, 92, 97, 0), (0x3824, 93, 99, 0),
    (0x32b4, 94, 99, 0), (0x2e17, 86, 93, 0), (0x56a8, 96, 95, 1),
    (0x4f46, 97, 101, 0), (0x47e5, 98, 102, 0), (0x41cf, 99, 103, 0),
    (0x3c3d, 100, 104, 0), (0x375e, 93, 99, 0), (0x5231, 102, 105, 0),
    (0x4c0f, 103, 106, 0), (0x4639, 104, 107, 0), (0x415e, 99, 103, 0),
    (0x5627, 106, 105, 1), (0x50e7, 107, 108, 0), (0x4b85, 103, 109, 0),
    (0x5597, 109, 110, 0), (0x504f, 107, 111, 0), (0x5a10, 111, 110, 1),
    (0x5522, 109, 112, 0), (0x59eb, 111, 112, 1), (0x5a1d, 113, 113, 0))
ARITAB = [qe << 16 | nm << 8 | sw << 7 | nl for qe, nm, nl, sw in _QE]


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
        self.samples = None  # lossless: (bh, bw) undifferenced samples


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

    def __init__(self, seg: bytes, pad: int = 8):
        raw = np.frombuffer(seg.replace(b"\xff\x00", b"\xff") + b"\0" * pad,
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
    if not e:  # jpeg_huff_decode: no code in 16 bits reads as 0 after 17
        bits.pos = pos + 17
        return 0
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
        self.dc_max = {}  # the largest symbol of each DC table
        self.restart = 0
        self.adobe = None
        self.jfif = False
        self.eobrun = 0
        self.scans = 0  # cinfo->input_scan_number
        self.arith = self.lossless = False
        self.eoi = False
        self.precision = 8  # the sample precision the caller reads
        # DAC conditioning per table (jdmarker.c's defaults)
        self.dc_l, self.dc_u, self.ac_k = [0] * 16, [1] * 16, [5] * 16


def _parse_sof(fr, body, marker):
    if marker in _UNSUPPORTED_SOF:
        raise ValueError(f"JPEG: {_UNSUPPORTED_SOF[marker]} is not supported")
    if fr.comps:
        raise ValueError("JPEG: a second SOF marker (libjpeg refuses it)")
    if len(body) < 6 or len(body) != 6 + 3 * body[5]:
        raise ValueError("JPEG: SOF length (libjpeg: bogus marker length)")
    fr.lossless = marker == 0xC3
    if body[0] != fr.precision or (fr.lossless and body[0] != 8):
        raise ValueError(f"JPEG: {body[0]}-bit samples are not supported "
                         f"({fr.precision}-bit only)")
    fr.progressive = marker in (0xC2, 0xCA)
    fr.arith = marker in (0xC9, 0xCA)
    fr.height = body[1] << 8 | body[2]
    fr.width = body[3] << 8 | body[4]
    n = body[5]
    if fr.height == 0 or fr.width == 0:
        raise ValueError("JPEG: empty image (or a DNL marker height)")
    if n not in (1, 3, 4):
        raise ValueError(f"JPEG: {n} components are not supported")
    modes.check_size(fr.width, fr.height)
    for i in range(n):
        cid, hv, tq = body[6 + 3 * i:9 + 3 * i]
        if not (1 <= hv >> 4 <= 4 and 1 <= hv & 15 <= 4):
            raise ValueError(f"JPEG: sampling factors {hv >> 4}x{hv & 15} "
                             f"(libjpeg: bogus sampling factors)")
        fr.comps.append(_Component(cid, hv >> 4, hv & 15, tq))
    fr.hmax = max(c.h for c in fr.comps)
    fr.vmax = max(c.v for c in fr.comps)
    unit = 1 if fr.lossless else 8  # a lossless "block" is one sample
    fr.mcux = -(-fr.width // (unit * fr.hmax))
    fr.mcuy = -(-fr.height // (unit * fr.vmax))
    for c in fr.comps:
        if fr.hmax % c.h or fr.vmax % c.v:
            raise ValueError("JPEG: fractional sampling factors are not "
                             "supported")
        c.bw, c.bh = fr.mcux * c.h, fr.mcuy * c.v  # blocks incl. MCU pad
        # the component's own size and block grid (non-interleaved scans)
        c.w = -(-fr.width * c.h // fr.hmax)
        c.hgt = -(-fr.height * c.v // fr.vmax)
        c.nbx, c.nby = -(-c.w // unit), -(-c.hgt // unit)
        c.coefs = [0] * (c.bw * c.bh * unit * unit)


def _parse_dac(fr, body):
    """jdmarker.c get_dac: Tc << 4 | Tb, then L and U (DC) or Kx (AC)."""
    for i in range(0, len(body) - 1, 2):
        index, val = body[i], body[i + 1]
        if index >= 32:
            raise ValueError(f"JPEG: bad DAC table index {index}")
        if index >= 16:
            fr.ac_k[index - 16] = val
        else:
            fr.dc_l[index], fr.dc_u[index] = val & 15, val >> 4
            if fr.dc_l[index] > fr.dc_u[index]:
                raise ValueError(f"JPEG: bad DAC value {val}")


def _parse_dht(fr, body):
    i = 0
    while i < len(body):
        tc_th = body[i]
        if (tc_th & ~0x10) >= 4 or i + 17 > len(body):
            raise ValueError(f"JPEG: DHT table 0x{tc_th:02X} (libjpeg: bogus "
                             f"table index or length)")
        counts = list(body[i + 1:i + 17])
        n = sum(counts)
        if n > 256 or i + 17 + n > len(body):
            raise ValueError("JPEG: bogus Huffman table definition")
        symbols = list(body[i + 17:i + 17 + n])
        (fr.ac_tables if tc_th >> 4 else fr.dc_tables)[tc_th & 15] = \
            _huffman_table(counts, symbols)
        if not tc_th >> 4:
            fr.dc_max[tc_th & 15] = max(symbols, default=0)
        i += 17 + n


def _table(fr, cls, slot):
    """The scan's Huffman table of class 0 (DC) or 1 (AC) in `slot`: the
    file's, else jstdhuff.c's standard one for slots 0 and 1, else None."""
    tables = fr.ac_tables if cls else fr.dc_tables
    if slot not in tables and (cls, slot) in STD_HUFFMAN:
        counts, symbols = STD_HUFFMAN[(cls, slot)]
        tables[slot] = _huffman_table(counts, list(symbols))
        if not cls:
            fr.dc_max[slot] = max(symbols)
    return tables.get(slot)


def _parse_dqt(fr, body):
    i = 0
    while i < len(body):
        pq, tq = body[i] >> 4, body[i] & 15
        if tq >= 4 or i + (129 if pq else 65) > len(body):
            raise ValueError(f"JPEG: DQT table {tq} (libjpeg: bogus table "
                             f"index or length)")
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


def _next_marker(data, i):
    """The position of the first marker (0xFF, then a byte neither 0 nor
    0xFF) at or after i, or len(data)."""
    n = len(data)
    while True:
        j = data.find(b"\xff", i)
        if j < 0 or j + 1 >= n:
            return n
        nxt = data[j + 1]
        if nxt == 0:
            i = j + 2
        elif nxt == 0xFF:
            i = j + 1
        else:
            return j


def _segments(data, start, intervals):
    """The entropy-coded segments of the scan at data[start:], one per
    restart interval, as libjpeg finds them: each runs to the next marker;
    at each restart jdmarker.c read_restart_marker takes the expected RSTn
    and otherwise jpeg_resync_to_restart decides: an invalid marker (below
    SOF0) or one of the two RSTs before the expected one is skipped to the
    next marker; a non-RST marker, or one of the next two RSTs, is left
    (the interval is empty); another RST is taken as the expected one.
    Returns (segments, None for an interval left empty before a marker,
    the offset of the marker after the scan)."""
    n = len(data)
    end = _next_marker(data, start)
    segs = [data[start:end]]
    for k in range(1, intervals):
        want = (k - 1) & 7
        while True:
            m = data[end + 1] if end < n else 0xD9  # past the data: EOI
            if m == 0xD0 + want:
                action = 1
            elif m < 0xC0:
                action = 2
            elif not 0xD0 <= m <= 0xD7:
                action = 3
            elif m - 0xD0 in ((want + 1) & 7, (want + 2) & 7):
                action = 3
            elif m - 0xD0 in ((want - 1) & 7, (want - 2) & 7):
                action = 2
            else:
                action = 1
            if action == 2:
                end = _next_marker(data, end + 2)
                continue
            break
        if action == 3:
            segs.append(None)  # an empty interval, the marker left unread
            continue
        seg_start = end + 2
        end = _next_marker(data, seg_start)
        segs.append(data[seg_start:end])
    return segs, end


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
    if not 1 <= ns <= 4 or len(body) != 4 + 2 * ns:
        raise ValueError("JPEG: SOS length (libjpeg: bogus marker length)")
    by_id = {c.id: c for c in fr.comps}
    comps, tables = [], []
    for i in range(ns):
        cid, td_ta = body[1 + 2 * i], body[2 + 2 * i]
        c = by_id.get(cid)
        if c is None or c in comps:
            raise ValueError(f"JPEG: SOS component {cid} (libjpeg: invalid "
                             f"component ID in SOS)")
        if c.quant is None and not fr.lossless:
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
    if not fr.arith and (not fr.progressive or (ss == 0 and ah == 0)):
        # jpeg_make_d_derived_tbl: DC symbols are categories 0-15 (16 in
        # lossless mode)
        for td, _ in tables:
            if fr.dc_max.get(td, 0) > (16 if fr.lossless else 15):
                raise ValueError(f"JPEG: DC Huffman table {td} has symbol "
                                 f"{fr.dc_max[td]} (libjpeg: bogus Huffman "
                                 f"table definition)")
    if ns > 1 and sum(c.h * c.v for c in comps) > 10:
        raise ValueError("JPEG: more than 10 blocks in an MCU (libjpeg: "
                         "sampling factors too large for interleaved scan)")
    mcus = _block_order(fr, comps)
    per = fr.restart or len(mcus)
    segs, end = _segments(data, start, -(-len(mcus) // per))
    if fr.lossless:
        _lossless_scan(fr, comps, tables, ss, se, ah, al, segs, mcus, per)
        return end
    if fr.arith:
        _arith_scan(fr, comps, tables, ss, se, ah, al, segs, mcus, per)
        return end
    dc_tab = {id(c): _table(fr, 0, t[0]) for c, t in zip(comps, tables)}
    ac_tab = {id(c): _table(fr, 1, t[1]) for c, t in zip(comps, tables)}
    if not fr.progressive:
        kind = "sequential"
    elif ss == 0:
        kind = "dc_first" if ah == 0 else "dc_refine"
    else:
        kind = "ac_first" if ah == 0 else "ac_refine"
    if fr.progressive:
        _check_progression(ss, se, ah, al, len(comps))
    starved = False  # libjpeg's insufficient_data
    pad = len(mcus[0]) * 64 * 32 // 8 + 16  # zero bits for one whole MCU
    for k in range(0, len(mcus), per):
        seg = segs[k // per] if k // per < len(segs) else b""
        if seg is not None:  # a restart marker read: the flag is reset
            starved = False
        seg, run = seg or b"", mcus[k:k + per]
        # the segment's data and 8 zero bytes, again with zero bits for a
        # whole MCU where corrupt data reads that far past its end (an
        # AC refinement adds to coefficients: those are restored first)
        saved = [(c.coefs, blk * 64, c.coefs[blk * 64:blk * 64 + 64])
                 for mcu in run for c, blk in mcu] if kind == "ac_refine" \
            else ()
        try:
            starved = _huffman_segment(fr, kind, _Bits(seg), seg, run,
                                       comps, dc_tab, ac_tab, ss, se, al,
                                       starved)
        except IndexError:
            for coefs, base, block in saved:
                coefs[base:base + 64] = block
            starved = _huffman_segment(fr, kind, _Bits(seg, pad), seg, run,
                                       comps, dc_tab, ac_tab, ss, se, al,
                                       starved)
    return end


def _huffman_segment(fr, kind, bits, seg, mcus, comps, dc_tab, ac_tab, ss,
                     se, al, starved):
    """One restart interval of a Huffman scan; returns libjpeg's
    insufficient_data flag after it (set once a read needs bits past the
    data: the later MCUs stay as they are)."""
    real = 8 * len(seg.replace(b"\xff\x00", b"\xff"))
    for c in comps:
        c.dc_pred = 0
    fr.eobrun = 0
    for mcu in mcus:
        if starved:
            continue  # decode_mcu leaves the MCU as it is
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
        starved = bits.pos > real
    return starved


def _check_progression(ss, se, ah, al, ncomps):
    """jdphuff.c / jdarith.c start_pass: the scan parameters a progressive
    scan may have (an error otherwise)."""
    if (ss == 0 and se != 0) or (ss and (se < ss or se > 63 or ncomps != 1)) \
            or (ah and al != ah - 1) or al > 13:
        raise ValueError(f"JPEG: bad progressive scan Ss {ss} Se {se} Ah {ah} "
                         f"Al {al} (libjpeg: invalid progressive parameters)")


def _block_sequential(bits, c, base, dc, ac):
    """One block of a sequential scan: _decode and _receive_extend
    inlined (the decoder's hottest loop)."""
    coefs, win, pos, natural = c.coefs, bits.win, bits.pos, _NATURAL
    e = dc[(win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
    if not e:
        e = 17 << 8  # a bad code: 0 after 17 bits, as jpeg_huff_decode
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
            e = 17 << 8  # a bad code: 0 (EOB) after 17 bits
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


# ------------------------ arithmetic decoding ------------------------

class _Arith:
    """jdarith.c's decoder state over one entropy-coded segment: the C and A
    registers and the bit counter; past the segment's end (a marker) it
    reads zero bytes."""

    def __init__(self, seg: bytes):
        self.data, self.pos, self.n = seg, 0, len(seg)
        self.a = self.c = 0
        self.ct = -16  # force reading 2 initial bytes to fill C
        self.marker = False

    def _byte(self):
        if self.marker or self.pos >= self.n:
            self.marker = True
            return 0
        d, p = self.data, self.pos
        v = d[p]
        p += 1
        if v == 0xFF:
            while p < self.n and d[p] == 0xFF:
                p += 1
            if p < self.n and d[p] == 0:
                p += 1
            else:
                self.marker = True
                v = 0
        self.pos = p
        return v

    def decode(self, st, i):
        """arith_decode: one binary decision with the statistics bin st[i]
        (state index | MPS << 7), updated in place."""
        a, c, ct = self.a, self.c, self.ct
        while a < 0x8000:
            ct -= 1
            if ct < 0:
                c = (c << 8) | self._byte()
                ct += 8
                if ct < 0:
                    ct += 1
                    if ct == 0:
                        a = 0x8000  # 2 initial bytes read: A = 0x10000
            a <<= 1
        sv = st[i]
        qe = ARITAB[sv & 0x7F]
        nl = qe & 0xFF
        nm = (qe >> 8) & 0xFF
        qe >>= 16
        a -= qe
        temp = a << ct
        if c >= temp:
            c -= temp
            if a < qe:  # conditional LPS exchange
                a = qe
                st[i] = (sv & 0x80) ^ nm
            else:
                a = qe
                st[i] = (sv & 0x80) ^ nl
                sv ^= 0x80
        elif a < 0x8000:  # conditional MPS exchange
            if a < qe:
                st[i] = (sv & 0x80) ^ nl
                sv ^= 0x80
            else:
                st[i] = (sv & 0x80) ^ nm
        self.a, self.c, self.ct = a, c, ct
        return sv >> 7


class _ArithError(Exception):
    """jdarith.c's ct = -1: a spectral or magnitude overflow; the rest of
    the restart interval decodes nothing."""


def _arith_dc(fr, e, st, ci_state, tbl):
    """Figure F.19 with F.4's conditioning: one DC difference."""
    ctx = ci_state[1]
    if e.decode(st, ctx) == 0:
        ci_state[1] = 0
        return 0
    sign = e.decode(st, ctx + 1)
    base = ctx + 2 + sign
    m = e.decode(st, base)
    at = base
    if m:
        at = 20
        while e.decode(st, at):
            m <<= 1
            if m == 0x8000:
                raise _ArithError
            at += 1
    if m < (1 << fr.dc_l[tbl]) >> 1:
        ci_state[1] = 0
    elif m > (1 << fr.dc_u[tbl]) >> 1:
        ci_state[1] = 12 + sign * 4
    else:
        ci_state[1] = 4 + sign * 4
    v = m
    at += 14
    m >>= 1
    while m:
        if e.decode(st, at):
            v |= m
        m >>= 1
    v += 1
    return -v if sign else v


def _arith_ac(fr, e, st, fixed, coefs, base, ss, se, kx, shift):
    """Figure F.20 (sequential: ss 1, se 63) and G.1.3.2 (first AC scan)."""
    k = ss
    natural = _NATURAL
    while k <= se:
        at = 3 * (k - 1)
        if e.decode(st, at):
            return  # EOB
        while e.decode(st, at + 1) == 0:
            at += 3
            k += 1
            if k > se:
                raise _ArithError
        sign = e.decode(fixed, 0)
        at += 2
        m = e.decode(st, at)
        if m:
            if e.decode(st, at):
                m <<= 1
                at = 189 if k <= kx else 217
                while e.decode(st, at):
                    m <<= 1
                    if m == 0x8000:
                        raise _ArithError
                    at += 1
        v = m
        at += 14
        m >>= 1
        while m:
            if e.decode(st, at):
                v |= m
            m >>= 1
        v += 1
        coefs[base + natural[k]] = (-v if sign else v) << shift
        k += 1


def _arith_ac_refine(e, st, fixed, coefs, base, ss, se, al):
    """decode_mcu_AC_refine (G.1.3.3)."""
    natural = _NATURAL
    p1, m1 = 1 << al, -1 << al
    kex = se
    while kex > 0 and not coefs[base + natural[kex]]:
        kex -= 1
    k = ss
    while k <= se:
        at = 3 * (k - 1)
        if k > kex and e.decode(st, at):
            return  # EOB
        while True:
            pos = base + natural[k]
            v = coefs[pos]
            if v:
                if e.decode(st, at + 2):
                    coefs[pos] = v + m1 if v < 0 else v + p1
                break
            if e.decode(st, at + 1):
                coefs[pos] = m1 if e.decode(fixed, 0) else p1
                break
            at += 3
            k += 1
            if k > se:
                raise _ArithError
        k += 1


def _arith_scan(fr, comps, tables, ss, se, ah, al, segs, mcus, per):
    """One arithmetic-coded scan (jdarith.c), its restart intervals each a
    fresh decoder with fresh statistics."""
    if fr.progressive:
        _check_progression(ss, se, ah, al, len(comps))
    dc_first = not fr.progressive or (ss == 0 and ah == 0)
    ac_scan = not fr.progressive or ss > 0
    slot = {id(c): i for i, c in enumerate(comps)}
    fixed = [113]
    for k in range(0, len(mcus), per):
        e = _Arith(segs[k // per] or b"" if k // per < len(segs) else b"")
        dc_stats = {t[0]: [0] * 64 for t in tables} if dc_first else {}
        ac_stats = {t[1]: [0] * 256 for t in tables} if ac_scan else {}
        state = [[0, 0] for _ in comps]  # last DC value, DC context
        try:
            for mcu in mcus[k:k + per]:
                for c, blk in mcu:
                    i = slot[id(c)]
                    td, ta = tables[i]
                    base = blk * 64
                    if not fr.progressive:
                        d = _arith_dc(fr, e, dc_stats[td], state[i], td)
                        v = ((state[i][0] + d + 32768) & 0xFFFF) - 32768
                        state[i][0] = v
                        c.coefs[base] = v
                        _arith_ac(fr, e, ac_stats[ta], fixed, c.coefs, base,
                                  1, 63, fr.ac_k[ta], 0)
                    elif ss == 0 and ah == 0:
                        d = _arith_dc(fr, e, dc_stats[td], state[i], td)
                        v = ((state[i][0] + d + 32768) & 0xFFFF) - 32768
                        state[i][0] = v
                        c.coefs[base] = ((v << al) + 32768) % 65536 - 32768
                    elif ss == 0:
                        if e.decode(fixed, 0):
                            c.coefs[base] |= 1 << al
                    elif ah == 0:
                        _arith_ac(fr, e, ac_stats[ta], fixed, c.coefs, base,
                                  ss, se, fr.ac_k[ta], al)
                    else:
                        _arith_ac_refine(e, ac_stats[ta], fixed, c.coefs,
                                         base, ss, se, al)
        except _ArithError:
            pass  # ct = -1: the interval's remaining MCUs stay as they are


# ---------------------------- lossless mode ----------------------------

def _lossless_scan(fr, comps, tables, ss, se, ah, al, segs, mcus, per):
    """One lossless Huffman scan (jdlhuff.c decode_mcus: one difference a
    sample, 16 meaning 32768, a bad code read as 0 after 17 bits as
    jpeg_huff_decode does), then jddiffct.c / jdlossls.c undifferencing
    of each component's rows, iMCU row by iMCU row."""
    if not 1 <= ss <= 7 or se != 0 or ah != 0 or al >= fr.precision:
        raise ValueError(f"JPEG: bad lossless scan (predictor {ss}, Se {se}, "
                         f"Ah {ah}, Pt {al})")
    per_row = fr.mcux if len(comps) > 1 else comps[0].nbx
    if fr.restart and fr.restart % per_row:
        raise ValueError(f"JPEG: lossless restart interval {fr.restart} is "
                         f"not a multiple of the {per_row} MCUs of a row "
                         f"(libjpeg-turbo refuses it)")
    slot = {id(c): i for i, c in enumerate(comps)}
    dc = []
    for _, (td, _ta) in zip(comps, tables):
        if fr.dc_tables.get(td) is None:  # jdlhuff.c installs no defaults
            raise ValueError(f"JPEG: lossless scan without Huffman table "
                             f"{td}")
        dc.append(fr.dc_tables[td])
    starved = False  # libjpeg's insufficient_data
    reset_rows = set()  # MCU rows zeroed for want of data
    for k in range(0, len(mcus), per):
        seg = segs[k // per] if k // per < len(segs) else b""
        if seg is not None:  # a restart marker read: the flag is reset
            starved = False
        seg = seg or b""
        try:
            starved = _lossless_segment(seg, _Bits(seg), mcus, k, per,
                                        per_row, dc, slot, starved,
                                        reset_rows)
        except IndexError:  # zero bits for a whole MCU row past the data
            starved = _lossless_segment(
                seg, _Bits(seg, per_row * len(mcus[0]) * 17 // 8 + 8), mcus,
                k, per, per_row, dc, slot, starved, reset_rows)
    # restarts fall on MCU rows; each resets the predictors, which act at
    # the undifferencing of the iMCU row that holds it
    mcu_rows = per // per_row if fr.restart else len(mcus) // per_row
    for c in comps:
        vrows = c.v if len(comps) > 1 else 1  # sample rows an MCU row holds
        imcu = c.v  # sample rows an iMCU row holds
        diffs = np.array(c.coefs, np.int64).reshape(c.bh, c.bw)
        out = np.zeros((c.bh, c.bw), np.int64)
        w = c.nbx
        prev = None
        first = True
        for r0 in range(0, c.nby, imcu):
            m0, m1 = r0 // vrows, (min(r0 + imcu, c.nby) - 1) // vrows
            if any(m % mcu_rows == 0 or m in reset_rows
                   for m in range(m0, m1 + 1)):
                first = True
            for r in range(r0, min(r0 + imcu, c.nby)):
                out[r, :w] = _undifference(diffs[r, :w], prev, first, ss,
                                           1 << (fr.precision - al - 1))
                first = False
                prev = out[r, :w]
        c.samples = (out << al) & 0xFF


def _lossless_segment(seg, bits, mcus, k, per, per_row, dc, slot, starved,
                      reset_rows):
    """One restart interval of a lossless Huffman scan into the
    components' difference lists; returns the insufficient_data flag."""
    real = 8 * len(seg.replace(b"\xff\x00", b"\xff"))
    win = bits.win
    for m, mcu in enumerate(mcus[k:k + per], start=k):
        if m % per_row == 0 and starved:
            # decode_mcus: a row after the data ran out is zeros, the
            # predictors reset (its samples 2^(P - Pt - 1))
            reset_rows.add(m // per_row)
        if starved and (m // per_row) in reset_rows:
            for c, blk in mcu:
                c.coefs[blk] = 0
            continue
        for c, blk in mcu:
            pos = bits.pos
            e = dc[slot[id(c)]][(win[pos >> 3] >> (16 - (pos & 7)))
                                & 0xFFFF]
            if not e:
                bits.pos = pos + 17
                c.coefs[blk] = 0
            else:
                bits.pos = pos + (e >> 8)
                s = e & 0xFF
                if s == 16:
                    c.coefs[blk] = 32768
                elif s:
                    c.coefs[blk] = _receive_extend(bits, s)
                else:
                    c.coefs[blk] = 0
            if bits.pos > real:
                starved = True
    return starved


def _undifference(diff, prev, first, predictor, initial):
    """jdlossls.c: one row (16-bit wrap-around)."""
    row = np.zeros(len(diff), np.int64)
    d = diff.tolist()
    if first:
        ra = (d[0] + initial) & 0xFFFF
        row[0] = ra
        for x in range(1, len(d)):
            ra = (d[x] + ra) & 0xFFFF
            row[x] = ra
        return row
    above = prev.tolist()
    rb = above[0]
    ra = (d[0] + rb) & 0xFFFF
    row[0] = ra
    for x in range(1, len(d)):
        rc, rb = rb, above[x]
        if predictor == 1:
            p = ra
        elif predictor == 2:
            p = rb
        elif predictor == 3:
            p = rc
        elif predictor == 4:
            p = ra + rb - rc
        elif predictor == 5:
            p = ra + ((rb - rc) >> 1)
        elif predictor == 6:
            p = rb + ((ra - rc) >> 1)
        else:
            p = (ra + rb) >> 1
        ra = (d[x] + p) & 0xFFFF
        row[x] = ra
    return row


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


def _wrap16(x):
    return ((x + 32768) & 0xFFFF) - 32768


def _wrap32(x):
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _idct_1d_simd(x0, x1, x2, x3, x4, x5, x6, x7):
    """jidctint-avx2.asm's 1-D pass on 16-bit inputs: the same products
    as jidctint.c regrouped for pmaddwd, the sums x0 + x4, x7 + x3 and x5
    + x1 in 16 bits (wrapping), the rest in 32 bits (wrapping)."""
    tmp2 = x2 * F0541 + x6 * (F0541 - F1847)
    tmp3 = x2 * (F0541 + F0765) + x6 * F0541
    tmp0 = _wrap16(x0 + x4) << _C
    tmp1 = _wrap16(x0 - x4) << _C
    t10, t13 = _wrap32(tmp0 + tmp3), _wrap32(tmp0 - tmp3)
    t11, t12 = _wrap32(tmp1 + tmp2), _wrap32(tmp1 - tmp2)
    z3, z4 = _wrap16(x7 + x3), _wrap16(x5 + x1)
    z3p = z3 * (F1175 - F1961) + z4 * F1175
    z4p = z3 * F1175 + z4 * (F1175 - F0390)
    o0 = _wrap32(x7 * (F0298 - F0899) - x1 * F0899 + z3p)
    o1 = _wrap32(x5 * (F2053 - F2562) - x3 * F2562 + z4p)
    o2 = _wrap32(-x5 * F2562 + x3 * (F3072 - F2562) + z3p)
    o3 = _wrap32(-x7 * F0899 + x1 * (F1501 - F0899) + z4p)
    return tuple(_wrap32(v) for v in (
        t10 + o3, t11 + o2, t12 + o1, t13 + o0, t13 - o0, t12 - o1,
        t11 - o2, t10 - o3))


def _idct_islow_simd(coefs, quant):
    """jsimd_idct_islow_avx2, which libjpeg-turbo runs for 8-bit samples
    on x86-64: jidctint.c's integer arithmetic on 16-bit lanes. On every
    block of a valid file it equals the C version; on the huge
    coefficients of a corrupt one the 16-bit dequantisation (pmullw), the
    16-bit sums, the saturation of the workspace (packssdw) and of the
    output (packsswb, then + 128) decide the samples. A block whose
    coefficients 8-63 are all 0 takes the shortcut: its dequantised DC
    row shifted left by PASS1_BITS in 16 bits."""
    c = np.asarray(coefs, np.int64).reshape(-1, 8, 8)
    d = _wrap16(c * np.asarray(quant, np.int64).reshape(8, 8))
    cols = _idct_1d_simd(*(d[:, r, :] for r in range(8)))
    n1 = _C - _P
    ws = np.stack([np.clip((v + (1 << (n1 - 1))) >> n1, -32768, 32767)
                   for v in cols], axis=1)
    dc_only = ~c[:, 1:, :].any(axis=(1, 2))
    if dc_only.any():
        ws[dc_only] = _wrap16(d[dc_only, :1, :] << _P)
    rows = _idct_1d_simd(*(ws[:, :, k] for k in range(8)))
    n2 = _C + _P + 3
    out = np.stack([np.clip((_wrap32(v + (1 << (n2 - 1))) >> n2), -128, 127)
                    for v in rows], axis=2)
    return (out + 128).astype(np.uint8)


def idct_islow(coefs, quant, precision=8):
    """(N, 64) natural-order coefficients, (64,) quantisation table ->
    (N, 8, 8) samples: at 8 bits libjpeg-turbo's AVX2 "islow" IDCT
    (_idct_islow_simd), at 12 bits (u16, PASS1_BITS 1, centre 2048)
    jidctint.c jpeg_idct_islow, which libjpeg-turbo runs there (its
    zero-column and zero-row shortcuts give the same values as the full
    passes)."""
    if precision == 8:
        return _idct_islow_simd(coefs, quant)
    p = 1
    # JCOEF coefficients (16 bits), a JLONG product, an int workspace
    d = (_wrap16(np.asarray(coefs, np.int64)) * quant).reshape(-1, 8, 8)
    cols = _idct_1d(*(d[:, r, :] for r in range(8)))  # over rows: columns
    n1 = _C - p
    ws = np.stack([_wrap32((v + (1 << (n1 - 1))) >> n1) for v in cols],
                  axis=1)
    rows = _idct_1d(*(ws[:, :, c] for c in range(8)))
    n2 = _C + p + 3
    out = np.stack([(v + (1 << (n2 - 1))) >> n2 for v in rows], axis=2)
    # the range-limit table: the low bits (10 at 8-bit samples) as a
    # signed value, + the centre, clamped (jdmaster.c
    # prepare_range_limit_table, RANGE_MASK = 4 * MAXJSAMPLE + 3)
    top = 1 << precision
    out = ((out & (4 * top - 1)) ^ (2 * top)) - 2 * top
    out = np.clip(out + top // 2, 0, top - 1)
    return out.astype(np.uint8 if precision == 8 else np.uint16)


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
    elif fr.lossless:  # jdsample.c: no fancy upsampling at 1 x 1 "blocks"
        out = np.repeat(np.repeat(plane, fv, axis=0), fh, axis=1)
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
    if not fr.eoi:
        # libjpeg reads on to EOI; PIL's source then runs out of data
        raise ValueError(f"JPEG file ends before its EOI marker (PIL: image "
                         f"file is truncated): {name}")
    if fr.lossless and ((len(planes) == 3 and not _is_rgb(fr)) or (
            len(planes) == 4 and fr.adobe and not cmyk_space)):
        raise ValueError(f"JPEG: colour conversion in lossless mode "
                         f"(libjpeg-turbo refuses it): {name}")
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
                      ycbcr: bool = False, precision: int = 8):
    """JPEG bytes -> ((H, W, components) samples, [(h, v) sampling
    factors of each component]), upsampled but not colour-converted (a
    TIFF strip's JPEG, which libtiff decodes as colour space "unknown"),
    or, with `ycbcr`, 3 components converted from YCbCr to RGB (libtiff's
    JPEGCOLORMODE_RGB). Samples are u8, or u16 for a 12-bit stream
    (`precision` 12, the only precision read then)."""
    fr, planes = _planes(data, name, precision)
    if ycbcr:
        if len(planes) != 3:
            raise ValueError(f"JPEG with {len(planes)} components is not "
                             f"YCbCr: {name}")
        planes = _ycc_to_rgb(*planes)
    dt = np.uint8 if precision == 8 else np.uint16
    return (np.stack([p.astype(dt) for p in planes], -1),
            [(c.h, c.v) for c in fr.comps])


def decode_raw(data: bytes, name: str = "<jpeg>"):
    """JPEG bytes -> (frame, [(IDCT samples of each component's whole block
    grid, u8), ...]) without upsampling or colour conversion, as
    jpeg_read_raw_data gives them (libtiff's old-style JPEG codec reads
    subsampled YCbCr so)."""
    fr, planes = _planes(data, name, upsample=False)
    return fr, planes


def _planes(data: bytes, name: str, precision: int = 8,
            upsample: bool = True):
    """The frame and its components' samples at full size, (H, W) each,
    or without `upsample` each component's block grid as decoded."""
    if not data.startswith(b"\xff\xd8"):
        raise ValueError(f"not a JPEG file: {name}")
    fr = _Frame()
    fr.precision = precision
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
                fr.eoi = True
                break
            if marker in (0x00, 0x01) or 0xD0 <= marker <= 0xD7:
                i += 2  # a stuffed FF 00, TEM or RSTn between segments
                continue
            if marker < 0xC0 or marker in (0xC8, 0xD8, 0xDE, 0xDF) or \
                    0xF0 <= marker <= 0xFD:
                raise ValueError(f"JPEG: marker 0x{marker:02X} (libjpeg: "
                                 f"unsupported or unknown marker)")
            length = data[i + 2] << 8 | data[i + 3]
            body = data[i + 4:i + 2 + length]
            i += 2 + length
            if 0xC0 <= marker <= 0xCF and marker not in (DHT, 0xC8, 0xCC):
                _parse_sof(fr, body, marker)
                seen_sof = True
            elif marker == DAC:
                _parse_dac(fr, body)
            elif marker == DHT:
                _parse_dht(fr, body)
            elif marker == DQT:
                _parse_dqt(fr, body)
            elif marker == DRI:
                if len(body) != 2:
                    raise ValueError("JPEG: DRI length (libjpeg: bogus "
                                     "marker length)")
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
        if fr.lossless:
            if c.samples is None:
                raise ValueError(f"JPEG: component {c.id} has no scan: "
                                 f"{name}")
            planes.append(_upsample(c.samples, c, fr))
            continue
        if c.quant is None:
            raise ValueError(f"JPEG: component {c.id} has no scan: {name}")
        coefs = np.array(c.coefs, np.int64).reshape(-1, 64)
        if smoothing:
            _smooth(fr, c, coefs)
        blocks = idct_islow(coefs, c.quant, fr.precision).reshape(
            c.bh, c.bw, 8, 8)
        plane = blocks.transpose(0, 2, 1, 3).reshape(c.bh * 8, c.bw * 8)
        planes.append(_upsample(plane, c, fr) if upsample else plane)
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

