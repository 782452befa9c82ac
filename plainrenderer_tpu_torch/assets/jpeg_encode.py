"""JPEG encoding without PIL, byte-equal to PIL's default
``Image.fromarray(a).save(path)`` for modes L and RGB (the JAX package's
save_image writes by suffix through PIL, plainrenderer_tpu/assets/
image_io.py:56-60).

PIL's defaults are libjpeg(-turbo)'s: quality 75 (the standard tables of
jcparam.c scaled by 50%), baseline sequential Huffman coding with the
standard tables (no optimisation, no restart markers), a JFIF APP0 marker
(version 1.01, no units, density 1 x 1), grey as one component and RGB as
YCbCr with 2 x 2 chroma subsampling (4:2:0). Every step is integer
arithmetic, so the bytes follow from libjpeg-turbo's C code (its SIMD
paths give the same bits for these steps):

  - jccolor.c rgb_ycc_convert: the fixed-point tables (SCALEBITS 16, the
    0.5 - epsilon rounding of Cb and Cr);
  - jcsample.c: right edges replicated to whole blocks, h2v2_downsample's
    alternating +1 / +2 bias; jcprepct.c: the bottom edge replicated to
    the row group, then to the whole iMCU row;
  - jfdctint.c's "islow" forward DCT (CONST_BITS 13, PASS1_BITS 2);
  - jcdctmgr.c's quantisation by reciprocal multiplication
    (compute_reciprocal with 16-bit DCT elements);
  - jccoefct.c's dummy blocks at the right and bottom of the last MCUs
    (zero AC, the DC of the block before them);
  - jchuff.c's entropy coding, vectorised in numpy: every symbol's code
    and amplitude bits are laid into 32-bit words at their bit offsets,
    then 0xFF bytes are stuffed and the last byte padded with ones.

RGBA is refused as PIL refuses it ("cannot write mode RGBA as JPEG").
"""

from __future__ import annotations

import struct

import numpy as np

from .jpeg import STD_HUFFMAN, ZIGZAG

# jcparam.c: the standard quantisation tables (natural order) ...
_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_CHROMA_Q = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99]
    + [99] * 32)
# ... and Huffman tables (jpeg.py keeps them: the decoder's defaults too)
_DC_LUMA, _AC_LUMA, _DC_CHROMA, _AC_CHROMA = (
    STD_HUFFMAN[(0, 0)], STD_HUFFMAN[(1, 0)], STD_HUFFMAN[(0, 1)],
    STD_HUFFMAN[(1, 1)])
# jfdctint.c's constants, FIX(x) at CONST_BITS 13
_CONST_BITS, _PASS1_BITS = 13, 2
(_F0298, _F0390, _F0541, _F0765, _F0899, _F1175, _F1501, _F1847, _F1961,
 _F2053, _F2562, _F3072) = (2446, 3196, 4433, 6270, 7373, 9633, 12299,
                            15137, 16069, 16819, 20995, 25172)


def _quant_table(basic: np.ndarray) -> np.ndarray:
    """jcparam.c jpeg_set_quality(75): the basic table scaled by 200 - 2 x
    75 percent, 1-255."""
    return np.clip((basic * 50 + 50) // 100, 1, 255)


def _reciprocals(q: np.ndarray):
    """jcdctmgr.c compute_reciprocal for the islow divisors q << 3, with
    16-bit DCT elements: (reciprocal, correction, shift) per entry."""
    recip, corr, shift = [], [], []
    for d in (q.astype(np.int64) << 3).tolist():
        b = d.bit_length() - 1
        r = 16 + b
        fq, fr = divmod(1 << r, d)
        c = d // 2
        if fr == 0:
            fq >>= 1
            r -= 1
        elif fr <= d // 2:
            c += 1
        else:
            fq += 1
        recip.append(fq)
        corr.append(c)
        shift.append(r)
    return (np.array(recip, np.int64), np.array(corr, np.int64),
            np.array(shift, np.int64))


def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


def _fdct_pass(d, axis, last: bool):
    """One pass of jpeg_fdct_islow along `axis` (rows first, then
    columns) of int64 blocks."""
    x = [np.take(d, k, axis=axis) for k in range(8)]
    tmp0, tmp7 = x[0] + x[7], x[0] - x[7]
    tmp1, tmp6 = x[1] + x[6], x[1] - x[6]
    tmp2, tmp5 = x[2] + x[5], x[2] - x[5]
    tmp3, tmp4 = x[3] + x[4], x[3] - x[4]
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    n = _CONST_BITS + _PASS1_BITS if last else _CONST_BITS - _PASS1_BITS
    out = [None] * 8
    if last:
        out[0] = _descale(tmp10 + tmp11, _PASS1_BITS)
        out[4] = _descale(tmp10 - tmp11, _PASS1_BITS)
    else:
        out[0] = (tmp10 + tmp11) << _PASS1_BITS
        out[4] = (tmp10 - tmp11) << _PASS1_BITS
    z1 = (tmp12 + tmp13) * _F0541
    out[2] = _descale(z1 + tmp13 * _F0765, n)
    out[6] = _descale(z1 - tmp12 * _F1847, n)
    z1, z2 = tmp4 + tmp7, tmp5 + tmp6
    z3, z4 = tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * _F1175
    tmp4, tmp5 = tmp4 * _F0298, tmp5 * _F2053
    tmp6, tmp7 = tmp6 * _F3072, tmp7 * _F1501
    z1, z2 = z1 * -_F0899, z2 * -_F2562
    z3, z4 = z3 * -_F1961 + z5, z4 * -_F0390 + z5
    out[7] = _descale(tmp4 + z1 + z3, n)
    out[5] = _descale(tmp5 + z2 + z4, n)
    out[3] = _descale(tmp6 + z2 + z3, n)
    out[1] = _descale(tmp7 + z1 + z4, n)
    return np.stack(out, axis=axis)


def _quantized_blocks(plane: np.ndarray, q: np.ndarray) -> np.ndarray:
    """(8 by, 8 bx) samples -> (by, bx, 64) quantised coefficients in
    zigzag order (forward_DCT: level shift, islow DCT, quantize)."""
    by, bx = plane.shape[0] // 8, plane.shape[1] // 8
    blocks = plane.reshape(by, 8, bx, 8).transpose(0, 2, 1, 3).astype(
        np.int64) - 128
    coef = _fdct_pass(_fdct_pass(blocks, -1, False), -2, True)
    coef = coef.reshape(by, bx, 64)
    recip, corr, shift = _reciprocals(q)
    mag = ((np.abs(coef) + corr) * recip) >> shift
    return np.where(coef < 0, -mag, mag)[..., ZIGZAG]


def _pad(plane: np.ndarray, h: int, w: int) -> np.ndarray:
    """The plane with its last row and column replicated to h x w."""
    return np.pad(plane, ((0, h - plane.shape[0]), (0, w - plane.shape[1])),
                  mode="edge")


def _ycc(rgb: np.ndarray):
    """jccolor.c rgb_ycc_convert on (H, W, 3) u8: Y, Cb, Cr as int64."""
    def fix(x):
        return int(x * 65536 + 0.5)
    r, g, b = (rgb[..., k].astype(np.int64) for k in range(3))
    half, offset = 1 << 15, 128 << 16
    y = (fix(0.299) * r + fix(0.587) * g + fix(0.114) * b + half) >> 16
    cb = (-fix(0.16874) * r - fix(0.33126) * g + fix(0.5) * b + offset
          + half - 1) >> 16
    cr = (fix(0.5) * r - fix(0.41869) * g - fix(0.08131) * b + offset
          + half - 1) >> 16
    return y, cb, cr


def _h2v2(plane: np.ndarray) -> np.ndarray:
    """jcsample.c h2v2_downsample of an even-sized plane: the 2 x 2 sum
    plus the bias 1, 2, 1, 2, ... along each output row, over 4."""
    s = (plane[0::2, 0::2] + plane[0::2, 1::2] + plane[1::2, 0::2]
         + plane[1::2, 1::2])
    bias = 1 + (np.arange(s.shape[1]) & 1)
    return (s + bias) >> 2


def _huffman_codes(spec):
    """jchuff.c jpeg_make_c_derived_tbl: (code, length) per symbol."""
    counts, symbols = spec
    code_of = np.zeros(256, np.int64)
    size_of = np.zeros(256, np.int64)
    code, k = 0, 0
    for length, n in enumerate(counts, 1):
        for _ in range(n):
            code_of[symbols[k]], size_of[symbols[k]] = code, length
            code += 1
            k += 1
        code <<= 1
    return code_of, size_of


def _nbits(v: np.ndarray) -> np.ndarray:
    """The bit length of |v| (0 for 0)."""
    a = np.abs(v)
    n = np.zeros(a.shape, np.int64)
    for k in range(16):
        n += (a >> k) > 0
    return n


def _amplitude(v: np.ndarray, n: np.ndarray) -> np.ndarray:
    """The n low bits of v, or of v - 1 where v is negative."""
    return np.where(v < 0, v - 1, v) & ((1 << n) - 1)


def _symbols(coefs: np.ndarray, table: np.ndarray, tables):
    """Blocks in scan order -> (codes, lengths) of every Huffman code with
    its amplitude bits, in order. `coefs` is (N, 64) zigzag with each DC
    already replaced by its difference; `table` is each block's table
    pair; `tables` the ((dc codes, dc sizes), (ac codes, ac sizes))
    pairs."""
    n = coefs.shape[0]
    dc_code = np.stack([t[0][0] for t in tables])
    dc_size = np.stack([t[0][1] for t in tables])
    ac_code = np.stack([t[1][0] for t in tables])
    ac_size = np.stack([t[1][1] for t in tables])
    # DC: the category's code, then its amplitude bits
    diff = coefs[:, 0]
    s = _nbits(diff)
    keys = [np.arange(n) * 260]
    vals = [dc_code[table, s] << s | _amplitude(diff, s)]
    lens = [dc_size[table, s] + s]
    # AC: runs of zeros (ZRL per 16), then the (run, size) symbol
    b, k = np.nonzero(coefs[:, 1:])
    k = k + 1
    v = coefs[b, k]
    first = np.ones(b.size, bool)
    first[1:] = b[1:] != b[:-1]
    prev = np.where(first, 0, np.concatenate(([0], k[:-1])))
    run = k - prev - 1
    zrl = run >> 4
    s = _nbits(v)
    sym = (run & 15) << 4 | s
    tb = table[b]
    keys.append(b * 260 + 4 * k + zrl)
    vals.append(ac_code[tb, sym] << s | _amplitude(v, s))
    lens.append(ac_size[tb, sym] + s)
    zb = np.repeat(np.arange(b.size), zrl)
    if zb.size:
        j = np.arange(zb.size) - np.repeat(np.cumsum(zrl) - zrl, zrl)
        keys.append(b[zb] * 260 + 4 * k[zb] + j)
        vals.append(ac_code[tb[zb], 0xF0])
        lens.append(ac_size[tb[zb], 0xF0])
    # EOB where the block ends in zeros
    last = np.zeros(n, np.int64)
    np.maximum.at(last, b, k)
    eob = np.nonzero(last < 63)[0]
    keys.append(eob * 260 + 259)
    vals.append(ac_code[table[eob], 0])
    lens.append(ac_size[table[eob], 0])
    order = np.argsort(np.concatenate(keys), kind="stable")
    return np.concatenate(vals)[order], np.concatenate(lens)[order]


def _bitstream(vals: np.ndarray, lens: np.ndarray) -> bytes:
    """The codes packed MSB first, padded with ones to a byte, with a
    0x00 stuffed after every 0xFF."""
    total = int(lens.sum())
    nbytes = (total + 7) // 8
    nwords = (nbytes + 3) // 4 + 1
    start = np.cumsum(lens) - lens
    word, off = start >> 5, start & 31
    # each code (at most 27 bits) in a 64-bit window of two words
    window = vals.astype(np.uint64) << (64 - off - lens).astype(np.uint64)
    hi = (window >> np.uint64(32)).astype(np.float64)
    lo = (window & np.uint64(0xFFFFFFFF)).astype(np.float64)
    words = (np.bincount(word, hi, nwords) + np.bincount(word + 1, lo, nwords))
    words = words.astype(np.uint64)
    pad = nbytes * 8 - total
    if pad:
        words[total >> 5] |= np.uint64(((1 << pad) - 1) << (
            31 - ((total + pad - 1) & 31)))
    out = words.astype(">u4").view(np.uint8)[:nbytes]
    ff = np.nonzero(out == 0xFF)[0]
    return np.insert(out, ff + 1, 0).tobytes()


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


def encode_jpeg(image: np.ndarray) -> bytes:
    """(H, W) or (H, W, 3) u8 -> JPEG bytes equal to PIL's default save
    of the array. RGBA raises ValueError, as in PIL."""
    img = np.asarray(image)
    if img.ndim == 3 and img.shape[2] == 4:
        raise ValueError("cannot write mode RGBA as JPEG")
    if img.dtype != np.uint8 or not (
            img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"encode_jpeg takes (H, W) or (H, W, 3) uint8, got "
                         f"{img.dtype} {img.shape}")
    h, w = img.shape[:2]
    if not (0 < h < 65536 and 0 < w < 65536):
        raise ValueError(f"JPEG size {w}x{h} is outside 1-65535")
    qy, qc = _quant_table(_LUMA_Q), _quant_table(_CHROMA_Q)
    luma = (_huffman_codes(_DC_LUMA), _huffman_codes(_AC_LUMA))
    chroma = (_huffman_codes(_DC_CHROMA), _huffman_codes(_AC_CHROMA))
    if img.ndim == 2:
        # one component, a non-interleaved scan of its blocks
        bh, bw = -(-h // 8), -(-w // 8)
        z = _quantized_blocks(_pad(img, 8 * bh, 8 * bw), qy).reshape(-1, 64)
        z[:, 0] = np.diff(z[:, 0], prepend=0)
        vals, lens = _symbols(z, np.zeros(len(z), np.int64), [luma])
        comps, tables = [(1, 0x11, 0)], [(0, qy)]
        huff = [(0x00, _DC_LUMA), (0x10, _AC_LUMA)]
    else:
        mh, mw = -(-h // 16), -(-w // 16)  # MCUs of 16 x 16 pixels
        y, cb, cr = _ycc(img)
        # the image rows to an even count (the row group), then each
        # plane's rows and columns replicated to whole iMCU rows and MCUs
        he = h + (h & 1)
        cbd = [_h2v2(_pad(c, he, 16 * mw)) for c in (cb, cr)]
        zy = _quantized_blocks(_pad(y, 16 * mh, 16 * mw), qy)
        zc = [_quantized_blocks(_pad(c, 8 * mh, 8 * mw), qc) for c in cbd]
        # jccoefct.c dummy blocks: past the image's last block column and
        # row, AC 0 and the DC of the block before them in the MCU
        if -(-w // 8) % 2:
            zy[:, -1] = 0
            zy[:, -1, 0] = zy[:, -2, 0]
        if -(-h // 8) % 2:
            dc = zy[-2, 1::2, 0].copy()
            zy[-1] = 0
            zy[-1, 0::2, 0] = dc
            zy[-1, 1::2, 0] = dc
        mcu_y = zy.reshape(mh, 2, mw, 2, 64).transpose(0, 2, 1, 3, 4)
        z = np.concatenate([mcu_y.reshape(mh, mw, 4, 64)]
                           + [c.reshape(mh, mw, 1, 64) for c in zc], axis=2)
        for lo, hi in ((0, 4), (4, 5), (5, 6)):  # DC differences per comp
            dc = z[:, :, lo:hi, 0].reshape(-1)
            z[:, :, lo:hi, 0] = np.diff(dc, prepend=0).reshape(mh, mw,
                                                               hi - lo)
        z = z.reshape(-1, 64)
        which = np.tile(np.array([0, 0, 0, 0, 1, 1]), mh * mw)
        vals, lens = _symbols(z, which, [luma, chroma])
        comps = [(1, 0x22, 0), (2, 0x11, 1), (3, 0x11, 1)]
        tables = [(0, qy), (1, qc)]
        huff = [(0x00, _DC_LUMA), (0x10, _AC_LUMA), (0x01, _DC_CHROMA),
                (0x11, _AC_CHROMA)]
    out = [b"\xff\xd8",
           _segment(0xE0, b"JFIF\x00\x01\x01\x00" + struct.pack(">HH", 1, 1)
                    + b"\x00\x00")]
    for tq, q in tables:
        out.append(_segment(0xDB, bytes([tq]) + bytes(
            q.reshape(-1)[ZIGZAG].astype(np.uint8))))
    out.append(_segment(0xC0, struct.pack(">BHHB", 8, h, w, len(comps))
                        + b"".join(bytes(c) for c in comps)))
    for tc, (counts, symbols) in huff:
        out.append(_segment(0xC4, bytes([tc]) + bytes(counts)
                            + bytes(symbols)))
    sel = [(1, 0x00), (2, 0x11), (3, 0x11)][:len(comps)]
    out.append(_segment(0xDA, bytes([len(comps)])
                        + b"".join(bytes(s) for s in sel) + b"\x00\x3f\x00"))
    out.append(_bitstream(vals, lens))
    out.append(b"\xff\xd9")
    return b"".join(out)
