"""WebP lossless (VP8L) decoding without PIL, bit for bit as libwebp 1.6's
src/dec/vp8l_dec.c and src/dsp/lossless.c decode it (Pillow 12.1 reads
WebP through libwebp).

Covered: the 5-byte header; the four transforms (predictor with its 14
modes, cross-colour, subtract-green, colour indexing with pixel
bundling), applied in reverse order of reading; the colour cache; meta
Huffman codes (entropy image, one group of five codes per meta code);
simple and normal Huffman codes (code-length codes, repeat codes 16-18,
the max_symbol field; a code of one symbol reads no bits); LZ77 backward
references with the 120 2-D distance codes. ``decode_argb`` returns the
(H, W) u32 ARGB image; ``decode_image_stream`` is the header-less stream
that WebP's ALPH chunk stores (alpha in the green channel).

The decoder is a Python loop over the symbols (the bit reader indexes a
precomputed list of 64-bit windows); the inverse transforms other than
the predictor's serial rows are numpy.
"""

from __future__ import annotations

import numpy as np

_CODE_LENGTH_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12,
                      13, 14, 15)
# vp8l_dec.c kCodeToPlane: (yoffset << 4) | (8 - xoffset)
_CODE_TO_PLANE = bytes.fromhex(
    "1807171928062729161a262a38053739151b363a252b48044749141c353b464a"
    "242c58454b343c035759131d565a232d444c555b333d68026769121e666a222e"
    "545c434d656b323e78017779535d111f646c424e767a212f757b313f636d525e"
    "00747c414f1020626e30737d515f40727e616f50717f6070")
_GREEN, _RED, _BLUE, _ALPHA, _DIST = range(5)


class _Bits:
    """LSB-first bit reader over 64-bit windows."""

    def __init__(self, data: bytes):
        b = np.frombuffer(bytes(data) + b"\0" * 8, np.uint8).astype(np.uint64)
        n = len(data)
        win = np.zeros(n + 1, np.uint64)
        for k in range(8):
            win |= b[k:k + n + 1] << np.uint64(8 * k)
        self.win = win.tolist()
        self.pos = 0
        self.end = 8 * n

    def read(self, n: int) -> int:
        pos = self.pos
        self.pos = pos + n
        if self.pos > self.end:
            raise ValueError("VP8L: bitstream truncated")
        return (self.win[pos >> 3] >> (pos & 7)) & ((1 << n) - 1)


def _build_table(lengths):
    """Canonical code of `lengths` (by symbol) -> (lookup list indexed by
    the next `bits` stream bits, bits): entry = symbol << 4 | length."""
    lengths = np.asarray(lengths, np.int64)
    syms = np.flatnonzero(lengths)
    if syms.size == 0:
        raise ValueError("VP8L: a Huffman code without symbols")
    if syms.size == 1:
        return [int(syms[0]) << 4], 0
    maxlen = int(lengths.max())
    table = np.zeros(1 << maxlen, np.int64)
    code = 0
    order = sorted(syms.tolist(), key=lambda s: (lengths[s], s))
    prev_len = int(lengths[order[0]])
    for s in order:
        ln = int(lengths[s])
        code <<= ln - prev_len
        prev_len = ln
        if code >= 1 << ln:
            raise ValueError("VP8L: an over-subscribed Huffman code")
        rev = int(f"{code:0{ln}b}"[::-1], 2)
        table[rev::1 << ln] = s << 4 | ln
        code += 1
    if code != 1 << prev_len:
        raise ValueError("VP8L: an incomplete Huffman code")
    return table.tolist(), maxlen


def _read_symbol(br, code):
    table, bits = code
    pos = br.pos
    e = table[(br.win[pos >> 3] >> (pos & 7)) & ((1 << bits) - 1)]
    br.pos = pos + (e & 15)
    return e >> 4


def _read_code(br, alphabet: int):
    if br.read(1):  # simple code
        lengths = [0] * alphabet
        n = br.read(1) + 1
        s0 = br.read(8 if br.read(1) else 1)
        lengths[s0] = 1
        if n == 2:
            lengths[br.read(8)] = 1
        return _build_table(lengths)
    n = br.read(4) + 4
    cl = [0] * 19
    for i in range(n):
        cl[_CODE_LENGTH_ORDER[i]] = br.read(3)
    cl_code = _build_table(cl)
    if br.read(1):
        max_symbol = 2 + br.read(2 + 2 * br.read(3))
        if max_symbol > alphabet:
            raise ValueError("VP8L: max_symbol past the alphabet")
    else:
        max_symbol = alphabet
    lengths = [0] * alphabet
    sym, prev = 0, 8
    while sym < alphabet:
        if max_symbol == 0:
            break
        max_symbol -= 1
        c = _read_symbol(br, cl_code)
        if c < 16:
            lengths[sym] = c
            sym += 1
            if c:
                prev = c
        else:
            extra, offset = ((2, 3), (3, 3), (7, 11))[c - 16]
            rep = br.read(extra) + offset
            if sym + rep > alphabet:
                raise ValueError("VP8L: a repeat past the alphabet")
            val = prev if c == 16 else 0
            lengths[sym:sym + rep] = [val] * rep
            sym += rep
    return _build_table(lengths)


def _copy_distance(br, sym: int) -> int:
    if sym < 4:
        return sym + 1
    extra = (sym - 2) >> 1
    return ((2 + (sym & 1)) << extra) + br.read(extra) + 1


def _subimage_size(n: int, bits: int) -> int:
    return (n + (1 << bits) - 1) >> bits


def _decode_stream(br, w: int, h: int, level0: bool) -> list:
    """DecodeImageStream: the entropy-coded image (w * h ARGB ints)."""
    cache_bits = 0
    if br.read(1):
        cache_bits = br.read(4)
        if not 1 <= cache_bits <= 11:
            raise ValueError(f"VP8L: colour cache of {cache_bits} bits")
    huff_bits, huff_image, huff_w = 0, None, 1
    if level0 and br.read(1):
        huff_bits = br.read(3) + 2
        huff_w = _subimage_size(w, huff_bits)
        sub = _decode_stream(br, huff_w, _subimage_size(h, huff_bits), False)
        huff_image = [(p >> 8) & 0xFFFF for p in sub]
    n_groups = max(huff_image) + 1 if huff_image else 1
    cache_size = (1 << cache_bits) if cache_bits else 0
    groups = []
    for _ in range(n_groups):
        groups.append([_read_code(br, a) for a in (
            256 + 24 + cache_size, 256, 256, 256, 40)])
    return _decode_pixels(br, w, h, groups, huff_image, huff_bits, huff_w,
                          cache_bits)


def _decode_pixels(br, w, h, groups, huff_image, huff_bits, huff_w,
                   cache_bits):
    total = w * h
    out = [0] * total
    cache = [0] * (1 << cache_bits) if cache_bits else None
    cache_shift = 32 - cache_bits
    cached = 0  # pixels inserted into the cache so far
    pos = 0
    group = groups[0]
    win = br.win
    while pos < total:
        x, y = pos % w, pos // w
        if huff_image is not None:
            group = groups[huff_image[(y >> huff_bits) * huff_w
                                      + (x >> huff_bits)]]
        green = group[_GREEN]
        bp = br.pos
        e = green[0][(win[bp >> 3] >> (bp & 7)) & ((1 << green[1]) - 1)]
        br.pos = bp + (e & 15)
        code = e >> 4
        if code < 256:
            r = _read_symbol(br, group[_RED])
            b = _read_symbol(br, group[_BLUE])
            a = _read_symbol(br, group[_ALPHA])
            out[pos] = (a << 24) | (r << 16) | (code << 8) | b
            pos += 1
        elif code < 280:
            length = _copy_distance(br, code - 256)
            dsym = _read_symbol(br, group[_DIST])
            dcode = _copy_distance(br, dsym)
            if dcode > 120:
                dist = dcode - 120
            else:
                p = _CODE_TO_PLANE[dcode - 1]
                dist = max(1, (p >> 4) * w + 8 - (p & 15))
            if dist > pos or pos + length > total:
                raise ValueError("VP8L: a backward reference out of the "
                                 "image")
            if dist >= length:
                out[pos:pos + length] = out[pos - dist:pos - dist + length]
            else:
                for i in range(length):
                    out[pos + i] = out[pos + i - dist]
            pos += length
        else:
            if cache is None:
                raise ValueError("VP8L: a colour-cache code without a cache")
            while cached < pos:
                p = out[cached]
                cache[((p * 0x1E35A7BD) & 0xFFFFFFFF) >> cache_shift] = p
                cached += 1
            out[pos] = cache[code - 280]
            pos += 1
        if br.pos > br.end:
            raise ValueError("VP8L: bitstream truncated")
    return out


def _avg2(a, b):
    return (((a ^ b) & 0xFEFEFEFE) >> 1) + (a & b)


def _bytes4(p):
    return ((p >> 24) & 255, (p >> 16) & 255, (p >> 8) & 255, p & 255)


def _select(t, l, tl):
    ta, tb, tc = _bytes4(t), _bytes4(l), _bytes4(tl)
    pa_minus_pb = sum(abs(b - c) - abs(a - c) for a, b, c in zip(ta, tb, tc))
    return t if pa_minus_pb <= 0 else l


def _clamp_full(c0, c1, c2):
    out = 0
    for s in (24, 16, 8, 0):
        v = ((c0 >> s) & 255) + ((c1 >> s) & 255) - ((c2 >> s) & 255)
        out |= (0 if v < 0 else 255 if v > 255 else v) << s
    return out


def _clamp_half(c0, c2):
    out = 0
    for s in (24, 16, 8, 0):
        a, b = (c0 >> s) & 255, (c2 >> s) & 255
        d = a - b
        v = a + (d // 2 if d >= 0 else -((-d) // 2))
        out |= (0 if v < 0 else 255 if v > 255 else v) << s
    return out


def _predict(mode, L, T, TR, TL):
    if mode == 1:
        return L
    if mode == 2:
        return T
    if mode == 3:
        return TR
    if mode == 4:
        return TL
    if mode == 5:
        return _avg2(_avg2(L, TR), T)
    if mode == 6:
        return _avg2(L, TL)
    if mode == 7:
        return _avg2(L, T)
    if mode == 8:
        return _avg2(TL, T)
    if mode == 9:
        return _avg2(T, TR)
    if mode == 10:
        return _avg2(_avg2(L, TL), _avg2(T, TR))
    if mode == 11:
        return _select(T, L, TL)
    if mode == 12:
        return _clamp_full(L, T, TL)
    if mode == 13:
        return _clamp_half(_avg2(L, T), TL)
    return 0xFF000000  # 0, and the sentinels 14 and 15


def _add(a, b):
    return ((((a & 0xFF00FF00) + (b & 0xFF00FF00)) & 0xFF00FF00)
            | (((a & 0x00FF00FF) + (b & 0x00FF00FF)) & 0x00FF00FF))


def _inverse_predictor(px, w, h, bits, sub):
    sw = _subimage_size(w, bits)
    px[0] = _add(px[0], 0xFF000000)
    for x in range(1, w):
        px[x] = _add(px[x], px[x - 1])
    for y in range(1, h):
        row = y * w
        px[row] = _add(px[row], px[row - w])
        modes = [(sub[(y >> bits) * sw + (x >> bits)] >> 8) & 15
                 for x in range(w)]
        for x in range(1, w):
            i = row + x
            px[i] = _add(px[i], _predict(modes[x], px[i - 1], px[i - w],
                                         px[i - w + 1], px[i - w - 1]))
    return px


def _inverse_cross_color(px, w, h, bits, sub):
    a = np.asarray(px, np.uint32).reshape(h, w)
    sw = _subimage_size(w, bits)
    m = np.asarray(sub, np.uint32).reshape(-1, sw)
    m = m[np.arange(h)[:, None] >> bits, np.arange(w)[None, :] >> bits]
    g2r = (m & 255).astype(np.uint8).view(np.int8).astype(np.int64)
    g2b = ((m >> 8) & 255).astype(np.uint8).view(np.int8).astype(np.int64)
    r2b = ((m >> 16) & 255).astype(np.uint8).view(np.int8).astype(np.int64)
    green = ((a >> 8) & 255).astype(np.uint8).view(np.int8).astype(np.int64)
    red = ((a >> 16) & 255).astype(np.int64)
    blue = (a & 255).astype(np.int64)
    red = (red + ((g2r * green) >> 5)) & 255
    red8 = red.astype(np.uint8).view(np.int8).astype(np.int64)
    blue = (blue + ((g2b * green) >> 5) + ((r2b * red8) >> 5)) & 255
    out = (a & np.uint32(0xFF00FF00)) | (red.astype(np.uint32) << 16) \
        | blue.astype(np.uint32)
    return out.ravel().tolist()


def _inverse_subtract_green(px):
    a = np.asarray(px, np.uint32)
    g = (a >> 8) & 255
    rb = ((a & np.uint32(0x00FF00FF)) + ((g << 16) | g)) & np.uint32(
        0x00FF00FF)
    return ((a & np.uint32(0xFF00FF00)) | rb).tolist()


def _inverse_color_index(px, w, h, bits, palette):
    """px: the packed image (its width w >> bits rounded up) -> w x h."""
    table = np.zeros(256, np.uint32)
    table[:len(palette)] = palette
    pw = _subimage_size(w, bits)
    idx = ((np.asarray(px, np.uint32).reshape(h, pw) >> 8) & 255)
    if bits:
        per = 1 << bits
        nb = 8 >> bits
        shifts = (np.arange(per) * nb).astype(np.uint32)
        idx = ((idx[:, :, None] >> shifts) & ((1 << nb) - 1)).reshape(
            h, pw * per)[:, :w]
    return table[idx].ravel().tolist()


def decode_image_stream(data: bytes, w: int, h: int) -> list:
    """A VP8L image stream without its header (as in an ALPH chunk):
    transforms, then the entropy-coded image -> w * h ARGB ints."""
    return _decode_with_transforms(_Bits(data), w, h)


def _decode_with_transforms(br, w, h):
    transforms = []
    xsize = w
    seen = set()
    while br.read(1):
        t = br.read(2)
        if t in seen:
            raise ValueError("VP8L: a transform used twice")
        seen.add(t)
        if t in (0, 1):
            bits = br.read(3) + 2
            sub = _decode_stream(br, _subimage_size(xsize, bits),
                                 _subimage_size(h, bits), False)
            transforms.append((t, bits, sub, xsize))
        elif t == 2:
            transforms.append((t, 0, None, xsize))
        else:
            n = br.read(8) + 1
            bits = 0 if n > 16 else 1 if n > 4 else 2 if n > 2 else 3
            pal = _decode_stream(br, n, 1, False)
            for i in range(1, n):
                pal[i] = _add(pal[i], pal[i - 1])
            transforms.append((t, bits, pal, xsize))
            xsize = _subimage_size(xsize, bits)
    px = _decode_stream(br, xsize, h, True)
    for t, bits, data, tw in reversed(transforms):
        if t == 0:
            px = _inverse_predictor(px, tw, h, bits, data)
        elif t == 1:
            px = _inverse_cross_color(px, tw, h, bits, data)
        elif t == 2:
            px = _inverse_subtract_green(px)
        else:
            px = _inverse_color_index(px, tw, h, bits, data)
    return px


def read_header(data: bytes) -> tuple[int, int, bool]:
    """The VP8L header: (width, height, alpha_is_used)."""
    if len(data) < 5 or data[0] != 0x2F:
        raise ValueError("VP8L: missing the 0x2f signature")
    v = int.from_bytes(data[1:5], "little")
    if v >> 29:
        raise ValueError(f"VP8L: version {v >> 29} is not 0")
    return (v & 0x3FFF) + 1, ((v >> 14) & 0x3FFF) + 1, bool((v >> 28) & 1)


def decode_argb(data: bytes) -> np.ndarray:
    """A VP8L bitstream (the chunk's payload) -> (H, W) u32 ARGB."""
    w, h, _ = read_header(data)
    br = _Bits(data)
    br.pos = 40
    px = _decode_with_transforms(br, w, h)
    return np.asarray(px, np.uint32).reshape(h, w)
