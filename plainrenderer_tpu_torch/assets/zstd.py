"""Zstandard decoding (RFC 8878) without a zstd module, for TIFF
compression 50000 (libtiff's tif_zstd.c, which PIL's libtiff calls, runs
ZSTD_decompressStream until the strip is full or the frame ends).

Covered: frames with or without a window descriptor, frame content size
and XXH64 content checksum (checked when the frame's flag sets it);
skippable frames and concatenated frames (decode); raw, RLE and
compressed blocks; literals raw, RLE, Huffman-compressed in 1 or 4
streams (the jump table, direct or FSE-compressed weights) and treeless
(the previous block's Huffman table); sequences with predefined, RLE,
FSE-compressed and repeat tables (the RFC's default distributions), the
three repeat offsets and the window of everything decoded before. A
dictionary ID raises ValueError naming it, as does every corruption the
reference decoder detects: a table that does not sum up, a stream not
consumed to its last bit, an offset before the frame's start, a block
past 128 KiB. Every error names ZSTD.
"""

from __future__ import annotations

MAGIC = 0xFD2FB528
_M64 = (1 << 64) - 1
_P1, _P2, _P3, _P4, _P5 = (11400714785074694791, 14029467366897019727,
                           1609587929392839161, 9650029242287828579,
                           2870177450012600261)
BLOCK_MAX = 128 << 10

# RFC 8878 3.1.1.3.2.1: (baseline, extra bits) of each code
_LL = [(i, 0) for i in range(16)] + [
    (16, 1), (18, 1), (20, 1), (22, 1), (24, 2), (28, 2), (32, 3), (40, 3),
    (48, 4), (64, 6), (128, 7), (256, 8), (512, 9), (1024, 10), (2048, 11),
    (4096, 12), (8192, 13), (16384, 14), (32768, 15), (65536, 16)]
_ML = [(i + 3, 0) for i in range(32)] + [
    (35, 1), (37, 1), (39, 1), (41, 1), (43, 2), (47, 2), (51, 3), (59, 3),
    (67, 4), (83, 4), (99, 5), (131, 7), (259, 8), (515, 9), (1027, 10),
    (2051, 11), (4099, 12), (8195, 13), (16387, 14), (32771, 15),
    (65539, 16)]
# 3.1.1.3.2.2: the predefined distributions and their accuracy logs
_LL_DEFAULT = ([4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2,
                2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1], 6)
_ML_DEFAULT = ([1, 4, 3, 2, 2, 2, 2, 2, 2] + [1] * 37 + [-1] * 7, 6)
_OF_DEFAULT = ([1, 1, 1, 1, 1, 1, 2, 2, 2] + [1] * 15 + [-1] * 5, 5)


def _err(what: str):
    return ValueError(f"ZSTD data is corrupt: {what}")


def _rotl(x, r):
    return ((x << r) | (x >> (64 - r))) & _M64


def _round(acc, lane):
    return _rotl((acc + lane * _P2) & _M64, 31) * _P1 & _M64


def xxh64(data: bytes, seed: int = 0) -> int:
    """XXH64 of data (the frame checksum is its low 32 bits)."""
    n, i = len(data), 0
    if n >= 32:
        v = [(seed + _P1 + _P2) & _M64, (seed + _P2) & _M64, seed,
             (seed - _P1) & _M64]
        lanes = memoryview(data)[:n - n % 32].cast("Q")
        for k in range(0, len(lanes), 4):
            v[0] = _round(v[0], lanes[k])
            v[1] = _round(v[1], lanes[k + 1])
            v[2] = _round(v[2], lanes[k + 2])
            v[3] = _round(v[3], lanes[k + 3])
        acc = (_rotl(v[0], 1) + _rotl(v[1], 7) + _rotl(v[2], 12)
               + _rotl(v[3], 18)) & _M64
        for x in v:
            acc = ((acc ^ _round(0, x)) * _P1 + _P4) & _M64
        i = n - n % 32
    else:
        acc = (seed + _P5) & _M64
    acc = (acc + n) & _M64
    while i + 8 <= n:
        acc ^= _round(0, int.from_bytes(data[i:i + 8], "little"))
        acc = (_rotl(acc, 27) * _P1 + _P4) & _M64
        i += 8
    if i + 4 <= n:
        acc ^= int.from_bytes(data[i:i + 4], "little") * _P1 & _M64
        acc = (_rotl(acc, 23) * _P2 + _P3) & _M64
        i += 4
    while i < n:
        acc ^= data[i] * _P5 & _M64
        acc = _rotl(acc, 11) * _P1 & _M64
        i += 1
    acc ^= acc >> 33
    acc = acc * _P2 & _M64
    acc ^= acc >> 29
    acc = acc * _P3 & _M64
    return acc ^ (acc >> 32)


class _Back:
    """A backward bit stream (3.1.1.3.1.1 and 4.1.x): its last byte's
    highest set bit marks the start; fields are read from there towards
    the first byte, most significant bit first. Reading past the first
    byte reads zeros (the caller checks for overflow)."""

    def __init__(self, data: bytes):
        if not data or data[-1] == 0:
            raise _err("a bit stream without its end mark")
        self.buf = bytes(8) + data + bytes(8)
        self.pos = len(data) * 8 - 8 + data[-1].bit_length() - 1 + 64

    def read(self, n):
        if n == 0:
            return 0
        self.pos -= n
        p = self.pos
        if p < 32:
            raise _err("a bit stream read far past its start")
        i = p >> 3
        return (int.from_bytes(self.buf[i:i + 8], "little") >> (p & 7)) \
            & ((1 << n) - 1)

    def peek(self, n):
        p = self.pos - n
        i = p >> 3
        return (int.from_bytes(self.buf[i:i + 8], "little") >> (p & 7)) \
            & ((1 << n) - 1)

    def left(self):
        """Bits not read yet (negative after an overflow)."""
        return self.pos - 64


def _read_ncount(data: bytes, pos: int, max_symbol: int, max_log: int):
    """4.1.1 (FSE_readNCount): the normalised counts and accuracy log of
    an FSE table description at data[pos:]; returns (counts, log, bytes
    read)."""
    def bits_at(bit):
        i = pos + (bit >> 3)
        return int.from_bytes(data[i:i + 4].ljust(4, b"\0"), "little") \
            >> (bit & 7)
    if pos >= len(data):
        raise _err("an FSE table description past the block")
    log = (data[pos] & 15) + 5
    if log > max_log:
        raise _err(f"an FSE accuracy log {log} over {max_log}")
    bit = 4
    remaining = (1 << log) + 1
    threshold = 1 << log
    nbits = log + 1
    counts = []
    previous0 = False
    while remaining > 1 and len(counts) <= max_symbol:
        if previous0:
            while True:
                rep = bits_at(bit) & 3
                bit += 2
                counts.extend([0] * rep)
                if rep != 3:
                    break
            if len(counts) > max_symbol:
                raise _err("an FSE table past its largest symbol")
        v = bits_at(bit)
        mx = 2 * threshold - 1 - remaining
        if v & (threshold - 1) < mx:
            count = v & (threshold - 1)
            bit += nbits - 1
        else:
            count = v & (2 * threshold - 1)
            if count >= threshold:
                count -= mx
            bit += nbits
        count -= 1
        remaining -= -count if count < 0 else count
        counts.append(count)
        previous0 = count == 0
        while remaining < threshold:
            nbits -= 1
            threshold >>= 1
    if remaining != 1 or len(counts) > max_symbol + 1:
        raise _err("FSE counts that do not sum up")
    used = (bit + 7) >> 3
    if pos + used > len(data):
        raise _err("an FSE table description past the block")
    return counts, log, used


def _fse_table(counts, log):
    """4.1.1's decoding table: per state (symbol, bits, baseline)."""
    size = 1 << log
    symbol = [0] * size
    high = size - 1
    nxt = [0] * len(counts)
    for s, c in enumerate(counts):
        if c == -1:
            symbol[high] = s
            high -= 1
            nxt[s] = 1
        else:
            nxt[s] = c
    step, pos = (size >> 1) + (size >> 3) + 3, 0
    for s, c in enumerate(counts):
        for _ in range(max(c, 0)):
            symbol[pos] = s
            pos = (pos + step) & (size - 1)
            while pos > high:
                pos = (pos + step) & (size - 1)
    if pos != 0:
        raise _err("an FSE table that does not spread")
    table = []
    for u in range(size):
        s = symbol[u]
        state = nxt[s]
        nxt[s] += 1
        nb = log - (state.bit_length() - 1)
        table.append((s, nb, (state << nb) - size))
    return table


def _rle_table(symbol):
    return [(symbol, 0, 0)]


class _Frame:
    def __init__(self):
        self.huffman = None  # (table, max bits) of the last Huffman block
        self.tables = [None, None, None]  # LL, OF, ML of the last block
        self.reps = [1, 4, 8]


def _huffman_weights(data: bytes, pos: int):
    """4.2.1: the Huffman weights (their count, byte length)."""
    head = data[pos]
    if head >= 128:
        n = head - 127
        size = (n + 1) // 2
        raw = data[pos + 1:pos + 1 + size]
        if len(raw) < size:
            raise _err("Huffman weights past the block")
        w = []
        for b in raw:
            w += [b >> 4, b & 15]
        return w[:n], 1 + size
    size = head
    blob = data[pos + 1:pos + 1 + size]
    if len(blob) < size:
        raise _err("Huffman weights past the block")
    counts, log, used = _read_ncount(blob, 0, 255, 6)
    table = _fse_table(counts, log)
    bits = _Back(blob[used:])
    s1, s2 = bits.read(log), bits.read(log)
    out = []
    while True:
        for cur in (0, 1):
            if len(out) > 254:
                raise _err("too many Huffman weights")
            sym, nb, base = table[s1 if cur == 0 else s2]
            out.append(sym)
            v = base + bits.read(nb)
            if cur == 0:
                s1 = v
            else:
                s2 = v
            if bits.left() < 0:
                out.append(table[s2 if cur == 0 else s1][0])
                return out, 1 + size


def _huffman_table(weights):
    """The decoding table of 4.2.1.3: entry [peek(max bits)] = (symbol,
    bits), weight 1's symbols first."""
    total = sum(1 << (w - 1) for w in weights if w)
    if not total or any(w > 11 for w in weights):
        raise _err("Huffman weights out of range")
    maxbits = total.bit_length()
    rest = (1 << maxbits) - total
    if rest & (rest - 1):
        raise _err("Huffman weights that do not complete a tree")
    weights = weights + [rest.bit_length()]
    if maxbits > 11:
        raise _err("a Huffman code longer than 11 bits")
    table = [None] * (1 << maxbits)
    at = 0
    for w in range(1, maxbits + 1):
        for s, sw in enumerate(weights):
            if sw == w:
                n = 1 << (w - 1)
                table[at:at + n] = [(s, maxbits + 1 - w)] * n
                at += n
    return table, maxbits


def _huffman_stream(data: bytes, start: int, end: int, n: int, table,
                    maxbits, fast: bool) -> bytearray:
    """n symbols of the stream data[start:end]. The reference decoder's
    fast loop (4 streams of 8 bytes and more) neither needs the end mark
    (a zero last byte is all data) nor checks that the stream is consumed
    to its first bit, reading on into the bytes before it; its other path
    does both."""
    bits = _Back(data[:end])
    if fast and data[end - 1] == 0:
        bits.pos = 8 * end + 64
    floor = 64 if fast else 64 + 8 * start - 16
    out = bytearray()
    for _ in range(n):
        sym, nb = table[bits.peek(maxbits)]
        bits.pos -= nb
        out.append(sym)
        if bits.pos < floor:
            raise _err("a Huffman stream read past its start")
    if not fast and bits.pos != 64 + 8 * start:
        raise _err("a Huffman stream not consumed to its end")
    return out


def _literals(fr: _Frame, data: bytes, pos: int):
    """3.1.1.3.1: the literals section at data[pos:]; returns (literals,
    the position after it)."""
    b0 = data[pos]
    kind, fmt = b0 & 3, (b0 >> 2) & 3
    if kind in (0, 1):
        if fmt in (0, 2):
            size, pos = b0 >> 3, pos + 1
        elif fmt == 1:
            size, pos = (b0 >> 4) + (data[pos + 1] << 4), pos + 2
        else:
            size = (b0 >> 4) + (data[pos + 1] << 4) + (data[pos + 2] << 12)
            pos += 3
        if size > BLOCK_MAX:
            raise _err("literals past 128 KiB")
        if kind == 0:
            if pos + size > len(data):
                raise _err("raw literals past the block")
            return bytearray(data[pos:pos + size]), pos + size
        if pos >= len(data):
            raise _err("RLE literals past the block")
        return bytearray(data[pos:pos + 1] * size), pos + 1
    head = int.from_bytes(data[pos:pos + 5], "little")
    if fmt in (0, 1):
        regen, comp, pos = (head >> 4) & 0x3FF, (head >> 14) & 0x3FF, pos + 3
    elif fmt == 2:
        regen, comp, pos = (head >> 4) & 0x3FFF, (head >> 18) & 0x3FFF, pos + 4
    else:
        regen, comp = (head >> 4) & 0x3FFFF, (head >> 22) & 0x3FFFF
        pos += 5
    if regen > BLOCK_MAX or pos + comp > len(data):
        raise _err("compressed literals past the block")
    end = pos + comp
    if kind == 2:
        weights, used = _huffman_weights(data, pos)
        fr.huffman = _huffman_table(weights)
        pos += used
    elif fr.huffman is None:
        raise _err("treeless literals without an earlier Huffman table")
    table, maxbits = fr.huffman
    if fmt == 0:
        section = data[pos:end]
        return _huffman_stream(section, 0, len(section), regen, table,
                               maxbits, False), end
    if regen < 6 or end - pos < 10:
        raise _err("too few literals or bytes for 4 streams")
    section = data[pos:end]  # the jump table and the 4 streams
    sizes = [int.from_bytes(section[2 * k:2 * k + 2], "little")
             for k in range(3)]
    sizes.append(len(section) - 6 - sum(sizes))
    if sizes[3] < 1:
        raise _err("literal streams past the block")
    fast = min(sizes) >= 8
    part = (regen + 3) // 4
    out, at = bytearray(), 6
    for k, size in enumerate(sizes):
        n = part if k < 3 else regen - 3 * part
        out += _huffman_stream(section, at, at + size, n, table, maxbits,
                               fast)
        at += size
    return out, end


def _sequence_table(fr, k, mode, data, pos, default, max_symbol, max_log):
    if mode == 0:
        fr.tables[k] = _fse_table(*default)
    elif mode == 1:
        if pos >= len(data):
            raise _err("an RLE table past the block")
        if data[pos] > max_symbol:
            raise _err("an RLE symbol out of range")
        fr.tables[k] = _rle_table(data[pos])
        pos += 1
    elif mode == 2:
        counts, log, used = _read_ncount(data, pos, max_symbol, max_log)
        fr.tables[k] = _fse_table(counts, log)
        pos += used
    elif fr.tables[k] is None:
        raise _err("a repeat table without an earlier one")
    return pos


def _block(fr: _Frame, data: bytes, out: bytearray):
    """3.1.1.3: one compressed block (data is its content), decoded onto
    out."""
    lits, pos = _literals(fr, data, 0)
    if pos >= len(data):
        raise _err("a block without its sequences section")
    n = data[pos]
    if n < 128:
        pos += 1
    elif n < 255:
        if pos + 1 >= len(data):
            raise _err("sequences header past the block")
        n, pos = ((n - 128) << 8) + data[pos + 1], pos + 2
    else:
        if pos + 2 >= len(data):
            raise _err("sequences header past the block")
        n, pos = data[pos + 1] + (data[pos + 2] << 8) + 0x7F00, pos + 3
    if n == 0:
        if pos != len(data):
            raise _err("bytes after an empty sequences section")
        out += lits
        return
    if pos >= len(data):
        raise _err("sequences header past the block")
    modes = data[pos]
    if modes & 3:
        raise _err("reserved sequence modes")
    pos += 1
    pos = _sequence_table(fr, 0, modes >> 6, data, pos, _LL_DEFAULT, 35, 9)
    pos = _sequence_table(fr, 1, (modes >> 4) & 3, data, pos, _OF_DEFAULT,
                          31, 8)
    pos = _sequence_table(fr, 2, (modes >> 2) & 3, data, pos, _ML_DEFAULT,
                          52, 9)
    ll_t, of_t, ml_t = fr.tables
    bits = _Back(data[pos:])
    ll_s = bits.read(len(ll_t).bit_length() - 1)
    of_s = bits.read(len(of_t).bit_length() - 1)
    ml_s = bits.read(len(ml_t).bit_length() - 1)
    reps, lit_at, read = fr.reps, 0, bits.read
    for i in range(n):
        of_code, of_nb, of_base = of_t[of_s]
        ml_code, ml_nb, ml_base = ml_t[ml_s]
        ll_code, ll_nb, ll_base = ll_t[ll_s]
        if of_code > 31:
            raise _err("an offset code past 31")
        value = (1 << of_code) + read(of_code)
        ml_b, ml_x = _ML[ml_code]
        ml = ml_b + read(ml_x)
        ll_b, ll_x = _LL[ll_code]
        ll = ll_b + read(ll_x)
        if value > 3:
            offset = value - 3
            reps[2], reps[1], reps[0] = reps[1], reps[0], offset
        else:
            idx = value - (ll != 0)  # 0 = rep 1, ..., 3 = rep 1 - 1
            if idx == 0:
                offset = reps[0]
            elif idx == 1:
                offset = reps[1]
                reps[1], reps[0] = reps[0], offset
            else:
                offset = reps[2] if idx == 2 else reps[0] - 1
                if offset == 0:
                    raise _err("a repeat offset of 0")
                reps[2], reps[1], reps[0] = reps[1], reps[0], offset
        if i + 1 < n:
            ll_s = ll_t[ll_s][2] + read(ll_nb)
            ml_s = ml_t[ml_s][2] + read(ml_nb)
            of_s = of_t[of_s][2] + read(of_nb)
        if lit_at + ll > len(lits):
            raise _err("a sequence past its literals")
        out += lits[lit_at:lit_at + ll]
        lit_at += ll
        if offset > len(out):
            raise _err("an offset before the frame's start")
        start = len(out) - offset
        if offset >= ml:
            out += out[start:start + ml]
        else:
            chunk = out[start:]
            out += (chunk * (ml // offset + 1))[:ml]
    if bits.left() > 0:
        raise _err("a sequences stream not consumed to its end")
    out += lits[lit_at:]


def _frame_header(data: bytes, pos: int):
    """3.1.1.1: (frame header length, content checksum flag, content
    size or None, window size)."""
    if pos + 5 > len(data):
        raise _err("a frame header past the data")
    fhd = data[pos + 4]
    fcs_flag, single, checksum, dict_flag = (fhd >> 6, (fhd >> 5) & 1,
                                             (fhd >> 2) & 1, fhd & 3)
    if fhd & 8:
        raise _err("the reserved frame header bit is set")
    at = pos + 5
    window = None
    if not single:
        wd = data[at]
        log = 10 + (wd >> 3)
        window = (1 << log) + ((1 << log) >> 3) * (wd & 7)
        at += 1
    dict_size = (0, 1, 2, 4)[dict_flag]
    dict_id = int.from_bytes(data[at:at + dict_size], "little")
    at += dict_size
    if dict_id:
        raise ValueError(f"ZSTD frame needs dictionary {dict_id}, which the "
                         f"port does not have (nor has libtiff)")
    fcs_size = (1 if single else 0, 2, 4, 8)[fcs_flag]
    if at + fcs_size > len(data):
        raise _err("a frame header past the data")
    size = int.from_bytes(data[at:at + fcs_size], "little") \
        if fcs_size else None
    if fcs_size == 2:
        size += 256
    at += fcs_size
    if window is None:
        window = size
    return at - pos, checksum, size, window


def _decode_frame(data: bytes, pos: int, limit=None):
    """One frame at data[pos:]; returns (content, position after the
    frame, True when the frame ended). With `limit` it stops once limit
    bytes are out and one more block was decoded (the streaming decoder
    decodes the block after a full output buffer before it stops)."""
    head, checksum, size, window = _frame_header(data, pos)
    fr = _Frame()
    out = bytearray()
    at = pos + head
    block_max = min(window or BLOCK_MAX, BLOCK_MAX)
    full = False
    while True:
        if at + 3 > len(data):
            raise _err("a block header past the data")
        bh = int.from_bytes(data[at:at + 3], "little")
        last, kind, bsize = bh & 1, (bh >> 1) & 3, bh >> 3
        at += 3
        if kind == 3:
            raise _err("a reserved block type")
        if kind == 1:
            if at >= len(data) or bsize > block_max:
                raise _err("an RLE block past the data")
            out += data[at:at + 1] * bsize
            at += 1
        else:
            if bsize > block_max or at + bsize > len(data):
                raise _err("a block past the data or past 128 KiB")
            if kind == 0:
                out += data[at:at + bsize]
            else:
                before = len(out)
                _block(fr, data[at:at + bsize], out)
                if len(out) - before > block_max:
                    raise _err("a block past 128 KiB")
            at += bsize
        if last:
            break
        if limit is not None and (full or len(out) > limit):
            return out, at, False
        full = limit is not None and len(out) >= limit
    if size is not None and len(out) != size:
        raise _err(f"{len(out)} bytes where the frame header says {size}")
    if checksum:
        if at + 4 <= len(data):
            want = int.from_bytes(data[at:at + 4], "little")
            if xxh64(bytes(out)) & 0xFFFFFFFF != want:
                raise _err("the content checksum does not match")
        at += 4
    return out, at, True


def decompress(data: bytes) -> bytes:
    """Every frame of data, skippable frames skipped, concatenated."""
    out, pos = bytearray(), 0
    if not data:
        raise _err("no frame")
    while pos < len(data):
        if pos + 8 <= len(data) and (
                int.from_bytes(data[pos:pos + 4], "little") & ~15
                ) == 0x184D2A50:
            pos += 8 + int.from_bytes(data[pos + 4:pos + 8], "little")
            if pos > len(data):
                raise _err("a skippable frame past the data")
            continue
        if pos + 4 > len(data) or int.from_bytes(data[pos:pos + 4],
                                                 "little") != MAGIC:
            raise _err("no frame magic number")
        frame, pos, _ = _decode_frame(data, pos)
        if pos > len(data):
            raise _err("a content checksum past the data")
        out += frame
    return bytes(out)


def decode_strip(raw: bytes, need: int, where: str) -> bytes:
    """A TIFF strip or tile as tif_zstd.c reads it: the first frame
    only (ZSTD_decompressStream returns at a frame's end, which ends
    libtiff's loop; a leading skippable frame is such an end), `need`
    bytes of it or an error."""
    try:
        if len(raw) < 4 or int.from_bytes(raw[:4], "little") != MAGIC:
            raise _err("no frame magic number")
        out, _, _ = _decode_frame(raw, 0, need)
    except (IndexError, ValueError) as e:
        raise ValueError(f"TIFF ZSTD data does not decode ({e}): "
                         f"{where}") from None
    if len(out) < need:
        raise ValueError(f"TIFF ZSTD strip holds {len(out)} bytes, the "
                         f"image needs {need}: {where}")
    return bytes(out[:need])
