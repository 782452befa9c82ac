"""LZW decoding for GIF and TIFF, in the two variants their readers use:

  - GIF (Pillow 12.1's libImaging/GifDecode.c): codes packed LSB first,
    a minimum code size from the file, clear and end codes after the
    roots, the code width growing when the next free code reaches the
    current width's limit, up to 12 bits; a full table adds no codes
    until the next clear;
  - TIFF compression 5 (libtiff's tif_lzw.c LZWDecode, which PIL calls):
    codes packed MSB first, 9 to 12 bits, clear 256, end 257, and the
    width growing one code early ("early change");
  - TIFF compression 5 in the old form (tif_lzw.c LZWDecodeCompat, which
    libtiff picks for data that starts 0x00 0x01: a clear code packed LSB
    first): codes packed LSB first, the width growing when the next free
    code reaches the current width's limit, a code past the table an
    error, as is a clear code followed by a code above 256.

The decoders return the decoded bytes; the callers cut or check the
length. ``encode_gif`` is the GIF encoder PIL's GifImagePlugin runs
(libImaging/GifEncode.c).
"""

from __future__ import annotations


def decode_gif(data: bytes, min_size: int, limit: int) -> bytes:
    """GIF LZW data (the sub-blocks joined) -> at most `limit` bytes of
    pixel indices. Stops at the end code, at the end of the data, or
    when `limit` bytes are out."""
    if not 0 < min_size <= 11:
        raise ValueError(f"GIF LZW minimum code size {min_size} is out of "
                         "range")
    clear, end = 1 << min_size, (1 << min_size) + 1
    roots = [bytes([i]) for i in range(clear)]
    table = roots + [b"", b""]
    size = min_size + 1
    out = bytearray()
    acc = nbits = pos = 0
    prev = None
    n = len(data)
    while len(out) < limit:
        while nbits < size and pos < n:
            acc |= data[pos] << nbits
            nbits += 8
            pos += 1
        if nbits < size:
            break
        code = acc & ((1 << size) - 1)
        acc >>= size
        nbits -= size
        if code == clear:
            table = roots + [b"", b""]
            size = min_size + 1
            prev = None
            continue
        if code == end:
            break
        if prev is None:
            if code >= len(table):
                raise ValueError("GIF LZW: a code before its entry exists")
            entry = table[code]
        elif code < len(table):
            entry = table[code]
            if len(table) < 4096:
                table.append(prev + entry[:1])
        elif code == len(table):
            entry = prev + prev[:1]
            if len(table) < 4096:
                table.append(entry)
        else:
            raise ValueError("GIF LZW: a code past the table")
        if len(table) == 1 << size and size < 12:
            size += 1
        out += entry
        prev = entry
    return bytes(out[:limit])


def decode_tiff(data: bytes, limit: int) -> bytes:
    """TIFF LZW (MSB first, early change; or the old LSB-first form) -> at
    most `limit` bytes."""
    if data[:1] == b"\0" and len(data) > 1 and data[1] & 1:
        return _decode_tiff_compat(data, limit)
    roots = [bytes([i]) for i in range(256)]
    table = roots + [b"", b""]
    size = 9
    out = bytearray()
    acc = nbits = pos = 0
    prev = None
    n = len(data)
    while len(out) < limit:
        while nbits < size and pos < n:
            acc = (acc << 8) | data[pos]
            nbits += 8
            pos += 1
        if nbits < size:
            break
        code = (acc >> (nbits - size)) & ((1 << size) - 1)
        nbits -= size
        acc &= (1 << nbits) - 1
        if code == 256:
            table = roots + [b"", b""]
            size = 9
            prev = None
            continue
        if code == 257:
            break
        if prev is None:
            if code >= 256:
                raise ValueError("TIFF LZW: the first code is not a root")
            entry = table[code]
        elif code < len(table):
            entry = table[code]
            table.append(prev + entry[:1])
        elif code == len(table):
            entry = prev + prev[:1]
            table.append(entry)
        else:
            raise ValueError("TIFF LZW: a code past the table")
        if len(table) >= (1 << size) - 1 and size < 12:
            size += 1
        if len(table) > 4096:
            raise ValueError("TIFF LZW: the table overflows")
        out += entry
        prev = entry
    return bytes(out[:limit])


def _decode_tiff_compat(data: bytes, limit: int) -> bytes:
    """libtiff's LZWDecodeCompat: LSB-first codes; the width grows once
    the next free code passes the current width's largest; a string code
    not yet in the table is corrupt data (libtiff: wrong length of decoded
    string), so are a clear code followed by a code above 256 and a
    table past libtiff's 5119 entries. The data
    ends with the end code or when fewer bits than a code remain."""
    roots = [bytes([i]) for i in range(256)]
    table = roots + [b"", b""]
    size = 9
    out = bytearray()
    acc = nbits = pos = 0
    prev = None
    n = len(data)
    while len(out) < limit:
        while nbits < size and pos < n:
            acc |= data[pos] << nbits
            nbits += 8
            pos += 1
        if nbits < size:
            break
        code = acc & ((1 << size) - 1)
        acc >>= size
        nbits -= size
        if code == 257:
            break
        if code == 256:
            table = roots + [b"", b""]
            size = 9
            prev = None
            continue
        if prev is None:
            if code > 256:
                raise ValueError("TIFF old-style LZW: corrupted table (a "
                                 "string code after a clear code)")
            entry = table[code]
        else:
            if len(table) >= 5119:  # libtiff's CSIZE; codes reach 4095
                raise ValueError("TIFF old-style LZW: corrupted table")
            if code < len(table):
                entry = table[code]
                table.append(prev + entry[:1])
            elif code == len(table):
                entry = prev + prev[:1]
                table.append(entry)
            else:
                raise ValueError("TIFF old-style LZW: a code past the table")
            if len(table) > (1 << size) - 1 and size < 12:
                size += 1
        out += entry
        prev = entry
    return bytes(out[:limit])


def encode_gif(indices: bytes) -> bytes:
    """Pixel indices -> GIF LZW codes packed LSB first at PIL's minimum
    code size of 8, as PIL's GifEncode.c writes them: a clear code first; greedy matching; after
    each emitted code the new string takes the next code while the
    table has fewer than 4096, and the code width grows once the code
    just added passes the width's largest; at 4096 a clear code (at 12
    bits) resets the table instead; the last string's code, the end code,
    and the last partial byte."""
    min_size = 8
    clear = 1 << min_size
    out = bytearray()
    acc = nacc = 0

    def put(code: int, width: int) -> None:
        nonlocal acc, nacc
        acc |= code << nacc
        nacc += width
        while nacc >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nacc -= 8

    width = min_size + 1
    put(clear, width)
    if indices:
        table: dict[int, int] = {}
        next_code, max_code = clear + 2, 2 * clear - 1
        head = indices[0]
        for tail in indices[1:]:
            key = (head << 8) | tail
            code = table.get(key)
            if code is not None:
                head = code
                continue
            put(head, width)
            if next_code < 4096:
                table[key] = next_code
                if next_code > max_code:
                    max_code, width = 2 * max_code + 1, width + 1
                next_code += 1
            else:
                put(clear, width)
                table.clear()
                next_code, max_code = clear + 2, 2 * clear - 1
                width = min_size + 1
            head = tail
        put(head, width)
    put(clear + 1, width)
    if nacc:
        out.append(acc & 0xFF)
    return bytes(out)
