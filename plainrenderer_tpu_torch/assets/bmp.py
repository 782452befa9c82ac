"""Windows BMP reading and writing without PIL, as Pillow 12.1's
BmpImagePlugin.py reads (``BmpImageFile._bitmap``, ``BmpRleDecoder``) and
writes (``_save``) them.

Read: the core (12-byte), info (40), V2-V3 (52, 56), OS/2 2 (64), V4
(108) and V5 (124) headers; 1, 4, 8, 16, 24 and 32 bits; BI_RGB, BI_RLE8,
BI_RLE4 and BI_BITFIELDS with the mask layouts PIL accepts; bottom-up and
top-down rows. PIL's rules are kept: 32-bit BI_RGB is RGB (its fourth byte
ignored), a palette of greys (0, 255 for two colours, else 0, 1, 2, ...)
makes the image L or 1, a pixel offset that points right after the header
skips the palette, 16-bit BI_RGB is 5-5-5, and the RLE decoder keeps
PIL's quirks (an odd RLE4 literal run loses its last pixel; a delta
escape reads two bytes more than it uses; the image must be filled).
What PIL refuses (other compressions, BI_ALPHABITFIELDS among them; other
depths or mask layouts) raises ValueError naming it.

Write: 8-bit L with a grey palette, 24-bit RGB and 32-bit BGRA (which PIL
reads back as RGB), bottom-up, 96 dpi, byte for byte as PIL writes them.
"""

from __future__ import annotations

import struct

import numpy as np

from . import modes

_BIT2MODE = {1: ("P", "P;1"), 4: ("P", "P;4"), 8: ("P", "P"),
             16: ("RGB", "BGR;15"), 24: ("RGB", "BGR"), 32: ("RGB", "BGRX")}
_MASK_MODES = {
    (32, (0xFF0000, 0xFF00, 0xFF, 0x0)): "BGRX",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0x0)): "XBGR",
    (32, (0xFF000000, 0xFF00, 0xFF, 0x0)): "BGXR",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0xFF)): "ABGR",
    (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)): "RGBA",
    (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)): "BGRA",
    (32, (0xFF000000, 0xFF00, 0xFF, 0xFF0000)): "BGAR",
    (32, (0x0, 0x0, 0x0, 0x0)): "BGRA",
    (24, (0xFF0000, 0xFF00, 0xFF)): "BGR",
    (16, (0xF800, 0x7E0, 0x1F)): "BGR;16",
    (16, (0x7C00, 0x3E0, 0x1F)): "BGR;15",
}
_COMPRESSIONS = {0: "BI_RGB", 1: "BI_RLE8", 2: "BI_RLE4", 3: "BI_BITFIELDS",
                 4: "BI_JPEG", 5: "BI_PNG", 6: "BI_ALPHABITFIELDS",
                 11: "BI_CMYK", 12: "BI_CMYKRLE8", 13: "BI_CMYKRLE4"}


def _u32(b, o=0):
    return struct.unpack_from("<I", b, o)[0]


def _u16(b, o=0):
    return struct.unpack_from("<H", b, o)[0]


def _unpack_rows(buf: bytes, width: int, height: int, stride: int,
                 rawmode: str, direction: int, where: str) -> np.ndarray:
    """PIL's raw decoder: `height` rows of `stride` bytes (the last row
    first when direction is -1), each unpacked by `rawmode`."""
    if len(buf) < stride * height:
        raise ValueError(f"BMP pixel data truncated: {where}")
    rows = np.frombuffer(buf, np.uint8, stride * height).reshape(height,
                                                                 stride)
    if direction < 0:
        rows = rows[::-1]
    if rawmode in ("P;1", "1", "P;4"):
        bits = np.unpackbits(rows, axis=1)
        if rawmode == "P;4":
            bits = bits[:, :width * 4].reshape(height, width, 4)
            return (bits * np.array([8, 4, 2, 1], np.uint8)).sum(-1) \
                .astype(np.uint8)
        return bits[:, :width]
    if rawmode in ("P", "L"):
        return rows[:, :width]
    if rawmode in ("BGR;15", "BGR;16"):
        v = rows[:, :2 * width].copy().view("<u2")
        return modes.unpack_bgr16(v) if rawmode == "BGR;16" else \
            modes.unpack_bgr15(v)
    n = len(rawmode)
    px = rows[:, :n * width].reshape(height, width, n)
    out = np.full((height, width, 4), 255, np.uint8)
    for k, ch in enumerate(rawmode):
        if ch in "RGBA":
            out[..., "RGBA".index(ch)] = px[..., k]
    return out


def _rle(buf: bytes, start: int, width: int, height: int, rle4: bool,
         where: str) -> np.ndarray:
    """BmpRleDecoder.decode: the pixel indices, top row last as stored."""
    data = bytearray()
    x, pos, end = 0, start, len(buf)
    total = width * height

    def read(n):
        nonlocal pos
        out = buf[pos:pos + n]
        pos += len(out)
        return out
    while len(data) < total:
        pair = read(2)
        if len(pair) < 2:
            break
        n, byte = pair[0], pair[1]
        if n:  # encoded mode
            if x + n > width:
                n = max(0, width - x)
            if rle4:
                hi, lo = byte >> 4, byte & 15
                data += bytes(hi if i % 2 == 0 else lo for i in range(n))
            else:
                data += bytes([byte]) * n
            x += n
        elif byte == 0:  # end of line
            while len(data) % width:
                data.append(0)
            x = 0
        elif byte == 1:  # end of bitmap
            break
        elif byte == 2:  # delta: PIL reads two bytes, then two more
            if len(read(2)) < 2:
                break
            d = read(2)
            if len(d) < 2:
                raise ValueError(f"BMP RLE delta truncated: {where}")
            data += bytes(d[0] + d[1] * width)
            x = len(data) % width
        else:  # absolute mode
            count = byte // 2 if rle4 else byte
            got = read(count)
            if rle4:
                for b in got:
                    data += bytes((b >> 4, b & 15))
            else:
                data += got
            if len(got) < count:
                break
            x += byte
            if pos % 2:  # align to 16 bits (from the start of the file)
                pos += 1
        if pos > end:
            break
    if len(data) < total:
        raise ValueError(f"BMP RLE data ends before the image is filled "
                         f"(not enough image data): {where}")
    return np.frombuffer(bytes(data[:total]), np.uint8).reshape(height, width)


def read_bmp(buf: bytes, where: str = "<bmp>") -> np.ndarray:
    """BMP bytes -> (H, W, 4) u8, as PIL's Image.open(...).convert("RGBA")
    gives them."""
    if not buf.startswith(b"BM") or len(buf) < 18:
        raise ValueError(f"not a BMP file: {where}")
    return bitmap(buf, 14, _u32(buf, 10), where)[0]


def looks_like_dib(head: bytes) -> bool:
    """PIL's DIB format: an info header without the file header."""
    return len(head) >= 4 and _u32(head) in (12, 40, 52, 56, 64, 108, 124)


def read_dib(buf: bytes, where: str = "<dib>") -> np.ndarray:
    """A bare DIB (info header, palette and pixels), as PIL's DibImageFile
    opens it."""
    return bitmap(buf, 0, 0, where)[0]


def bitmap(buf: bytes, at: int, offset: int, where: str,
           halve: bool = False, raw_alpha: bool = False):
    """PIL's BmpImageFile._bitmap from the info header at `at`, its pixels
    at `offset` (0: right after the header and palette): (RGBA pixels,
    where the pixels start). `halve` reads the top half of the rows, as
    ICO and CUR images (pixels and mask in one height) are read;
    `raw_alpha` reads 32-bit BI_RGB as BGRA (a cursor at offset 22)."""
    if len(buf) < at + 4:
        raise ValueError(f"BMP header truncated: {where}")
    hsize = _u32(buf, at)
    hdr = buf[at + 4:at + hsize]
    if len(hdr) < hsize - 4:
        raise ValueError(f"BMP header truncated: {where}")
    pos = at + hsize
    direction = -1
    masks = None
    if hsize == 12:
        width, height, bits = _u16(hdr, 0), _u16(hdr, 2), _u16(hdr, 6)
        compression, colors, padding = 0, 0, 3
    elif hsize in (40, 52, 56, 64, 108, 124):
        y_flip = hdr[7] == 0xFF
        direction = 1 if y_flip else -1
        width = _u32(hdr, 0)
        height = 2**32 - _u32(hdr, 4) if y_flip else _u32(hdr, 4)
        bits, compression = _u16(hdr, 10), _u32(hdr, 12)
        colors, padding = _u32(hdr, 28), 4
        if compression == 3:
            if len(hdr) >= 48:
                n = 4 if len(hdr) >= 52 else 3
                masks = [_u32(hdr, 36 + 4 * i) for i in range(n)]
                masks += [0] * (4 - n)
            else:
                if len(buf) < pos + 12:
                    raise ValueError(f"BMP bitfield masks truncated: {where}")
                masks = [_u32(buf, pos + 4 * i) for i in range(3)] + [0]
                pos += 12
    else:
        raise ValueError(f"BMP header size {hsize} is not supported "
                         f"(PIL reads 12, 40, 52, 56, 64, 108 and 124): "
                         f"{where}")
    colors = colors or (1 << bits)
    if offset == 14 + hsize and bits <= 8:
        offset += 4 * colors
    if bits not in _BIT2MODE:
        raise ValueError(f"BMP pixel depth {bits} is not supported: {where}")
    mode, rawmode = _BIT2MODE[bits]
    declared = (width, height)    # an ICO's DIB: pixels and mask
    if halve:
        height //= 2
    rle = False
    if compression == 3:
        key = (bits, tuple(masks) if bits == 32 else tuple(masks[:3]))
        if key not in _MASK_MODES:
            raise ValueError(f"BMP bitfields layout {bits} bits, masks "
                             f"{[hex(m) for m in masks]} is not supported: "
                             f"{where}")
        rawmode = _MASK_MODES[key]
    elif compression == 0 and bits == 32 and raw_alpha:
        rawmode = "BGRA"
    elif compression in (1, 2):
        rle = True
    elif compression != 0:
        name = _COMPRESSIONS.get(compression, str(compression))
        raise ValueError(f"BMP compression {name} is not supported: {where}")
    palette = None
    if mode == "P":
        if not 0 < colors <= 65536:
            raise ValueError(f"BMP palette size {colors} is not supported: "
                             f"{where}")
        pal = buf[pos:pos + padding * colors]
        pos += padding * colors
        indices = (0, 255) if colors == 2 else range(colors)
        grey = all(pal[i * padding:i * padding + 3] == bytes([v]) * 3
                   for i, v in enumerate(indices))
        if grey:
            mode = rawmode = "1" if colors == 2 else "L"
        else:
            entries = np.frombuffer(pal[:len(pal) // padding * padding],
                                    np.uint8).reshape(-1, padding)
            palette = entries[:, 2::-1]  # BGR(X) -> RGB
    if width == 0 or height == 0:
        raise ValueError(f"BMP of size {width}x{height}: {where}")
    modes.check_size(*declared)
    start = offset or pos
    if rle:
        if mode not in ("P", "L"):
            raise ValueError(f"BMP RLE in mode {mode} is not supported: "
                             f"{where}")
        px = _rle(buf, start, width, height, compression == 2, where)
        if direction < 0:
            px = px[::-1]
    else:
        stride = ((width * bits + 31) >> 3) & ~3
        px = _unpack_rows(buf[start:], width, height, stride, rawmode,
                          direction, where)
    if px.ndim == 3:
        return px, start
    return modes.to_rgba(mode, px, palette), start


def encode_bmp(image: np.ndarray) -> bytes:
    """(H, W) or (H, W, 3|4) u8 -> BMP bytes as PIL's BmpImagePlugin._save
    writes modes L, RGB and RGBA."""
    img = np.asarray(image)
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    bits = 8 * c
    stride = ((w * bits + 7) // 8 + 3) & ~3
    palette = b""
    colors = 0
    if c == 1:
        colors = 256
        palette = b"".join(bytes((i, i, i, 0)) for i in range(256))
        px = img.reshape(h, w)
    else:
        px = img[..., [2, 1, 0, 3][:c]]
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :w * c] = px.reshape(h, w * c)
    ppm = int(96 * 39.3701 + 0.5)
    offset = 14 + 40 + colors * 4
    size = stride * h
    return (b"BM" + struct.pack("<III", offset + size, 0, offset)
            + struct.pack("<IiiHHIIiiII", 40, w, h, 1, bits, 0, size, ppm,
                          ppm, colors, colors)
            + palette + rows[::-1].tobytes())
