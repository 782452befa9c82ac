"""GIF reading without PIL: the first frame, as Pillow 12.1's
GifImagePlugin.py opens it (``GifImageFile._open`` and ``_seek(0)``,
``load_prepare``) and libImaging/GifDecode.c decodes it, converted as
``Image.convert("RGBA")`` converts it.

Covered: GIF87a and GIF89a; the global and a local colour table; the
first image descriptor's rectangle (an image larger than the logical
screen grows it, as in PIL); interlaced rows; the graphic control
extension's transparency index; comment, application and other
extensions skipped. PIL's mode rules are kept: a colour table that is
the identity grey ramp (entry i = (i, i, i)) is no palette, and the frame
is then L, as it is without any table; else P. Pixels outside the first
frame's rectangle are the transparency index where there is one, else 0.
Conversion: P through its table (an index past the table is opaque
black) with the transparent entry's alpha 0; L as grey with alpha 0 where
the value is the transparency index.

``encode_gif`` writes (H, W) and (H, W, 3|4) u8 as PIL's
GifImagePlugin._save writes one frame at its default arguments
(``optimize`` on): L as it is, RGB and RGBA through
``convert("P", palette=ADAPTIVE)`` (assets/quantize.py: median cut, and
for RGBA the fast octree with its RGBA palette, whose first entry of
alpha 0 becomes the transparency index); ``_get_optimize``'s palette
remap (always for L; for a palette image under 512 x 512 pixels where the
used entries leave holes or fit a table half the size); the header (GIF89a
where there is a transparency index, else GIF87a), the global colour
table padded to a power of two, the graphic control extension, the image
descriptor (interlaced where both sides are at least 16), minimum code
size 8 and PIL's LZW data (assets/lzw.py) in sub-blocks of 255 bytes,
each encoder buffer of max(65536, 4 W) bytes ending its last sub-block.
"""

from __future__ import annotations

import math
import struct

import numpy as np

from . import lzw, modes, quantize


def _palette_needed(p: bytes) -> bool:
    """GifImageFile._is_palette_needed: not the identity grey ramp."""
    return any(not (i // 3 == p[i] == p[i + 1] == p[i + 2])
               for i in range(0, len(p) - 2, 3))


def _sub_blocks(buf: bytes, pos: int, where: str):
    """The data sub-blocks from pos joined, and the position after the
    terminator."""
    out = []
    while True:
        if pos >= len(buf):
            return b"".join(out), pos
        n = buf[pos]
        pos += 1
        if n == 0:
            return b"".join(out), pos
        out.append(buf[pos:pos + n])
        pos += n


def _interlaced_rows(h: int) -> list[int]:
    return (list(range(0, h, 8)) + list(range(4, h, 8))
            + list(range(2, h, 4)) + list(range(1, h, 2)))


def read_gif(buf: bytes, where: str = "<gif>") -> np.ndarray:
    """GIF bytes -> (H, W, 4) u8 of the first frame, as PIL's
    Image.open(...).convert("RGBA") gives them."""
    if not buf.startswith((b"GIF87a", b"GIF89a")) or len(buf) < 13:
        raise ValueError(f"not a GIF file: {where}")
    w, h = struct.unpack_from("<HH", buf, 6)
    flags = buf[10]
    pos = 13
    palette = None
    if flags & 0x80:
        p = buf[pos:pos + (3 << ((flags & 7) + 1))]
        pos += len(p)
        if _palette_needed(p):
            palette = p
    transparency = None
    while True:
        if pos >= len(buf) or buf[pos] == 0x3B:
            raise ValueError(f"GIF without an image: {where}")
        kind = buf[pos]
        pos += 1
        if kind == 0x21:  # extension
            label = buf[pos]
            pos += 1
            first = b""
            if pos < len(buf) and buf[pos]:
                first = buf[pos + 1:pos + 1 + buf[pos]]
            if label == 0xF9 and len(first) >= 4 and first[0] & 1:
                transparency = first[3]
            _, pos = _sub_blocks(buf, pos, where)
        elif kind == 0x2C:  # image descriptor
            x0, y0, fw, fh, fflags = struct.unpack_from("<HHHHB", buf, pos)
            pos += 9
            if fflags & 0x80:
                p = buf[pos:pos + (3 << ((fflags & 7) + 1))]
                pos += len(p)
                palette = p if _palette_needed(p) else None
            break
        else:
            continue  # PIL skips other bytes between blocks
    interlace = bool(fflags & 0x40)
    modes.check_size(w, h)
    if x0 + fw > w or y0 + fh > h:
        # PIL grows the image to the frame, and checks the new size
        w, h = max(w, x0 + fw), max(h, y0 + fh)
        modes.check_size(w, h)
    if pos >= len(buf):
        raise ValueError(f"GIF image data truncated: {where}")
    min_size = buf[pos]
    data, _ = _sub_blocks(buf, pos + 1, where)
    idx = lzw.decode_gif(data, min_size, fw * fh)
    if len(idx) < fw * fh:
        raise ValueError(f"GIF image data ends before the frame is filled "
                         f"(PIL: image file is truncated): {where}")
    frame = np.frombuffer(idx, np.uint8).reshape(fh, fw)
    if interlace:
        rows = np.empty_like(frame)
        rows[_interlaced_rows(fh)] = frame
        frame = rows
    canvas = np.full((h, w), transparency or 0, np.uint8)
    canvas[y0:y0 + fh, x0:x0 + fw] = frame
    if palette is None:
        return modes.to_rgba("L", canvas, transparency=transparency)
    pal = np.frombuffer(palette[:len(palette) // 3 * 3], np.uint8)
    return modes.to_rgba("P", canvas, pal.reshape(-1, 3), transparency)


def _table_size(palette: bytes) -> int:
    """_get_color_table_size."""
    if not palette:
        return 0
    if len(palette) < 9:
        return 1
    return math.ceil(math.log(len(palette) // 3, 2)) - 1


def _sub_blocks_of(data: bytes, bufsize: int) -> bytes:
    """GifEncode.c's sub-blocks: 255 data bytes each, the last of each
    encoder buffer of `bufsize` bytes shorter where the buffer ends."""
    out = bytearray()
    pos = 0
    while pos < len(data):
        room = bufsize
        while room >= 2 and pos < len(data):
            n = min(room, 256) - 1
            chunk = data[pos:pos + n]
            out += bytes([len(chunk)]) + chunk
            pos += len(chunk)
            room -= len(chunk) + 1
    return bytes(out)


def encode_gif(image: np.ndarray) -> bytes:
    """(H, W) or (H, W, 3|4) u8 -> GIF bytes."""
    img = np.asarray(image)
    h, w = img.shape[:2]
    transparency = None
    if img.ndim == 2:
        idx, bands = img, 3
        source = bytes(i // 3 for i in range(768))
        used = np.flatnonzero(np.bincount(idx.reshape(-1), minlength=256))
    else:
        if img.shape[2] == 3:
            idx, pal = quantize.median_cut(img)
        else:
            idx, pal = quantize.fast_octree(img)
            clear = np.flatnonzero(pal[:, 3] == 0)
            transparency = int(clear[0]) if len(clear) else None
        idx = idx.reshape(h, w)
        bands, source = pal.shape[1], pal.tobytes()
        used = np.flatnonzero(np.bincount(idx.reshape(-1), minlength=256))
        size = 1 << (len(pal) - 1).bit_length()
        if not (w * h < 512 * 512 and (
                used[-1] >= len(used)
                or (len(used) <= size // 2 and size > 2))):
            used = None
    if used is not None:  # remap_palette
        if bands == 3 and len(source) > 768:
            bands = 4
        new = np.zeros(256, np.uint8)
        new[used] = np.arange(len(used))
        idx = new[idx]
        source = b"".join(source[u * bands:u * bands + bands] for u in used)
        if transparency is not None:
            hit = np.flatnonzero(used == transparency)
            transparency = int(hit[0]) if len(hit) else None
    palette = source if bands == 3 else b"".join(
        source[i * 4:i * 4 + 3] for i in range(len(source) // 3))
    size = _table_size(palette)
    table = palette + bytes(3 * max(0, (2 << size) - len(palette) // 3))
    out = (b"GIF" + (b"87a" if transparency is None else b"89a")
           + struct.pack("<HHBBB", w, h, size + 128, 0, 0) + table)
    if transparency is not None:
        out += b"!\xf9\x04\x01\x00\x00" + bytes([transparency, 0])
    interlace = min(w, h) >= 16
    out += b"," + struct.pack("<HHHHB", 0, 0, w, h, 64 if interlace else 0)
    rows = idx[_interlaced_rows(h)] if interlace else idx
    data = lzw.encode_gif(np.ascontiguousarray(rows, np.uint8).tobytes())
    return (out + b"\x08" + _sub_blocks_of(data, max(65536, 4 * w))
            + b"\x00;")
