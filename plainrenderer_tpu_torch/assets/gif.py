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
"""

from __future__ import annotations

import struct

import numpy as np

from . import lzw, modes


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
    w, h = max(w, x0 + fw), max(h, y0 + fh)
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
