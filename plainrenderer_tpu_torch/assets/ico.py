"""Windows ICO and CUR reading without PIL, as Pillow 12.1's
IcoImagePlugin.py and CurImagePlugin.py read them.

ICO: the entry PIL loads is the first of the directory sorted by colour
depth (the bits per pixel, else log2 of the colour count, else 256) and
then, stably, by area, largest first: the largest image, and of those
the one of least depth. A PNG entry decodes as PNG (its transparency
chunk dropped: the icon's info, which convert reads, does not carry it);
a BMP entry is a DIB of twice the image's height (bmp.py's header and
rows code reads its top half), whose alpha comes from the fourth byte of
each 32-bit pixel when the directory says 32 bits a pixel, else from the
AND mask after it (1 transparent, rows padded to 32 bits, bottom-up, at
the end of the entry's byte count).

CUR: the first entry, replaced by each later one larger in both width
and height (the directory's bytes), read as a DIB of twice its height
with no mask; 32-bit pixels keep their fourth byte as alpha only when the
bitmap starts at byte 22, as in PIL.

``encode_ico`` writes (H, W) and (H, W, 3|4) u8 as PIL's IcoImagePlugin
._save does at its default arguments: one entry for each of PIL's sizes
16, 24, 32, 48, 64, 128 and 256 (square) that fits within the image, the
image shrunk into it by ``thumbnail`` with the LANCZOS filter
(assets/resample.py, which keeps the aspect ratio) and stored as a PNG of
the image's mode; directory entries of 32 bits a pixel, 0 colours and 0
planes, the data in size order after the directory.
"""

from __future__ import annotations

import math
import struct

import numpy as np

from . import bmp, resample
from .modes import NotThisFormat

ICO_MAGIC = b"\x00\x00\x01\x00"
CUR_MAGIC = b"\x00\x00\x02\x00"
PNG_MAGIC = b"\x89PNG\r\n\x1a\n"


def _entries(buf: bytes, where: str) -> list[tuple]:
    if len(buf) < 6:
        raise ValueError(f"ICO or CUR directory truncated: {where}")
    (n,) = struct.unpack_from("<H", buf, 4)
    out = []
    for i in range(n):
        s = buf[6 + 16 * i:22 + 16 * i]
        if len(s) < 16:
            raise ValueError(f"ICO or CUR directory truncated: {where}")
        out.append(s)
    return out


def read_ico(buf: bytes, where: str = "<ico>") -> np.ndarray:
    """ICO bytes -> (H, W, 4) u8, as PIL's Image.open(...).convert("RGBA")
    gives them."""
    from .image_io import decode_png  # image_io imports this module

    if not buf.startswith(ICO_MAGIC):
        raise ValueError(f"not an ICO file: {where}")
    entries = []
    for s in _entries(buf, where):
        width, height, colors = s[0] or 256, s[1] or 256, s[2]
        bpp, size, offset = struct.unpack_from("<HII", s, 6)
        depth = bpp or (colors != 0 and math.ceil(math.log(colors, 2))) \
            or 256
        entries.append((width * height, depth, bpp, size, offset))
    if not entries:
        raise NotThisFormat(f"ICO file without images: {where}")
    entries.sort(key=lambda e: e[1])
    entries.sort(key=lambda e: e[0], reverse=True)
    _, _, bpp, size, offset = entries[0]
    if buf[offset:offset + 8] == PNG_MAGIC:
        return decode_png(buf[offset:], where, transparency=False)
    rgba, start = bmp.bitmap(buf, offset, 0, where, halve=True)
    h, w = rgba.shape[:2]
    if bpp == 32:
        alpha = np.frombuffer(buf, np.uint8, offset=start)[3::4]
        if alpha.size < w * h:
            raise ValueError(f"ICO alpha data truncated: {where}")
        mask = alpha[:w * h].reshape(h, w)[::-1]
    else:
        stride = -(-w // 32) * 4
        at = offset + size - stride * h
        data = buf[at:at + stride * h] if at >= 0 else b""
        if len(data) < stride * h:
            raise ValueError(f"ICO AND mask truncated: {where}")
        bits = np.unpackbits(np.frombuffer(data, np.uint8).reshape(h, stride),
                             axis=1)[::-1, :w]
        mask = np.where(bits == 1, 0, 255).astype(np.uint8)
    out = rgba.copy()
    out[..., 3] = mask
    return out


def read_cur(buf: bytes, where: str = "<cur>") -> np.ndarray:
    """CUR bytes -> (H, W, 4) u8, as PIL's Image.open(...).convert("RGBA")
    gives them."""
    if not buf.startswith(CUR_MAGIC):
        raise ValueError(f"not a CUR file: {where}")
    best = None
    for s in _entries(buf, where):
        if best is None or (s[0] > best[0] and s[1] > best[1]):
            best = s
    if best is None:
        raise NotThisFormat(f"CUR file without cursors: {where}")
    (at,) = struct.unpack_from("<I", best, 12)
    return bmp.bitmap(buf, at, 0, where, halve=True, raw_alpha=at == 22)[0]


# IcoImagePlugin._save's default sizes, each (width, height)
ICO_SIZES = (16, 24, 32, 48, 64, 128, 256)


def encode_ico(image: np.ndarray, encode_png) -> bytes:
    """(H, W) or (H, W, 3|4) u8 -> ICO bytes; `encode_png` is
    image_io.encode_png."""
    img = np.asarray(image)
    h, w = img.shape[:2]
    frames = [resample.thumbnail(img, (s, s), "lanczos")
              for s in ICO_SIZES if s <= w and s <= h]
    pngs = [encode_png(f) for f in frames]
    head = ICO_MAGIC + struct.pack("<H", len(frames))
    offset = len(head) + 16 * len(frames)
    for f, png in zip(frames, pngs):
        fh, fw = f.shape[:2]
        head += struct.pack("<BBBBHHII", fw % 256, fh % 256, 0, 0, 0, 32,
                            len(png), offset)
        offset += len(png)
    return head + b"".join(pngs)
