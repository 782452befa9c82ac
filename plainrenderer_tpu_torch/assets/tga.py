"""Truevision TGA reading and writing without PIL, as Pillow 12.1's
TgaImagePlugin.py reads (``TgaImageFile._open``, with libImaging's raw and
TgaRleDecode.c decoders) and writes (``_save``) them.

Read: image types 1 (colour-mapped), 2 (true colour), 3 (grey) and their
run-length versions 9, 10 and 11; pixel depths 1 (type 3), 8, 16 (type 2:
5-5-5 with PIL's inverted alpha bit, "BGRA;15Z"; type 3: grey and alpha),
24 and 32; colour maps of 16 and 24 bits, with a first entry; both origin
bits (bottom-up or top-down rows, and a horizontal flip). PIL's rules are
kept: a run-length packet may not cross a row (PIL: buffer overrun), the
image must be filled, and what PIL refuses raises ValueError naming it:
15-bit pixels and 15- or 32-bit colour maps (PIL: not a TGA file / an
unrecognised raw mode), a colour map on a true-colour image, a type-1
image without a map, a run-length 1-bit image.

TGA has no magic bytes: ``looks_like_tga`` is PIL's header check (the map
type, the size and the depth), which the caller applies to files named
.tga, .icb, .vda or .vst, the extensions PIL registers for it.

Write: grey (type 3), RGB (type 2, 24 bits) and RGBA (type 2, 32 bits,
attribute bits 8), uncompressed and bottom-up with the version 2 footer,
byte for byte as PIL writes them.
"""

from __future__ import annotations

import struct

import numpy as np

from . import modes

EXTENSIONS = (".tga", ".icb", ".vda", ".vst")
_RAWMODES = {(1, 8): "P", (3, 1): "1", (3, 8): "L", (3, 16): "LA",
             (2, 16): "BGRA;15Z", (2, 24): "BGR", (2, 32): "BGRA"}
FOOTER = b"\0" * 8 + b"TRUEVISION-XFILE." + b"\0"


def looks_like_tga(head: bytes) -> bool:
    """PIL's validity test of the 18-byte header."""
    if len(head) < 18:
        return False
    w, h = struct.unpack_from("<HH", head, 12)
    return head[1] in (0, 1) and w > 0 and h > 0 and head[16] in (
        1, 8, 16, 24, 32)


def _rle_rows(buf: bytes, pos: int, row_bytes: int, height: int,
              pixel: int, where: str) -> np.ndarray:
    """TgaRleDecode.c: packets of `pixel`-byte pixels, none crossing a
    row."""
    out = bytearray()
    for _ in range(height):
        row = bytearray()
        while len(row) < row_bytes:
            if pos >= len(buf):
                raise ValueError(f"TGA run-length data truncated: {where}")
            head = buf[pos]
            n = pixel * ((head & 0x7F) + 1)
            if len(row) + n > row_bytes:
                raise ValueError(f"TGA run-length packet crosses a row "
                                 f"(PIL: buffer overrun): {where}")
            if head & 0x80:
                value = buf[pos + 1:pos + 1 + pixel]
                if len(value) < pixel:
                    raise ValueError(f"TGA run-length data truncated: "
                                     f"{where}")
                row += value * (n // pixel)
                pos += 1 + pixel
            else:
                lit = buf[pos + 1:pos + 1 + n]
                if len(lit) < n:
                    raise ValueError(f"TGA run-length data truncated: "
                                     f"{where}")
                row += lit
                pos += 1 + n
        out += row
    return np.frombuffer(bytes(out), np.uint8).reshape(height, row_bytes)


def read_tga(buf: bytes, where: str = "<tga>") -> np.ndarray:
    """TGA bytes -> (H, W, 4) u8, as PIL's Image.open(...).convert("RGBA")
    gives them."""
    if not looks_like_tga(buf):
        raise ValueError(f"not a TGA file (PIL's header check): {where}")
    id_len, maptype, itype = buf[0], buf[1], buf[2]
    w, h = struct.unpack_from("<HH", buf, 12)
    depth, flags = buf[16], buf[17]
    if itype in (3, 11):
        mode = {1: "1", 16: "LA"}.get(depth, "L")
    elif itype in (1, 9):
        mode = "P" if maptype else "L"
    elif itype in (2, 10):
        mode = "RGB" if depth == 24 else "RGBA"
    else:
        raise ValueError(f"TGA image type {itype} is not supported: {where}")
    flip_x = flags & 0x10
    top_down = flags & 0x20
    pos = 18 + id_len
    palette = None
    if maptype:
        start, size, mapdepth = struct.unpack_from("<HHB", buf, 3)
        if mapdepth not in (16, 24):
            raise ValueError(f"TGA colour map of {mapdepth} bits is not "
                             f"supported (PIL reads 16 and 24): {where}")
        if mode != "P":
            raise ValueError(f"TGA colour map on a type {itype} image is "
                             f"not supported (PIL: unrecognised mode): "
                             f"{where}")
        nb = mapdepth // 8
        raw = buf[pos:pos + nb * size]
        pos += nb * size
        if mapdepth == 16:
            entries = modes.unpack_bgr15(np.frombuffer(
                raw[:len(raw) // 2 * 2], "<u2"), alpha_bit=True)
        else:
            entries = np.frombuffer(raw[:len(raw) // 3 * 3],
                                    np.uint8).reshape(-1, 3)[:, ::-1]
        palette = np.zeros((start + len(entries), entries.shape[1]),
                           np.uint8)
        if mapdepth == 16:
            palette[:start, 3] = 255  # zero entries: BGRA;15Z of 0
        palette[start:] = entries
    rawmode = _RAWMODES.get((itype & 7, depth))
    if rawmode is None or (rawmode == "P" and mode != "P"):
        raise ValueError(f"TGA type {itype} at {depth} bits is not "
                         f"supported: {where}")
    modes.check_size(w, h)
    row_bytes = (w * depth + 7) // 8
    if itype & 8 and depth == 1:
        raise ValueError(f"TGA run-length 1-bit image (PIL's decoder takes "
                         f"depth // 8 = 0 bytes a pixel and reads none): "
                         f"{where}")
    if itype & 8:
        rows = _rle_rows(buf, pos, row_bytes, h, depth // 8, where)
    else:
        if len(buf) < pos + row_bytes * h:
            raise ValueError(f"TGA pixel data truncated: {where}")
        rows = np.frombuffer(buf, np.uint8, row_bytes * h, pos).reshape(
            h, row_bytes)
    if not top_down:
        rows = rows[::-1]
    if rawmode == "1":
        px = np.unpackbits(rows, axis=1)[:, :w]
    elif rawmode == "BGRA;15Z":
        px = modes.unpack_bgr15(rows[:, :2 * w].copy().view("<u2"),
                                alpha_bit=True)
        mode = "RGBA"
    elif rawmode in ("BGR", "BGRA"):
        n = len(rawmode)
        px = rows.reshape(h, w, n)[..., [2, 1, 0, 3][:n]]
    else:
        px = rows.reshape(h, w, -1) if rawmode == "LA" else rows
    if flip_x:
        px = px[:, ::-1]
    return modes.to_rgba(mode, px, palette)


def encode_tga(image: np.ndarray) -> bytes:
    """(H, W) or (H, W, 3|4) u8 -> TGA bytes as PIL's TgaImagePlugin._save
    writes modes L, RGB and RGBA (uncompressed, bottom-up)."""
    img = np.asarray(image)
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    itype = 3 if c == 1 else 2
    flags = 8 if c == 4 else 0
    head = struct.pack("<BBBHHBHHHHBB", 0, 0, itype, 0, 0, 0, 0, 0, w, h,
                       8 * c, flags)
    px = img if c == 1 else img[..., [2, 1, 0, 3][:c]]
    return head + np.ascontiguousarray(px[::-1]).tobytes() + FOOTER
