"""Blizzard BLP and FTEX textures without PIL, as Pillow 12.1's
BlpImagePlugin.py and FtexImagePlugin.py read them.

BLP1 (magic "BLP1"): compression 0 is JPEG: a shared JPEG header, then the
first mip level's bytes at its offset, decoded by assets/jpeg.py (four
components as CMYK whatever an Adobe marker says, the colour space PIL
sets for BLP) and taken as PIL takes
it: the RGB bytes read as BGR, so red and blue swap. Compression 1 with
encoding 4 or 5 is paletted: 256 BGRA entries after the header, then the
first mip level's indices read from right after the palette (PIL does not
seek to the level's offset).

BLP2 (magic "BLP2"): the 256-entry palette after the header is always
read; then, at the first mip level's offset, encoding 1 (palette indices)
or encoding 2 (DXT): alpha encoding 0 is DXT1 (with an alpha channel where
the alpha depth is not 0), 1 DXT3 and 7 DXT5, decoded as BlpImagePlugin's
Python decoders do (assets/bcn.decode_blp). Any nonzero alpha depth makes
the image RGBA; PIL reads the decoded bytes as rows of the image's width,
so DXT images of widths that are not multiples of 4, and DXT3 / DXT5
without alpha, come out as PIL's sheared decode.

FTEX ("FTEX", one format): format 0 is DXT1 through PIL's bcn codec
(assets/bcn.decode_bcn), format 1 raw RGB.

What PIL refuses (other compressions and encodings, truncated data)
raises ValueError.
"""

from __future__ import annotations

import struct

import numpy as np

from . import bcn, jpeg, modes


def _safe_read(buf: bytes, pos: int, n: int, where: str) -> bytes:
    """ImageFile._safe_read: n bytes or a truncated-file error."""
    if n <= 0:
        return b""
    data = buf[pos:pos + n]
    if len(data) < n:
        raise ValueError(f"BLP file truncated: {where}")
    return data


def _bgra_palette(buf: bytes, pos: int, where: str) -> np.ndarray:
    pal = np.frombuffer(_safe_read(buf, pos, 1024, where), np.uint8)
    return pal.reshape(256, 4)[:, [2, 1, 0, 3]]


def _raw(data: np.ndarray, w: int, h: int, bands: int,
         where: str) -> np.ndarray:
    """set_as_raw: the image's rows from the start of the flat bytes."""
    if data.size < w * h * bands:
        raise ValueError(f"BLP image data too short (PIL: not enough image "
                         f"data): {where}")
    px = data[:w * h * bands].reshape(h, w, bands)
    return modes.to_rgba("RGBA" if bands == 4 else "RGB", px)


def read_blp(buf: bytes, where: str = "<blp>") -> np.ndarray:
    magic = buf[:4]
    if magic not in (b"BLP1", b"BLP2") or len(buf) < 20:
        raise modes.NotThisFormat("not a BLP file")
    (compression,) = struct.unpack_from("<i", buf, 4)
    if magic == b"BLP1":
        if len(buf) < 28:
            raise modes.NotThisFormat("BLP1 header truncated")
        alpha = struct.unpack_from("<I", buf, 8)[0] != 0
        w, h = struct.unpack_from("<II", buf, 12)
        (encoding,) = struct.unpack_from("<i", buf, 20)
        head = 28
    else:
        encoding, alpha, alpha_encoding = struct.unpack_from("<bbb", buf, 8)
        alpha = alpha != 0
        w, h = struct.unpack_from("<II", buf, 12)
        head = 20
    if w == 0 or h == 0:
        raise modes.NotThisFormat("BLP size 0")
    modes.check_size(w, h)
    bands = 4 if alpha else 3
    offsets = struct.unpack("<16I", _safe_read(buf, head, 64, where))
    lengths = struct.unpack("<16I", _safe_read(buf, head + 64, 64, where))
    pos = head + 128
    if magic == b"BLP1":
        if compression == 0:
            (size,) = struct.unpack("<I", _safe_read(buf, pos, 4, where))
            header = _safe_read(buf, pos + 4, size, where)
            pos = max(pos + 4 + size, offsets[0])
            body = _safe_read(buf, pos, lengths[0], where)
            rgba = jpeg.decode_jpeg(header + body, where, cmyk_space=True)
            # read as BGR, also into an RGBA image (alpha 255)
            return _raw(rgba[..., [2, 1, 0]].reshape(-1), w, h, 3, where)
        if compression != 1 or encoding not in (4, 5):
            raise ValueError(f"BLP1 compression {compression}, encoding "
                             f"{encoding} is not one PIL reads: {where}")
        palette = _bgra_palette(buf, pos, where)
        idx = np.frombuffer(_safe_read(buf, pos + 1024, lengths[0], where),
                            np.uint8)
        return _raw(palette[idx][:, :bands].reshape(-1), w, h, bands, where)
    palette = _bgra_palette(buf, pos, where)
    if compression != 1 or encoding not in (1, 2):
        raise ValueError(f"BLP2 compression {compression}, encoding "
                         f"{encoding} is not one PIL reads: {where}")
    if encoding == 1:
        idx = np.frombuffer(_safe_read(buf, offsets[0], lengths[0], where),
                            np.uint8)
        return _raw(palette[idx][:, :bands].reshape(-1), w, h, bands, where)
    kinds = {0: 1, 1: 2, 7: 3}
    if alpha_encoding not in kinds:
        raise ValueError(f"BLP2 alpha encoding {alpha_encoding} is not one "
                         f"PIL reads: {where}")
    kind = kinds[alpha_encoding]
    size = ((w + 3) // 4) * ((h + 3) // 4) * (8 if kind == 1 else 16)
    data = bcn.decode_blp(_safe_read(buf, offsets[0], size, where), kind, w,
                          h, alpha, where)
    return _raw(data, w, h, bands, where)


def read_ftex(buf: bytes, where: str = "<ftex>") -> np.ndarray:
    if not buf.startswith(b"FTEX"):
        raise modes.NotThisFormat("not an FTEX file")
    try:
        w, h, _, count, fmt, at = struct.unpack_from("<2i2i2i", buf, 8)
        (size,) = struct.unpack_from("<i", buf, at)
    except struct.error:
        raise modes.NotThisFormat("FTEX header truncated") from None
    if count != 1:
        raise ValueError(f"FTEX with {count} formats (PIL asserts one): "
                         f"{where}")
    data = buf[at + 4:] if size < 0 else buf[at + 4:at + 4 + size]
    if fmt not in (0, 1):
        raise ValueError(f"FTEX format {fmt} is not DXT1 or raw RGB: "
                         f"{where}")
    if w <= 0 or h <= 0:
        raise modes.NotThisFormat(f"FTEX size {w}x{h}")
    modes.check_size(w, h)
    if fmt == 0:
        return modes.to_rgba("RGBA", bcn.decode_bcn(data, 1, w, h, where))
    return modes.to_rgba("RGB", modes.raw(data, 0, "RGB", w, h, where=where))
