"""SPIDER and FITS images without PIL: float and integer data as Pillow
12.1's SpiderImagePlugin.py and FitsImagePlugin.py read it, converted to
RGBA through PIL's I and F conversions (modes.py: clipped to 0-255, F
truncated).

SPIDER has no magic bytes: PIL takes a file whose first 27 header floats
(big-endian, else little-endian) pass ``isSpiderHeader`` (integral
nslice, nrow, iform, nsam, labrec, labbyt and lenbyt, iform one of SPIDER's
image kinds, labbyt = labrec * lenbyt); only iform 1 (a 2D image) opens.
A single image starts at labbyt, the first image of a stack at 2 *
labbyt; the pixels are 32-bit floats in the header's byte order.

FITS: the primary header's 80-byte cards up to END, then, where the
primary HDU holds no image, an extension's (a BINTABLE with ZIMAGE = T and
ZCMPTYPE 'GZIP_1' is PIL's tile compression). BITPIX 8, 16, 32, -32 and
-64 open as L, I;16, I and F, and PIL's raw decoder reads them with the
mode's own raw mode, so 16- and 32-bit samples and floats are read
little-endian (-64 as pairs of 32-bit floats), with the rows bottom-up;
PIL's data offset is the position of the first card read after the
header, less 80 (earlier where fewer than 80 bytes follow). Gzip tiles:
the table's bytes skipped, the rest of the file through gzip.decompress,
each pixel the last BITPIX / 8 bytes of 4, the rows reversed (float tiles
give PIL no data and fail).
"""

from __future__ import annotations

import gzip
import math
import struct
import zlib

import numpy as np

from . import modes

_IFORMS = (1, 3, -11, -12, -21, -22)


def _is_int(f: float) -> bool:
    try:
        return f - int(f) == 0
    except (ValueError, OverflowError):
        return False


def _spider_header(t: tuple) -> int:
    """isSpiderHeader: the header's byte length, or 0."""
    h = (99,) + t
    if not all(_is_int(h[i]) for i in (1, 2, 5, 12, 13, 22, 23)):
        return 0
    if int(h[5]) not in _IFORMS:
        return 0
    labrec, labbyt, lenbyt = int(h[13]), int(h[22]), int(h[23])
    return labbyt if labbyt == labrec * lenbyt else 0


def read_spider(buf: bytes, where: str = "<spider>") -> np.ndarray:
    if len(buf) < 108:
        raise modes.NotThisFormat("not a SPIDER file")
    for order in (">", "<"):
        t = struct.unpack(f"{order}27f", buf[:108])
        hdrlen = _spider_header(t)
        if hdrlen:
            break
    else:
        raise modes.NotThisFormat("not a valid SPIDER file")
    h = (99,) + t
    if int(h[5]) != 1:
        raise modes.NotThisFormat("not a SPIDER 2D image")
    w, ht = int(h[12]), int(h[2])
    try:
        istack, imgnumber = int(h[24]), int(h[27])
    except (ValueError, OverflowError):
        raise ValueError(f"SPIDER stack fields {h[24]}, {h[27]} are not "
                         f"numbers: {where}") from None
    if istack == 0 and imgnumber == 0:
        offset = hdrlen
    elif istack > 0 and imgnumber == 0:
        offset = 2 * hdrlen
    elif istack == 0 and imgnumber > 0:
        raise ValueError(f"SPIDER image of a stack opened alone (PIL fails "
                         f"on its stack offset): {where}")
    else:
        raise modes.NotThisFormat("inconsistent SPIDER stack header")
    if w <= 0 or ht <= 0:
        raise modes.NotThisFormat(f"SPIDER size {w}x{ht}")
    modes.check_size(w, ht)
    px = modes.raw(buf, offset, "F;32BF" if order == ">" else "F;32F", w, ht,
                   where=where)
    return modes.to_rgba("F", px)


# -------------------------------- FITS -------------------------------

_FITS_MODES = {8: ("L", "L"), 16: ("I;16", "I;16"), 32: ("I", "I;32"),
               -32: ("F", "F;32F"), -64: ("F", "F;32F")}


def _fits_size(headers: dict, prefix: bytes):
    naxis = int(headers[prefix + b"NAXIS"])
    if naxis == 0:
        return None
    if naxis == 1:
        return 1, int(headers[prefix + b"NAXIS1"])
    return int(headers[prefix + b"NAXIS1"]), int(headers[prefix + b"NAXIS2"])


def _fits_parse(headers: dict):
    """FitsImageFile._parse_headers: (gzip?, size, bitpix, offset) or
    None where the HDU holds no image."""
    prefix, gz, offset = b"", False, 0
    if (headers.get(b"XTENSION") == b"'BINTABLE'"
            and headers.get(b"ZIMAGE") == b"T"
            and headers[b"ZCMPTYPE"] == b"'GZIP_1  '"):
        table = _fits_size(headers, prefix) or (0, 0)
        offset = table[0] * table[1] * (int(headers[b"BITPIX"]) // 8)
        prefix, gz = b"Z", True
    size = _fits_size(headers, prefix)
    if not size:
        return None
    return gz, size, int(headers[prefix + b"BITPIX"]), offset


def read_fits(buf: bytes, where: str = "<fits>") -> np.ndarray:
    headers, in_header, found, pos = {}, False, None, 0
    try:
        while True:
            card = buf[pos:pos + 80]
            pos += len(card)
            if not card:
                raise ValueError(f"FITS file truncated: {where}")
            keyword = card[:8].strip()
            if keyword in (b"SIMPLE", b"XTENSION"):
                in_header = True
            elif headers and not in_header:
                break
            elif keyword == b"END":
                pos = math.ceil(pos / 2880) * 2880
                if not found:
                    found = _fits_parse(headers)
                in_header = False
                continue
            if found:
                continue
            value = card[8:].split(b"/")[0].strip()
            if value.startswith(b"="):
                value = value[1:].strip()
            if not headers and (not keyword.startswith(b"SIMPLE")
                                or value != b"T"):
                raise modes.NotThisFormat("not a FITS file")
            headers[keyword] = value
    except KeyError as e:
        raise modes.NotThisFormat(f"FITS header without {e}") from None
    if not found:
        raise ValueError(f"FITS file without image data: {where}")
    gz, (w, h), bitpix, offset = found
    if bitpix not in _FITS_MODES:
        raise modes.NotThisFormat(f"FITS BITPIX {bitpix}")
    if w <= 0 or h <= 0:
        raise modes.NotThisFormat(f"FITS size {w}x{h}")
    modes.check_size(w, h)
    mode, rawmode = _FITS_MODES[bitpix]
    offset += pos - 80
    if not gz:
        return modes.to_rgba(mode, modes.raw(buf, offset, rawmode, w, h,
                                             ystep=-1, where=where))
    try:
        value = gzip.decompress(buf[max(offset, 0):])
    except (OSError, EOFError, zlib.error) as e:
        raise ValueError(f"FITS gzip tiles do not inflate ({e}): "
                         f"{where}") from None
    nbytes = min(bitpix // 8, 4)
    if nbytes <= 0 or len(value) < 4 * w * h:
        raise ValueError(f"FITS gzip tiles give PIL too little data "
                         f"(BITPIX {bitpix}): {where}")
    px = np.frombuffer(value, np.uint8, 4 * w * h).reshape(h, w, 4)
    rows = np.ascontiguousarray(px[::-1, :, 4 - nbytes:]).tobytes()
    return modes.to_rgba(mode, modes.raw(rows, 0, rawmode, w, h,
                                         where=where))
