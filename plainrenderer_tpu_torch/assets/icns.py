"""Apple icon (ICNS) files without PIL, as Pillow 12.1's IcnsImagePlugin.py
reads them: the element of the largest size (PIL's ``bestsize``, the
largest (width, height, scale) among the sizes whose elements the file
holds), then:

  - a PNG element (ic07-ic14, icp4-icp6), decoded by image_io.decode_png
    (PIL returns the PNG itself, whatever its mode, and checks that its
    size divides one of the file's sizes);
  - else the 24-bit RGB element of that size (it32 after its four zero
    bytes, ih32, il32, is32): raw RGB where it holds exactly 3 bytes a
    pixel, else three channels of PIL's run-length code (a byte >= 0x80
    repeats the next byte byte - 125 times, else byte + 1 literal
    bytes), with the 8-bit mask (t8mk, h8mk, l8mk, s8mk) as alpha where
    the file has one.

A JPEG 2000 element (a J2K codestream or a JP2 file; PIL's
read_png_or_jpeg2000) is decoded from its own bytes by assets/jp2.py and
held to the same size check as a PNG element.

``encode_icns`` writes (H, W) and (H, W, 3|4) u8 as PIL's
IcnsImagePlugin._save does: the image resized (BICUBIC, assets/
resample.py) to 32, 64, 128, 256, 512 and 1024 pixels square, each a PNG
of the image's mode, under the 8 element types ic07-ic14, after the
header and a table of contents of their types and lengths.
"""

from __future__ import annotations

import struct

import numpy as np

from . import jp2, modes, resample

_PNG = b"\x89PNG\r\n\x1a\n"
# (width, height, scale) -> the element types PIL reads for it, in order
_SIZES = {
    (512, 512, 2): (b"ic10",), (512, 512, 1): (b"ic09",),
    (256, 256, 2): (b"ic14",), (256, 256, 1): (b"ic08",),
    (128, 128, 2): (b"ic13",), (128, 128, 1): (b"ic07", b"it32", b"t8mk"),
    (64, 64, 1): (b"icp6",), (32, 32, 2): (b"ic12",),
    (48, 48, 1): (b"ih32", b"h8mk"), (32, 32, 1): (b"icp5", b"il32",
                                                   b"l8mk"),
    (16, 16, 2): (b"ic11",), (16, 16, 1): (b"icp4", b"is32", b"s8mk")}


def _elements(buf: bytes) -> dict:
    """IcnsFile.__init__: element type -> (start, length)."""
    try:
        sig, filesize = struct.unpack_from(">4sI", buf)
        if sig != b"icns":
            raise modes.NotThisFormat("not an icns file")
        found, i = {}, 8
        while i < filesize:
            sig, size = struct.unpack_from(">4sI", buf, i)
            if size <= 0:
                raise modes.NotThisFormat("invalid ICNS block header")
            found[sig] = (i + 8, size - 8)
            i += size
    except struct.error:
        raise modes.NotThisFormat("ICNS file truncated") from None
    return found


def _rle_channels(buf: bytes, pos: int, n: int, where: str) -> np.ndarray:
    """read_32's three run-length channels of n bytes each."""
    bands = []
    for band in range(3):
        parts, left = [], n
        while left > 0:
            if pos >= len(buf):
                break
            c = buf[pos]
            pos += 1
            if c & 0x80:
                parts.append(buf[pos:pos + 1] * (c - 125))
                pos += 1
                left -= c - 125
            else:
                parts.append(buf[pos:pos + c + 1])
                pos += c + 1
                left -= c + 1
        if left != 0:
            raise ValueError(f"ICNS channel {band} ends {left} bytes off "
                             f"its size: {where}")
        data = b"".join(parts)
        if len(data) < n:
            raise ValueError(f"ICNS channel {band} truncated: {where}")
        bands.append(np.frombuffer(data, np.uint8, n))
    return np.stack(bands, -1)


def read_icns(buf: bytes, where: str = "<icns>",
              decode_png=None) -> np.ndarray:
    """ICNS bytes -> (H, W, 4) u8; `decode_png` is image_io.decode_png."""
    found = _elements(buf)
    sizes = [s for s, codes in _SIZES.items()
             if any(c in found for c in codes)]
    if not sizes:
        raise modes.NotThisFormat("no 32-bit icon resources found")
    best = max(sizes)
    w, h = best[0] * best[2], best[1] * best[2]
    rgb = alpha = png = None
    for code in _SIZES[best]:  # PIL reads every element of the size
        if code not in found:
            continue
        start, length = found[code]
        if code.startswith(b"ic"):
            sig = buf[start:start + 12]
            if sig.startswith(_PNG):
                img = decode_png(buf[start:], where)
            elif sig.startswith((b"\xff\x4f\xff\x51", b"\x0d\x0a\x87\x0a")) \
                    or sig == b"\0\0\0\x0cjP  \r\n\x87\n":
                # read_png_or_jpeg2000: the element's bytes alone
                img = jp2.read_jpeg2000(buf[start:start + length], where)
            else:
                raise ValueError(f"unsupported ICNS element format: {where}")
            ih, iw = img.shape[:2]
            if not any((s[1] * s[2]) / ih == (s[0] * s[2]) // iw
                       for s in sizes):
                raise ValueError(f"ICNS element of {iw}x{ih} fits none of "
                                 f"the file's sizes: {where}")
            png = img
            continue
        if code.endswith(b"8mk"):
            data = buf[start:start + w * h]
            if len(data) < w * h:
                raise ValueError(f"ICNS mask truncated: {where}")
            alpha = np.frombuffer(data, np.uint8).reshape(h, w)
            continue
        if code == b"it32":
            if buf[start:start + 4] != b"\0\0\0\0":
                raise ValueError(f"ICNS it32 without its zero signature: "
                                 f"{where}")
            start, length = start + 4, length - 4
        if length == w * h * 3:
            rgb = np.frombuffer(buf, np.uint8, length, start).reshape(h, w, 3)
        else:
            rgb = _rle_channels(buf, start, w * h, where).reshape(h, w, 3)
    if png is not None:
        return png
    if rgb is None:
        raise ValueError(f"ICNS mask without its colour element: {where}")
    return modes.to_rgba("RGB", rgb) if alpha is None else \
        modes.to_rgba("RGBA", np.dstack([rgb, alpha]))


# IcnsImagePlugin._save: element type -> size, in the order it writes them
ICNS_TYPES = {b"ic07": 128, b"ic08": 256, b"ic09": 512, b"ic10": 1024,
              b"ic11": 32, b"ic12": 64, b"ic13": 256, b"ic14": 512}


def encode_icns(image: np.ndarray, encode_png) -> bytes:
    """(H, W) or (H, W, 3|4) u8 -> ICNS bytes; `encode_png` is
    image_io.encode_png."""
    img = np.asarray(image)
    pngs = {s: encode_png(resample.resize(img, (s, s), "bicubic"))
            for s in sorted(set(ICNS_TYPES.values()))}
    toc = b"".join(t + struct.pack(">i", 8 + len(pngs[s]))
                   for t, s in ICNS_TYPES.items())
    body = b"".join(t + struct.pack(">i", 8 + len(pngs[s])) + pngs[s]
                    for t, s in ICNS_TYPES.items())
    total = 8 + 8 + len(toc) + len(body)
    return (b"icns" + struct.pack(">i", total) + b"TOC "
            + struct.pack(">i", 8 + len(toc)) + toc + body)
