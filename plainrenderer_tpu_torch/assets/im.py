"""IFUNC Image Memory (IM) files without PIL: read as Pillow 12.1's
ImImagePlugin.py opens them (the first frame), written as its ``_save``
writes modes L, RGB and RGBA.

Read: PIL takes any file whose first 100 bytes hold a newline and whose
header lines ("Key: value", up to 100 bytes, ended by a 0 or 0x1A byte)
name at least one of IM's keys; the pixels follow the 0x1A byte, and a
"Lut" key puts a 768-byte planar palette before them. Every "Image type"
of PIL's OPEN table is read with PIL's raw mode for it, the rows
bottom-up: 1-bit, grey, palette (1-, 2-, 4- and 8-bit; without a palette
every index is black), line-interleaved RGB / RGBA / RGBX / CMYK / YCbCr
/ LA, pixel-interleaved RGB ("X 24"), the three planes of RGB3 / RYB3 (G,
R, B), 16-bit I;16 (either byte order), 32-bit I, the float types "L 8",
"L 8S", "L 16", "L 16S", "L 32", "L 32F" (F;8 ... F;32F, so that "L 32 F"
and "L*32" are unsigned integers read as floats) and "L*N" for N of 2 to
32 (PIL's bit decoder: N-bit little-endian fields, least significant
first, each row starting on a byte whose low bits the last row's spare
bits are ORed into). A palette that is not a grey ramp turns L into P and
LA into PA; a grey one is ignored. The types PIL names but cannot load
(RLB, RYB, and PA or LA data without a palette) raise ValueError.

Write: "Image type" Greyscale / RGB / RGBA, "Name" (the file's name, cut
to 92 characters with its suffix kept), the size and one frame, zero
bytes to 511, 0x1A, then the rows bottom-up as L, RGB;L or RGBA;L.
"""

from __future__ import annotations

import os
import re

import numpy as np

from . import modes

COMMENT, FRAMES, LUT, MODE, SIZE = ("Comment", "File size (no of images)",
                                    "Lut", "Image type", "Image size (x*y)")
_TAGS = {COMMENT, "Date", "Digitalization equipment", FRAMES, LUT, "Name",
         "Scale (x,y)", SIZE, MODE}
_OPEN = {
    "0 1 image": ("1", "1"), "L 1 image": ("1", "1"),
    "Greyscale image": ("L", "L"), "Grayscale image": ("L", "L"),
    "RGB image": ("RGB", "RGB;L"), "RLB image": ("RGB", "RLB"),
    "RYB image": ("RGB", "RLB"), "B1 image": ("1", "1"),
    "B2 image": ("P", "P;2"), "B4 image": ("P", "P;4"),
    "X 24 image": ("RGB", "RGB"), "L 32 S image": ("I", "I;32"),
    "L 32 F image": ("F", "F;32"), "RGB3 image": ("RGB", "RGB;T"),
    "RYB3 image": ("RGB", "RYB;T"), "LA image": ("LA", "LA;L"),
    "PA image": ("LA", "PA;L"), "RGBA image": ("RGBA", "RGBA;L"),
    "RGBX image": ("RGB", "RGBX;L"), "CMYK image": ("CMYK", "CMYK;L"),
    "YCC image": ("YCbCr", "YCbCr;L")}
for _i in ("8", "8S", "16", "16S", "32", "32F"):
    _OPEN[f"L {_i} image"] = _OPEN[f"L*{_i} image"] = ("F", f"F;{_i}")
for _i in ("16", "16L", "16B"):
    _OPEN[f"L {_i} image"] = _OPEN[f"L*{_i} image"] = (f"I;{_i}", f"I;{_i}")
_OPEN["L 32S image"] = _OPEN["L*32S image"] = ("I", "I;32S")
for _j in range(2, 33):
    _OPEN[f"L*{_j} image"] = ("F", f"F;{_j}")
_SPLIT = re.compile(rb"^([A-Za-z][^:]*):[ \t]*(.*)[ \t]*$")
# (mode, raw mode) pairs PIL's unpackers lack
_UNLOADABLE = {("RGB", "RLB"), ("LA", "PA;L")}


def _number(s: str):
    try:
        return int(s)
    except ValueError:
        return float(s)


def _header(buf: bytes, where: str):
    """ImImageFile._open: (info, raw mode, pixel offset)."""
    if b"\n" not in buf[:100]:
        raise modes.NotThisFormat("not an IM file")
    info = {MODE: "L", SIZE: (512, 512), FRAMES: 1}
    rawmode, n, pos = "L", 0, 0
    s = b""
    while True:
        s = buf[pos:pos + 1]
        pos += len(s)
        if s == b"\r":
            continue
        if not s or s in (b"\0", b"\x1a"):
            break
        end = buf.find(b"\n", pos)
        end = len(buf) if end < 0 else end + 1
        s += buf[pos:end]
        pos = end
        if len(s) > 100:
            raise modes.NotThisFormat("IM header line too long")
        s = s[:-2] if s.endswith(b"\r\n") else s[:-1] if s.endswith(
            b"\n") else s
        m = _SPLIT.match(s)
        if not m:
            raise modes.NotThisFormat("syntax error in IM header")
        k = m.group(1).decode("latin-1", "replace")
        v = m.group(2).decode("latin-1", "replace")
        if k in (FRAMES, "Scale (x,y)", SIZE):
            try:
                v = tuple(_number(x) for x in v.replace("*", ",").split(","))
            except ValueError:
                raise ValueError(f"IM {k} {v!r} is not numbers: "
                                 f"{where}") from None
            if len(v) == 1:
                v = v[0]
        elif k == MODE and v in _OPEN:
            v, rawmode = _OPEN[v]
        if k == COMMENT:
            info.setdefault(k, []).append(v)
        else:
            info[k] = v
        if k in _TAGS:
            n += 1
    if not n:
        raise modes.NotThisFormat("not an IM file")
    while s and not s.startswith(b"\x1a"):
        s = buf[pos:pos + 1]
        pos += len(s)
    if not s:
        raise modes.NotThisFormat("IM file truncated")
    return info, rawmode, pos


def _bits(buf: bytes, pos: int, bits: int, w: int, h: int,
          where: str) -> np.ndarray:
    """BitDecode.c with (bits, pad 8, fill 3, unsigned, ystep -1)."""
    if not 1 <= bits < 32:
        raise ValueError(f"IM bit depth {bits} (PIL: bad configuration): "
                         f"{where}")
    nbytes = (w * bits + 7) // 8
    if len(buf) - pos < nbytes * h:
        raise ValueError(f"IM data truncated: {where}")
    rows = np.frombuffer(buf, np.uint8, nbytes * h, pos).reshape(h, nbytes)
    spare = 8 * nbytes - w * bits
    if spare:  # the bit buffer keeps the last row's spare bits
        rows = rows.copy()
        rows[1:, 0] |= rows[:-1, -1] >> (8 - spare)
    v = np.unpackbits(rows, axis=1, bitorder="little")[:, :w * bits]
    weights = (1 << np.arange(bits, dtype=np.int64))
    vals = (v.reshape(h, w, bits).astype(np.int64) * weights).sum(-1)
    return vals[::-1].astype(np.float32)


def read_im(buf: bytes, where: str = "<im>") -> np.ndarray:
    info, rawmode, pos = _header(buf, where)
    size, mode = info[SIZE], info[MODE]
    if not isinstance(size, tuple):
        raise modes.NotThisFormat("IM size is one number")
    if len(size) != 2 or not all(isinstance(x, int) for x in size):
        raise ValueError(f"IM size {size} is not two integers: {where}")
    w, h = size
    if not mode or w <= 0 or h <= 0:
        raise modes.NotThisFormat(f"IM size {w}x{h}")
    modes.check_size(w, h)
    palette = None
    if LUT in info:
        if len(buf) - pos < 768:
            raise modes.NotThisFormat("IM palette truncated")
        lut = np.frombuffer(buf, np.uint8, 768, pos).reshape(3, 256)
        pos += 768
        grey = bool((lut[0] == lut[1]).all() and (lut[1] == lut[2]).all())
        if mode in ("L", "LA", "P", "PA") and not grey:
            if mode in ("L", "P"):
                mode = rawmode = "P"
            else:
                mode, rawmode = "PA", "PA;L"
            palette = lut.T
    if mode not in ("1", "L", "P", "PA", "LA", "RGB", "RGBA", "CMYK",
                    "YCbCr", "I", "I;16", "I;16L", "I;16B", "F"):
        raise ValueError(f"IM image type {mode!r} is not one PIL reads: "
                         f"{where}")
    if (mode, rawmode) in _UNLOADABLE:
        raise ValueError(f"IM raw mode {rawmode} for {mode} (PIL: unknown "
                         f"raw mode): {where}")
    if rawmode.startswith("F;") and rawmode[2:].isdigit() \
            and int(rawmode[2:]) not in (8, 16, 32):
        return modes.to_rgba("F", _bits(buf, pos, int(rawmode[2:]), w, h,
                                        where))
    if rawmode in ("RGB;T", "RYB;T"):
        planes = [modes.raw(buf, pos + k * w * h, "L", w, h, ystep=-1,
                            where=where) for k in range(3)]
        return modes.to_rgba("RGB", np.stack([planes[1], planes[0],
                                              planes[2]], -1))
    px = modes.raw(buf, pos, rawmode, w, h, ystep=-1, where=where)
    return modes.to_rgba(mode, px, palette)


def encode_im(image: np.ndarray, name: str) -> bytes:
    """(H, W) or (H, W, 3|4) u8 -> IM bytes as PIL's _save writes modes
    L, RGB and RGBA to a file called `name` (a base name)."""
    img = np.asarray(image)
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    kind = {1: "Greyscale", 3: "RGB", 4: "RGBA"}[c]
    stem, ext = os.path.splitext(name)
    name = stem[:92 - len(ext)] + ext
    head = (f"Image type: {kind} image\r\nName: {name}\r\n"
            f"Image size (x*y): {w}*{h}\r\nFile size (no of images): 1\r\n"
            ).encode("ascii")
    head += b"\0" * (511 - len(head)) + b"\x1a"
    rows = img[::-1] if c == 1 else img[::-1].transpose(0, 2, 1)
    return head + np.ascontiguousarray(rows).tobytes()
