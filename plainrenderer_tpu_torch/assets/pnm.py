"""Netpbm (PBM, PGM, PPM: P1-P6) reading and writing without PIL, as
Pillow 12.1's PpmImagePlugin.py reads (``PpmImageFile._open``,
``PpmPlainDecoder``, ``PpmDecoder``) and writes (``_save``) them.

Read: P1 and P4 (1-bit, 1 is black), P2 and P5 (grey), P3 and P6 (RGB),
plain (ASCII) and raw, any maxval from 1 to 65535. PIL's scaling is kept:
a sample becomes round(v / maxval * 255) (Python's rounding, half to
even) except where the raw decoder reads it directly (maxval 255 as is;
raw grey at maxval 65535 as 16 bits); grey above maxval 255 is PIL's mode
I (round(v / maxval * 65535)), which converts to RGBA clipped at 255.
Header comments (``#`` to the end of the line) are skipped between
tokens, and in plain data. PIL's extensions are read as its
``PpmImagePlugin.MODES`` maps them: Pf (PFM: one 32-bit float a pixel,
big-endian where the scale is positive and little-endian where it is
negative, the rows bottom-up, converted as mode F), P0CMYK and PyCMYK
(CMYK), PyRGBA (RGBA) and PyP (palette indices with no palette, so every
pixel is black), raw, with PIL's maxval scaling.

Write: grey as P5 and RGB as P6 at maxval 255; RGBA is written as P6, its
alpha dropped, as PIL does.
"""

from __future__ import annotations

import numpy as np

from . import modes

_WHITESPACE = b" \t\n\x0b\x0c\r"
_MODES = {b"P1": "1", b"P2": "L", b"P3": "RGB", b"P4": "1", b"P5": "L",
          b"P6": "RGB", b"P0CMYK": "CMYK", b"Pf": "F", b"PyP": "P",
          b"PyRGBA": "RGBA", b"PyCMYK": "CMYK"}
_BANDS = {"RGB": 3, "RGBA": 4, "CMYK": 4}


def looks_like_pnm(head: bytes) -> bool:
    """PIL's prefix test: P and one of 0-6, f, y."""
    return len(head) >= 2 and head[:1] == b"P" and head[1] in b"0123456fy"


class _Reader:
    def __init__(self, buf: bytes, where: str):
        self.buf, self.pos, self.where = buf, 0, where

    def magic(self) -> bytes:
        out = b""
        for _ in range(6):
            c = self.buf[self.pos:self.pos + 1]
            self.pos += 1
            if not c or c in _WHITESPACE:
                break
            out += c
        return out

    def token(self) -> bytes:
        tok = b""
        while len(tok) <= 10:
            c = self.buf[self.pos:self.pos + 1]
            self.pos += 1
            if not c:
                break
            if c in _WHITESPACE:
                if not tok:
                    continue
                break
            if c == b"#":
                while self.buf[self.pos:self.pos + 1] not in b"\r\n":
                    self.pos += 1
                self.pos += 1
                continue
            tok += c
        if not tok:
            raise ValueError(f"PNM header ends early: {self.where}")
        if len(tok) > 10:
            raise ValueError(f"PNM header token too long: {self.where}")
        return tok


def _strip_comments(data: bytes) -> bytes:
    """Plain data with every comment (# to CR or LF) removed."""
    out, pos = [], 0
    while True:
        i = data.find(b"#", pos)
        if i < 0:
            out.append(data[pos:])
            return b"".join(out)
        out.append(data[pos:i])
        ends = [e for e in (data.find(b"\n", i), data.find(b"\r", i))
                if e >= 0]
        if not ends:
            return b"".join(out)
        pos = min(ends) + 1


def read_pnm(buf: bytes, where: str = "<pnm>") -> np.ndarray:
    """PBM / PGM / PPM bytes -> (H, W, 4) u8, as PIL's
    Image.open(...).convert("RGBA") gives them."""
    r = _Reader(buf, where)
    magic = r.magic()
    if magic not in _MODES:
        raise ValueError(f"not a PNM file: {where}")
    mode = _MODES[magic]
    try:
        w, h = int(r.token()), int(r.token())
    except ValueError as e:
        raise ValueError(f"PNM size is not a number ({e}): {where}") from None
    if w <= 0 or h <= 0:
        raise ValueError(f"PNM size {w}x{h}: {where}")
    modes.check_size(w, h)
    plain = magic in (b"P1", b"P2", b"P3")
    bands = _BANDS.get(mode, 1)
    if mode == "1":
        data = buf[r.pos:]
        if plain:
            toks = b"".join(_strip_comments(data).split())
            if toks.strip(b"01"):
                raise ValueError(f"PBM plain data holds a token other than "
                                 f"0 and 1: {where}")
            if len(toks) < w * h:
                raise ValueError(f"PBM data truncated: {where}")
            px = np.frombuffer(toks[:w * h], np.uint8).reshape(h, w) == 48
        else:
            stride = (w + 7) // 8
            if len(data) < stride * h:
                raise ValueError(f"PBM data truncated: {where}")
            bits = np.unpackbits(np.frombuffer(data, np.uint8, stride * h)
                                 .reshape(h, stride), axis=1)[:, :w]
            px = bits == 0
        return modes.to_rgba("1", px.astype(np.uint8))
    if mode == "F":
        tok = r.token()
        try:
            scale = float(tok)
        except ValueError:
            raise ValueError(f"PFM scale {tok!r} is not a number: "
                             f"{where}") from None
        if scale == 0.0 or not np.isfinite(scale):
            raise ValueError(f"PFM scale must be finite and non-zero: "
                             f"{where}")
        return modes.to_rgba("F", modes.raw(
            buf, r.pos, "F;32F" if scale < 0 else "F;32BF", w, h, ystep=-1,
            where=where))
    tok = r.token()
    try:
        maxval = int(tok)
    except ValueError:
        raise ValueError(f"PNM maxval {tok!r} is not a number: "
                         f"{where}") from None
    if not 0 < maxval < 65536:
        raise ValueError(f"PNM maxval {maxval} is not in 1-65535: {where}")
    if maxval > 255 and mode == "L":
        mode = "I"
    out_max = 65535 if mode == "I" else 255
    n = w * h * bands
    data = buf[r.pos:]
    if plain:
        toks = _strip_comments(data).split()
        if any(len(t) > 10 for t in toks[:n]):
            raise ValueError(f"PNM plain token too long: {where}")
        try:
            vals = np.array([int(t) for t in toks[:n]], np.int64)
        except ValueError:
            raise ValueError(f"PNM plain data is not numbers: "
                             f"{where}") from None
        if vals.size < n:
            raise ValueError(f"PNM data truncated: {where}")
        if (vals < 0).any() or (vals > maxval).any():
            raise ValueError(f"PNM sample outside 0-{maxval}: {where}")
        px = np.round(vals / maxval * out_max).astype(np.int64)
    else:
        width = 1 if maxval < 256 else 2
        if len(data) < n * width:
            raise ValueError(f"PNM data truncated: {where}")
        vals = np.frombuffer(data, np.uint8 if width == 1 else ">u2", n) \
            .astype(np.int64)
        if maxval == 255 or (maxval == 65535 and mode == "I"):
            px = vals
        else:
            px = np.minimum(out_max, np.round(vals / maxval * out_max)) \
                .astype(np.int64)
    px = px.reshape(h, w, bands) if bands > 1 else px.reshape(h, w)
    return modes.to_rgba(mode, px if mode == "I" else px.astype(np.uint8))


def encode_pnm(image: np.ndarray) -> bytes:
    """(H, W) or (H, W, 3|4) u8 -> P5 or P6 bytes as PIL's
    PpmImagePlugin._save writes modes L, RGB and RGBA."""
    img = np.asarray(image)
    h, w = img.shape[:2]
    if img.ndim == 2:
        return b"P5\n%d %d\n255\n" % (w, h) + img.tobytes()
    return (b"P6\n%d %d\n255\n" % (w, h)
            + np.ascontiguousarray(img[..., :3]).tobytes())
