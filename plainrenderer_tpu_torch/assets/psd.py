"""Photoshop PSD reading without PIL: the merged image at the end of the
file, as Pillow 12.1's PsdImagePlugin.py opens it (its ``_maketile`` and
the raw and PackBits decoders) and converts it to RGBA.

Read: version 1 files in bitmap (1 bit, PIL's mode 1: a set bit is
white), grayscale, duotone and multichannel (L), indexed (P, with the
768-byte colour table, planar R, G, B), RGB and CMYK (stored inverted, as
PIL's ;I raw modes read it) at 8 bits; raw (0) and PackBits (1) image
data, each channel a plane. PIL's treatment of extra channels is kept: an
RGB file with exactly 4 channels is RGBA, any other extra channel is
ignored, and PackBits row counts are read for the channels PIL reads
only, so the planes of a file with more channels start where PIL starts
them. What PIL refuses (16- and 32-bit samples, PSB, too few channels,
compressions other than raw and PackBits, too little data) raises
ValueError naming it. Lab (mode 9) is read as PIL reads it, L, a and b
planes with a and b offset by 128, converted by modes.lab_to_rgb with
alpha 0 (PIL copies LAB's unset fourth byte).
"""

from __future__ import annotations

import struct

import numpy as np

from . import modes

MAGIC = b"8BPS"
_MODES = {(0, 1): ("1", 1), (0, 8): ("L", 1), (1, 8): ("L", 1),
          (2, 8): ("P", 1), (3, 8): ("RGB", 3), (4, 8): ("CMYK", 4),
          (7, 8): ("L", 1), (8, 8): ("L", 1), (9, 8): ("LAB", 3)}
_MODE_NAMES = {0: "bitmap", 1: "grayscale", 2: "indexed", 3: "RGB",
               4: "CMYK", 7: "multichannel", 8: "duotone", 9: "Lab"}


def _u16(b, o):
    return struct.unpack_from(">H", b, o)[0]


def _u32(b, o):
    return struct.unpack_from(">I", b, o)[0]


def _packbits_rows(buf: bytes, pos: int, rows: int, row_bytes: int,
                   where: str) -> np.ndarray:
    """PackbitsDecode.c: `rows` rows of `row_bytes` bytes from `pos`; a
    run or literal that crosses the end of a row is cut there (its other
    bytes are dropped, as PIL drops them)."""
    out = bytearray()
    for _ in range(rows):
        line = bytearray()
        while len(line) < row_bytes:
            if pos >= len(buf):
                raise ValueError(f"PSD PackBits data truncated: {where}")
            c = buf[pos]
            if c == 0x80:
                pos += 1
                continue
            if c > 0x80:
                n, chunk = 257 - c, buf[pos + 1:pos + 2] * (257 - c)
                pos += 2
            else:
                n, chunk = c + 1, buf[pos + 1:pos + 2 + c]
                pos += 2 + c
            if len(chunk) < n:
                raise ValueError(f"PSD PackBits data truncated: {where}")
            line += chunk[:row_bytes - len(line)]
        out += line
    return np.frombuffer(bytes(out), np.uint8).reshape(rows, row_bytes)


def read_psd(buf: bytes, where: str = "<psd>") -> np.ndarray:
    """PSD bytes -> (H, W, 4) u8, as PIL's Image.open(...).convert("RGBA")
    gives them."""
    if len(buf) < 26 or not buf.startswith(MAGIC) or _u16(buf, 4) != 1:
        raise ValueError(f"not a PSD file (or a PSB, version 2): {where}")
    n_channels, h, w = _u16(buf, 12), _u32(buf, 14), _u32(buf, 18)
    bits, psd_mode = _u16(buf, 22), _u16(buf, 24)
    if (psd_mode, bits) not in _MODES:
        name = _MODE_NAMES.get(psd_mode, f"mode {psd_mode}")
        raise ValueError(f"PSD {name} at {bits}-bit samples is not read "
                         f"(PIL reads 8-bit samples and 1-bit bitmaps): "
                         f"{where}")
    mode, channels = _MODES[(psd_mode, bits)]
    if channels > n_channels:
        raise ValueError(f"PSD has {n_channels} channels, mode {mode} needs "
                         f"{channels} (PIL: not enough channels): {where}")
    if mode == "RGB" and n_channels == 4:
        mode, channels = "RGBA", 4
    pos = 26
    size = _u32(buf, pos)
    palette = None
    if mode == "P" and size == 768:
        palette = np.frombuffer(buf, np.uint8, 768, pos + 4).reshape(3, 256).T
    pos += 4 + size
    size = _u32(buf, pos)
    pos += 4
    end = pos + size
    while pos < end:  # the image resources, walked as PIL walks them
        name_len = buf[pos + 6]
        pos += 7 + name_len + (not name_len & 1)
        data_len = _u32(buf, pos)
        pos += 4 + data_len + (data_len & 1)
    size = _u32(buf, pos)
    pos += 4 + size
    modes.check_size(w, h)
    compression = _u16(buf, pos)
    pos += 2
    if compression not in (0, 1):
        raise ValueError(f"PSD compression {compression} (ZIP) is not raw or "
                         f"PackBits (PIL: cannot load this image): {where}")
    row_bytes = (w + 7) // 8 if mode == "1" else w
    planes = np.zeros((channels, h, row_bytes), np.uint8)
    if compression == 0:
        need = pos + (channels - 1) * w * h + row_bytes * h
        if len(buf) < need:
            raise ValueError(f"PSD image data truncated: {where}")
        for c in range(channels):
            planes[c] = np.frombuffer(buf, np.uint8, row_bytes * h,
                                      pos + c * w * h).reshape(h, row_bytes)
    else:
        counts = np.frombuffer(buf, ">u2", channels * h, pos).astype(np.int64)
        pos += 2 * channels * h
        for c in range(channels):
            planes[c] = _packbits_rows(buf, pos, h, row_bytes, where)
            pos += int(counts[c * h:(c + 1) * h].sum())
    if mode == "1":
        bit = np.unpackbits(planes[0], axis=1)[:, :w]
        return modes.to_rgba("1", bit)
    px = planes.transpose(1, 2, 0)
    if mode in ("L", "P"):
        return modes.to_rgba(mode, px[..., 0], palette)
    if mode == "CMYK":
        return modes.to_rgba("CMYK", 255 - px)
    if mode == "LAB":  # planes copied into L, a, b; the fourth byte stays 0
        return modes.to_rgba("LAB", np.dstack([px, np.zeros_like(px[..., 0])]))
    return modes.to_rgba(mode, px)
