"""PIL's ``Image.convert("RGBA")`` for every image mode the port's readers
produce, in one place (PIL's libImaging/Convert.c and Image.convert's
transparency handling, Pillow 12.1).

A reader returns its pixels in the mode PIL would open the file in, and
``to_rgba`` converts them as PIL does:

  - ``1``: 0 stays 0, anything else is 255 (1-bit images are stored
    0 / 255 by PIL's unpackers); alpha 255;
  - ``L``: grey to R, G and B; a ``transparency`` value gives alpha 0
    where the grey equals it (Convert.c ``convert_transparent``);
  - ``LA``: grey and alpha;
  - ``P``: the palette's entries (RGB or RGBA rows; an index past the
    palette is opaque black); ``transparency`` an int (that entry's alpha
    is 0) or bytes (the entries' alphas, ``putpalettealphas``);
  - ``PA``: the palette's RGB with the image's own alpha;
  - ``I;16`` and ``I``: the integer clipped to 0-255;
  - ``RGB``, ``RGBA``, ``RGBX`` (the fourth byte dropped);
  - ``CMYK``: 255 - k - (c * (255 - k)) / 255 per channel with PIL's
    MULDIV255 rounding (Convert.c ``cmyk2rgb``).

Unpackers that convert while reading (associated alpha, PIL's RGBa,
which TIFF unpacks straight to RGBA; 15- and 16-bit packed pixels) live
here too, so the readers share them.
"""

from __future__ import annotations

import numpy as np


class NotThisFormat(ValueError):
    """A reader's finding that a file its magic bytes claimed is not its
    format after all (PIL's plugins raise SyntaxError, TypeError or
    IndexError from _open, and Image.open tries the next format)."""


def _u8(x) -> np.ndarray:
    return np.clip(x, 0, 255).astype(np.uint8)


def palette_table(palette, transparency=None) -> np.ndarray:
    """(256, 4) u8 RGBA table of a palette given as (N, 3) or (N, 4) rows:
    entries past N are opaque black, as PIL's P -> RGBA gives them."""
    table = np.zeros((256, 4), np.uint8)
    table[:, 3] = 255
    pal = np.asarray(palette, np.uint8)
    pal = pal.reshape(-1, pal.shape[-1])[:256]
    table[:len(pal), :pal.shape[1]] = pal
    if isinstance(transparency, (bytes, bytearray)):
        alpha = np.frombuffer(bytes(transparency), np.uint8)[:256]
        table[:len(alpha), 3] = alpha
    elif transparency is not None:
        table[int(transparency), 3] = 0
    return table


def unpremultiply(rgb: np.ndarray, a: np.ndarray,
                  zero_alpha_black: bool = False) -> np.ndarray:
    """rgb * 255 // a (clipped) where 0 < a < 255, the stored rgb where a
    is 255, and where a is 0 the stored rgb (Convert.c rgba2rgbA) or, with
    ``zero_alpha_black``, 0 (Unpack.c unpackRGBa, TIFF's associated alpha
    read at unpack time)."""
    rgb = rgb.astype(np.int64)
    a = a.astype(np.int64)[..., None]
    out = np.where((a > 0) & (a < 255),
                   np.minimum(255, 255 * rgb // np.maximum(a, 1)), rgb)
    if zero_alpha_black:
        out = np.where(a == 0, 0, out)
    return out.astype(np.uint8)


def cmyk_to_rgb(cmyk: np.ndarray) -> np.ndarray:
    """(..., 4) CMYK u8 -> (..., 3) RGB u8 (Convert.c cmyk2rgb)."""
    c = cmyk.astype(np.int64)
    nk = 255 - c[..., 3:4]
    t = c[..., :3] * nk + 128
    return _u8(nk - (((t >> 8) + t) >> 8))


def unpack_bgr15(v: np.ndarray, alpha_bit: bool = False) -> np.ndarray:
    """16-bit little-endian 1-5-5-5 pixels (blue lowest) -> (..., 4) RGBA:
    each 5-bit field * 255 // 31; alpha 255, or with ``alpha_bit`` 0 where
    the top bit is set and 255 where it is clear (Unpack.c BGR;15 and
    BGRA;15Z)."""
    v = v.astype(np.int64)
    out = np.empty(v.shape + (4,), np.uint8)
    out[..., 0] = ((v >> 10) & 31) * 255 // 31
    out[..., 1] = ((v >> 5) & 31) * 255 // 31
    out[..., 2] = (v & 31) * 255 // 31
    out[..., 3] = np.where(v & 0x8000, 0, 255) if alpha_bit else 255
    return out


def unpack_bgr16(v: np.ndarray) -> np.ndarray:
    """16-bit 5-6-5 pixels (blue lowest) -> (..., 4) RGBA (Unpack.c
    BGR;16)."""
    v = v.astype(np.int64)
    out = np.full(v.shape + (4,), 255, np.uint8)
    out[..., 0] = ((v >> 11) & 31) * 255 // 31
    out[..., 1] = ((v >> 5) & 63) * 255 // 63
    out[..., 2] = (v & 31) * 255 // 31
    return out


def to_rgba(mode: str, pixels: np.ndarray, palette=None,
            transparency=None) -> np.ndarray:
    """Pixels of an image in PIL mode ``mode`` -> (H, W, 4) u8 RGBA, as
    ``Image.convert("RGBA")`` gives them. ``pixels`` is (H, W) for the
    one-band modes and (H, W, bands) for the others."""
    p = np.asarray(pixels)
    h, w = p.shape[:2]
    out = np.empty((h, w, 4), np.uint8)
    if mode in ("1", "L", "I;16", "I"):
        if mode == "1":
            grey = np.where(p != 0, 255, 0).astype(np.uint8)
        else:
            grey = _u8(p.astype(np.int64)) if mode != "L" else p
        out[..., :3] = grey[..., None]
        out[..., 3] = 255
        if transparency is not None:
            out[..., 3][p.astype(np.int64) == int(transparency)] = 0
        return out
    if mode == "LA":
        out[..., :3] = p[..., :1]
        out[..., 3] = p[..., 1]
        return out
    if mode in ("P", "PA"):
        table = palette_table(palette if palette is not None
                              else np.zeros((0, 3), np.uint8),
                              transparency if mode == "P" else None)
        out[:] = table[p[..., 0] if mode == "PA" else p]
        if mode == "PA":
            out[..., 3] = p[..., 1]
        return out
    if mode in ("RGB", "RGBX"):
        out[..., :3] = p[..., :3]
        out[..., 3] = 255
        return out
    if mode == "RGBA":
        out[:] = p[..., :4]
        return out
    if mode == "CMYK":
        out[..., :3] = cmyk_to_rgb(p)
        out[..., 3] = 255
        return out
    raise ValueError(f"image mode {mode!r} has no RGBA conversion in the "
                     "port")
