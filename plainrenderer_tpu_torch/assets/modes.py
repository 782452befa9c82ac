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
  - ``I;16``, ``I;16L``, ``I;16B`` and ``I``: the integer clipped to
    0-255;
  - ``F``: the float truncated and clipped to 0-255, NaN to 0 (Convert.c
    f2l, which PIL runs on the way to RGBA);
  - ``RGB``, ``RGBA``, ``RGBX`` (the fourth byte dropped);
  - ``CMYK``: 255 - k - (c * (255 - k)) / 255 per channel with PIL's
    MULDIV255 rounding (Convert.c ``cmyk2rgb``);
  - ``YCbCr``: ConvertYCbCr.c, y plus the Cb / Cr tables'
    int(k * 64 * (c - 128) + 0.5) (truncated toward zero) shifted right
    by 6, clipped.

  - ``LAB``: PIL hands LAB to RGB to LittleCMS (ImageCms, the built-in
    Lab v4 profile to the built-in sRGB, perceptual intent), which
    optimises the transform into a 33^3 16-bit table that ``lab_to_rgb``
    rebuilds as LittleCMS 2 samples it (the Lab -> XYZ -> sRGB pipeline
    in its float32 stages: D50 white, the Bradford-adapted Rec. 709
    primaries inverted, the inverse sRGB curve) and reads with its 16-bit
    tetrahedral interpolation; the pixels are L and a, b offset by 128,
    and a fourth byte, where given, is the alpha LittleCMS copies.

``raw`` is PIL's raw decoder (RawDecode.c with Unpack.c's unpackers) for
the raw modes the legacy readers name: rows of packed bits, nibbles,
bytes, line-interleaved bands (``;L``), and 16- and 32-bit integers and
floats of either byte order, with a row stride and bottom-up rows.

Unpackers that convert while reading (associated alpha, PIL's RGBa,
which TIFF unpacks straight to RGBA; 15- and 16-bit packed pixels) live
here too, so the readers share them.
"""

from __future__ import annotations

import functools
import warnings

import numpy as np

# PIL.Image.MAX_IMAGE_PIXELS, which the JAX package leaves at its default
MAX_IMAGE_PIXELS = int(1024 * 1024 * 1024 // 4 // 3)


class NotThisFormat(ValueError):
    """A reader's finding that a file its magic bytes claimed is not its
    format after all (PIL's plugins raise SyntaxError, TypeError or
    IndexError from _open, and Image.open tries the next format)."""


class DecompressionBombError(ValueError):
    """An image above twice MAX_IMAGE_PIXELS, refused from its header
    (PIL.Image.DecompressionBombError)."""


class DecompressionBombWarning(RuntimeWarning):
    """An image above MAX_IMAGE_PIXELS (PIL.Image.DecompressionBombWarning)."""


def check_size(w: int, h: int) -> None:
    """PIL's _decompression_bomb_check on the size a reader's header
    declares, before anything is decoded: above twice MAX_IMAGE_PIXELS
    raise DecompressionBombError, above it warn, with PIL's messages."""
    pixels = max(1, w) * max(1, h)
    if pixels > 2 * MAX_IMAGE_PIXELS:
        raise DecompressionBombError(
            f"Image size ({pixels} pixels) exceeds limit of "
            f"{2 * MAX_IMAGE_PIXELS} pixels, could be decompression bomb "
            "DOS attack.")
    if pixels > MAX_IMAGE_PIXELS:
        warnings.warn(
            f"Image size ({pixels} pixels) exceeds limit of "
            f"{MAX_IMAGE_PIXELS} pixels, could be decompression bomb DOS "
            "attack.", DecompressionBombWarning, stacklevel=2)


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


# ConvertYCbCr.c's coefficients
_YCC = {"r_cr": 1.402, "g_cb": -0.34414, "g_cr": -0.71414, "b_cb": 1.772}


def ycbcr_to_rgb(ycc: np.ndarray) -> np.ndarray:
    """(..., 3) YCbCr u8 -> (..., 3) RGB u8 as ImagingConvertYCbCr2RGB."""
    i = np.arange(256) - 128
    t = {k: np.trunc(v * 64 * i + 0.5).astype(np.int64)
         for k, v in _YCC.items()}
    y, cb, cr = (ycc[..., k].astype(np.int64) for k in range(3))
    return _u8(np.stack([y + (t["r_cr"][cr] >> 6),
                         y + ((t["g_cb"][cb] + t["g_cr"][cr]) >> 6),
                         y + (t["b_cb"][cb] >> 6)], -1))


# ---------------- LAB through LittleCMS's optimised transform --------------

_D50 = (0.9642, 1.0, 0.8249)
_BRADFORD = ((0.8951, 0.2664, -0.1614), (-0.7502, 1.7135, 0.0367),
             (0.0389, -0.0685, 1.0296))
_MAX_XYZ = 1.0 + 32767.0 / 32768.0  # XYZ 1.15 fixed point's largest value
_SRGB = (2.4, 1 / 1.055, 0.055 / 1.055, 1 / 12.92, 0.04045)
_GRID = 33


def _inv3(a):
    """cmsmtrx.c _cmsMAT3inverse, in its order of operations."""
    c0 = a[1][1] * a[2][2] - a[1][2] * a[2][1]
    c1 = -a[1][0] * a[2][2] + a[1][2] * a[2][0]
    c2 = a[1][0] * a[2][1] - a[1][1] * a[2][0]
    det = a[0][0] * c0 + a[0][1] * c1 + a[0][2] * c2
    return ((c0 / det, (a[0][2] * a[2][1] - a[0][1] * a[2][2]) / det,
             (a[0][1] * a[1][2] - a[0][2] * a[1][1]) / det),
            (c1 / det, (a[0][0] * a[2][2] - a[0][2] * a[2][0]) / det,
             (a[0][2] * a[1][0] - a[0][0] * a[1][2]) / det),
            (c2 / det, (a[0][1] * a[2][0] - a[0][0] * a[2][1]) / det,
             (a[0][0] * a[1][1] - a[0][1] * a[1][0]) / det))


def _mul3(a, b):
    return tuple(tuple(a[i][0] * b[0][j] + a[i][1] * b[1][j]
                       + a[i][2] * b[2][j] for j in range(3))
                 for i in range(3))


def _eval3(a, v):
    return tuple(a[i][0] * v[0] + a[i][1] * v[1] + a[i][2] * v[2]
                 for i in range(3))


def _srgb_from_xyz():
    """The inverse of the built-in sRGB profile's colorant matrix (D65
    white 0.3127, 0.3290 and Rec. 709 primaries, Bradford-adapted to D50:
    cmsvirt.c cmsCreateRGBProfile, cmswtpnt.c), scaled for XYZ in 1.15
    fixed point (cmsio1.c BuildRGBOutputMatrixShaper)."""
    xn, yn = 0.3127, 0.3290
    (xr, yr), (xg, yg), (xb, yb) = (0.64, 0.33), (0.30, 0.60), (0.15, 0.06)
    prim = ((xr, xg, xb), (yr, yg, yb),
            (1 - xr - yr, 1 - xg - yg, 1 - xb - yb))
    c = _eval3(_inv3(prim), (xn / yn, 1.0, (1.0 - xn - yn) / yn))
    rgb = ((c[0] * xr, c[1] * xg, c[2] * xb), (c[0] * yr, c[1] * yg,
                                              c[2] * yb),
           (c[0] * (1.0 - xr - yr), c[1] * (1.0 - xg - yg),
            c[2] * (1.0 - xb - yb)))
    s = _eval3(_BRADFORD, ((xn / yn) * 1.0, 1.0, ((1 - xn - yn) / yn) * 1.0))
    d = _eval3(_BRADFORD, _D50)
    cone = ((d[0] / s[0], 0.0, 0.0), (0.0, d[1] / s[1], 0.0),
            (0.0, 0.0, d[2] / s[2]))
    adapt = _mul3(_inv3(_BRADFORD), _mul3(cone, _BRADFORD))
    inv = _inv3(_mul3(adapt, rgb))
    return tuple(tuple(v * _MAX_XYZ for v in row) for row in inv)


def _quick_saturate_word(d: np.ndarray) -> np.ndarray:
    """lcms2_internal.h _cmsQuickSaturateWord (its fast floor: the value
    rounded to 1/65536, then floored)."""
    d = d + 0.5
    fixed = np.rint((d - 32767.0) * 65536.0).astype(np.int64)
    return np.where(d <= 0, 0, np.where(d >= 65535.0, 65535,
                                        (fixed >> 16) + 32767))


@functools.lru_cache(maxsize=1)
def _lab_table() -> np.ndarray:
    """The 33^3 x 3 16-bit table cmsStageSampleCLut16bit fills from the
    Lab -> XYZ -> sRGB pipeline (cmsopt.c XFormSampler16), read-only."""
    f32 = np.float32
    q = np.floor(np.arange(_GRID) * 65535.0 / (_GRID - 1) + 0.5)
    grid = np.stack(np.meshgrid(q, q, q, indexing="ij"), -1)
    x = (grid / 65535.0).astype(f32).astype(np.float64)
    y = (x[..., 0] * 100.0 + 16.0) / 116.0
    t = (y + 0.002 * (x[..., 1] * 255.0 - 128.0), y,
         y - 0.005 * (x[..., 2] * 255.0 - 128.0))
    xyz = [(np.where(v <= 24.0 / 116.0, (108.0 / 841.0) * (v - 16.0 / 116.0),
                     v * v * v) * w / _MAX_XYZ).astype(f32).astype(np.float64)
           for v, w in zip(t, _D50)]
    g, a, b, c, d = _SRGB
    cut = (a * d + b) ** g
    out = []
    for row in _srgb_from_xyz():
        lin = (xyz[0] * row[0] + xyz[1] * row[1] + xyz[2] * row[2]).astype(
            f32).astype(np.float64)
        with np.errstate(invalid="ignore"):
            enc = np.where(lin >= cut, (np.power(lin, 1.0 / g) - b) / a,
                           lin / c)
        out.append(_quick_saturate_word(enc.astype(f32).astype(np.float64)
                                        * 65535.0))
    table = np.stack(out, -1).reshape(-1, 3)
    table.flags.writeable = False
    return table


def lab_to_rgb(lab: np.ndarray) -> np.ndarray:
    """(..., 3) LAB u8 (L, a + 128, b + 128) -> (..., 3) RGB u8 as PIL's
    LAB -> RGB conversion gives them: the 8-bit input widened to 16 bits,
    cmsintrp.c TetrahedralInterp16 on the table, the 16-bit result narrowed
    as lcms2's FROM_16_TO_8."""
    table = _lab_table().reshape(-1)
    n = _GRID
    v = lab.reshape(-1, 3).astype(np.int64) * 257
    f = v * (n - 1)
    f = f + (f + 0x7FFF) // 0xFFFF  # _cmsToFixedDomain
    r = f & 0xFFFF
    step = np.where(v == 0xFFFF, 0, np.array([n * n * 3, n * 3, 3]))
    base = ((f >> 16) * np.array([n * n * 3, n * 3, 3])).sum(-1)
    rx, ry, rz = r.T
    sx, sy, sz = step.T
    # the tetrahedron's corners after the base, in TetrahedralInterp16's
    # six cases: (first, second, third) offsets and the weights' order
    xy, yz = rx >= ry, ry >= rz
    xz = rx >= rz
    cases = [xy & yz, xy & ~yz & ~xz, xy & ~yz & xz, ~xy & xz,
             ~xy & ~xz & yz, ~xy & ~xz & ~yz]
    corners = [(sx, sx + sy, sx + sy + sz), (sx + sz, sx + sy + sz, sz),
               (sx, sx + sy + sz, sx + sz), (sx + sy, sy, sx + sy + sz),
               (sx + sy + sz, sy, sy + sz), (sx + sy + sz, sy + sz, sz)]
    out = []
    for ch in range(3):
        at = base + ch
        c0 = table[at]
        k = [[table[at + o] for o in cs] for cs in corners]
        c1 = np.select(cases, [k[0][0] - c0, k[1][0] - k[1][2],
                               k[2][0] - c0, k[3][0] - k[3][1],
                               k[4][0] - k[4][2], k[5][0] - k[5][1]])
        c2 = np.select(cases, [k[0][1] - k[0][0], k[1][1] - k[1][0],
                               k[2][1] - k[2][2], k[3][1] - c0,
                               k[4][1] - c0, k[5][1] - k[5][2]])
        c3 = np.select(cases, [k[0][2] - k[0][1], k[1][2] - c0,
                               k[2][2] - k[2][0], k[3][2] - k[3][0],
                               k[4][2] - k[4][1], k[5][2] - c0])
        rest = c1 * rx + c2 * ry + c3 * rz + 0x8001
        w = (c0 + ((rest + (rest >> 16)) >> 16)) & 0xFFFF
        out.append(((w * 65281 + 8388608) >> 24) & 0xFF)
    return np.stack(out, -1).astype(np.uint8).reshape(lab.shape)


# raw mode -> (bits per pixel, bands of the mode's pixels)
_RAW = {"1": (1, 1), "1;I": (1, 1), "1;R": (1, 1), "P;2": (2, 1),
        "L;4": (4, 1), "P;4": (4, 1), "L": (8, 1), "P": (8, 1),
        "RGB": (24, 3), "BGR": (24, 3), "RGBX": (32, 3), "BGRX": (32, 3),
        "RGB;L": (24, 3), "RGBX;L": (32, 3), "RGBA;L": (32, 4),
        "CMYK;L": (32, 4), "LA;L": (16, 2), "PA;L": (16, 2), "YCbCr;L": (24, 3),
        "I;16": (16, 1), "I;16L": (16, 1), "I;16B": (16, 1),
        "I;32": (32, 1), "I;32S": (32, 1), "I;32B": (32, 1),
        "F;8": (8, 1), "F;8S": (8, 1), "F;16": (16, 1), "F;16S": (16, 1),
        "F;32": (32, 1), "F;32F": (32, 1), "F;32BF": (32, 1)}
_NUMBERS = {"I;16": "<u2", "I;16L": "<u2", "I;16B": ">u2", "I;32": "<i4",
            "I;32S": "<i4", "I;32B": ">i4", "F;8": "u1", "F;8S": "i1",
            "F;16": "<u2", "F;16S": "<i2", "F;32": "<u4", "F;32F": "<f4",
            "F;32BF": ">f4"}


def raw(buf: bytes, offset: int, rawmode: str, width: int, height: int,
        stride: int = 0, ystep: int = 1, where: str = "<raw>") -> np.ndarray:
    """PIL's raw decoder: `height` rows of `rawmode` pixels from
    buf[offset:], each row `stride` bytes apart (0: packed), the first row
    at the top (`ystep` 1) or the bottom (-1) -> (H, W) or (H, W, bands)
    pixels of the mode (u8; int64 for I; float32 for F). Too few bytes
    raise ValueError, as PIL's truncated-file error."""
    bits, bands = _RAW[rawmode]
    row = (width * bits + 7) // 8
    stride = stride or row
    if stride < row:
        raise ValueError(f"row stride {stride} below the row's {row} bytes "
                         f"({rawmode}): {where}")
    need = (height - 1) * stride + row if height else 0
    if offset < 0 or len(buf) - offset < need:
        raise ValueError(f"image data truncated ({rawmode}, {width}x"
                         f"{height}): {where}")
    flat = np.frombuffer(buf, np.uint8, need, offset)
    rows = np.lib.stride_tricks.as_strided(flat, (height, row), (stride, 1))
    if ystep < 0:
        rows = rows[::-1]
    if rawmode in _NUMBERS:
        v = rows[:, :width * bits // 8].copy().view(_NUMBERS[rawmode])
        return v.astype(np.float32 if rawmode[0] == "F" else np.int64)
    if bits < 8:
        v = np.unpackbits(rows, axis=1, bitorder="little" if rawmode == "1;R"
                          else "big")
        if bits > 1:
            v = v[:, :width * bits].reshape(height, width, bits)
            v = (v * (1 << np.arange(bits - 1, -1, -1))).sum(-1)
        v = v[:, :width]
        if rawmode == "L;4":
            v = v * 17
        elif rawmode in ("1", "1;R"):
            v = v * 255
        elif rawmode == "1;I":
            v = (1 - v) * 255
        return v.astype(np.uint8)
    if rawmode.endswith(";L"):  # each row holds one row per band
        n = bits // 8
        px = rows.reshape(height, n, width).transpose(0, 2, 1)
    else:
        px = rows.reshape(height, width, bits // 8)
    if rawmode.startswith("BGR"):
        px = px[..., [2, 1, 0]]
    px = np.ascontiguousarray(px[..., :bands])
    return px[..., 0] if bands == 1 else px


def to_rgba(mode: str, pixels: np.ndarray, palette=None,
            transparency=None) -> np.ndarray:
    """Pixels of an image in PIL mode ``mode`` -> (H, W, 4) u8 RGBA, as
    ``Image.convert("RGBA")`` gives them. ``pixels`` is (H, W) for the
    one-band modes and (H, W, bands) for the others."""
    p = np.asarray(pixels)
    h, w = p.shape[:2]
    out = np.empty((h, w, 4), np.uint8)
    if mode == "F":
        f = p.astype(np.float32)
        grey = np.where(f >= 255, 255, np.where(f > 0, f, 0)).astype(np.uint8)
        return to_rgba("L", grey)
    if mode in ("1", "L", "I;16", "I;16L", "I;16B", "I"):
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
    if mode == "LAB":  # a fourth byte is the alpha LittleCMS copies
        out[..., :3] = lab_to_rgb(p[..., :3])
        out[..., 3] = p[..., 3] if p.shape[-1] == 4 else 255
        return out
    if mode in ("CMYK", "YCbCr"):
        out[..., :3] = cmyk_to_rgb(p) if mode == "CMYK" else ycbcr_to_rgb(p)
        out[..., 3] = 255
        return out
    raise ValueError(f"image mode {mode!r} has no RGBA conversion in the "
                     "port")
