"""PIL's 8-bit resampling without PIL: ``Image.resize`` and
``Image.thumbnail`` (at ``reducing_gap=None``) for modes L, RGB and RGBA
with the BICUBIC and LANCZOS filters, as Pillow 12.1's
libImaging/Resample.c computes them, bit for bit.

Each axis gets per-output-pixel coefficients: the filter (bicubic with
a = -0.5, support 2; Lanczos with a = 3, support 3) is stretched by the
downscale factor (at least 1), evaluated in double precision at the input
pixels whose centres fall within the support (bounds rounded as C's
``(int)(x + 0.5)``), normalised to sum 1, and turned to fixed point with
22 fraction bits, rounding half away from zero. The horizontal pass runs
first, over every input row, then the vertical pass; each accumulates
from 2^21 in integers and clips to 0-255 after the shift. An axis whose
size does not change is not resampled. RGBA is resampled premultiplied
(``Image.resize`` converts RGBA to RGBa and back: c * a / 255 rounded by
PIL's MULDIV255, back as min(255, c * 255 // a) where alpha is neither 0
nor 255).
"""

from __future__ import annotations

import math

import numpy as np

_PRECISION_BITS = 32 - 8 - 2


def _bicubic(x: np.ndarray) -> np.ndarray:
    a = -0.5
    x = np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


def _sinc(x: np.ndarray) -> np.ndarray:
    px = x * math.pi
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.where(x == 0.0, 1.0, np.sin(px) / px)


def _lanczos(x: np.ndarray) -> np.ndarray:
    return np.where((-3.0 <= x) & (x < 3.0), _sinc(x) * _sinc(x / 3), 0.0)


FILTERS = {"bicubic": (_bicubic, 2.0), "lanczos": (_lanczos, 3.0)}


def _coefficients(in_size: int, out_size: int, name: str):
    """precompute_coeffs and normalize_coeffs_8bpc: (out, ksize) int64
    fixed-point weights and each output pixel's first input pixel."""
    fn, support = FILTERS[name]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = support * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum((center + support + 0.5).astype(np.int64),
                      in_size) - xmin
    x = np.arange(ksize)
    w = fn((x[None, :] + xmin[:, None] - center[:, None] + 0.5)
           / filterscale)
    w = np.where(x[None, :] < xmax[:, None], w, 0.0)
    total = w.sum(axis=1, keepdims=True)
    w = np.where(total != 0.0, w / np.where(total == 0.0, 1.0, total), w)
    fixed = np.where(w < 0, -0.5 + w * (1 << _PRECISION_BITS),
                     0.5 + w * (1 << _PRECISION_BITS))
    return np.trunc(fixed).astype(np.int64), xmin


def _pass(img: np.ndarray, out_size: int, name: str) -> np.ndarray:
    """Resample axis 1 of (rows, n, channels) int64 samples."""
    k, xmin = _coefficients(img.shape[1], out_size, name)
    idx = np.minimum(xmin[:, None] + np.arange(k.shape[1])[None, :],
                     img.shape[1] - 1)
    acc = np.full((img.shape[0], out_size, img.shape[2]),
                  1 << (_PRECISION_BITS - 1), np.int64)
    for j in range(k.shape[1]):
        acc += img[:, idx[:, j], :] * k[None, :, j, None]
    return np.clip(acc >> _PRECISION_BITS, 0, 255)


def _muldiv255(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    t = a * b + 128
    return ((t >> 8) + t) >> 8


def resize(image: np.ndarray, size: tuple[int, int],
           name: str = "bicubic") -> np.ndarray:
    """``Image.fromarray(image).resize(size, filter)`` for (H, W) or (H,
    W, 3|4) u8; `size` is (width, height) as in PIL."""
    img = np.asarray(image)
    w, h = size
    if (img.shape[1], img.shape[0]) == (w, h):
        return img.copy()
    x = img.astype(np.int64)
    if x.ndim == 2:
        x = x[..., None]
    rgba = x.shape[2] == 4
    if rgba:  # RGBA -> RGBa
        x[..., :3] = _muldiv255(x[..., :3], x[..., 3:])
    if x.shape[1] != w:
        x = _pass(x, w, name)
    if x.shape[0] != h:
        x = _pass(x.transpose(1, 0, 2), h, name).transpose(1, 0, 2)
    if rgba:  # RGBa -> RGBA
        a = x[..., 3:]
        back = np.minimum(255 * x[..., :3] // np.maximum(a, 1), 255)
        x[..., :3] = np.where((a == 0) | (a == 255), x[..., :3], back)
    out = x.astype(np.uint8)
    return out[..., 0] if img.ndim == 2 else out


def thumbnail_size(width: int, height: int,
                   size: tuple[int, int]) -> tuple[int, int] | None:
    """The size ``Image.thumbnail(size)`` gives a width x height image,
    or None where it leaves the image as it is."""
    x, y = (math.floor(v) for v in size)
    if x >= width and y >= height:
        return None

    def round_aspect(number, key):
        return max(min(math.floor(number), math.ceil(number), key=key), 1)

    aspect = width / height
    if x / y >= aspect:
        x = round_aspect(y * aspect, key=lambda n: abs(aspect - n / y))
    else:
        y = round_aspect(x / aspect,
                         key=lambda n: 0 if n == 0 else abs(aspect - x / n))
    return x, y


def thumbnail(image: np.ndarray, size: tuple[int, int],
              name: str = "bicubic") -> np.ndarray:
    """``Image.thumbnail(size, filter, reducing_gap=None)`` on a copy."""
    img = np.asarray(image)
    final = thumbnail_size(img.shape[1], img.shape[0], size)
    if final is None or final == (img.shape[1], img.shape[0]):
        return img.copy()
    return resize(img, final, name)
