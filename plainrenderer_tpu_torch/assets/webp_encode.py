"""WebP writing without PIL: ``Image.fromarray(a).save(path)`` for a .webp
path, byte for byte as Pillow 12.1 saves it through libwebp 1.6.0
(WebPImagePlugin._save: lossy, quality 80, alpha quality 100, method 4,
exact 0; src/enc/webp_enc.c WebPEncode):

  - the picture: grey as RGB, RGB(A) to YUV 4:2:0 and alpha, the
    transparent area cleaned up (assets/webp_picture.py);
  - the VP8 key frame (assets/vp8_encode.py);
  - the alpha plane where some pixel is below 255 (src/enc/alpha_enc.c
    EncodeAlpha at effort 4 with the fast filter choice): the number of
    alpha values, 16 or fewer keep the plane unfiltered, more pick one of
    the horizontal, vertical and gradient filters by
    WebPEstimateBestFilter (src/utils/filters_utils.c) and try no filter
    too; each trial is coded losslessly (assets/vp8l_encode.py) or kept
    raw where that is no smaller than the plane, and the smallest trial
    (the earlier on a tie) is kept, behind the ALPH header byte (method,
    filter);
  - the container (src/enc/syntax_enc.c): RIFF / WEBP / "VP8 " without
    alpha, RIFF / WEBP / VP8X (alpha flag, canvas size) / ALPH / "VP8 "
    with it; the VP8 chunk's size counts its padding byte, ALPH's does not.
"""

from __future__ import annotations

import struct

import numpy as np

from . import vp8_encode, vp8l_encode, webp_picture

MAX_DIMENSION = 16383
FILTER_NONE, FILTER_HORIZONTAL, FILTER_VERTICAL, FILTER_GRADIENT = range(4)


def _gradient_pred(a, b, c):
    g = a + b - c
    return np.clip(g, 0, 255)


def filter_alpha(a: np.ndarray, method: int) -> np.ndarray:
    """src/dsp/filters.c's forward filters: each sample minus its
    prediction (the first row from the left, the first column from
    above; the inverses of assets/webp.py's _unfilter_alpha)."""
    if method == FILTER_NONE:
        return a.copy()
    x = a.astype(np.int64)
    pred = np.zeros_like(x)
    pred[0, 1:] = x[0, :-1]
    pred[1:, 0] = x[:-1, 0]
    if method == FILTER_HORIZONTAL:
        pred[1:, 1:] = x[1:, :-1]
    elif method == FILTER_VERTICAL:
        pred[1:, 1:] = x[:-1, 1:]
    else:
        pred[1:, 1:] = _gradient_pred(x[1:, :-1], x[:-1, 1:], x[:-1, :-1])
    return ((x - pred) & 255).astype(np.uint8)


def estimate_best_filter(a: np.ndarray) -> int:
    """WebPEstimateBestFilter: which filter leaves the fewest distinct
    (diff >> 4) bins on every other pixel of every other row."""
    h, w = a.shape
    bins = np.zeros((4, 16), bool)
    flat = a.reshape(-1).astype(np.int64)
    for j in range(2, h - 1, 2):
        p0 = j * w
        mean = int(flat[p0])
        for i in range(2, w - 1, 2):
            v = int(flat[p0 + i])
            left, top = int(flat[p0 + i - 1]), int(flat[p0 + i - w])
            tl = int(flat[p0 + i - w - 1])
            g = left + top - tl
            g = 0 if g < 0 else 255 if g > 255 else g
            bins[0, abs(v - mean) >> 4] = True
            bins[1, abs(v - left) >> 4] = True
            bins[2, abs(v - top) >> 4] = True
            bins[3, abs(v - g) >> 4] = True
            mean = (3 * mean + v + 2) >> 2
    scores = (bins * np.arange(16)).sum(axis=1)
    return int(np.argmin(scores))


def encode_alpha(a: np.ndarray) -> bytes:
    """The ALPH chunk's payload for an (H, W) u8 alpha plane."""
    n_colors = len(np.unique(a))
    if n_colors <= 16:
        trials = [FILTER_NONE]
    else:
        trials = sorted({FILTER_NONE, estimate_best_filter(a)})
    best = None
    for filt in trials:
        src = filter_alpha(a, filt)
        stream = vp8l_encode.encode_alpha_stream(src)
        method = 1
        if len(stream) > src.size:
            stream = src.tobytes()
            method = 0
        out = bytes((method | (filt << 2),)) + stream
        if best is None or len(out) < len(best):
            best = out
    return best


def _chunk(tag: bytes, body: bytes, size: int | None = None) -> bytes:
    return tag + struct.pack("<I", len(body) if size is None else size) \
        + body + b"\0" * (len(body) & 1)


def encode_webp(image: np.ndarray) -> bytes:
    """(H, W), (H, W, 3) or (H, W, 4) u8 -> the .webp file PIL saves."""
    rgba = webp_picture.as_rgba(image)
    h, w = rgba.shape[:2]
    if not (0 < w <= MAX_DIMENSION and 0 < h <= MAX_DIMENSION):
        raise ValueError(f"WebP cannot hold a {w}x{h} image (sides 1 to "
                         f"{MAX_DIMENSION})")
    y, u, v, a = webp_picture.to_yuva(rgba)
    if a is not None:
        webp_picture.cleanup_transparent(y, u, v, a)
    frame = vp8_encode.encode_vp8(y, u, v, w, h)
    frame += b"\0" * (len(frame) & 1)  # counted in the chunk's size
    body = b"WEBP"
    if a is not None:
        vp8x = struct.pack("<I", 0x10) + (w - 1).to_bytes(3, "little") \
            + (h - 1).to_bytes(3, "little")
        body += _chunk(b"VP8X", vp8x) + _chunk(b"ALPH", encode_alpha(a))
    body += _chunk(b"VP8 ", frame)
    return b"RIFF" + struct.pack("<I", len(body)) + body
