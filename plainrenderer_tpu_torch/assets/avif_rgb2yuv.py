"""RGB to YUV as libavif 1.3.0's avifImageRGBToYUV converts PIL's pixels
for an AVIF save: nclx matrix 6 (BT.601), full range, 4:2:0, 8 bits,
automatic chroma downsampling, which takes libyuv's ARGBToJ420:

  - Y = (77 R + 150 G + 29 B + 128) >> 8 per pixel;
  - each chroma sample from the 2 x 2 block's rounded averages, first
    down each column, then across (libyuv's pavgb rows; a block past an
    odd edge repeats its last row or column), then
    U = (128 B - 85 G - 43 R + 0x8000) >> 8 and
    V = (128 R - 107 G - 21 B + 0x8000) >> 8.

The alpha plane is the image's alpha unchanged; libavif writes no alpha
item when every alpha sample is 255 (avifImageIsOpaque).
"""

from __future__ import annotations

import numpy as np


def rgb_to_yuv420(rgb: np.ndarray) -> list:
    """(H, W, 3 or 4) u8 -> [Y (H, W), U, V ((H+1)//2, (W+1)//2)] u8."""
    p = np.asarray(rgb)[..., :3].astype(np.int32)
    h, w = p.shape[:2]
    r, g, b = p[..., 0], p[..., 1], p[..., 2]
    y = (77 * r + 150 * g + 29 * b + 128) >> 8
    q = np.pad(p, ((0, h & 1), (0, w & 1), (0, 0)), mode="edge")
    col = (q[0::2] + q[1::2] + 1) >> 1
    avg = (col[:, 0::2] + col[:, 1::2] + 1) >> 1
    ar, ag, ab = avg[..., 0], avg[..., 1], avg[..., 2]
    u = (128 * ab - 85 * ag - 43 * ar + 0x8000) >> 8
    v = (128 * ar - 107 * ag - 21 * ab + 0x8000) >> 8
    return [x.astype(np.uint8) for x in (y, u, v)]


def alpha_plane(rgba: np.ndarray):
    """The alpha plane libavif encodes, or None where it is all 255."""
    a = np.asarray(rgba)
    if a.ndim != 3 or a.shape[2] != 4:
        return None
    alpha = a[..., 3]
    if (alpha == 255).all():
        return None
    return np.ascontiguousarray(alpha, np.uint8)
